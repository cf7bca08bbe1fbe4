"""The survey's Table-1 CNN models as cost graphs.

The effectiveness numbers in the survey's Tables 3-6 (Neurosurgeon 3.1x
latency, DDNN 20x communication reduction, DINA 2.6-4.2x, ...) were measured
on vision CNNs, whose defining property is that RAW INPUTS ARE LARGE and
intermediate activations SHRINK with depth — that is what makes partition
points interesting.  To validate our planners against the paper's own
claims we therefore need the paper's own models; this module encodes
per-layer (FLOPs, activation bytes) profiles for the classic CNNs in the
survey's Table 1 and exposes them as `CostGraph`s compatible with every
planner in core/.

Layer tables are standard published per-layer shapes (batch 1, fp32
activations; FLOPs = 2 * MACs).  A copy of the reference package's
framework-free ``core/cnn_zoo.py``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.cost_model import CostGraph, SegmentCost

_F = 4  # fp32 activation bytes


def _graph(name: str, input_elems: int, layers: Sequence[Tuple[str, float, int]],
           exit_after: Sequence[int] = ()) -> CostGraph:
    """layers: (name, flops, out_elems)."""
    segs: List[SegmentCost] = []
    for i, (lname, flops, out_el) in enumerate(layers):
        segs.append(SegmentCost(
            index=i, n_layers=1, flops=flops,
            param_bytes=flops / 2 * 0.01,     # rough; planners use flops/bytes
            out_bytes=float(out_el * _F),
            has_exit_after=(i in exit_after)))
    return CostGraph(name, 1, 1, float(input_elems * _F), tuple(segs), 4.0)


def alexnet() -> CostGraph:
    """AlexNet @227x227 (survey Table 1: 0.7 GFLOPs class)."""
    L = [
        ("conv1", 2 * 105e6, 55 * 55 * 96),
        ("pool1", 2 * 1e6, 27 * 27 * 96),
        ("conv2", 2 * 448e6, 27 * 27 * 256),
        ("pool2", 2 * 1e6, 13 * 13 * 256),
        ("conv3", 2 * 150e6, 13 * 13 * 384),
        ("conv4", 2 * 224e6, 13 * 13 * 384),
        ("conv5", 2 * 150e6, 13 * 13 * 256),
        ("pool5", 2 * 0.5e6, 6 * 6 * 256),
        ("fc6", 2 * 37.7e6, 4096),
        ("fc7", 2 * 16.8e6, 4096),
        ("fc8", 2 * 4.1e6, 1000),
    ]
    return _graph("alexnet", 227 * 227 * 3, L, exit_after=(3, 7))


def vgg16() -> CostGraph:
    """VGG-16 @224x224 (survey Table 1: 15.5 GFLOPs)."""
    L = [
        ("conv1_x", 2 * 1.94e9, 224 * 224 * 64),
        ("pool1", 2e6, 112 * 112 * 64),
        ("conv2_x", 2 * 2.77e9, 112 * 112 * 128),
        ("pool2", 1e6, 56 * 56 * 128),
        ("conv3_x", 2 * 4.62e9, 56 * 56 * 256),
        ("pool3", 1e6, 28 * 28 * 256),
        ("conv4_x", 2 * 4.62e9, 28 * 28 * 512),
        ("pool4", 1e6, 14 * 14 * 512),
        ("conv5_x", 2 * 1.39e9, 14 * 14 * 512),
        ("pool5", 0.5e6, 7 * 7 * 512),
        ("fc6", 2 * 102.8e6, 4096),
        ("fc7", 2 * 16.8e6, 4096),
        ("fc8", 2 * 4.1e6, 1000),
    ]
    return _graph("vgg16", 224 * 224 * 3, L, exit_after=(5, 9))


def resnet50() -> CostGraph:
    """ResNet-50 @224x224 (survey Table 1: 3.9 GFLOPs)."""
    L = [
        ("stem", 2 * 0.24e9, 56 * 56 * 64),
        ("stage1", 2 * 1.33e9, 56 * 56 * 256),
        ("stage2", 2 * 1.06e9, 28 * 28 * 512),
        ("stage3", 2 * 1.49e9, 14 * 14 * 1024),
        ("stage4", 2 * 0.80e9, 7 * 7 * 2048),
        ("fc", 2 * 4.1e6, 1000),
    ]
    return _graph("resnet50", 224 * 224 * 3, L, exit_after=(1, 3))


def yolov5s() -> CostGraph:
    """YOLOv5s @640x640 (survey Table 1: 6.38 GFLOPs class) — video analytics."""
    L = [
        ("backbone_p1", 2 * 1.2e9, 160 * 160 * 64),
        ("backbone_p2", 2 * 1.6e9, 80 * 80 * 128),
        ("backbone_p3", 2 * 1.6e9, 40 * 40 * 256),
        ("backbone_p4", 2 * 1.0e9, 20 * 20 * 512),
        ("neck", 2 * 0.8e9, 40 * 40 * 256),
        ("head", 2 * 0.2e9, 25200 * 85),
    ]
    return _graph("yolov5s", 640 * 640 * 3, L, exit_after=(2,))


def mobilenet_v1() -> CostGraph:
    """MobileNetV1 @224x224 (survey Table 1: 0.569 GFLOPs)."""
    L = [
        ("stem", 2 * 21e6, 112 * 112 * 32),
        ("dw1-3", 2 * 120e6, 56 * 56 * 128),
        ("dw4-6", 2 * 130e6, 28 * 28 * 256),
        ("dw7-12", 2 * 250e6, 14 * 14 * 512),
        ("dw13", 2 * 48e6, 7 * 7 * 1024),
        ("fc", 2 * 1e6, 1000),
    ]
    return _graph("mobilenet_v1", 224 * 224 * 3, L, exit_after=(1, 3))


CNN_ZOO = {
    "alexnet": alexnet,
    "vgg16": vgg16,
    "resnet50": resnet50,
    "yolov5s": yolov5s,
    "mobilenet_v1": mobilenet_v1,
}
