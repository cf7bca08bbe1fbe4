"""The port's config arithmetic and roofline terms against the
reference's (``repro.configs``, ``repro.launch.roofline``).

Exact: every config's ``param_count``, ``active_param_count``,
``supports_long_context``, ``is_decoder`` and ``flops_per_token`` at each
input shape's length, and ``model_flops_for`` at every (config, shape),
for the 10 registry configs and their smoke variants: the integers equal
and the floats equal to the bit.  ``INPUT_SHAPES`` and
``shape_applicable`` equal the reference's.  The ``Roofline`` fields,
properties and ``to_dict`` keys are the reference's; its constants are
one H100's published peaks, and ``chip_smoke.py`` reads them from here.
"""
import dataclasses
import math
import os
import re
import sys

import pytest

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import shape_applicable as ref_applicable
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, \
    shape_applicable
from repro_torch.launch import roofline
from repro_torch.launch.roofline import (COLLECTIVES, Roofline,
                                         collective_bytes_from_log,
                                         model_flops_for)

NAMES = sorted(ARCHS) + sorted(a + "-smoke" for a in ARCHS)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _same_float(a: float, b: float) -> bool:
    return math.isfinite(a) and a.hex() == b.hex()


def test_input_shapes_are_the_references():
    assert list(INPUT_SHAPES) == list(REF_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            REF_SHAPES[name])


@pytest.mark.parametrize("name", NAMES)
def test_config_arithmetic_is_the_references(name):
    cfg, ref = get_config(name), ref_config(name)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert type(cfg.param_count()) is int
    assert cfg.supports_long_context == ref.supports_long_context
    assert cfg.is_decoder is ref.is_decoder is True
    for shape in INPUT_SHAPES.values():
        assert _same_float(cfg.flops_per_token(shape.seq_len),
                           ref.flops_per_token(shape.seq_len))
        assert shape_applicable(cfg, shape.name) == ref_applicable(
            ref, shape.name)
        for kind in ("train", "prefill", "decode"):
            assert _same_float(model_flops_for(cfg, shape, kind),
                               ref_roofline.model_flops_for(ref, shape,
                                                            kind))


def test_long_500k_skips_only_whisper():
    skipped = sorted(a for a in ARCHS
                     if not shape_applicable(get_config(a), "long_500k"))
    assert skipped == ["whisper-base"]


def test_h100_peaks_and_no_tpu_constant():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.INT8_PEAK == 1979e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.HBM_BYTES == 80e9
    assert roofline.LINK_BW == 450e9
    assert not hasattr(roofline, "ICI_BW")
    src = open(roofline.__file__, encoding="utf-8").read()
    for tpu in ("197e12", "819e9", "50e9"):     # TPU v5e's, the reference's
        assert not re.search(r"(?<![\d.])" + tpu, src), tpu


def test_chip_smoke_reads_the_peaks_from_roofline():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.PEAKS == (roofline.HBM_BW, roofline.PEAK_FLOPS)
    assert chip_smoke.INT8_PEAK == roofline.INT8_PEAK


def test_roofline_has_the_references_fields_and_keys():
    fields = [f.name for f in dataclasses.fields(Roofline)]
    assert fields == [f.name for f in dataclasses.fields(
        ref_roofline.Roofline)]
    args = dict(arch="a", shape="s", mesh="one", chips=1, hlo_flops=2e12,
                hlo_bytes=1e9, collective=None, model_flops=1e12)
    ref = ref_roofline.Roofline(**dict(args, collective={
        k: 0.0 for k in ref_roofline._COLLECTIVES}))
    assert list(Roofline(**args).to_dict()) == list(ref.to_dict())


def test_roofline_terms():
    r = Roofline(arch="a", shape="s", mesh="one", chips=4, hlo_flops=989e9,
                 hlo_bytes=6.7e9, collective=None, model_flops=2 * 989e9)
    assert r.t_compute == 989e9 / 989e12
    assert r.t_memory == 6.7e9 / 3.35e12
    assert r.collective_bytes is None and r.t_collective is None
    assert r.bottleneck == "memory"
    assert r.useful_flops_ratio == 0.5
    coll = collective_bytes_from_log([
        {"kind": "all-reduce", "bytes": 100, "site": "x"},
        {"kind": "all-reduce", "bytes": 50, "site": "y"},
        {"kind": "broadcast", "bytes": 7, "site": "z"},
        {"kind": "collective-permute", "bytes": 3, "site": "z"}])
    assert coll == dict({k: 0.0 for k in COLLECTIVES}, **{
        "all-reduce": 150.0, "broadcast": 7.0, "collective-permute": 3.0})
    r = dataclasses.replace(r, collective=coll)
    # all-reduce twice (a ring's two phases), the rest once
    assert r.collective_bytes == 2 * 150 + 7 + 3
    assert r.t_collective == 310 / 450e9
    r = dataclasses.replace(r, collective={"all-gather": 1e12})
    assert r.bottleneck == "collective"
    assert set(COLLECTIVES) == set(ref_roofline._COLLECTIVES) | {"broadcast"}
    for k, w in ref_roofline._COLLECTIVES.items():
        assert COLLECTIVES[k] == w
