"""Offloading decisions ([30], [51], [36]).

The boundary activation is what a partition ships; compressing it trades
compute + a little accuracy for transfer time.  `compression_decision`
implements the survey's recurring trade-off (Vision-Pipeline [36] data
transmission reduction, PADCS [51] intermediate data compression) on top of
the cost model.  The per-row int8 compression itself is the kernel pair
``kernels.ops.compress_rows`` / ``decompress_rows``.

A copy of the planner part of the reference package's ``core/offload.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.cost_model import DeviceProfile, LinkProfile, compute_time


@dataclass(frozen=True)
class CompressionDecision:
    compress: bool
    bits: int
    tx_time_raw: float
    tx_time_compressed: float
    quant_overhead: float
    speedup: float


def compression_decision(boundary_bytes: float, device: DeviceProfile,
                         link: LinkProfile, bits: int = 8,
                         act_bytes: int = 2) -> CompressionDecision:
    """Compress iff (tx saved) > (quantize+dequantize compute overhead)."""
    raw_t = link.tx_time(boundary_bytes)
    ratio = act_bytes * 8 / bits
    comp_bytes = boundary_bytes / ratio + boundary_bytes / (act_bytes * 128)  # + scales
    comp_t = link.tx_time(comp_bytes)
    # quantization is ~3 flops/element + a row reduce
    n_el = boundary_bytes / act_bytes
    overhead = compute_time(6.0 * n_el, device)
    total_comp = comp_t + overhead
    return CompressionDecision(total_comp < raw_t, bits, raw_t, total_comp,
                               overhead, raw_t / max(total_comp, 1e-12))


def measured_tx_time(payload_bytes: float, link: LinkProfile, *,
                     quant_overhead: float = 0.0) -> float:
    """Transfer time of an ACTUAL payload.

    ``compression_decision`` predicts from an analytic byte estimate; once
    the payload exists (e.g. an exported ``SlotSnapshot``) the link must be
    charged for the bytes it really carries — ``payload_bytes`` summed over
    the shipped arrays — plus the quantization compute the sender spent
    producing them (0 for a raw handoff).  This is the virtual/real-gap
    closure: planners estimate, clocks pay measured."""
    return link.tx_time(payload_bytes) + quant_overhead
