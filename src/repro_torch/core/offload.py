"""Offloading decisions + intermediate-feature compression ([30], [51], [36]).

The boundary activation is what a partition ships; compressing it trades
compute + a little accuracy for transfer time.  `compression_decision`
implements the survey's recurring trade-off (Vision-Pipeline [36] data
transmission reduction, PADCS [51] intermediate data compression) on top of
the cost model.  `compress_boundary`/`decompress_boundary` are the runtime
ops, plain torch on any device as in the reference (where they are the
oracle of its Pallas kernel); at bits 8 they compute what the kernel pair
``kernels.ops.compress_rows`` / ``decompress_rows`` computes.

A copy of the reference package's ``core/offload.py``.  Rounding: the
reference divides the row's amax by qmax, which XLA turns into a product
with fl(1/qmax) under ``jax.jit`` (and keeps as a division when eager);
the port takes the jitted form, as its int8 kernel does.
``tests/test_torch_offload.py`` holds it against the jitted reference bit
for bit and counts where the eager one rounds apart.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.cost_model import DeviceProfile, LinkProfile, compute_time


# ---------------------------------------------------------------------------
# Runtime ops
# ---------------------------------------------------------------------------

def _reciprocal(qmax: float) -> float:
    """fl(1/qmax) in fp32, the constant XLA folds ``/ qmax`` into."""
    return float(torch.tensor(1.0) / torch.tensor(qmax))


def compress_boundary(x, bits: int = 8):
    """Per-row symmetric quantization to int8 (bits=8) or int4-in-int8
    (bits=4, qmax 7): x [..., D] -> (q int8 [..., D], scale fp32 [..., 1]),
    scale = max(amax * fl(1/qmax), 1e-8), q = clip(round_half_even(x /
    scale), +-qmax)."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True)
                        * _reciprocal(qmax), min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def decompress_boundary(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def compression_error(x, bits: int = 8) -> torch.Tensor:
    """RMS error of a compress/decompress round trip, fp32 scalar."""
    q, s = compress_boundary(x, bits)
    return torch.sqrt(torch.mean(torch.square(
        decompress_boundary(q, s, torch.float32) - x.float())))


# ---------------------------------------------------------------------------
# Planner decision
# ---------------------------------------------------------------------------


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
