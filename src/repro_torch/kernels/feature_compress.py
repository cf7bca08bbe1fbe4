"""Per-row int8 compression kernels: launches of
``csrc/feature_compress.cu``.

Replace the Pallas TPU kernels ``repro/kernels/feature_compress.py``
(``_quant_kernel``, ``_dequant_kernel``).  The design notes (one warp per
row, bit-exact scales and rounding, bound by bytes) are in the CUDA
source.  The plain versions are ``kernels.ref.quantize_rows_ref`` and
``dequantize_rows_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def quantize_cuda(x):
    """x [T, D] fp32/bf16 on the card (contiguous, T, D > 0) -> (q int8
    [T, D], scale fp32 [T, 1]).  Launches on the current stream; raises if
    the launch is refused."""
    lib = build.library("feature_compress")
    t, d = x.shape
    q = torch.empty((t, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    err = lib.repro_quantize_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
        scale.data_ptr(), t, d, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quantize_rows launch")
    return q, scale


def dequantize_cuda(q, scale, dtype):
    """q [T, D] int8, scale [T, 1] fp32 on the card (contiguous, T, D > 0)
    -> x [T, D] ``dtype`` (bf16 or fp32).  Launches on the current stream;
    raises if the launch is refused."""
    lib = build.library("feature_compress")
    t, d = q.shape
    out = torch.empty((t, d), dtype=dtype, device=q.device)
    err = lib.repro_dequantize_rows(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), t, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "dequantize_rows launch")
    return out
