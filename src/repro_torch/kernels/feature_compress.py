"""Per-row int8 compression kernels: launches of
``csrc/feature_compress.cu``.

Replace the Pallas TPU kernels ``repro/kernels/feature_compress.py``
(``_quant_kernel``, ``_dequant_kernel``).  ``plan`` picks one of two
hand-written instances from shapes and pointers on the host: ``vec``
(16-byte accesses, a row to a group of lanes held in registers, a
persistent grid) whenever a row of the float side is a whole number of
16-byte vectors and every pointer is 16-byte aligned, ``scalar`` (a warp per row, a thread per
element) for the rest.  The design notes (bit-exact scales and rounding,
bound by bytes) are in the CUDA source.  The plain versions are
``kernels.ref.quantize_rows_ref`` and ``dequantize_rows_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_mla import sm_count

WARPS = 8          # warps a block, both instances (kWarpsPerBlock)
LOADS = 4          # vec quantize: 16-byte loads in flight (kLoads)
DEQ_LOADS = 8      # vec dequantize: q loads in flight (kDeqLoads)
MAX_VECTORS = 16   # vec quantize: 16-byte vectors a lane (kMaxVectors)
SCALAR_THREADS = 256    # scalar dequantize: threads a block
SCALAR_MAX_GRID = 1 << 20
H100_SMS = 132


def blocks_per_sm(v: int) -> int:
    """Resident blocks an SM of the vec instance with ``v`` vectors a lane
    (its launch bound, ``blocks_per_sm`` in the CUDA source; dequantize
    is v = 1)."""
    return 1 if v >= 16 else 2 if v >= 8 else 4


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def divide_magic(c: int):
    """(mul, shr) such that row = (umulhi(i, mul) + i) >> shr equals
    i // c for every 0 <= i < 2**31 (c >= 1)."""
    shr = (c - 1).bit_length()
    return ((1 << 32) * ((1 << shr) - c)) // c + 1, shr


def plan(rows: int, d: int, elem_bytes: int, ptrs, sms: int = H100_SMS,
         kernel: str = "quantize") -> dict:
    """Instance and grid of one call of ``kernel`` ("quantize" or
    "dequantize") on ``rows`` rows of ``d`` elements whose float side (x
    of quantize, the output of dequantize) has ``elem_bytes`` bytes an
    element (4 fp32, 2 bf16); ``ptrs`` are the call's device addresses.
    ``vec`` when a float row is whole 16-byte vectors and every pointer is
    16-byte aligned, else ``scalar``.

    quantize ``vec``: g lanes a row (a power of two, at most 32), v 16-byte
    vectors a lane, u row groups a warp at a time (u * v >= LOADS); a row
    must fit in a warp's registers (at most 32 x MAX_VECTORS vectors, 8
    KB), a longer one takes ``scalar``.  dequantize
    ``vec``: one 16-byte output vector (``elems`` elements) a lane,
    DEQ_LOADS at a time, its row found by ``shift`` (a power of two pieces
    a row) or by ``mul`` / ``shr``.  Both on a persistent grid of at most
    ``sms`` x blocks_per_sm blocks."""
    row_bytes = d * elem_bytes
    chunks = row_bytes // 16                  # 16-byte vectors a float row
    vec = row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    block = 32 * WARPS
    if kernel == "dequantize":
        pieces = rows * chunks
        if not vec or pieces >= 1 << 31:
            grid = min(-(-rows * d // SCALAR_THREADS), SCALAR_MAX_GRID)
            return {"instance": "scalar", "grid": grid,
                    "block": SCALAR_THREADS, "shift": -1, "mul": 0,
                    "shr": 0}
        pow2 = chunks & (chunks - 1) == 0
        mul, shr = (0, 0) if pow2 else divide_magic(chunks)
        grid = min(-(-pieces // (block * DEQ_LOADS)),
                   sms * blocks_per_sm(1))
        return {"instance": "vec", "grid": grid, "block": block,
                "pieces": pieces, "elems": 16 // elem_bytes,
                "shift": chunks.bit_length() - 1 if pow2 else -1,
                "mul": mul, "shr": shr}
    if not vec or chunks > 32 * MAX_VECTORS:
        return {"instance": "scalar", "grid": -(-rows // WARPS),
                "block": block, "g": 0, "v": 0, "u": 0}
    if chunks <= 32:
        g, v = _pow2_at_least(chunks), 1
    else:
        g, v = 32, _pow2_at_least(-(-chunks // 32))
    u = max(1, LOADS // v)
    step = (32 // g) * u                      # rows a warp iteration
    grid = min(-(-rows // (step * WARPS)), sms * blocks_per_sm(v))
    return {"instance": "vec", "grid": grid, "block": block, "g": g,
            "v": v, "u": u, "rows_per_warp": 32 // g}


def quantize_cuda(x):
    """x [T, D] fp32/bf16 on the card (contiguous, T, D > 0) -> (q int8
    [T, D], scale fp32 [T, 1]).  Launches the plan's instance on the
    current stream; raises if the launch is refused."""
    lib = build.library("feature_compress")
    t, d = x.shape
    q = torch.empty((t, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    p = plan(t, d, x.element_size(),
             (x.data_ptr(), q.data_ptr(), scale.data_ptr()),
             sm_count(x.device))
    err = lib.repro_quantize_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
        scale.data_ptr(), t, d, int(p["instance"] == "vec"),
        p["g"].bit_length() - 1 if p["g"] else 0, p["v"], p["grid"],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"quantize_rows launch ({p['instance']})")
    return q, scale


def dequantize_cuda(q, scale, dtype):
    """q [T, D] int8, scale [T, 1] fp32 on the card (contiguous, T, D > 0)
    -> x [T, D] ``dtype`` (bf16 or fp32).  Launches the plan's instance on
    the current stream; raises if the launch is refused."""
    lib = build.library("feature_compress")
    t, d = q.shape
    out = torch.empty((t, d), dtype=dtype, device=q.device)
    p = plan(t, d, out.element_size(),
             (q.data_ptr(), scale.data_ptr(), out.data_ptr()),
             sm_count(q.device), kernel="dequantize")
    err = lib.repro_dequantize_rows(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), t, d, int(p["instance"] == "vec"),
        p["shift"], p["mul"], p["shr"], p["grid"],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"dequantize_rows launch ({p['instance']})")
    return out
