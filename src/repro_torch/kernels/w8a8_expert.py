"""W8A8 grouped expert GEMM: launch of ``csrc/w8a8_expert.cu``.

Replaces no Pallas kernel: the reference computes this product outside
Pallas, as XLA's int8 ``dot_general`` in ``_q_expert_matmul``
(``repro/models/ffn.py``).  One block of 8 warps per (expert, 128-column
tile, 8 capacity rows); each lane owns 4 columns, transposes 4 x 4 byte
blocks of the [E, K, N] weight into K-packed words in registers and
accumulates s8 x s8 -> s32 with ``__dp4a``; the warps' sums meet in shared
memory and the epilogue scales them.  The design notes are in the CUDA
source; the plain version is ``kernels.ref.w8a8_expert_matmul_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK_C = 8        # capacity rows a block (BC)
K_STEP = 16        # K rows a warp step (KS): K must be a multiple
MAX_K = 133_143    # K * 127^2 stays below 2^31


def supported(k: int, n: int) -> bool:
    """Whether the kernel takes a reduction depth ``k`` and ``n``
    columns: whole 16-row steps of K, whole 4-byte words of a wq row."""
    return 0 < k <= MAX_K and k % K_STEP == 0 and n > 0 and n % 4 == 0


def matmul_cuda(aq, a_scale, wq, w_scale):
    """aq [E, C, K] int8, a_scale [E, C, 1] fp32, wq [E, K, N] int8,
    w_scale [E, 1, N] fp32, on the card -> fp32 [E, C, N].  Launches on
    the current stream; raises if the launch is refused."""
    lib = build.library("w8a8_expert")
    if lib.repro_w8a8_k_step() != K_STEP:
        raise RuntimeError("repro_torch: w8a8_expert.cu's K step is not "
                           f"{K_STEP}")
    e, c, k = aq.shape
    n = wq.shape[2]
    out = torch.empty((e, c, n), dtype=torch.float32, device=aq.device)
    err = lib.repro_w8a8_expert_matmul(
        aq.data_ptr(), a_scale.data_ptr(), wq.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), e, c, k, n,
        torch.cuda.current_stream(aq.device).cuda_stream)
    build.check(err, "w8a8_expert_matmul launch")
    return out
