"""Fused exit-head entropy kernel: launch of ``csrc/exit_head.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/exit_head.py``
(``_exit_head_kernel``).  The design notes (two passes over vocab tiles,
the ragged vocab edge masked in the kernel, bound by the bytes of W) are in
the CUDA source.  The plain version is ``kernels.ref.exit_head_entropy_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def entropy_cuda(x, w):
    """x [T, D] bf16, w [D, V] bf16 on the card -> entropy [T] fp32.
    Launches on the current stream; raises if the launch is refused."""
    lib = build.library("exit_head")
    t, d = x.shape
    v = w.shape[1]
    n_tiles = -(-v // lib.repro_exit_head_block_v())
    part = torch.empty(3 * t * n_tiles, dtype=torch.float32, device=x.device)
    out = torch.empty(t, dtype=torch.float32, device=x.device)
    err = lib.repro_exit_head_entropy(
        x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(), t, d, v,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "exit_head_entropy launch")
    return out
