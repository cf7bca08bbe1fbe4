"""Fused exit-head entropy kernel: launch of ``csrc/exit_head.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/exit_head.py``
(``_exit_head_kernel``).  Two passes: one block per (128-column vocab
tile, group of 16 rows) streams W through a 6-stage cp.async ring in
shared memory and multiplies on the tensor cores (``mma.sync`` m16n8k16,
x as the 16-row A operand, staged through shared memory a step ahead),
four blocks to an SM, reducing its tile to per-row (m, s, t)
partials; a finish pass merges them.  The ragged vocab edge is masked in
the kernel and W is never padded.  Two instances: ``aligned`` for rows of
W that start on 16 bytes (V % 8 == 0), ``odd_pitch`` for the rest
(granite's V = 49155), which copies the aligned chunks covering each row
and reads them at the row's shift.  The design notes are in the CUDA
source; the plain version is ``kernels.ref.exit_head_entropy_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK_V = 128      # vocab columns per tile (the kernel's BV)
ROWS = 16          # rows per tile: one m16 MMA tile (the kernel's TB)


def instance(v: int, w_ptr: int) -> str:
    """The kernel instance for W [D, v] at address ``w_ptr``: ``aligned``
    when every row of W starts on 16 bytes, else ``odd_pitch``."""
    return "aligned" if v % 8 == 0 and w_ptr % 16 == 0 else "odd_pitch"


def plan(t: int, d: int, v: int, w_ptr: int) -> dict:
    """Grid and scratch of one call: vocab tiles (grid.x), 16-row groups
    (grid.y), the fp32 partials scratch (m, s, t per row and tile) and the
    instance."""
    n_tiles = -(-v // BLOCK_V)
    return {"n_tiles": n_tiles, "row_groups": -(-t // ROWS),
            "scratch": 3 * t * n_tiles, "instance": instance(v, w_ptr)}


def entropy_cuda(x, w):
    """x [T, D] bf16, w [D, V] bf16 on the card -> entropy [T] fp32.
    Launches on the current stream; raises if the launch is refused."""
    lib = build.library("exit_head")
    if lib.repro_exit_head_block_v() != BLOCK_V:
        raise RuntimeError("repro_torch: exit_head.cu's tile width is not "
                           f"{BLOCK_V}")
    t, d = x.shape
    v = w.shape[1]
    p = plan(t, d, v, w.data_ptr())
    part = torch.empty(p["scratch"], dtype=torch.float32, device=x.device)
    out = torch.empty(t, dtype=torch.float32, device=x.device)
    err = lib.repro_exit_head_entropy(
        x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(), t, d, v,
        int(p["instance"] == "aligned"),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "exit_head_entropy launch")
    return out
