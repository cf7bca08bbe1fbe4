"""Paged GQA decode attention kernel: launch of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``_paged_gqa_kernel``).  The design notes (one block per (kv-head,
sequence), the pool read in place through the block table, the page loop
bounded by ``pos``) are in the CUDA source.  The plain version is
``kernels.ref.paged_gqa_attention_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build


def supported(page: int, head_dim: int, group: int) -> bool:
    """Whether the kernel is instantiated for these shapes."""
    lib = build.library("paged_attention")
    return bool(lib.repro_paged_gqa_supported(page, head_dim, group))


def attention_cuda(q, pool_k, pool_v, tbl, pos):
    """q [B, 1, Nq, H] bf16, pools [n_pages, P, Nkv, H] bf16, tbl [B, pps]
    int32, pos [B] int32, all on the card -> [B, 1, Nq, H] bf16.  Launches
    on the current stream; raises if the launch is refused."""
    lib = build.library("paged_attention")
    b, _, nq, hd = q.shape
    n_pages, page, nkv, _ = pool_k.shape
    out = torch.empty_like(q)
    err = lib.repro_paged_gqa_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tbl.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, nkv, nq // nkv, hd, page, n_pages,
        tbl.shape[1], 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_gqa_attention launch")
    return out
