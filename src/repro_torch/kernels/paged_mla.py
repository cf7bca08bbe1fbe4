"""Paged MLA decode attention kernel: launch of ``csrc/paged_mla.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``_paged_mla_kernel``).  The design notes (one block per (head tile,
sequence, split of 16 pages) sharing each staged latent page, a combine
pass over the splits, both pools read in place with no concatenation or
padding, the page loop bounded by ``pos``) are in the CUDA source.  The plain version is ``kernels.ref.paged_mla_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def supported(n_heads: int, rank: int, rope_dim: int, page: int) -> bool:
    """Whether the kernel is instantiated for these shapes."""
    lib = build.library("paged_mla")
    return bool(lib.repro_paged_mla_supported(n_heads, rank, rope_dim, page))


def attention_cuda(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos, scale):
    """q_lat [B, 1, N, R] and q_rope [B, 1, N, Hr] bf16, pools
    [n_pages, P, R] / [n_pages, P, Hr] bf16, tbl [B, pps] int32, pos [B]
    int32, all on the card -> latent context [B, 1, N, R] fp32.  Tables of
    more than one split's pages get fp32 scratch for the per-split
    contexts and softmax statistics.  Launches on the current stream;
    raises if a launch is refused."""
    lib = build.library("paged_mla")
    b, _, n, r = q_lat.shape
    n_pages, page = pool_ckv.shape[0], pool_ckv.shape[1]
    pps = tbl.shape[1]
    splits = -(-pps // lib.repro_paged_mla_split_pages())
    dev = q_lat.device
    out = torch.empty((b, 1, n, r), dtype=torch.float32, device=dev)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b, splits, n, r), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((b, splits, n, 2), dtype=torch.float32,
                              device=dev)
    err = lib.repro_paged_mla_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), pool_ckv.data_ptr(),
        pool_krope.data_ptr(), tbl.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, n, r,
        pool_krope.shape[2], page, n_pages, pps, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_mla_attention launch")
    return out
