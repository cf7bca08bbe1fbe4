"""Paged GQA decode attention kernel: launch of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``_paged_gqa_kernel``).  One block per (up to 8 kv heads, sequence, split
of the page table): a producer thread feeds a ring of whole pages through
TMA, and one warp per kv head runs both products on ``mma.sync`` with its
G query rows (any G from 1 to 8) padded to 16; at H 224 (Zamba2's
shared blocks) a block spans 4 kv heads.  The pool is read in place
through the block table; the page loop is bounded by ``pos``.  ``plan``
splits the table from shapes only, never from ``pos``; with more than one
split a second launch merges the splits and rounds once to bf16.  The
design notes are in the CUDA source; the plain version is
``kernels.ref.paged_gqa_attention_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_mla import sm_count

KV_HEADS_PER_BLOCK = 8   # kvb_of(H) in csrc/paged_attention.cu, H <= 128
KV_HEADS_PER_BLOCK_WIDE = 4   # ... at H 224: a ring page of 8 heads
                              # would not fit the shared memory


def kv_heads_per_block(head_dim: int) -> int:
    """Kv heads one block spans at ``head_dim`` (the CUDA source's
    ``kvb_of``)."""
    return KV_HEADS_PER_BLOCK if head_dim <= 128 else KV_HEADS_PER_BLOCK_WIDE
# A split's partials are G x H fp32 a kv head, a sixteenth of one page's K
# and V at G 4, so splits are cheap; on the H100 (PERF.md) splits of 2
# pages were the fastest at serving's 18-page tables, and one wave of
# 15-16-page splits at 128-page tables.
MIN_SPLIT_PAGES = 2


def plan(b: int, nkv: int, pps: int, sms: int, head_dim: int) -> dict:
    """Split plan of one call from shapes only: enough splits that the
    grid fills one wave of ``sms`` blocks (two fit an SM, and ragged
    positions leave many idle), each split at least ``MIN_SPLIT_PAGES``
    pages.  Split z scores pages [z * split_pages, (z + 1) *
    split_pages); a block spans ``kv_heads_per_block(head_dim)`` kv
    heads."""
    groups = -(-nkv // kv_heads_per_block(head_dim))
    want = -(-sms // (b * groups))
    splits = max(1, min(want, pps // MIN_SPLIT_PAGES))
    split_pages = -(-pps // splits)
    splits = -(-pps // split_pages)
    return {"groups": groups, "splits": splits, "split_pages": split_pages,
            "grid": (groups, b, splits), "launches": 1 if splits == 1 else 2}


def supported(page: int, head_dim: int, group: int) -> bool:
    """Whether the kernel is instantiated for these shapes."""
    lib = build.library("paged_attention")
    return bool(lib.repro_paged_gqa_supported(page, head_dim, group))


def attention_cuda(q, pool_k, pool_v, tbl, pos, scale=None):
    """q [B, 1, Nq, H] bf16, pools [n_pages, P, Nkv, H] bf16, tbl [B, pps]
    int32, pos [B] int32, all on the card -> [B, 1, Nq, H] bf16; scores
    scaled by ``scale`` (None: 1/sqrt(H)).  A table of more than one
    split gets fp32 scratch for the per-split outputs and softmax
    statistics.  Launches on the current stream; raises if a launch is
    refused."""
    lib = build.library("paged_attention")
    b, _, nq, hd = q.shape
    n_pages, page, nkv, _ = pool_k.shape
    pps = tbl.shape[1]
    dev = q.device
    p = plan(b, nkv, pps, sm_count(dev), hd)
    splits = p["splits"]
    out = torch.empty_like(q)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((b, splits, nq, hd), dtype=torch.float32,
                             device=dev)
        part_ml = torch.empty((b, splits, nq, 2), dtype=torch.float32,
                              device=dev)
    err = lib.repro_paged_gqa_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tbl.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (part_o, part_ml)),
        b, nkv, nq // nkv, hd, page, n_pages, pps, p["split_pages"],
        1.0 / math.sqrt(hd) if scale is None else float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_gqa_attention launch")
    return out
