"""Paged MLA decode attention kernel: launch of ``csrc/paged_mla.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``_paged_mla_kernel``).  One block per (64 heads, sequence, split of the
page table): a producer thread feeds a ring of two-page stages through
TMA, and two consumer warpgroups, each owning half of the latent rank, run
the score and context products on ``wgmma`` (P as bf16 high and low
parts).  Both pools are read in place, with no concatenation or padding;
the page loop is bounded by ``pos``.  ``plan`` splits the table from
shapes only, never from ``pos``; with more than one split a second launch
merges the splits.  The design notes are in the CUDA source; the plain
version is ``kernels.ref.paged_mla_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEADS_PER_BLOCK = 64     # BH in csrc/paged_mla.cu: the M of both products
PAGES_PER_STAGE = 2      # PAGES there: split_pages is a multiple of it
# A split writes a 64 x R fp32 context per block, 128 KB at R 512, and the
# combine reads it back: about 7 pages' worth of pool bytes a block (both
# head tiles read each 18 KB page), so a split takes at least this many.
MIN_SPLIT_PAGES = 16

_SM_COUNT = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of the card (cached per device)."""
    idx = torch.device(device).index or 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def plan(b: int, n: int, pps: int, sms: int) -> dict:
    """Split plan of one call from shapes only: enough splits that the
    grid fills one wave of ``sms`` blocks (one block an SM), each split at
    least ``MIN_SPLIT_PAGES`` pages and a whole number of stages.  Split z
    scores pages [z * split_pages, (z + 1) * split_pages)."""
    tiles = -(-n // HEADS_PER_BLOCK)
    want = -(-sms // (b * tiles))
    splits = max(1, min(want, pps // MIN_SPLIT_PAGES))
    split_pages = -(-pps // splits)
    split_pages += -split_pages % PAGES_PER_STAGE
    splits = -(-pps // split_pages)
    return {"tiles": tiles, "splits": splits, "split_pages": split_pages,
            "grid": (tiles, b, splits), "launches": 1 if splits == 1 else 2}


def supported(n_heads: int, rank: int, rope_dim: int, page: int) -> bool:
    """Whether the kernel is instantiated for these shapes."""
    lib = build.library("paged_mla")
    return bool(lib.repro_paged_mla_supported(n_heads, rank, rope_dim, page))


def attention_cuda(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos, scale):
    """q_lat [B, 1, N, R] and q_rope [B, 1, N, Hr] bf16, pools
    [n_pages, P, R] / [n_pages, P, Hr] bf16, tbl [B, pps] int32, pos [B]
    int32, all on the card -> latent context [B, 1, N, R] fp32.  A table of
    more than one split gets fp32 scratch for the per-split contexts and
    softmax statistics.  Launches on the current stream; raises if a
    launch is refused."""
    lib = build.library("paged_mla")
    b, _, n, r = q_lat.shape
    n_pages, page = pool_ckv.shape[0], pool_ckv.shape[1]
    pps = tbl.shape[1]
    dev = q_lat.device
    p = plan(b, n, pps, sm_count(dev))
    splits = p["splits"]
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
        pool_krope.shape[2], page, n_pages, pps, p["split_pages"],
        float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_mla_attention launch")
    return out
