"""GQA decode attention: contiguous per-slot caches and the paged KV arena.

Conventions as in the reference: x [B, S, D]; q/k/v [B, S, N, H];
contiguous caches [B, S_max, Nkv, H]; paged pools [n_pages, P, Nkv, H].

Caches are updated IN PLACE (the reference donates them to XLA and gets
new arrays back); every decode function still returns the caches it was
given, so call sites read like the reference's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import scaled_init
from repro_torch.models.rope import apply_positional

NEG_INF = -1e30


def init_gqa(gen, cfg, device="cpu"):
    d, nq, nkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    return {
        "wq": scaled_init(gen, (d, nq, hd), d, device=device),
        "wk": scaled_init(gen, (d, nkv, hd), d, device=device),
        "wv": scaled_init(gen, (d, nkv, hd), d, device=device),
        "wo": scaled_init(gen, (nq, hd, d), nq * hd, device=device),
    }


def _proj(x, w):
    """einsum("bsd,dnh->bsnh") as one matmul."""
    d, n, h = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, n * h)).reshape(
        *x.shape[:-1], n, h)


def _out_proj(out, wo):
    """einsum("bsnh,nhd->bsd") as one matmul."""
    n, h, d = wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], n * h),
                        wo.to(out.dtype).reshape(n * h, d))


def _qkv(cfg, params, x, pos_b):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    q = apply_positional(q, pos_b[:, None], cfg.rope, cfg.rope_theta)
    k = apply_positional(k, pos_b[:, None], cfg.rope, cfg.rope_theta)
    return q, k, v


def _decode_positions(position, batch: int, device):
    """A decode position ([] scalar or [B] per-slot vector) as int32 [B]."""
    pos = torch.as_tensor(position, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(batch).contiguous()


def _masked_row_write(cache, bidx, slot, val, write_mask):
    """cache[b, slot[b]] = val[b] for rows with write_mask (all if None);
    each row writes only its own cache row, so rows never collide."""
    val = val.to(cache.dtype)
    if write_mask is not None:
        val = torch.where(write_mask[:, None, None], val, cache[bidx, slot])
    cache[bidx, slot] = val


def gqa_decode(cfg, params, x, cache_k, cache_v, position, *, window: int = 0,
               write_mask=None):
    """One-token decode.  x [B,1,D]; caches [B,Smax,Nkv,H] (written in
    place); position [] or [B].  ``write_mask`` [B] bool gates which rows
    store their new K/V (None = every row, as the reference step does).

    window>0: the cache is a ring buffer of size window; slot = position %
    window and validity follows each slot's most recent occupant.
    """
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    smax = cache_k.shape[1]
    pos_b = _decode_positions(position, b, x.device).long()
    q, k, v = _qkv(cfg, params, x, pos_b)
    slot = (pos_b % smax) if window else torch.clamp(pos_b, max=smax - 1)
    bidx = torch.arange(b, device=x.device)
    _masked_row_write(cache_k, bidx, slot, k[:, 0], write_mask)
    _masked_row_write(cache_v, bidx, slot, v[:, 0], write_mask)
    idx = torch.arange(smax, device=x.device)
    if window:
        age = (slot[:, None] - idx[None, :]) % smax
        valid = age < torch.clamp(pos_b + 1, max=smax)[:, None]
    else:
        valid = idx[None, :] <= pos_b[:, None]             # [B, Smax]
    nq, nkv = q.shape[2], cache_k.shape[2]
    qg = q.reshape(b, 1, nkv, nq // nkv, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          cache_k.float()) / math.sqrt(hd)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, cache_v.float())
    out = out.reshape(b, 1, nq, hd).to(x.dtype)
    return _out_proj(out, params["wo"]), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# Paged decode — KV pools [n_pages, P, ...] + per-slot block tables
# ---------------------------------------------------------------------------
#
# Each slot maps logical cache positions to physical pages through a block
# table row ``tbl [B, pages_per_slot]`` whose sentinel value is ``n_pages``
# (= unallocated).  Attention goes through ``kernels.ops.paged_gqa_attention``:
# the hand-written CUDA kernel for tensors on the card, its gather-view plain
# version on the CPU.


class PagedKV:
    """Block table + write gate for one paged decode step.

    ``tbl``: [B, pages_per_slot] int32 (sentinel = n_pages).
    ``write_mask``: [B] bool — rows allowed to write their KV this step.
    Masked rows, and rows whose page is unallocated, write nothing.
    """

    def __init__(self, tbl, write_mask):
        self.tbl = tbl
        self.write_mask = write_mask


def paged_view(pool, tbl):
    """Gather a slot-contiguous [B, pps*P, ...] view out of the pool.
    Sentinel entries are clipped to a real page — callers mask those
    positions (sentinels only cover positions > pos_b)."""
    n_pages = pool.shape[0]
    gathered = pool[tbl.long().clamp(0, n_pages - 1)]      # [B, pps, P, ...]
    b, pps, psz = gathered.shape[:3]
    return gathered.reshape(b, pps * psz, *gathered.shape[3:])


def paged_write(pool, paged: PagedKV, pos_b, val):
    """Scatter one token per row into its block-table page, in place.

    The reference drops masked rows with ``.at[...].set(mode="drop")``.
    Torch has no drop mode, and selecting the kept rows with a device mask
    would stall the host on every layer.  So the rows that must not write
    are filtered out by pointing them at the first kept row's (index,
    value): every write to that index then carries the same bytes, and the
    duplicate is harmless.  When no row may write, each row writes back the
    value it reads.  Stale slots therefore never corrupt live pages.
    """
    n_pages, psz = pool.shape[0], pool.shape[1]
    smax = paged.tbl.shape[1] * psz
    slot = torch.clamp(pos_b.long(), max=smax - 1)
    page = torch.gather(paged.tbl.long(), 1, (slot // psz)[:, None])[:, 0]
    keep = paged.write_mask & (page >= 0) & (page < n_pages)
    flat = pool.view(n_pages * psz, *pool.shape[2:])
    idx = page.clamp(0, n_pages - 1) * psz + slot % psz
    val = val.to(pool.dtype)
    first = torch.argmax(keep.to(torch.int32)).reshape(1)   # [1]: no sync
    any_keep = keep.any()
    idx = torch.where(keep, idx, torch.where(any_keep, idx[first], idx))
    val = torch.where(keep[:, None, None], val,
                      torch.where(any_keep, val[first], flat[idx]))
    flat.index_copy_(0, idx, val)
    return pool


def gqa_decode_paged(cfg, params, x, pool_k, pool_v, position,
                     paged: PagedKV):
    """One-token GQA decode against paged KV pools [n_pages, P, Nkv, H]
    (written in place).  No ring-buffer window (the scheduler refuses
    windowed models in paged mode)."""
    b = x.shape[0]
    pos_b = _decode_positions(position, b, x.device)
    q, k, v = _qkv(cfg, params, x, pos_b.long())
    paged_write(pool_k, paged, pos_b, k[:, 0])
    paged_write(pool_v, paged, pos_b, v[:, 0])
    out = kops.paged_gqa_attention(q, pool_k, pool_v, paged.tbl, pos_b)
    return _out_proj(out, params["wo"]), (pool_k, pool_v)
