"""Attention: GQA and MLA (DeepSeek-V3), full-sequence (``gqa_forward``,
``mla_forward``; GQA also unmasked and as cross-attention) and one-token
decode over contiguous per-slot caches and the paged KV arena, plus
whisper's cross-attention decode step (``cross_decode``).

Conventions as in the reference: x [B, S, D]; q/k/v [B, S, N, H];
contiguous caches [B, S_max, Nkv, H]; paged pools [n_pages, P, Nkv, H].
MLA latent caches: c_kv [B, S_max, R], k_rope [B, S_max, Hr]; paged
latent pools [n_pages, P, R] / [n_pages, P, Hr].

Caches are updated IN PLACE (the reference donates them to XLA and gets
new arrays back); every decode function still returns the caches it was
given, so call sites read like the reference's.

``REPRO_ATTN`` (read at import, as the reference reads it): ``dense``
(the default) or ``chunked``; any other value raises ``ValueError``.
Under ``chunked`` the full-sequence self-attention of ``gqa_forward`` on
the CPU follows ``_sdpa_chunked``, a copy of the reference's q-chunk /
kv-chunk online softmax, where the reference takes it: no ``kv_x``,
Sq * Skv above 2048^2, both lengths multiples of 1024.  On the card both
settings launch the flash-attention kernel, which is that same online
softmax written by hand (bf16 tiles in shared memory, fp32 running max
and sum in registers), so the toggle changes nothing there.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import init_norm, rmsnorm, scaled_init
from repro_torch.models.rope import apply_positional, apply_rope

NEG_INF = -1e30


def _env_impl(var: str, default: str, legal: tuple) -> str:
    """An implementation toggle from the environment, checked at import:
    a typo (REPRO_ATTN=kernal) raises instead of falling through to the
    default."""
    val = os.environ.get(var, default)
    if val not in legal:
        raise ValueError(
            f"{var}={val!r} is not a known implementation; legal values: "
            + ", ".join(repr(v) for v in legal))
    return val


ATTN_IMPL = _env_impl("REPRO_ATTN", "dense", ("dense", "chunked"))
CHUNKED_THRESHOLD = 2048   # chunked when Sq * Skv exceeds its square


def init_gqa(cfg, d_in: int = 0):
    """q/k/v from inputs of width ``d_in`` (0: d_model), o back to
    d_model."""
    d, nq, nkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    di = d_in or d
    return {
        "wq": scaled_init((di, nq, hd), di),
        "wk": scaled_init((di, nkv, hd), di),
        "wv": scaled_init((di, nkv, hd), di),
        "wo": scaled_init((nq, hd, d), nq * hd),
    }


def _scores(cfg, s):
    """Raw scores times the attention scale: ``cfg.attn_scale`` where set,
    else divided by sqrt(head_dim) as the reference divides."""
    if cfg.attn_scale:
        return s * cfg.attn_scale
    return s / math.sqrt(cfg.resolved_head_dim)


def init_mla(cfg):
    d, nq = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rph, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": scaled_init((d, qr), d),
        "q_norm": init_norm("rmsnorm", qr),
        "wq_b": scaled_init((qr, nq, nope + rph), qr),
        "wkv_a": scaled_init((d, kvr + rph), d),
        "kv_norm": init_norm("rmsnorm", kvr),
        "wk_b": scaled_init((kvr, nq, nope), kvr),
        "wv_b": scaled_init((kvr, nq, vh), kvr),
        "wo": scaled_init((nq, vh, d), nq * vh),
    }


def init_attention(cfg):
    return init_mla(cfg) if cfg.attention == "mla" else init_gqa(cfg)


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


def make_mask(q_len: int, kv_len: int, *, causal: bool, window: int = 0,
              device="cpu"):
    """Boolean [q_len, kv_len] attention mask (the reference's
    ``make_mask``): key j is visible to query i unless j > i (causal) or
    j <= i - window (window > 0)."""
    qi = torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return mask


def _sdpa_chunked(q, k, v, *, causal: bool, window: int, scale: float,
                  q_chunk: int = 1024, kv_chunk: int = 1024):
    """The reference's ``_sdpa_chunked``: q chunks in a Python loop, each
    seeing only its causal (and windowed) kv range, kv chunks folded in
    with an online softmax.  Block inputs are bf16 and their products
    summed in fp32 (the reference's ``preferred_element_type``); P is
    rounded to bf16 before P V; the running max, sum and output are fp32.
    q [B, Sq, Nq, H], k/v [B, Skv, Nkv, H] -> [B, Sq, Nq, H] in q's
    dtype."""
    b, sq, nq, h = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % qc or skv % kc:
        raise ValueError(f"_sdpa_chunked: lengths {sq} / {skv} are not "
                         f"whole chunks of {qc} / {kc}")
    kf = k.to(torch.bfloat16).float()
    vf = v.to(torch.bfloat16).float()
    outs = []
    for q0 in range(0, sq, qc):
        qg = q[:, q0:q0 + qc].reshape(b, qc, nkv, g, h).to(
            torch.bfloat16).float()
        hi = min(skv, q0 + qc) if causal else skv
        lo = max(0, q0 - window - kc + 1) if window else 0
        lo = (lo // kc) * kc
        hi = ((hi + kc - 1) // kc) * kc
        q_pos = q0 + torch.arange(qc, device=q.device)
        m_run = torch.full((b, nkv, g, qc), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, nkv, g, qc), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, nkv, g, qc, h), dtype=torch.float32,
                          device=q.device)
        for k0 in range(lo, hi, kc):
            s = torch.einsum("bsngh,btnh->bngst", qg,
                             kf[:, k0:k0 + kc]) * scale
            k_pos = k0 + torch.arange(kc, device=q.device)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bngst,btnh->bngsh", p.to(torch.bfloat16).float(),
                vf[:, k0:k0 + kc])
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, qc, nq, h))
    return torch.cat(outs, dim=1).to(q.dtype)


def _takes_chunked(q, k) -> bool:
    """The reference's condition for ``_sdpa_chunked`` (self-attention
    only), on the CPU; the card always runs the flash kernel."""
    sq, skv = q.shape[1], k.shape[1]
    return (ATTN_IMPL == "chunked" and q.device.type == "cpu"
            and sq * skv > CHUNKED_THRESHOLD ** 2
            and sq % 1024 == 0 and skv % 1024 == 0)


def gqa_forward(cfg, params, x, positions, *, causal: bool = True,
                window: int = 0, kv_x=None, rope_on: bool = True):
    """Full-sequence attention.  x [B, S, D], positions [B, S] (or
    [3, B, S] under M-RoPE) -> (y [B, S, D], (k, v)).  ``kv_x`` [B, Skv,
    D] makes it cross-attention: k and v are projected from ``kv_x``, with
    no rotation and no mask.  The attention itself is
    ``kernels.ops.flash_attention``: the hand-written kernel on the card,
    the reference's ``_sdpa`` + ``make_mask`` (its plain version) on the
    CPU, or there ``_sdpa_chunked`` under ``REPRO_ATTN=chunked``."""
    q = _proj(x, params["wq"])
    src = x if kv_x is None else kv_x
    k = _proj(src, params["wk"])
    v = _proj(src, params["wv"])
    if kv_x is None:
        if rope_on:
            q = apply_positional(q, positions, cfg.rope, cfg.rope_theta)
            k = apply_positional(k, positions, cfg.rope, cfg.rope_theta)
        if cfg.attn_scale:
            # the flash kernels fix 1/sqrt(H): the rest of the scale goes
            # into q (one more bf16 rounding of q)
            q = q * (cfg.attn_scale * math.sqrt(cfg.resolved_head_dim))
        if _takes_chunked(q, k):
            out = _sdpa_chunked(q, k, v, causal=causal, window=window,
                                scale=1.0 / math.sqrt(cfg.resolved_head_dim))
        else:
            out = kops.flash_attention(q, k, v, causal=causal,
                                       window=window)
    else:
        out = kops.flash_attention(q, k, v, causal=False)
    return _out_proj(out, params["wo"]), (k, v)


def _decode_positions(position, batch: int, device):
    """A decode position ([] scalar or [B] per-slot vector) as int32 [B]."""
    pos = torch.as_tensor(position, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(batch).contiguous()


def _rows(mask, val):
    """A [B] row mask shaped to broadcast over ``val`` [B, ...] of any
    trailing rank (GQA rows [B, Nkv, H], MLA latent rows [B, R])."""
    return mask.reshape(-1, *([1] * (val.ndim - 1)))


def _masked_row_write(cache, bidx, slot, val, write_mask):
    """cache[b, slot[b]] = val[b] for rows with write_mask (all if None);
    each row writes only its own cache row, so rows never collide."""
    val = val.to(cache.dtype)
    if write_mask is not None:
        val = torch.where(_rows(write_mask, val), val, cache[bidx, slot])
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
    scores = _scores(cfg, torch.einsum("bsngh,btnh->bngst", qg.float(),
                                       cache_k.float()))
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, cache_v.float())
    out = out.reshape(b, 1, nq, hd).to(x.dtype)
    return _out_proj(out, params["wo"]), (cache_k, cache_v)


def cross_decode(cfg, params, x, enc_k, enc_v):
    """Whisper's cross-attention at one token: x [B, 1, D] against the
    encoder's k/v [B, Tenc, Nkv, H], no mask.  Plain fp32 products and
    softmax, as the reference's ``_sdpa`` (its cross decode reaches no
    kernel either)."""
    hd = cfg.resolved_head_dim
    q = _proj(x, params["wq"])
    b, sq, nq, _ = q.shape
    nkv = enc_k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          enc_k.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, enc_v.float())
    out = out.reshape(b, sq, nq, hd).to(x.dtype)
    return _out_proj(out, params["wo"])


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
    val = torch.where(_rows(keep, val), val,
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
    out = kops.paged_gqa_attention(q, pool_k, pool_v, paged.tbl, pos_b,
                                   scale=cfg.attn_scale or None)
    return _out_proj(out, params["wo"]), (pool_k, pool_v)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): latent-compressed attention with matrix absorption
# ---------------------------------------------------------------------------

def _mla_qkv(cfg, params, x, positions):
    """x [B, S, D], positions [B, S] -> q_nope [B,S,N,nope], q_rope
    [B,S,N,Hr] (rotated), c_kv [B,S,R] (normed), k_rope [B,S,Hr]."""
    nope, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = torch.matmul(x, params["wq_a"].to(x.dtype))
    cq = rmsnorm(cq, params["q_norm"]["scale"])
    q = _proj(cq, params["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = torch.matmul(x, params["wkv_a"].to(x.dtype))
    c_kv = rmsnorm(ckv[..., :kvr], params["kv_norm"]["scale"])
    k_rope = apply_rope(ckv[..., None, kvr:], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _absorb_k(q_nope, wk_b):
    """q_lat = einsum("bsnh,rnh->bsnr"): W_kb folded into the query, in
    the query's dtype, so scores read the latent cache directly."""
    return torch.einsum("bsnh,rnh->bsnr", q_nope, wk_b.to(q_nope.dtype))


def _latent_out(ctx_lat, wv_b, dtype):
    """einsum("bsnr,rnv->bsnv") of the latent context, cast to ``dtype``
    first as the reference does."""
    return torch.einsum("bsnr,rnv->bsnv", ctx_lat.to(dtype), wv_b.to(dtype))


def mla_scores_ctx(cfg, params, q_nope, q_rope, c_kv, k_rope, mask):
    """Absorbed-matrix attention: scores and context from the latent
    cache.  mask [B|1, Sq, Skv] bool.  Returns [B, Sq, N, V]."""
    q_lat = _absorb_k(q_nope, params["wk_b"])
    scores = torch.einsum("bsnr,btr->bnst", q_lat.float(), c_kv.float())
    scores = scores + torch.einsum("bsnh,bth->bnst", q_rope.float(),
                                   k_rope.float())
    m = mask if mask.ndim == 3 else mask[None]
    scores = (scores * _mla_scale(cfg)).masked_fill(~m[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bnst,btr->bsnr", probs, c_kv.float())
    return _latent_out(ctx_lat, params["wv_b"], q_nope.dtype)


def mla_forward(cfg, params, x, positions, *, window: int = 0):
    """Full-sequence causal MLA attention over the latent projections: x
    [B, S, D], positions [B, S] -> (y [B, S, D], (c_kv, k_rope)).  As in
    the reference it reaches no kernel."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, params, x, positions)
    mask = make_mask(x.shape[1], x.shape[1], causal=True, window=window,
                     device=x.device)
    out = mla_scores_ctx(cfg, params, q_nope, q_rope, c_kv, k_rope, mask)
    return _out_proj(out, params["wo"]), (c_kv, k_rope)


def mla_decode(cfg, params, x, cache_ckv, cache_krope, position, *,
               window: int = 0, write_mask=None):
    """One-token MLA decode against the latent cache [B, Smax, R] /
    [B, Smax, Hr] (written in place; a ring buffer if ``window``)."""
    b = x.shape[0]
    smax = cache_ckv.shape[1]
    pos_b = _decode_positions(position, b, x.device).long()
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, params, x, pos_b[:, None])
    slot = (pos_b % smax) if window else torch.clamp(pos_b, max=smax - 1)
    bidx = torch.arange(b, device=x.device)
    _masked_row_write(cache_ckv, bidx, slot, c_kv[:, 0], write_mask)
    _masked_row_write(cache_krope, bidx, slot, k_rope[:, 0], write_mask)
    idx = torch.arange(smax, device=x.device)
    if window:
        age = (slot[:, None] - idx[None, :]) % smax
        valid = age < torch.clamp(pos_b + 1, max=smax)[:, None]
    else:
        valid = idx[None, :] <= pos_b[:, None]             # [B, Smax]
    out = mla_scores_ctx(cfg, params, q_nope, q_rope, cache_ckv, cache_krope,
                         valid[:, None, :])
    return _out_proj(out, params["wo"]), (cache_ckv, cache_krope)


def mla_decode_paged(cfg, params, x, pool_ckv, pool_krope, position,
                     paged: PagedKV):
    """One-token MLA decode against paged latent pools [n_pages, P, R] /
    [n_pages, P, Hr] (written in place).  W_kb is absorbed into the query
    outside the kernel, so ``kernels.ops.paged_mla_attention`` scores
    latent-rank queries only and returns the fp32 latent context; W_vb and
    W_o apply after it."""
    b = x.shape[0]
    pos_b = _decode_positions(position, b, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, params, x,
                                            pos_b.long()[:, None])
    paged_write(pool_ckv, paged, pos_b, c_kv[:, 0])
    paged_write(pool_krope, paged, pos_b, k_rope[:, 0])
    q_lat = _absorb_k(q_nope, params["wk_b"]).contiguous()
    ctx_lat = kops.paged_mla_attention(q_lat, q_rope.contiguous(), pool_ckv,
                                       pool_krope, paged.tbl, pos_b,
                                       scale=_mla_scale(cfg))
    out = _latent_out(ctx_lat, params["wv_b"], q_nope.dtype)
    return _out_proj(out, params["wo"]), (pool_ckv, pool_krope)
