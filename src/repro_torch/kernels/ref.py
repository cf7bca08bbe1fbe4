"""Plain PyTorch versions of the port's kernels.

The wrappers in ``kernels/ops.py`` run these for tensors on the CPU; on
the card they serve only as the yardstick each kernel is held against.

Entropy identity used by the exit head: with logZ = m + log s,
  H = -sum_i p_i log p_i = m + log(s) - t/s
where s = sum exp(l - m) and t = sum l * exp(l - m).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
# 1/127 rounded once to fp32: the reference kernel's `amax / 127.0` runs as
# a multiplication by this reciprocal under XLA (see feature_compress.cu)
INV127 = float(torch.tensor(1.0) / torch.tensor(127.0))


def exit_head_entropy_ref(x, w):
    """x [T, D], w [D, V] -> entropy [T] fp32."""
    logits = torch.matmul(x.float(), w.float())
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def _attention_mask(sq, skv, causal, window, device):
    """The reference's ``make_mask``: [Sq, Skv] bool, True = visible."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return mask


def _attention_scores(q, k, causal, window):
    """fp32 masked, scaled scores [B, Nkv, G, Sq, Skv] (NEG_INF where a
    key is masked)."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, hd)
    s = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    return s.masked_fill(~_attention_mask(sq, skv, causal, window, q.device),
                         NEG_INF)


def _attention_probs(q, k, causal, window):
    """fp32 softmax probabilities [B, Nkv, G, Sq, Skv] of the masked,
    scaled scores."""
    return torch.softmax(_attention_scores(q, k, causal, window), dim=-1)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Full-sequence attention, what the reference's ``_sdpa`` computes
    under ``make_mask``: q [B, Sq, Nq, H], k/v [B, Skv, Nkv, H], query
    head n*G + g reads kv head n; key j is masked for query i where j > i
    (causal) or j <= i - window (window > 0); fp32 scores scaled by
    1/sqrt(H), NEG_INF where a key is masked -> [B, Sq, Nq, H] in q's
    dtype."""
    b, sq, nq, hd = q.shape
    p = _attention_probs(q, k, causal, window)
    out = torch.einsum("bngst,btnh->bsngh", p, v.float())
    return out.reshape(b, sq, nq, hd).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True, window: int = 0):
    """Each row's log-sum-exp, natural log, of the masked, scaled fp32
    scores of ``flash_attention_ref``: q [B, Sq, Nq, H], k [B, Skv, Nkv, H]
    -> fp32 [B, Nq, Sq], what the forward kernel writes for the
    backward."""
    b, sq, nq, _ = q.shape
    s = _attention_scores(q, k, causal, window)
    return torch.logsumexp(s, dim=-1).reshape(b, nq, sq)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                            window: int = 0):
    """Gradients of ``flash_attention_ref`` from the textbook formulas, in
    fp32, with P from the forward's log-sum-exp as the kernel takes it:
    P = exp(masked Q K^T / sqrt(H) - L), dV = P^T dO, dP = dO V^T,
    D = rowsum(dO o O), dS = P o (dP - D), dQ = dS K / sqrt(H),
    dK = dS^T Q / sqrt(H); dK and dV sum over each kv head's G query heads.
    q, o, do [B, Sq, Nq, H], k/v [B, Skv, Nkv, H], ``lse`` fp32
    [B, Nq, Sq] (``flash_attention_lse_ref``) -> (dq, dk, dv) in the
    inputs' dtypes.  ``o`` is the forward's output as it was returned; D
    is taken from it."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = 1.0 / math.sqrt(hd)
    lg = lse.float().reshape(b, nkv, g, sq, 1)
    p = torch.exp(_attention_scores(q, k, causal, window) - lg)  # [B,n,g,s,t]
    dog = do.reshape(b, sq, nkv, g, hd).float()
    og = o.reshape(b, sq, nkv, g, hd).float()
    qg = q.reshape(b, sq, nkv, g, hd).float()
    dv = torch.einsum("bngst,bsngh->btnh", p, dog)
    dp = torch.einsum("bsngh,btnh->bngst", dog, v.float())
    dd = (dog * og).sum(-1).permute(0, 2, 3, 1)             # [B,n,g,s]
    ds = p * (dp - dd[..., None])
    dq = torch.einsum("bngst,btnh->bsngh", ds, k.float()) * scale
    dk = torch.einsum("bngst,bsngh->btnh", ds, qg) * scale
    return (dq.reshape(b, sq, nq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def paged_gqa_attention_ref(q, pool_k, pool_v, tbl, pos, scale=None):
    """Gather-view version of the paged GQA decode kernel: q [B, 1, Nq, H],
    pools [n_pages, P, Nkv, H], tbl [B, pps] (sentinel entries clipped and
    always masked by ``pos``), pos [B] -> [B, 1, Nq, H] in q's dtype.
    Scores are scaled by ``scale`` (None: divided by sqrt(H))."""
    b, _, nq, hd = q.shape
    n_pages, page, nkv, _ = pool_k.shape
    smax = tbl.shape[1] * page
    tblc = tbl.long().clamp(0, n_pages - 1)
    ck = pool_k[tblc].reshape(b, smax, nkv, hd)
    cv = pool_v[tblc].reshape(b, smax, nkv, hd)
    valid = (torch.arange(smax, device=q.device)[None, :]
             <= pos.long()[:, None])
    g = nq // nkv
    qg = q.reshape(b, 1, nkv, g, hd)
    s = torch.einsum("bsngh,btnh->bngst", qg.float(), ck.float())
    s = s / math.sqrt(hd) if scale is None else s * scale
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", p, cv.float())
    return out.reshape(b, 1, nq, hd).to(q.dtype)


def paged_mla_attention_ref(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos,
                            *, scale):
    """Gather-view version of the paged MLA decode kernel: q_lat
    [B, 1, N, R] (W_kb absorbed), q_rope [B, 1, N, Hr], pools
    [n_pages, P, R] / [n_pages, P, Hr], tbl [B, pps] (sentinel entries
    clipped and always masked by ``pos``), pos [B] -> latent context
    [B, 1, N, R] fp32."""
    b, _, n, r = q_lat.shape
    n_pages, page = pool_ckv.shape[0], pool_ckv.shape[1]
    smax = tbl.shape[1] * page
    tblc = tbl.long().clamp(0, n_pages - 1)
    ckv = pool_ckv[tblc].reshape(b, smax, r).float()
    krope = pool_krope[tblc].reshape(b, smax, -1).float()
    s = torch.einsum("bsnr,btr->bnst", q_lat.float(), ckv)
    s = s + torch.einsum("bsnh,bth->bnst", q_rope.float(), krope)
    valid = (torch.arange(smax, device=q_lat.device)[None, :]
             <= pos.long()[:, None])
    s = (s * scale).masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnst,btr->bsnr", p, ckv)


def quantize_rows_ref(x):
    """x [..., D] fp32/bf16 -> (q int8 [..., D], scale fp32 [..., 1]):
    scale = max(amax * fl(1/127), 1e-8), q = clip(round_half_even(x /
    scale), +-127).  ``torch.round`` rounds half to even, like jnp.round."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax * INV127, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_rows_ref(q, scale, dtype=torch.bfloat16):
    """(q int8 [..., D], scale fp32 [..., 1]) -> x [..., D] ``dtype``."""
    return (q.float() * scale).to(dtype)


def w8a8_expert_matmul_ref(aq, a_scale, wq, w_scale):
    """aq [E, C, K] int8, a_scale [E, C, 1] fp32, wq [E, K, N] int8,
    w_scale [E, 1, N] fp32 -> fp32 [E, C, N] = float(s32 sum) * a_scale *
    w_scale, left to right.  The int32 sum is exact: an int32 ``bmm`` on
    the CPU; on the card, which has no integer ``bmm``, one fp64 product
    an expert (exact, since every partial sum is an integer of magnitude
    at most K * 127^2 < 2^53; one expert at a time keeps the fp64 copy of
    wq to one [K, N] matrix), cast back to int32.  On "meta" the shapes of
    the CPU's one ``bmm``."""
    if aq.device.type in ("cpu", "meta"):
        acc = torch.bmm(aq.int(), wq.int())
    else:
        e, c, _ = aq.shape
        acc = torch.empty((e, c, wq.shape[2]), dtype=torch.int32,
                          device=aq.device)
        for i in range(e):
            acc[i] = torch.mm(aq[i].double(), wq[i].double()).to(torch.int32)
    return acc.float() * a_scale * w_scale
