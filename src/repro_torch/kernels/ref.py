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


def exit_head_entropy_ref(x, w):
    """x [T, D], w [D, V] -> entropy [T] fp32."""
    logits = torch.matmul(x.float(), w.float())
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def paged_gqa_attention_ref(q, pool_k, pool_v, tbl, pos):
    """Gather-view version of the paged GQA decode kernel: q [B, 1, Nq, H],
    pools [n_pages, P, Nkv, H], tbl [B, pps] (sentinel entries clipped and
    always masked by ``pos``), pos [B] -> [B, 1, Nq, H] in q's dtype."""
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
    s = torch.einsum("bsngh,btnh->bngst", qg.float(), ck.float()) \
        / math.sqrt(hd)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", p, cv.float())
    return out.reshape(b, 1, nq, hd).to(q.dtype)
