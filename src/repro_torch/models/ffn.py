"""Feed-forward layers: gated dense FFN and the capacity-bounded MoE.

The MoE is the reference's single-device form (``moe_ffn_reference``):
route every token to its top-k experts, give each expert ``capacity``
rows, drop the assignments past it (in the row-major order of the (token,
k) assignments), run every expert over its rows as one batched product,
and combine the expert outputs weighted by the gates.  The expert-parallel
form across devices and the W8A8 expert weights are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, scaled_init


def init_ffn(d: int, ff: int, act: str):
    if act == "silu":
        return {
            "w_gate": scaled_init((d, ff), d),
            "w_up": scaled_init((d, ff), d),
            "w_down": scaled_init((ff, d), ff),
        }
    return {
        "w_in": scaled_init((d, ff), d),
        "w_down": scaled_init((ff, d), ff),
    }


def ffn_forward(params, x, act: str):
    fn = activation(act)
    w = {k: v.to(x.dtype) for k, v in params.items()}
    if "w_gate" in params:
        h = fn(torch.matmul(x, w["w_gate"])) * torch.matmul(x, w["w_up"])
    else:
        h = fn(torch.matmul(x, w["w_in"]))
    return torch.matmul(h, w["w_down"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(cfg):
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    p = {
        "router": scaled_init((d, m.num_experts), d),
        "wg": scaled_init((m.num_experts, d, fe), d),
        "wu": scaled_init((m.num_experts, d, fe), d),
        "wd": scaled_init((m.num_experts, fe, d), fe),
    }
    if m.num_shared_experts:
        p["shared"] = init_ffn(d, fe * m.num_shared_experts, cfg.act)
    return p


def _capacity(tokens_local: int, num_experts: int, top_k: int,
              cf: float) -> int:
    return max(4, int(math.ceil(tokens_local * top_k * cf / num_experts)))


def _route(x2d, router_w, top_k: int):
    """Router: (gates [T,k] fp32, idx [T,k] int32, probs [T,E] fp32).

    The logits are a full-fp32 product: routing is a discrete decision, so
    the port leaves ``torch.backends.cuda.matmul.allow_tf32`` at PyTorch's
    default (False) and never turns it on.  Ties in the top-k go to the
    lower expert index, as ``jax.lax.top_k`` orders them: a stable
    descending sort keeps equal probabilities in index order."""
    logits = torch.matmul(x2d.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :top_k], order[:, :top_k]
    if top_k > 1:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx.to(torch.int32), probs


def _slots(idx, e0: int, e_loc: int, capacity: int):
    """Buffer row of every (token, k) assignment: expert ``e`` owns rows
    [e * capacity, (e + 1) * capacity), filled in the row-major order of
    the assignments (a cumsum over the flattened [T*k]); non-local
    experts and assignments past the capacity go to the trash row
    ``e_loc * capacity``.  Returns (slot [T,k] int64, kept [T,k] bool)."""
    t, k = idx.shape
    idx = idx.long()
    local = (idx >= e0) & (idx < e0 + e_loc)
    le = torch.where(local, idx - e0, torch.full_like(idx, e_loc))
    flat_oh = F.one_hot(le, e_loc + 1).reshape(t * k, e_loc + 1)
    pos = torch.cumsum(flat_oh, dim=0) - flat_oh          # exclusive count
    pos_in_e = (pos * flat_oh).sum(-1).reshape(t, k)
    kept = local & (pos_in_e < capacity)
    slot = torch.where(kept, le * capacity + pos_in_e,
                       torch.full_like(le, e_loc * capacity))
    return slot, kept


def _dispatch_compute_combine(x2d, gates, idx, weights, e0: int,
                              capacity: int, act: str):
    """Local-expert scatter -> batched expert FFN -> gather-combine (the
    reference's bf16 branch).  x2d [T,d]; gates/idx [T,k]; ``weights``
    holds E_loc experts {"wg","wu","wd"}; e0 = first local expert id.
    Returns this shard's output [T,d] in x2d's dtype."""
    t, d = x2d.shape
    k = idx.shape[1]
    wg, wu, wd = weights["wg"], weights["wu"], weights["wd"]
    e_loc = wg.shape[0]
    fn = activation(act)
    slot, _ = _slots(idx, e0, e_loc, capacity)
    # each kept row receives exactly one token; only the trash row sums
    buf = torch.zeros((e_loc * capacity + 1, d), dtype=x2d.dtype,
                      device=x2d.device)
    for j in range(k):
        buf.index_add_(0, slot[:, j], x2d)
    ebuf = buf[:e_loc * capacity].reshape(e_loc, capacity, d)
    h = fn(torch.bmm(ebuf, wg.to(ebuf.dtype)))
    h = h * torch.bmm(ebuf, wu.to(ebuf.dtype))
    out = torch.bmm(h, wd.to(ebuf.dtype))
    flat = torch.cat([out.reshape(e_loc * capacity, d),
                      torch.zeros((1, d), dtype=out.dtype,
                                  device=out.device)])
    y = torch.zeros((t, d), dtype=torch.float32, device=x2d.device)
    for j in range(k):                    # fp32 sum in k order, one cast
        y = y + flat[slot[:, j]].float() * gates[:, j:j + 1]
    return y.to(x2d.dtype)


def _aux_loss(probs, idx, num_experts: int):
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    k = idx.shape[-1]
    f = F.one_hot(idx.long(), num_experts).float().sum(-2).mean(0) / k
    p = probs.mean(0)
    return num_experts * torch.sum(f * p)


def moe_ffn_reference(params, x, cfg,
                      tokens_for_capacity: Optional[int] = None):
    """Single-device MoE with the reference's dropping semantics.
    x [B,S,D] -> (y [B,S,D], aux_loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    cap = _capacity(tokens_for_capacity or b * s, m.num_experts, m.top_k,
                    m.capacity_factor)
    gates, idx, probs = _route(x2d, params["router"], m.top_k)
    y = _dispatch_compute_combine(x2d, gates, idx, params, 0, cap, cfg.act)
    if "shared" in params:
        y = y + ffn_forward(params["shared"], x2d, cfg.act)
    aux = _aux_loss(probs, idx, m.num_experts)
    return y.reshape(b, s, d), aux


def moe_ffn(params, x, cfg):
    """The MoE layer on one device, as the reference runs it without a
    mesh (``ShardCtx(None)``, what serving builds): the reference oracle.
    x [B,S,D] -> (y [B,S,D], aux_loss scalar)."""
    return moe_ffn_reference(params, x, cfg)
