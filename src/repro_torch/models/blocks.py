"""Execution plan + the dense decode layer.

Every architecture compiles to a PLAN, an ordered list of steps

    ("scan",  kind, n_units, layer0)   — n_units stacked layers of one kind
    ("shared_attn", site_idx)          — zamba2 weight-shared attention block
    ("exit", exit_idx, layer)          — early-exit head / partition boundary

exactly as in the reference.  Stacked blocks keep their leading layer axis
([n_units, ...]); the full-sequence forward (``run_scan_block``) and
decode (``decode_scan_block``) walk it in a Python loop.  The ``dense``
and ``moe`` kinds are ported, with GQA or MLA attention; ``pair``
(llama4's grouped dense/MoE unit) and the state kinds are not yet.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (apply_norm, init_norm, materialize,
                                       scaled_init, tree_leaves, tree_map)


# ---------------------------------------------------------------------------
# Plan construction (a copy of the reference's)
# ---------------------------------------------------------------------------

def layer_kind(cfg, i: int) -> str:
    if cfg.family in ("dense", "vlm"):
        return "dense"
    if cfg.family == "moe":
        m = cfg.moe
        if i < m.first_dense_layers:
            return "dense"
        if m.layer_period > 1:
            return "pair"
        return "moe"
    if cfg.family == "hybrid":
        return "mamba"
    if cfg.family == "ssm":
        return "slstm" if i in cfg.ssm.slstm_layers else "mlstm"
    if cfg.family == "encdec":
        return "decx"
    raise ValueError(cfg.family)


def shared_attn_sites(cfg) -> Tuple[int, ...]:
    if not cfg.shared_attn_period:
        return ()
    p = cfg.shared_attn_period
    return tuple(i for i in range(cfg.num_layers) if i % p == p - 1)


def build_plan(cfg) -> List[Tuple]:
    """Returns the ordered plan (see module docstring)."""
    L = cfg.num_layers
    exits = set(cfg.exits.exit_layers)
    sa = set(i + 1 for i in shared_attn_sites(cfg))
    bounds = {0, L} | exits | sa
    for i in range(1, L):
        if layer_kind(cfg, i) != layer_kind(cfg, i - 1):
            bounds.add(i)
    if cfg.family == "moe" and cfg.moe.layer_period > 1:
        period = cfg.moe.layer_period
        bounds = {b for b in bounds
                  if b <= cfg.moe.first_dense_layers
                  or (b - cfg.moe.first_dense_layers) % period == 0
                  or b == L}
    bl = sorted(bounds)
    plan: List[Tuple] = []
    exit_idx = 0
    sa_idx = 0
    for a, b in zip(bl[:-1], bl[1:]):
        kind = layer_kind(cfg, a)
        n = b - a
        if kind == "pair":
            n = n // cfg.moe.layer_period
        plan.append(("scan", kind, n, a))
        if b in sa:
            plan.append(("shared_attn", sa_idx))
            sa_idx += 1
        if b in exits:
            plan.append(("exit", exit_idx, b))
            exit_idx += 1
    return plan


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

PORTED_KINDS = frozenset({"dense", "moe"})


def _require_ported(kind: str):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"repro_torch: layer kind {kind!r} is not ported yet")


def _init_dense_layer(cfg):
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model),
        "attn": attn.init_attention(cfg),
        "ln2": init_norm(cfg.norm, cfg.d_model),
        "ffn": ffn_mod.init_ffn(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _init_moe_layer(cfg):
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model),
        "attn": attn.init_attention(cfg),
        "ln2": init_norm(cfg.norm, cfg.d_model),
        "moe": ffn_mod.init_moe(cfg),
    }


_INIT = {"dense": _init_dense_layer, "moe": _init_moe_layer}


def init_scan_block(gen, cfg, kind: str, n_units: int, device="cpu"):
    """Stacked params [n_units, ...] for a block of one kind, made in
    place leaf by leaf (``common.materialize``)."""
    _require_ported(kind)
    return materialize(gen, _INIT[kind](cfg), device, n_units)


def init_exit_head(cfg):
    """Leaf specs of one exit head (``Model.init`` makes them)."""
    hid = cfg.exits.head_hidden
    p = {"norm": init_norm(cfg.norm, cfg.d_model)}
    if hid:
        p["w_h"] = scaled_init((cfg.d_model, hid), cfg.d_model)
        p["w"] = scaled_init((hid, cfg.vocab_size), hid)
    else:
        p["w"] = scaled_init((cfg.d_model, cfg.vocab_size), cfg.d_model)
    return p


def exit_head_hidden(cfg, p, x):
    """The exit head's pre-vocab hidden state (norm + optional gelu MLP),
    shared by the full-logits head and the fused entropy probe."""
    h = apply_norm(cfg.norm, x, p["norm"])
    if "w_h" in p:
        h = torch.nn.functional.gelu(
            torch.matmul(h, p["w_h"].to(h.dtype)), approximate="tanh")
    return h


def exit_head_logits(cfg, p, x):
    h = exit_head_hidden(cfg, p, x)
    return torch.matmul(h, p["w"].to(h.dtype)).float()


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def _ffn_residual(cfg, kind: str, lp, x):
    """The second half of a ``dense`` or ``moe`` layer: x + FFN(norm(x)).
    Returns (x, aux): the MoE load-balance loss, 0.0 for a dense layer."""
    h = apply_norm(cfg.norm, x, lp["ln2"])
    if kind == "moe":
        y, aux = ffn_mod.moe_ffn(lp["moe"], h, cfg)
        return x + y, aux
    return x + ffn_mod.ffn_forward(lp["ffn"], h, cfg.act), 0.0


def forward_layer(cfg, kind: str, lp, x, positions, window):
    """One ``dense`` or ``moe`` layer over the full sequence (the
    reference's ``_dense_fwd`` / ``_moe_fwd``).  Returns (x, aux)."""
    h = apply_norm(cfg.norm, x, lp["ln1"])
    fwd = attn.mla_forward if cfg.attention == "mla" else attn.gqa_forward
    y, _ = fwd(cfg, lp["attn"], h, positions, window=window)
    return _ffn_residual(cfg, kind, lp, x + y)


def run_scan_block(cfg, kind: str, bparams, x, positions, window):
    """A stacked block over the full sequence: a loop over its layer axis.
    Returns (x, aux): one layer's aux as it is, the sum over layers
    otherwise (the reference's rule)."""
    _require_ported(kind)
    n = tree_leaves(bparams)[0].shape[0]
    auxs = []
    for i in range(n):
        lp = tree_map(lambda a: a[i], bparams)
        x, aux = forward_layer(cfg, kind, lp, x, positions, window)
        auxs.append(aux)
    return x, auxs[0] if n == 1 else sum(auxs[1:], auxs[0])


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

# Scan kinds whose decode cache is attention KV (paged-arena eligible).
PAGED_KINDS = frozenset({"dense", "moe", "pair", "enc"})


def _attn_cache_shapes(cfg, lead):
    """Shapes of one layer's attention cache leaves, behind the leading
    axes ``lead``: (k, v) [.., Nkv, H] for GQA, (c_kv, k_rope) [.., R] /
    [.., Hr] for MLA."""
    if cfg.attention == "mla":
        return ((*lead, cfg.kv_lora_rank), (*lead, cfg.qk_rope_head_dim))
    kv = (*lead, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (kv, kv)


def init_layer_cache(cfg, kind: str, batch: int, cache_len: int,
                     device="cpu"):
    """Contiguous decode cache for ONE layer, bf16: (k, v)
    [B, S, Nkv, H], or MLA's (c_kv, k_rope) [B, S, R] / [B, S, Hr]."""
    _require_ported(kind)
    return tuple(torch.zeros(sh, dtype=torch.bfloat16, device=device)
                 for sh in _attn_cache_shapes(cfg, (batch, cache_len)))


def init_layer_cache_paged(cfg, kind: str, batch: int, n_pages: int,
                           page_size: int, device="cpu"):
    """Paged decode cache for ONE layer: global bf16 pools [n_pages, P,
    ...] of the same leaves, indexed through the slot block table."""
    _require_ported(kind)
    return tuple(torch.zeros(sh, dtype=torch.bfloat16, device=device)
                 for sh in _attn_cache_shapes(cfg, (n_pages, page_size)))


# ---------------------------------------------------------------------------
# Decode (single token, cache-carrying)
# ---------------------------------------------------------------------------

def _attn_decode_dispatch(cfg, lp_attn, h, cache, position, window,
                          paged=None, write_mask=None):
    if paged is not None:
        if cfg.attention == "mla":
            return attn.mla_decode_paged(cfg, lp_attn, h, cache[0], cache[1],
                                         position, paged)
        return attn.gqa_decode_paged(cfg, lp_attn, h, cache[0], cache[1],
                                     position, paged)
    decode = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    return decode(cfg, lp_attn, h, cache[0], cache[1], position,
                  window=window, write_mask=write_mask)


def decode_layer(cfg, kind: str, lp, x, cache, position, window,
                 paged=None, write_mask=None):
    """One-token decode through one layer; the layer's cache is updated in
    place.  Returns (x, cache, aux): ``aux`` is the MoE load-balance loss
    (0 for dense layers), which decode callers drop.  ``paged`` (an
    ``attn.PagedKV``) selects the paged pools; ``write_mask`` gates
    contiguous-row writes."""
    _require_ported(kind)
    h = apply_norm(cfg.norm, x, lp["ln1"])
    y, new = _attn_decode_dispatch(cfg, lp["attn"], h, cache, position,
                                   window, paged, write_mask)
    x, aux = _ffn_residual(cfg, kind, lp, x + y)
    return x, new, aux


def decode_scan_block(cfg, kind: str, bparams, x, caches, position, window,
                      paged=None, write_mask=None):
    """Decode through a stacked block: a loop over its layer axis.  Layer
    i's params and cache are views ``[i]`` of the stacked tensors, so the
    in-place cache writes land in the stacked caches."""
    n = tree_leaves(bparams)[0].shape[0]
    for i in range(n):
        lp = tree_map(lambda a: a[i], bparams)
        cc = tree_map(lambda a: a[i], caches)
        x, _, _ = decode_layer(cfg, kind, lp, x, cc, position, window, paged,
                               write_mask)
    return x, caches
