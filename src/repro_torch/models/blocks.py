"""Execution plan + the dense decode layer.

Every architecture compiles to a PLAN, an ordered list of steps

    ("scan",  kind, n_units, layer0)   — n_units stacked layers of one kind
    ("shared_attn", site_idx)          — zamba2 weight-shared attention block
    ("exit", exit_idx, layer)          — early-exit head / partition boundary

exactly as in the reference.  Zamba2's published layout
(``cfg.hybrid_layer_ids``, Zamba2-7B) places site k *before* layer
ids[k] instead: the site reads the stream and the input embedding and
returns what it adds to that layer's norm input (``run_site``), and the
scan block after it starts at that layer; ``num_mem_blocks`` shared
blocks alternate over the sites, each site with its own adapter and
linear.  An exit at the same boundary comes before the site, so a site
and the layer it feeds always share a decode segment.

Stacked blocks keep their leading layer axis
([n_units, ...]); the full-sequence forward (``run_scan_block``) and
decode (``decode_scan_block``) walk it in a Python loop.  The ``dense``
and ``moe`` kinds are ported, with GQA or MLA attention, ``mamba``
(zamba2's Mamba2 layers, with its weight-shared attention block), the
xLSTM kinds ``mlstm`` and ``slstm``, whisper's ``enc`` (a dense layer
with unmasked self-attention) and ``decx`` (causal self-attention,
cross-attention over the encoder output, then the FFN), and llama4's
``pair``: one unit of a dense layer ``"a"`` then a MoE layer ``"b"``,
whose cache is the dict {"a": (k, v), "b": (k, v)} (the reference's key
order, so its leaves flatten alike).  The plan never splits a unit, so an
exit inside one is dropped.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
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
    """The layers the shared block's sites follow (period layout), or
    precede (``hybrid_layer_ids``)."""
    if cfg.hybrid_layer_ids:
        return tuple(cfg.hybrid_layer_ids)
    if not cfg.shared_attn_period:
        return ()
    p = cfg.shared_attn_period
    return tuple(i for i in range(cfg.num_layers) if i % p == p - 1)


def build_plan(cfg) -> List[Tuple]:
    """Returns the ordered plan (see module docstring)."""
    L = cfg.num_layers
    exits = set(cfg.exits.exit_layers)
    before = set(cfg.hybrid_layer_ids)
    if any(not 0 <= i < L for i in before):
        raise ValueError(f"hybrid_layer_ids {cfg.hybrid_layer_ids} outside "
                         f"{L} layers")
    sa = set() if before else set(i + 1 for i in shared_attn_sites(cfg))
    bounds = {0, L} | exits | sa | before
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
        if a in before:
            plan.append(("shared_attn", sa_idx))
            sa_idx += 1
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

PORTED_KINDS = frozenset({"dense", "moe", "pair", "mamba", "mlstm", "slstm",
                          "decx", "enc"})


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


def _init_pair_unit(cfg):
    return {"a": _init_dense_layer(cfg), "b": _init_moe_layer(cfg)}


def _init_mamba_layer(cfg):
    return {"ln": init_norm(cfg.norm, cfg.d_model),
            "mamba": ssm_mod.init_mamba2(cfg)}


def _init_mlstm_layer(cfg):
    return {"ln": init_norm(cfg.norm, cfg.d_model),
            "mlstm": xlstm_mod.init_mlstm(cfg)}


def _init_slstm_layer(cfg):
    return {"ln": init_norm(cfg.norm, cfg.d_model),
            "slstm": xlstm_mod.init_slstm(cfg)}


def _init_decx_layer(cfg):
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model),
        "self_attn": attn.init_gqa(cfg),
        "ln2": init_norm(cfg.norm, cfg.d_model),
        "cross_attn": attn.init_gqa(cfg),
        "ln3": init_norm(cfg.norm, cfg.d_model),
        "ffn": ffn_mod.init_ffn(cfg.d_model, cfg.d_ff, cfg.act),
    }


_INIT = {"dense": _init_dense_layer, "moe": _init_moe_layer,
         "pair": _init_pair_unit, "mamba": _init_mamba_layer,
         "mlstm": _init_mlstm_layer, "slstm": _init_slstm_layer,
         "decx": _init_decx_layer, "enc": _init_dense_layer}

# the state kinds' full-sequence functions, by kind
_STATE_FWD = {"mamba": ssm_mod.mamba2_forward,
              "mlstm": xlstm_mod.mlstm_forward,
              "slstm": xlstm_mod.slstm_forward}


def init_scan_block(gen, cfg, kind: str, n_units: int, device="cpu",
                    keep=True):
    """Stacked params [n_units, ...] for a block of one kind, made in
    place leaf by leaf (``common.materialize``, whose ``keep`` this is)."""
    _require_ported(kind)
    return materialize(gen, _INIT[kind](cfg), device, n_units, keep)


def init_shared_attn(cfg):
    """Leaf specs of zamba2's shared block: attention + FFN with their own
    norms, ONE set of weights for every site."""
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model),
        "attn": attn.init_gqa(cfg),
        "ln2": init_norm(cfg.norm, cfg.d_model),
        "ffn": ffn_mod.init_ffn(cfg.d_model, cfg.d_ff, cfg.act),
    }


def init_sites(cfg):
    """Leaf specs of Zamba2's published shared blocks: ``num_mem_blocks``
    blocks, each an RMSNorm over the site input (2 D when it is
    concatenated with the embedding), attention from that width back to
    D, a pre-FFN RMSNorm and the gated FFN; and per site its adapter of
    the FFN's gate/up and its D x D linear."""
    d = cfg.d_model
    d_in = 2 * d if cfg.site_concat_input else d
    block = {"ln1": init_norm(cfg.norm, d_in),
             "attn": attn.init_gqa(cfg, d_in),
             "ln2": init_norm(cfg.norm, d),
             "ffn": ffn_mod.init_ffn(d, cfg.d_ff, cfg.act)}
    site = {}
    if cfg.site_adapter_rank:
        site["adapter"] = ffn_mod.init_adapter(d, cfg.d_ff,
                                               cfg.site_adapter_rank)
    if cfg.site_linear:
        site["linear"] = scaled_init((d, d), d)
    return {"blocks": [block for _ in range(cfg.num_mem_blocks)],
            "sites": [site for _ in cfg.hybrid_layer_ids]}


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

def _ffn_residual(cfg, kind: str, lp, x, ctx=ffn_mod.SINGLE):
    """The second half of a ``dense`` or ``moe`` layer: x + FFN(norm(x)).
    Returns (x, aux): the MoE load-balance loss, 0.0 for a dense layer.
    ``ctx`` is the mesh an expert-parallel MoE runs over."""
    h = apply_norm(cfg.norm, x, lp["ln2"])
    if kind == "moe":
        y, aux = ffn_mod.moe_ffn(lp["moe"], h, cfg, ctx)
        return x + y, aux
    return x + ffn_mod.ffn_forward(lp["ffn"], h, cfg.act), 0.0


def forward_layer(cfg, kind: str, lp, x, positions, window, enc_out=None,
                  ctx=ffn_mod.SINGLE, inject=None):
    """One layer over the full sequence (the reference's ``_dense_fwd`` /
    ``_moe_fwd`` / ``_pair_fwd`` / ``_mamba_fwd`` / ``_mlstm_fwd`` /
    ``_slstm_fwd`` / ``_enc_fwd`` and ``_make_decx_fwd(enc_out)``).
    ``inject`` (a site's output, state kinds only) is added to the norm's
    input, not to the residual.  Returns (x, aux); a pair unit's aux is
    its MoE layer's."""
    if kind == "pair":
        x, _ = forward_layer(cfg, "dense", lp["a"], x, positions, window)
        return forward_layer(cfg, "moe", lp["b"], x, positions, window,
                             ctx=ctx)
    if kind in _STATE_FWD:
        h = apply_norm(cfg.norm, x if inject is None else x + inject,
                       lp["ln"])
        y, _ = _STATE_FWD[kind](cfg, lp[kind], h)
        return x + y, 0.0
    if kind == "decx":
        h = apply_norm(cfg.norm, x, lp["ln1"])
        y, _ = attn.gqa_forward(cfg, lp["self_attn"], h, positions,
                                window=window)
        x = x + y
        h = apply_norm(cfg.norm, x, lp["ln2"])
        y, _ = attn.gqa_forward(cfg, lp["cross_attn"], h, positions,
                                kv_x=enc_out)
        x = x + y
        h = apply_norm(cfg.norm, x, lp["ln3"])
        return x + ffn_mod.ffn_forward(lp["ffn"], h, cfg.act), 0.0
    h = apply_norm(cfg.norm, x, lp["ln1"])
    if cfg.attention == "mla":
        y, _ = attn.mla_forward(cfg, lp["attn"], h, positions, window=window)
    else:
        y, _ = attn.gqa_forward(cfg, lp["attn"], h, positions,
                                causal=kind != "enc", window=window)
    return _ffn_residual(cfg, kind, lp, x + y, ctx)


def _unbind_layers(tree):
    """A stacked block's params as one tree per layer, each leaf a view of
    its stacked leaf.  ``torch.unbind`` takes every layer at once, so under
    autograd the stacked leaf's gradient is assembled once a block, where
    ``a[i]`` a layer would make a zero gradient of the whole stack for each
    layer and add them up."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [_unbind_layers(v) for v in tree]
        return [type(tree)(p[i] for p in per) for i in range(len(per[0]))]
    return list(torch.unbind(tree, 0))


def run_scan_block(cfg, kind: str, bparams, x, positions, window,
                   enc_out=None, ctx=ffn_mod.SINGLE, inject=None):
    """A stacked block over the full sequence: a loop over its layer axis.
    ``enc_out`` is the encoder output a ``decx`` block attends to; ``ctx``
    the mesh of its expert-parallel MoE layers; ``inject`` what a site
    adds to the first layer's norm input.
    Returns (x, aux): one layer's aux as it is, the sum over layers
    otherwise (the reference's rule)."""
    _require_ported(kind)
    n = tree_leaves(bparams)[0].shape[0]
    auxs = []
    for lp in _unbind_layers(bparams):
        x, aux = forward_layer(cfg, kind, lp, x, positions, window, enc_out,
                               ctx, inject)
        inject = None
        auxs.append(aux)
    return x, auxs[0] if n == 1 else sum(auxs[1:], auxs[0])


def run_shared_attn(cfg, sp, x, positions, window):
    """zamba2's shared attention + FFN block over the full sequence."""
    h = apply_norm(cfg.norm, x, sp["ln1"])
    y, _ = attn.gqa_forward(cfg, sp["attn"], h, positions, window=window)
    x = x + y
    h = apply_norm(cfg.norm, x, sp["ln2"])
    return x + ffn_mod.ffn_forward(sp["ffn"], h, cfg.act)


def _site_input(cfg, block, x, emb):
    """The site's normed input: concat(x, embedding) or x."""
    if cfg.site_concat_input:
        x = torch.cat([x, emb], dim=-1)
    return apply_norm(cfg.norm, x, block["ln1"])


def _site_output(cfg, block, site, y):
    """Attention output -> pre-FFN norm -> FFN with the site's adapter ->
    the site's linear: no residual inside the block."""
    h = apply_norm(cfg.norm, y, block["ln2"])
    y = ffn_mod.ffn_forward(block["ffn"], h, cfg.act, site.get("adapter"))
    if "linear" in site:
        y = torch.matmul(y, site["linear"].to(y.dtype))
    return y


def site_params(cfg, sp, k: int):
    """(shared block, own params) of site k: the blocks alternate."""
    return sp["blocks"][k % cfg.num_mem_blocks], sp["sites"][k]


def run_site(cfg, sp, k: int, x, emb, positions, window):
    """Zamba2's published site k over the full sequence: what it adds to
    the next layer's norm input (the stream x is left as it is)."""
    block, site = site_params(cfg, sp, k)
    h = _site_input(cfg, block, x, emb)
    y, _ = attn.gqa_forward(cfg, block["attn"], h, positions, window=window)
    return _site_output(cfg, block, site, y)


def run_site_decode(cfg, sp, k: int, x, emb, cache, position, window,
                    paged=None, write_mask=None):
    """Site k at one token, against its own KV cache (paged pools through
    ``attn.gqa_decode_paged``: the paged GQA kernel at head 224, G 1 for
    Zamba2-7B); returns what it adds to the next layer's norm input."""
    block, site = site_params(cfg, sp, k)
    h = _site_input(cfg, block, x, emb)
    if paged is not None:
        y, _ = attn.gqa_decode_paged(cfg, block["attn"], h, cache[0],
                                     cache[1], position, paged)
    else:
        y, _ = attn.gqa_decode(cfg, block["attn"], h, cache[0], cache[1],
                               position, window=window, write_mask=write_mask)
    return _site_output(cfg, block, site, y)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

# Scan kinds whose decode cache is attention KV (paged-arena eligible).
# State kinds (mamba, mlstm, slstm) keep fixed per-slot rows in paged
# arenas too; ``decx`` never reaches a paged arena (the scheduler and
# ``Model.init_decode_cache_paged`` refuse the encdec family).
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
    [B, S, Nkv, H], or MLA's (c_kv, k_rope) [B, S, R] / [B, S, Hr]; a
    mamba layer's (state [B, H, P, N] fp32, conv window [B, K-1, C]); an
    mlstm layer's (C [B, H, P, P], n [B, H, P]) and an slstm layer's
    (c, n, h, m) [B, H, P], all fp32; a decx layer's {"cross": (k, v)
    [B, Tenc, Nkv, H], "self": (k, v) [B, S, Nkv, H]} bf16 (the keys in
    the reference tree's sorted order, so leaves flatten alike); a pair
    unit's {"a": (k, v), "b": (k, v)}, its dense and MoE layers'."""
    _require_ported(kind)
    if kind == "pair":
        return {"a": init_layer_cache(cfg, "dense", batch, cache_len, device),
                "b": init_layer_cache(cfg, "moe", batch, cache_len, device)}
    if kind == "decx":
        def kv(length):
            return tuple(torch.zeros(sh, dtype=torch.bfloat16, device=device)
                         for sh in _attn_cache_shapes(cfg, (batch, length)))
        return {"cross": kv(cfg.encdec.encoder_seq_len), "self": kv(cache_len)}
    if kind == "mamba":
        return ssm_mod.init_mamba2_state(cfg, batch, device)
    if kind == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    return tuple(torch.zeros(sh, dtype=torch.bfloat16, device=device)
                 for sh in _attn_cache_shapes(cfg, (batch, cache_len)))


def init_layer_cache_paged(cfg, kind: str, batch: int, n_pages: int,
                           page_size: int, device="cpu"):
    """Paged decode cache for ONE layer: global bf16 pools [n_pages, P,
    ...] of the same leaves, indexed through the slot block table; state
    kinds keep their per-slot rows unchanged; a pair unit holds one set
    of pools for each of its layers, {"a": ..., "b": ...}.  ``decx`` has
    none."""
    _require_ported(kind)
    if kind == "decx":
        raise ValueError("kind 'decx' has no paged decode cache")
    if kind == "pair":
        return {"a": init_layer_cache_paged(cfg, "dense", batch, n_pages,
                                            page_size, device),
                "b": init_layer_cache_paged(cfg, "moe", batch, n_pages,
                                            page_size, device)}
    if kind not in PAGED_KINDS:
        return init_layer_cache(cfg, kind, batch, 0, device)
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


def _store_rows(dst, new, mask):
    """dst[b] = new[b] in place for rows where ``mask`` [B] (every row if
    None): a row that must not write keeps its value."""
    if mask is not None:
        new = torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new,
                          dst)
    dst.copy_(new)


def decode_layer(cfg, kind: str, lp, x, cache, position, window,
                 paged=None, write_mask=None, ctx=ffn_mod.SINGLE,
                 inject=None):
    """One-token decode through one layer; the layer's cache is updated in
    place.  Returns (x, cache, aux): ``aux`` is the MoE load-balance loss
    (0 for dense layers), which decode callers drop.  ``paged`` (an
    ``attn.PagedKV``) selects the paged pools; ``write_mask`` gates
    contiguous-row writes.  A state kind's rows (mamba, mlstm, slstm) are
    per slot in both arenas: every leaf stores under ``paged.write_mask``
    or ``write_mask`` (the reference merges them row-wise on the same
    mask).  A ``decx`` layer writes its self-attention row under
    ``write_mask`` and reads its cross rows, which admission primed.
    ``inject`` is added to a state kind's norm input, as in
    ``forward_layer``.  A ``pair`` unit decodes its dense layer, then its
    MoE layer, each with its own half of the cache."""
    _require_ported(kind)
    if kind == "pair":
        x, _, _ = decode_layer(cfg, "dense", lp["a"], x, cache["a"],
                               position, window, paged, write_mask)
        x, _, aux = decode_layer(cfg, "moe", lp["b"], x, cache["b"],
                                 position, window, paged, write_mask, ctx)
        return x, cache, aux
    if kind == "decx":
        if paged is not None:
            raise ValueError("kind 'decx' has no paged decode")
        h = apply_norm(cfg.norm, x, lp["ln1"])
        y, _ = attn.gqa_decode(cfg, lp["self_attn"], h, cache["self"][0],
                               cache["self"][1], position, window=window,
                               write_mask=write_mask)
        x = x + y
        h = apply_norm(cfg.norm, x, lp["ln2"])
        x = x + attn.cross_decode(cfg, lp["cross_attn"], h,
                                  cache["cross"][0], cache["cross"][1])
        h = apply_norm(cfg.norm, x, lp["ln3"])
        return x + ffn_mod.ffn_forward(lp["ffn"], h, cfg.act), cache, 0.0
    if kind in _STATE_FWD:
        h = apply_norm(cfg.norm, x if inject is None else x + inject,
                       lp["ln"])
        if kind == "mamba":
            y, st, cv = ssm_mod.mamba2_decode(cfg, lp["mamba"], h, cache[0],
                                              cache[1])
            new = (st, cv)
        elif kind == "mlstm":
            y, new = xlstm_mod.mlstm_decode(cfg, lp["mlstm"], h, cache)
        else:
            y, new = xlstm_mod.slstm_decode(cfg, lp["slstm"], h, cache)
        mask = paged.write_mask if paged is not None else write_mask
        for dst, val in zip(cache, new):
            _store_rows(dst, val, mask)
        return x + y, cache, 0.0
    h = apply_norm(cfg.norm, x, lp["ln1"])
    y, new = _attn_decode_dispatch(cfg, lp["attn"], h, cache, position,
                                   window, paged, write_mask)
    x, aux = _ffn_residual(cfg, kind, lp, x + y, ctx)
    return x, new, aux


def decode_scan_block(cfg, kind: str, bparams, x, caches, position, window,
                      paged=None, write_mask=None, ctx=ffn_mod.SINGLE,
                      inject=None):
    """Decode through a stacked block: a loop over its layer axis.  Layer
    i's params and cache are views ``[i]`` of the stacked tensors, so the
    in-place cache writes land in the stacked caches.  ``inject`` goes to
    the first layer."""
    n = tree_leaves(bparams)[0].shape[0]
    for i in range(n):
        lp = tree_map(lambda a: a[i], bparams)
        cc = tree_map(lambda a: a[i], caches)
        x, _, _ = decode_layer(cfg, kind, lp, x, cc, position, window, paged,
                               write_mask, ctx, inject if i == 0 else None)
    return x, caches


def run_shared_attn_decode(cfg, sp, x, cache, position, window, paged=None,
                           write_mask=None):
    """zamba2's shared block at one token: GQA decode against this site's
    own cache (paged pools through ``attn.gqa_decode_paged``, hence the
    paged GQA kernel at G 1), then the FFN."""
    h = apply_norm(cfg.norm, x, sp["ln1"])
    if paged is not None:
        y, _ = attn.gqa_decode_paged(cfg, sp["attn"], h, cache[0], cache[1],
                                     position, paged)
    else:
        y, _ = attn.gqa_decode(cfg, sp["attn"], h, cache[0], cache[1],
                               position, window=window, write_mask=write_mask)
    x = x + y
    h = apply_norm(cfg.norm, x, sp["ln2"])
    return x + ffn_mod.ffn_forward(sp["ffn"], h, cfg.act), cache
