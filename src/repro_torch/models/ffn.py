"""Feed-forward layers: gated dense FFN and the capacity-bounded MoE.

The MoE is the reference's single-device form (``moe_ffn_reference``):
route every token to its top-k experts, give each expert ``capacity``
rows, drop the assignments past it (in the row-major order of the (token,
k) assignments), run every expert over its rows as one batched product,
and combine the expert outputs weighted by the gates.

Expert parallel (``moe_ffn(params, x, cfg, ShardCtx(mesh))``, the
reference's ``shard_map`` form over a world of ranks): tokens are sharded
over the ("pod", "data") axes and replicated over "model"; each rank holds
only its own experts (``local_experts``), dispatches the tokens it sees
into capacity-bounded buffers for them, runs them, and one ``all_reduce``
over "model" in the activation dtype combines the expert shards (the
reference's ``psum``); the result is gathered back to the global batch on
every rank.

Serving-time W8A8 experts (the reference's ``quantize_model_moe``): the
expert weights are stored int8 with one fp32 scale per (expert, output
column), and each product quantizes its dispatched rows per row, so the
expert GEMMs run s8 x s8 -> s32 (``kernels.ops.w8a8_expert_matmul``, a
hand-written kernel on the card) and read half the bytes of bf16.  A MoE
params dict holds either form, told apart by its keys, and ``moe_ffn``
takes both.

The two quantizers divide by 127 in the two forms the reference takes:
``_quant_rows`` runs inside the reference's jitted decode step and
forward, where XLA turns ``amax / 127`` into ``amax * fl(1/127)``, so the
port multiplies by ``ref.INV127``; ``quantize_expert_weights`` runs eagerly
(``quantize_model_moe`` is called outside any jit), so the port divides.
``tests/test_torch_w8a8.py`` holds each against the reference, eager and
under ``jax.jit``, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import INV127
from repro_torch.models.common import activation, materialize, scaled_init
from repro_torch.sharding import comm
from repro_torch.sharding.specs import ShardingRules, local_slice


# ---------------------------------------------------------------------------
# Mesh context threaded through the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Ambient mesh info: a ``torch.distributed.device_mesh.DeviceMesh``
    over the world of ranks (``launch.mesh.make_host_mesh``), or ``None``
    for one device (serving, training, tests)."""
    mesh: Optional[Any] = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return () if self.mesh is None else tuple(self.mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        if self.mesh is None:
            return {}
        return dict(zip(self.axis_names, self.mesh.mesh.shape))

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    @property
    def model_axis(self) -> Optional[str]:
        return "model" if "model" in self.axis_names else None

    @property
    def model_size(self) -> int:
        ax = self.model_axis
        return self.shape[ax] if ax else 1

    @property
    def data_size(self) -> int:
        return math.prod(self.shape[a] for a in self.data_axes)

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``."""
        return self.mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.mesh.get_local_rank(axis)

    @property
    def coords(self) -> Dict[str, int]:
        return {a: self.coord(a) for a in self.axis_names}


SINGLE = ShardCtx(None)


GATED = ("silu", "geglu")


def init_ffn(d: int, ff: int, act: str):
    if act in GATED:
        return {
            "w_gate": scaled_init((d, ff), d),
            "w_up": scaled_init((d, ff), d),
            "w_down": scaled_init((ff, d), ff),
        }
    return {
        "w_in": scaled_init((d, ff), d),
        "w_down": scaled_init((ff, d), ff),
    }


def init_adapter(d: int, ff: int, rank: int):
    """A low-rank adapter of a gated FFN's gate and up projections:
    x @ a [D, r] @ b [r, 2F], gate columns first (Zamba2's per-site
    ``gate_up_proj_adapter``)."""
    return {"a": scaled_init((d, rank), d),
            "b": scaled_init((rank, 2 * ff), rank)}


def ffn_forward(params, x, act: str, adapter=None):
    """The FFN; ``adapter`` (``init_adapter``) adds its low-rank term to
    a gated FFN's gate and up pre-activations."""
    fn = activation(act)
    w = {k: v.to(x.dtype) for k, v in params.items()}
    if "w_gate" in params:
        gate = torch.matmul(x, w["w_gate"])
        up = torch.matmul(x, w["w_up"])
        if adapter is not None:
            low = torch.matmul(torch.matmul(x, adapter["a"].to(x.dtype)),
                               adapter["b"].to(x.dtype))
            gate = gate + low[..., :gate.shape[-1]]
            up = up + low[..., gate.shape[-1]:]
        h = fn(gate) * up
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


# ---------------------------------------------------------------------------
# W8A8 experts
# ---------------------------------------------------------------------------

_EXPERT_KEYS = ("wg", "wu", "wd")


def _quantize_weight(w):
    """One expert weight leaf [..., E, in, out] -> (int8 of its shape, fp32
    scales [..., E, 1, out]), the reference's eager ``quantize_expert_weights``
    formula: s = max(amax_in(|w|) / 127, 1e-8), q = clip(round(w / s),
    +-127).  Made one expert at a time, so the fp32 transient is one
    [in, out] matrix (168 MB at llama4's widths, not the whole leaf's
    21.5 GB).  The divisor 127 is a tensor on w's device: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal instead."""
    lead, nout = w.shape[:-2], w.shape[-1]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((*lead, 1, nout), dtype=torch.float32, device=w.device)
    c127 = torch.tensor(127.0, dtype=torch.float32, device=w.device)
    wf, qf, sf = (t.reshape(-1, *t.shape[-2:]) for t in (w, q, s))
    for i in range(wf.shape[0]):
        we = wf[i].float()
        se = torch.clamp(we.abs().amax(dim=0, keepdim=True) / c127, min=1e-8)
        qf[i].copy_(torch.clamp(torch.round(we / se), -127.0, 127.0))
        sf[i].copy_(se)
    return q, s


def quantize_expert_weights(moe_params):
    """bf16 expert weights -> int8 + scales: keys wg/wu/wd -> *_q (int8,
    the weight's shape) and *_s (fp32 [..., E, 1, out]); every other key
    as it is.  Returns a new dict; ``moe_params`` is left alone."""
    out = {k: v for k, v in moe_params.items() if k not in _EXPERT_KEYS}
    for k in _EXPERT_KEYS:
        out[k + "_q"], out[k + "_s"] = _quantize_weight(moe_params[k])
    return out


def init_moe_layer(cfg, seed: int, device, experts=None,
                   w8a8: bool = False):
    """One MoE layer's params made from ``seed`` on ``device``, holding
    experts [e0, e1) = ``experts`` (all of them by default) of the layer
    that the full init from the same seed makes: the other experts'
    draws are made and dropped (``common.materialize``'s ``keep``).  With
    ``w8a8`` each expert leaf is quantized as soon as it is made and its
    bf16 form dropped, so one bf16 expert leaf exists at a time."""
    e0, e1 = experts if experts is not None else (0, cfg.moe.num_experts)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, leaf in init_moe(cfg).items():
        keep = (0, e0, e1) if k in _EXPERT_KEYS else True
        out[k] = materialize(gen, leaf, device, keep=keep)
        if w8a8 and k in _EXPERT_KEYS:
            out[k + "_q"], out[k + "_s"] = _quantize_weight(out.pop(k))
    return out


def quantize_model_moe(params):
    """Every MoE expert set of a model params tree (a dict holding "wg"
    next to a "router") in its W8A8 form; the rest untouched.  IN PLACE,
    unlike the reference's tree map: each bf16 leaf leaves its dict as
    soon as its int8 form exists, so it is freed once nothing else holds
    it (a full-width llama4 tree carries 64.4 GB of bf16 experts and
    would not fit twice on one card).  Returns ``params``."""
    if isinstance(params, dict):
        if "wg" in params and "router" in params:
            for k in _EXPERT_KEYS:
                params[k + "_q"], params[k + "_s"] = _quantize_weight(
                    params.pop(k))
        for v in params.values():
            quantize_model_moe(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            quantize_model_moe(v)
    return params


def _quant_rows(x):
    """Per-row symmetric int8: x [T, D] -> (q int8, scale fp32 [T, 1]),
    scale = max(amax * fl(1/127), 1e-8) (the jitted reference's form),
    q = clip(round_half_even(x / scale), +-127)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * INV127, min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8)
    return q, s


def _q_expert_matmul(ebuf, wq, ws):
    """W8A8 grouped matmul: ebuf [E, C, d] float, wq [E, d, f] int8, ws
    [E, 1, f] fp32 -> fp32 [E, C, f] = float(s32 sum) * a_scale * w_scale.
    Every capacity row is computed, empty or not, as the reference does."""
    e, c, d = ebuf.shape
    aq, as_ = _quant_rows(ebuf.reshape(e * c, d))
    return kops.w8a8_expert_matmul(aq.reshape(e, c, d),
                                   as_.reshape(e, c, 1), wq, ws)


def _dispatch_compute_combine(x2d, gates, idx, weights, e0: int,
                              capacity: int, act: str):
    """Local-expert scatter -> batched expert FFN -> gather-combine.
    x2d [T,d]; gates/idx [T,k]; ``weights`` holds E_loc experts as either
    {"wg","wu","wd"} bf16 or the W8A8 form {"wg_q","wg_s",...}; e0 = first
    local expert id.  Returns this shard's output [T,d] in x2d's dtype."""
    t, d = x2d.shape
    k = idx.shape[1]
    quant = "wg_q" in weights
    e_loc = weights["wg_q" if quant else "wg"].shape[0]
    fn = activation(act)
    slot, _ = _slots(idx, e0, e_loc, capacity)
    # each kept row receives exactly one token; only the trash row sums
    buf = torch.zeros((e_loc * capacity + 1, d), dtype=x2d.dtype,
                      device=x2d.device)
    for j in range(k):
        buf.index_add_(0, slot[:, j], x2d)
    ebuf = buf[:e_loc * capacity].reshape(e_loc, capacity, d)
    if quant:                             # h stays fp32 between products
        h = fn(_q_expert_matmul(ebuf, weights["wg_q"], weights["wg_s"]))
        h = h * _q_expert_matmul(ebuf, weights["wu_q"], weights["wu_s"])
        out = _q_expert_matmul(h, weights["wd_q"],
                               weights["wd_s"]).to(x2d.dtype)
    else:
        wg, wu, wd = weights["wg"], weights["wu"], weights["wd"]
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


def moe_ffn(params, x, cfg, ctx: ShardCtx = SINGLE):
    """The MoE layer, bf16 or W8A8 experts by the keys of ``params``.
    x [B,S,D] -> (y [B,S,D], aux_loss scalar).

    Without a mesh (``SINGLE``, what serving builds): the reference
    oracle.  With one: ``params`` holds this rank's experts only (E / model
    of them, ``local_experts``), ``x`` is the global batch and so is the
    returned ``y``, on every rank.  The rank routes its data shard (the
    whole batch when the data axes do not divide it), sizes capacity from
    its own token count, runs experts ``e0 = model_rank * e_loc`` onward,
    sums the shards' partial ``y`` over "model" in x's dtype, averages aux
    over the data axes and adds the shared expert outside, as the
    reference does."""
    m = cfg.moe
    if ctx.mesh is None:
        return moe_ffn_reference(params, x, cfg)
    b, s, d = x.shape
    # batch not divisible by the data axes (e.g. long_500k batch=1):
    # replicate tokens over data instead of sharding them
    dax = ctx.data_axes if b % max(ctx.data_size, 1) == 0 else ()
    dsize = ctx.data_size if dax else 1
    bl = b // dsize
    t_local = bl * s
    cap = _capacity(t_local, m.num_experts, m.top_k, m.capacity_factor)
    e_loc = params["wg_q" if "wg_q" in params else "wg"].shape[0]
    if e_loc * ctx.model_size != m.num_experts:
        raise ValueError(f"moe_ffn: {e_loc} local experts x model "
                         f"{ctx.model_size} != {m.num_experts} experts")
    row = 0
    for a in dax:                         # the data axes, first one major
        row = row * ctx.shape[a] + ctx.coord(a)
    x2d = x[row * bl:(row + 1) * bl].reshape(t_local, d)
    gates, idx, probs = _route(x2d, params["router"], m.top_k)
    e0 = ctx.coord(ctx.model_axis) * e_loc if ctx.model_axis else 0
    y = _dispatch_compute_combine(x2d, gates, idx, params, e0, cap, cfg.act)
    if ctx.model_axis:
        comm.all_reduce(y, ctx.group(ctx.model_axis))  # the shards
    aux = _aux_loss(probs, idx, m.num_experts).reshape(1)
    for a in dax:
        comm.all_reduce(aux, ctx.group(a))
    aux = (aux / dsize if dax else aux).reshape(())
    y = y.reshape(bl, s, d)
    if dax:
        y = comm.all_gather_axes(y, [ctx.group(a) for a in dax])
    if "shared" in params:
        y = y + ffn_forward(params["shared"], x, cfg.act)
    return y, aux


_LOCAL_KEYS = _EXPERT_KEYS + tuple(k + sfx for k in _EXPERT_KEYS
                                   for sfx in ("_q", "_s"))


def local_experts(params, ctx: ShardCtx):
    """``params`` (a model's tree or one MoE layer's) with every expert
    leaf (wg/wu/wd, bf16 or W8A8) cut to this rank's shard over "model"
    under the reference's partition rule (``sharding.specs``: the expert
    dimension over "model"); every other leaf as it is."""
    if ctx.mesh is None:
        return params
    rules = ShardingRules(ctx.mesh, "tp")
    coords = ctx.coords

    def walk(node, path):
        if isinstance(node, dict):
            moe = "router" in node
            return {k: (local_slice(v, rules.param_spec(
                        path + (k,), tuple(v.shape)), rules.mesh, coords)
                        if moe and k in _LOCAL_KEYS
                        else walk(v, path + (str(k),)))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return node
    return walk(params, ())
