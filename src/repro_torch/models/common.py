"""Shared building blocks: device check, norms, activations, init, embed,
and the model's spans."""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

SPAN_PREFIX = "repro.model."
_NULL = contextlib.nullcontext()


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def step_span(name: str):
    """A context that records ``repro.model.<name>`` around one plan step
    of an eager decode step or forward (a scan block's kind, ``site``,
    ``exit``, ``head``) while a profiler collects, as
    ``serving/spans.py``'s spans do (a function-scope record, never a user
    annotation).  With no profiler it costs one check; inside a CUDA
    graph capture it records nothing, since a replay re-runs no Python."""
    if not torch.autograd._profiler_enabled() or _capturing():
        return _NULL
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default of every
    entry point; asking for it without a GPU raises instead of falling back
    to the CPU.  Only an explicit ``"cpu"`` runs on the host; ``"meta"``
    (the dry run's stand-ins) allocates and computes nothing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts / lists / tuples of tensors
    (the port's parameter and cache trees)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


# ---------------------------------------------------------------------------
# Initializers (std and dtype rules of the reference; the random stream is
# torch's, so a test hands both packages the same weights via the bridge)
#
# The init functions of the model modules return trees of ``Leaf`` specs;
# ``materialize`` makes them.  Each parameter is allocated once, in its
# final dtype and, for a block, already stacked [n_units, ...]; random
# leaves are drawn in fp32 slices of at most ``DRAW_CHUNK`` elements and
# written into it.  So no fp32 copy of a weight and no stack copy of a
# block ever exists: a full-width deepseek-v3 MoE layer (22.5 GB of bf16
# experts) would not fit on one 80 GB card beside those.
# ---------------------------------------------------------------------------

DRAW_CHUNK = 1 << 24               # elements drawn at once (64 MB of fp32)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter to be made: its per-layer shape, and either a normal
    draw with standard deviation ``std`` or the constant ``fill``."""
    shape: Tuple[int, ...]
    std: float = 0.0
    fill: float = 0.0


def normal_init(shape, std: float = 0.02) -> Leaf:
    return Leaf(tuple(shape), std=std)


def scaled_init(shape, fan_in: int) -> Leaf:
    return Leaf(tuple(shape), std=1.0 / math.sqrt(max(1, fan_in)))


def materialize(gen, tree, device, n_units: Optional[int] = None,
                keep=True):
    """Make every ``Leaf`` of ``tree`` on ``device``, stacked
    [n_units, ...] when ``n_units`` is given.  dtype follows the
    reference's cast, applied after stacking: bf16 where the made tensor
    has rank >= 2 (stacked norm scales included), fp32 otherwise.

    ``keep`` says what of each leaf this process holds: True, all of it;
    False, none (its draws are made and dropped, so the leaves after it
    get the numbers they get in a full init; the leaf becomes None); or
    (dim, lo, hi), the part [lo, hi) of the made tensor's dimension
    ``dim`` (a rank's experts), equal to that part of the full leaf.  On
    the "meta" device nothing is drawn."""
    def make(leaf: Leaf):
        shape = leaf.shape if n_units is None else (n_units, *leaf.shape)
        dtype = torch.bfloat16 if len(shape) >= 2 else torch.float32
        numel = math.prod(shape)
        if keep is False:
            if leaf.std and torch.device(device).type != "meta":
                for a in range(0, numel, DRAW_CHUNK):
                    torch.randn(min(DRAW_CHUNK, numel - a), generator=gen,
                                dtype=torch.float32, device=device)
            return None
        # kept runs of the full leaf's flat draw: (start, length, out start)
        if keep is True:
            runs = [(0, numel, 0)]
        else:
            dim, lo, hi = keep
            pre = math.prod(shape[:dim])
            post = math.prod(shape[dim + 1:])
            n = shape[dim]
            runs = [((a * n + lo) * post, (hi - lo) * post,
                     a * (hi - lo) * post) for a in range(pre)]
            shape = (*shape[:dim], hi - lo, *shape[dim + 1:])
        out = torch.empty(shape, dtype=dtype, device=device)
        if not leaf.std:
            return out.fill_(leaf.fill)
        if out.is_meta:
            return out
        flat = out.view(-1)
        for a in range(0, numel, DRAW_CHUNK):
            b = min(a + DRAW_CHUNK, numel)
            draw = torch.randn(b - a, generator=gen, dtype=torch.float32,
                               device=device).mul_(leaf.std)
            for start, length, dst in runs:
                lo_, hi_ = max(a, start), min(b, start + length)
                if lo_ < hi_:
                    flat[dst + lo_ - start:dst + hi_ - start].copy_(
                        draw[lo_ - a:hi_ - a])
        return out
    return tree_map(make, tree)


# ---------------------------------------------------------------------------
# Norms — computed in fp32, cast back
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def group_rmsnorm(x, scale, groups: int, eps: float = 1e-6):
    """RMSNorm over each of ``groups`` equal groups of the last axis (one
    group: ``rmsnorm``), then the scale over the whole axis."""
    if groups == 1:
        return rmsnorm(x, scale, eps)
    xf = x.float().reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).reshape(x.shape) * scale.float()
    return out.to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(kind: str, x, p):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def init_norm(kind: str, d: int):
    if kind == "rmsnorm":
        return {"scale": Leaf((d,), fill=1.0)}
    return {"scale": Leaf((d,), fill=1.0), "bias": Leaf((d,), fill=0.0)}


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(kind: str):
    """The FFN activation; ``geglu`` is a gated FFN on the erf gelu."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu,
            "geglu": F.gelu}[kind]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(tokens, table):
    return table[tokens]


def unembed(x, table):
    """x [..., D] @ table.T [D, V] -> logits fp32."""
    return torch.matmul(x, table.to(x.dtype).t()).float()


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions.  logits fp32 [..., V], labels int
    [...], mask [...] (any dtype; 1 = counted) or None."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = logz - gold
    if mask is not None:
        mask = mask.to(loss.dtype)
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)
