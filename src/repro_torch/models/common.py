"""Shared building blocks: device check, norms, activations, init, embed."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default of every
    entry point; asking for it without a GPU raises instead of falling back
    to the CPU.  Only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
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
# ---------------------------------------------------------------------------

def normal_init(gen, shape, std: float = 0.02, dtype=torch.float32,
                device="cpu"):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def scaled_init(gen, shape, fan_in: int, dtype=torch.float32, device="cpu"):
    return normal_init(gen, shape, std=1.0 / math.sqrt(max(1, fan_in)),
                       dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms — computed in fp32, cast back
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
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


def init_norm(kind: str, d: int, device="cpu"):
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(kind: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[kind]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(tokens, table):
    return table[tokens]


def unembed(x, table):
    """x [..., D] @ table.T [D, V] -> logits fp32."""
    return torch.matmul(x, table.to(x.dtype).t()).float()
