"""AdamW + cosine schedule + global-norm clipping over the port's param
trees (nested dicts and lists of tensors).

The state keeps fp32 m and v; params keep their own dtype (bf16 matmul
weights, fp32 norms).  The arithmetic is the reference package's
``training/optimizer.py`` step for step, in fp32.  Unlike the reference,
which returns new trees, ``apply_updates`` writes params, m and v in place
and returns the same trees: at granite-3-2b's full width a second copy of
the params and moments (27 GB) would not fit beside the activations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models.common import tree_leaves, tree_map

@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptimizerConfig, step):
    """Linear warm-up, then cosine decay to ``min_lr_ratio * lr``; fp32,
    on the device of ``step`` when it is a tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_optimizer(params) -> Dict[str, Any]:
    """fp32 zeros m and v in the params' tree, and the int32 step 0."""
    def zeros(p):
        return tree_map(
            lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                  device=a.device), p)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32; None leaves (no
    gradient) count as zeros."""
    total = sum(torch.sum(torch.square(a.float()))
                for a in tree_leaves(tree) if a is not None)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step, in place.  ``grads`` has the params' tree; a None
    leaf (a param autograd left without a gradient) is a zero gradient, as
    the reference's ``jax.grad`` gives it.  Returns (params, state,
    metrics) with metrics ``grad_norm`` and ``lr`` (0-dim tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.ndim >= 2:                     # decay matmul weights only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            upd(p, torch.zeros_like(p) if g is None else g, m, v)
        state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
