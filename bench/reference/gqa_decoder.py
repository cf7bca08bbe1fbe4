"""Plain float32 reference of a dense GQA decoder with early-exit heads.

It follows the published description of a Llama-style decoder, as the
configuration file gives it: token embedding (times
``embedding_multiplier``), then per layer RMSNorm, q/k/v projections,
split-halves RoPE at ``rope_theta``, causal grouped-query attention
(query head n*G + g reads key/value head n) scaled by
``attention_multiplier``, the output projection, a residual add (times
``residual_multiplier``), RMSNorm and the SwiGLU FFN; a final RMSNorm
and the vocabulary head (the embedding when tied), divided by
``logits_scaling``.  After layer i in ``exit_layers`` an exit head (an
RMSNorm and a [D, V] projection) reads the residual stream.

It is a full forward over a whole sequence, with no cache, no batching
of sequences and no kernel, and it reads only the benchmark's weights
and tokens.  ``lowp=True`` runs every matmul of the projections and heads
on float8 (e4m3) inputs, each row of activations and each output column
of a weight scaled to the format's range: the control, the step below
the bfloat16 the configuration states.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

FP8_MAX = 448.0                           # largest finite float8_e4m3fn


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3, scaled per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, lowp: bool) -> torch.Tensor:
    """x [T, K] @ w [K, N] in float32 (float8 inputs under ``lowp``)."""
    w = w.to(torch.float32)
    if lowp:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * scale.to(torch.float32)


def _rope(x, theta):
    """x [T, N, H], positions 0..T-1, split halves."""
    t, _, h = x.shape
    half = h // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, scale):
    """Causal GQA: q [T, Nq, H], k/v [T, Nkv, H] -> [T, Nq * H]."""
    t, nq, h = q.shape
    nkv = k.shape[1]
    qg = q.reshape(t, nkv, nq // nkv, h).permute(1, 2, 0, 3)
    s = torch.einsum("ngth,nsh->ngts", qg, k.permute(1, 0, 2)) * scale
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("ngts,nsh->ngth", p, v.permute(1, 0, 2))
    return o.permute(2, 0, 1, 3).reshape(t, nq * h)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -(logp.exp() * logp).sum(-1)


def forward(cfg: dict, w: Dict[str, object], tokens: torch.Tensor,
            first: int = 0, lowp: bool = False) -> Dict[str, object]:
    """Logits of one sequence ``tokens`` [T] at positions [first, T):
    ``logits`` [T - first, V] and ``exit_logits``, one [T - first, V]
    tensor an exit head, all float32."""
    d = cfg["hidden_size"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    h = cfg.get("head_dim") or d // nq
    eps = cfg["rms_norm_eps"]
    scale = cfg.get("attention_multiplier") or 1.0 / math.sqrt(h)
    res = cfg.get("residual_multiplier", 1.0)
    exits = list(cfg.get("exit_layers", ()))
    t = tokens.shape[0]
    x = w["embed"][tokens].to(torch.float32) * cfg.get(
        "embedding_multiplier", 1.0)
    exit_logits: List[torch.Tensor] = []
    for i in range(cfg["num_hidden_layers"]):
        a = _rmsnorm(x, w["ln1"][i], eps)
        q = _mm(a, w["wq"][i].reshape(d, nq * h), lowp).reshape(t, nq, h)
        k = _mm(a, w["wk"][i].reshape(d, nkv * h), lowp).reshape(t, nkv, h)
        v = _mm(a, w["wv"][i].reshape(d, nkv * h), lowp).reshape(t, nkv, h)
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        o = _attention(q, k, v, scale)
        x = x + res * _mm(o, w["wo"][i].reshape(nq * h, d), lowp)
        a = _rmsnorm(x, w["ln2"][i], eps)
        g = torch.nn.functional.silu(_mm(a, w["w_gate"][i], lowp))
        x = x + res * _mm(g * _mm(a, w["w_up"][i], lowp), w["w_down"][i],
                          lowp)
        if i + 1 in exits:
            e = w["exit_heads"][exits.index(i + 1)]
            exit_logits.append(_mm(_rmsnorm(x[first:], e["norm"], eps),
                                   e["w"], lowp))
    head = w.get("lm_head", w["embed"])
    logits = _mm(_rmsnorm(x[first:], w["final_norm"], eps), head.t(), lowp)
    return {"logits": logits / cfg.get("logits_scaling", 1.0),
            "exit_logits": exit_logits}


def no_tf32() -> Optional[tuple]:
    """Turn TF32 off for float32 matmuls; returns the settings to restore."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


def restore_tf32(old: tuple) -> None:
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old
