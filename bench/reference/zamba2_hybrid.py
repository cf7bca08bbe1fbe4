"""Plain float32 reference of Zamba2's published hybrid (Zamba2-7B) with
early-exit heads.

It follows the layer equations of transformers' ``modeling_zamba2.py``
(``Zamba2Model``), as the configuration file gives them.  x0 is the token
embedding.  Layer i (0-based) is a Mamba2 layer; when i is in
``hybrid_layer_ids`` (site k), a shared block runs first:

* block k mod ``num_mem_blocks`` reads RMSNorm(concat(x, x0)) of width
  ``attention_hidden_size``; q, k, v project it to heads of
  ``attention_head_dim``, split-halves RoPE at ``rope_theta`` over the
  whole head, causal attention scaled by (head_dim / 2)^-0.5, o back to
  ``hidden_size``;
* RMSNorm (``pre_ff_layernorm``), then the gelu GLU FFN, whose gate and
  up pre-activations add site k's own adapter (x @ a @ b, gate columns
  first); no residual around either part;
* site k's own ``linear`` (hidden x hidden);

and its output t is added to the Mamba2 layer's norm input, not to the
stream: x = x + Mamba2(RMSNorm(x + t)).  Mamba2 (``Zamba2MambaMixer``):
in_proj to [z | x | B | C | dt], B and C of ``mamba_ngroups`` groups of
``mamba_d_state``; a depthwise causal conv (width ``mamba_d_conv``, with
bias) and silu over [x | B | C]; dt = softplus(dt + dt_bias), A =
-exp(A_log); head h reads group h // (heads / groups); the SSM
y = SSD(x dt, A dt, B, C) + D x; then y * silu(z), RMSNorm over each
group of d_inner / groups channels, and out_proj.  After the last layer
an RMSNorm and the vocabulary head (the embedding, tied).  After layer
i in ``exit_layers`` (a count of layers done) an exit head (an RMSNorm
and a [D, V] projection) reads the stream.

The SSM is the chunked dual form (SSD, chunks of ``chunk_size``, the
sequence padded to whole chunks): within a chunk the decays and C B^T
products as a masked matrix, across chunks a loop over the carried
state.  The plain recurrence would take a step a token and layer, which
does not fit a run's check at thousands of tokens.

Departures, each noted in the configuration's ``assumed``: every RMSNorm
epsilon is ``rms_norm_eps``, the published Mamba2 gated norm's 1e-5
included; dt is not clamped at ``time_step_min`` (the published kernel
path, with ``time_step_limit`` null, does not clamp; transformers' plain
torch path does); the exit heads are the repository's.

A full forward over one whole sequence, with no cache, no batching and
no kernel, reading only the benchmark's weights and tokens.
``lowp=True`` runs every matmul of the projections, adapters, linears
and heads on float8 (e4m3) inputs, each row of activations and each
output column of a weight scaled to the format's range: the control,
the step below the bfloat16 the configuration states.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                           # largest finite float8_e4m3fn
NEG_INF = float("-inf")


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


def _rmsnorm(x, scale, eps, groups: int = 1):
    """RMSNorm over each of ``groups`` equal groups of the last axis."""
    g = x.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    g = g * torch.rsqrt(torch.mean(g * g, -1, keepdim=True) + eps)
    return g.reshape(x.shape) * scale.to(torch.float32)


def _rope(x, theta):
    """x [T, N, H], positions 0..T-1, split halves over the whole head."""
    t, _, h = x.shape
    half = h // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, scale):
    """Causal attention, q [T, Nq, H], k/v [T, Nkv, H] -> [T, Nq * H]."""
    t, nq, h = q.shape
    nkv = k.shape[1]
    qg = q.reshape(t, nkv, nq // nkv, h).permute(1, 2, 0, 3)
    s = torch.einsum("ngth,nsh->ngts", qg, k.permute(1, 0, 2)) * scale
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), -1)
    o = torch.einsum("ngts,nsh->ngth", p, v.permute(1, 0, 2))
    return o.permute(2, 0, 1, 3).reshape(t, nq * h)


def _site(cfg, blk, site, x, x0, lowp):
    """A shared block at one site: what it adds to the next layer's norm
    input."""
    eps = cfg["rms_norm_eps"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, a = cfg["attention_head_dim"], cfg["attention_hidden_size"]
    t = x.shape[0]
    h = _rmsnorm(torch.cat([x, x0], -1), blk["ln1"], eps)
    q = _mm(h, blk["wq"].reshape(a, nq * hd), lowp).reshape(t, nq, hd)
    k = _mm(h, blk["wk"].reshape(a, nkv * hd), lowp).reshape(t, nkv, hd)
    v = _mm(h, blk["wv"].reshape(a, nkv * hd), lowp).reshape(t, nkv, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    o = _attention(q, k, v, (hd / 2) ** -0.5)
    y = _mm(o, blk["wo"].reshape(nq * hd, -1), lowp)
    h = _rmsnorm(y, blk["ln2"], eps)
    gate_up = torch.cat([_mm(h, blk["w_gate"], lowp),
                         _mm(h, blk["w_up"], lowp)], -1)
    gate_up = gate_up + _mm(_mm(h, site["adapter_a"], lowp),
                            site["adapter_b"], lowp)
    gate, up = gate_up.chunk(2, -1)
    y = _mm(F.gelu(gate) * up, blk["w_down"], lowp)
    return _mm(y, site["linear"], lowp)


def _ssd(xs, dt, a, b, c, chunk):
    """The SSM over one sequence in the chunked dual form.  xs [T, H, P],
    dt [T, H], a [H] (negative), b/c [T, H, N] -> y [T, H, P] (without
    the D skip), from a zero state."""
    t, nh, p = xs.shape
    n = b.shape[-1]
    pad = (-t) % chunk
    if pad:
        xs, dt, b, c = (F.pad(u, (0, 0) * (u.ndim - 1) + (0, pad))
                        for u in (xs, dt, b, c))
    nc = xs.shape[0] // chunk
    xs = (xs * dt[..., None]).reshape(nc, chunk, nh, p)
    la = (dt * a).reshape(nc, chunk, nh).permute(0, 2, 1)     # [nc, H, Q]
    b = b.reshape(nc, chunk, nh, n)
    c = c.reshape(nc, chunk, nh, n)
    cum = torch.cumsum(la, -1)                                 # [nc, H, Q]
    # within a chunk: decay from j to i (j <= i) times C_i . B_j
    seg = cum[..., :, None] - cum[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=xs.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, NEG_INF))       # [nc,H,Q,Q]
    cb = torch.einsum("cihn,cjhn->chij", c, b)
    y = torch.einsum("chij,cjhp->cihp", decay * cb, xs)
    # each chunk's state contribution, carried across chunks
    to_end = torch.exp(cum[..., -1:] - cum)                    # [nc, H, Q]
    add = torch.einsum("chj,cjhn,cjhp->chpn", to_end, b, xs)
    state = torch.zeros(nh, p, n, dtype=torch.float32, device=xs.device)
    for k in range(nc):
        y[k] += torch.einsum("ihn,hpn,hi->ihp", c[k], state,
                             torch.exp(cum[k]))
        state = state * torch.exp(cum[k, :, -1])[:, None, None] + add[k]
    return y.reshape(nc * chunk, nh, p)[:t]


def _mamba(cfg, w, i, h, lowp):
    """Layer i's Mamba2 mixer over one sequence, h [T, D] (normed)."""
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    nh = cfg["n_mamba_heads"]
    p = d_in // nh
    t = h.shape[0]
    proj = _mm(h, w["in_proj"][i], lowp)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * g * n, nh], -1)
    kw = w["conv_w"][i].to(torch.float32)                      # [K, C]
    k = kw.shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[j:j + t] * kw[j] for j in range(k))
    xbc = F.silu(conv + w["conv_b"][i].to(torch.float32))
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], -1)
    dt = F.softplus(dt + w["dt_bias"][i].to(torch.float32))   # [T, H]
    a = -torch.exp(w["a_log"][i].to(torch.float32))            # [H]
    per = nh // g
    b = b.reshape(t, g, n).repeat_interleave(per, 1)           # [T, H, N]
    c = c.reshape(t, g, n).repeat_interleave(per, 1)
    xs = xs.reshape(t, nh, p)
    y = _ssd(xs, dt, a, b, c, cfg["chunk_size"])
    y = y + xs * w["d_skip"][i].to(torch.float32)[:, None]
    y = y.reshape(t, d_in) * F.silu(z)
    y = _rmsnorm(y, w["norm"][i], cfg["rms_norm_eps"], g)
    return _mm(y, w["out_proj"][i], lowp)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -(logp.exp() * logp).sum(-1)


def forward(cfg: dict, w: Dict[str, object], tokens: torch.Tensor,
            first: int = 0, lowp: bool = False) -> Dict[str, object]:
    """Logits of one sequence ``tokens`` [T] at positions [first, T):
    ``logits`` [T - first, V] and ``exit_logits``, one [T - first, V]
    tensor an exit head, all float32."""
    eps = cfg["rms_norm_eps"]
    sites = {i: k for k, i in enumerate(cfg["hybrid_layer_ids"])}
    exits = list(cfg.get("exit_layers", ()))
    x0 = w["embed"][tokens].to(torch.float32)
    x = x0
    exit_logits: List[torch.Tensor] = []
    for i in range(cfg["num_hidden_layers"]):
        inp = x
        if i in sites:
            k = sites[i]
            blk = w["blocks"][k % cfg["num_mem_blocks"]]
            inp = x + _site(cfg, blk, w["sites"][k], x, x0, lowp)
        x = x + _mamba(cfg, w, i, _rmsnorm(inp, w["ln"][i], eps), lowp)
        if i + 1 in exits:
            e = w["exit_heads"][exits.index(i + 1)]
            exit_logits.append(_mm(_rmsnorm(x[first:], e["norm"], eps),
                                   e["w"], lowp))
    logits = _mm(_rmsnorm(x[first:], w["final_norm"], eps), w["embed"].t(),
                 lowp)
    return {"logits": logits, "exit_logits": exit_logits}


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
