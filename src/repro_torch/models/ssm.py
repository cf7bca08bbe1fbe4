"""Mamba2 (SSD: state-space duality) layer, as the reference computes it.

Grouped B/C (``ssm.n_groups`` G, Zamba2-7B's 2): head h reads group
h // (H / G), and the gated RMSNorm normalizes each group of d_inner / G
channels on its own; G = 1 is the reference's single group.

Chunked-scan formulation [arXiv:2405.21060]: the sequence is split into
chunks of Q tokens.  Within a chunk the recurrence is evaluated in its
quadratic "attention" dual (matmuls, decays via masked segment sums);
across chunks a short loop carries the [H, P, N] state.  Decode is the
O(1) recurrent state update per token.

The reference computes these outside any Pallas kernel, so they run here
as plain PyTorch ops.  Its three-operand einsums are split into two
products; torch contracts them in another order than XLA, which moves
fp32 rounding (``tests/test_torch_hybrid.py`` states the tolerance).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Leaf, group_rmsnorm, scaled_init


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return (d_in, max(1, d_in // s.head_dim),
            d_in + 2 * s.n_groups * s.state_size)


def init_mamba2(cfg):
    """Leaf specs of one Mamba2 mixer (``Model.init`` makes them)."""
    d, s = cfg.d_model, cfg.ssm
    d_in, n_heads, conv_ch = _dims(cfg)
    return {
        # order: [z | x | B | C | dt]
        "in_proj": scaled_init(
            (d, 2 * d_in + 2 * s.n_groups * s.state_size + n_heads), d),
        "conv_w": scaled_init((s.conv_width, conv_ch), s.conv_width),
        "conv_b": Leaf((conv_ch,), fill=0.0),
        "a_log": Leaf((n_heads,), fill=0.0),       # A = -exp(a_log) = -1
        "d_skip": Leaf((n_heads,), fill=1.0),
        "dt_bias": Leaf((n_heads,), fill=0.0),
        "norm": Leaf((d_in,), fill=1.0),
        "out_proj": scaled_init((d_in, d), d_in),
    }


def _split_in_proj(cfg, proj):
    s = cfg.ssm
    d_in, n_heads, _ = _dims(cfg)
    gn = s.n_groups * s.state_size
    z, xin, b, c, dt = torch.split(proj, [d_in, d_in, gn, gn, n_heads],
                                   dim=-1)
    return z, xin, b, c, dt, d_in, n_heads


def _per_head(t, groups: int, heads: int):
    """B or C [..., G * N] -> [..., H, N]: head h reads group
    h // (H / G)."""
    t = t.reshape(*t.shape[:-1], groups, t.shape[-1] // groups)
    return t.repeat_interleave(heads // groups, -2)


def _causal_conv(u, w, bias):
    """Depthwise causal conv.  u [B, S, C], w [K, C]: fp32 accumulation
    in the reference's order, then silu, then a cast to u's dtype."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(k):
        out = out + pad[:, i: i + u.shape[1]].float() * w[i].float()
    return F.silu(out + bias.float()).to(u.dtype)


def _segsum(log_a):
    """log_a [..., Q] -> decay exponents [..., Q, Q], L[i, j] = sum over
    j < k <= i of log_a.  The difference of cumsums is taken before the
    mask, so it stays finite and no inf - inf makes a NaN."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=log_a.device))
    return dif.masked_fill(~mask, float("-inf"))


def _gate_norm_out(cfg, params, y, z, x_dtype):
    """y * silu(z) in the input dtype, RMSNorm over each of the
    ``n_groups`` groups of channels, then the out projection."""
    y = group_rmsnorm(y * F.silu(z.float()).to(x_dtype), params["norm"],
                      cfg.ssm.n_groups)
    return torch.matmul(y, params["out_proj"].to(x_dtype))


def mamba2_forward(cfg, params, x, state=None):
    """Full-sequence SSD.  x [B, S, D] -> (y [B, S, D], final state
    [B, H, P, N] fp32).  ``S`` must be a multiple of the chunk (or under
    it), as in the reference: nothing is padded."""
    s = cfg.ssm
    b_sz, seq, _ = x.shape
    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xin, bb, cc, dt, d_in, h = _split_in_proj(cfg, proj)
    conv_out = _causal_conv(torch.cat([xin, bb, cc], dim=-1),
                            params["conv_w"], params["conv_b"])
    g, gn = s.n_groups, s.n_groups * s.state_size
    xin, bb, cc = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    p, n = s.head_dim, s.state_size
    xh = xin.reshape(b_sz, seq, h, p).float()
    dt = F.softplus(dt.float() + params["dt_bias"])            # [B, S, H]
    log_a = dt * -torch.exp(params["a_log"])                   # [B, S, H]

    q = min(s.chunk_size, seq)
    nc = max(1, seq // q)
    assert nc * q == seq, f"seq {seq} not divisible by chunk {q}"
    xc = xh.reshape(b_sz, nc, q, h, p)
    lac = log_a.reshape(b_sz, nc, q, h)
    if g == 1:          # one group: B and C broadcast over the heads
        bc = bb.float().reshape(b_sz, nc, q, n)
        ccg = cc.float().reshape(b_sz, nc, q, n)
        eqs = ("bcin,bcjn->bcij", "bcjhp,bcjn->bchpn", "bcin,bchpn->bcihp")
    else:               # head h reads group h // (H / G): [B,nc,Q,H,N]
        bc = _per_head(bb.float().reshape(b_sz, nc, q, g * n), g, h)
        ccg = _per_head(cc.float().reshape(b_sz, nc, q, g * n), g, h)
        eqs = ("bcihn,bcjhn->bchij", "bcjhp,bcjhn->bchpn",
               "bcihn,bchpn->bcihp")
    dtx = xc * dt.reshape(b_sz, nc, q, h)[..., None]           # [B,nc,Q,H,P]

    # intra-chunk (quadratic dual): scores x decays, then the values
    lmat = torch.exp(_segsum(lac.transpose(-1, -2)))           # [B,nc,H,Q,Q]
    scores = torch.einsum(eqs[0], ccg, bc)       # [B,nc,Q,Q] / [B,nc,H,Q,Q]
    # out of place: exp's backward reads lmat
    lmat = lmat * (scores[:, :, None] if g == 1 else scores)
    y = torch.einsum("bchij,bcjhp->bcihp", lmat, dtx)
    del lmat

    # chunk states and the scan across chunks
    cum = torch.cumsum(lac, dim=2)                             # [B,nc,Q,H]
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    chunk_state = torch.einsum(eqs[1], dtx * decay_to_end[..., None], bc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [B,nc,H]
    st = (torch.zeros((b_sz, h, p, n), dtype=torch.float32, device=x.device)
          if state is None else state)
    init_states = []
    for c in range(nc):
        init_states.append(st)                                 # before chunk
        st = st * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    init_states = torch.stack(init_states, dim=1)              # [B,nc,H,P,N]
    y_inter = torch.einsum(eqs[2], ccg, init_states)
    y = y + y_inter * torch.exp(cum)[..., None]

    y = y.reshape(b_sz, seq, h, p) + xh * params["d_skip"][None, None, :,
                                                           None]
    y = y.reshape(b_sz, seq, d_in).to(x.dtype)
    return _gate_norm_out(cfg, params, y, z, x.dtype), st


def mamba2_decode(cfg, params, x, state, conv_state):
    """One-token decode.  x [B, 1, D]; state [B, H, P, N] fp32;
    conv_state [B, K-1, C].  Returns (y [B, 1, D], new state, new conv
    window); the caller decides which rows store them."""
    s = cfg.ssm
    b_sz = x.shape[0]
    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xin, bb, cc, dt, d_in, h = _split_in_proj(cfg, proj)
    window = torch.cat([conv_state, torch.cat([xin, bb, cc], dim=-1)],
                       dim=1)                                  # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float()) + params["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :].to(x.dtype)
    g, gn = s.n_groups, s.n_groups * s.state_size
    xin, bb, cc = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    xh = xin.reshape(b_sz, h, s.head_dim).float()
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])     # [B, H]
    decay = torch.exp(dt * -torch.exp(params["a_log"]))
    bbf = bb[:, 0].float()                                     # [B, G*N]
    ccf = cc[:, 0].float()
    if g == 1:
        state = (state * decay[:, :, None, None]
                 + (dt[:, :, None] * xh)[..., None] * bbf[:, None, None, :])
        y = torch.einsum("bn,bhpn->bhp", ccf, state)
    else:               # head h reads group h // (H / G): [B, H, N]
        bh, ch = _per_head(bbf, g, h), _per_head(ccf, g, h)
        state = (state * decay[:, :, None, None]
                 + (dt[:, :, None] * xh)[..., None] * bh[:, :, None, :])
        y = torch.einsum("bhn,bhpn->bhp", ch, state)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(b_sz, 1, d_in).to(x.dtype)
    return (_gate_norm_out(cfg, params, y, z, x.dtype), state,
            window[:, 1:])


def init_mamba2_state(cfg, batch: int, device="cpu"):
    """Zero (state [B, H, P, N] fp32, conv window [B, K-1, C] bf16)."""
    s = cfg.ssm
    _, n_heads, conv_ch = _dims(cfg)
    return (torch.zeros((batch, n_heads, s.head_dim, s.state_size),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, s.conv_width - 1, conv_ch),
                        dtype=torch.bfloat16, device=device))
