"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential recurrence) [arXiv:2405.04517], as the reference
computes them.

The mLSTM parallel dual is evaluated chunk-wise like the Mamba2 SSD path:
products within chunks, then a short loop across chunks carrying the
[H, P, P] matrix memory and the [H, P] normalizer.  The sLSTM recurrence
is sequential (recurrent weights R on h_{t-1}) and runs as a Python loop
over time.  Gates follow the reference's stabilized formulation: sigmoid
forget gate, exponential input gate with max-stabilizer m (sLSTM); the
chunked mLSTM uses a sigmoid f and a sigmoid-scaled i.

The reference computes these outside any Pallas kernel, so they run here
as plain PyTorch ops.  Its three-operand einsums are split into two
products, contracting the shared index first: a single call could build
[B, nc, Q, H, P, P] at full width.  Casts follow the reference's, so
greedy tokens can match (``tests/test_torch_xlstm.py`` states the
tolerances).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import Leaf, rmsnorm, scaled_init


def _dims(cfg):
    d = cfg.d_model
    d_in = int(cfg.ssm.proj_factor * d)
    h = cfg.num_heads
    p = d_in // h
    return d, d_in, h, p


def _gate_norm_down(params, y, z, x_dtype):
    """y * silu(z) in the input dtype (silu in fp32), RMSNorm, then the
    down projection."""
    y = rmsnorm(y * F.silu(z.float()).to(x_dtype), params["norm"])
    return torch.matmul(y, params["down"].to(x_dtype))


def _up(params, x):
    """The block's up projection, split into the cell input and the gate
    branch z."""
    up = torch.matmul(x, params["up"].to(x.dtype))
    return torch.chunk(up, 2, dim=-1)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg):
    """Leaf specs of one mLSTM cell (``Model.init`` makes them)."""
    d, d_in, h, p = _dims(cfg)
    return {
        "up": scaled_init((d, 2 * d_in), d),           # x, z (gate)
        "wq": scaled_init((d_in, d_in), d_in),
        "wk": scaled_init((d_in, d_in), d_in),
        "wv": scaled_init((d_in, d_in), d_in),
        "wi": scaled_init((d_in, h), d_in),
        "wf": scaled_init((d_in, h), d_in),
        "fb": Leaf((h,), fill=3.0),                    # forget-gate bias
        "norm": Leaf((d_in,), fill=1.0),
        "down": scaled_init((d_in, d), d_in),
    }


def _mlstm_qkvif(cfg, params, xs):
    """q, k, v [B, S, H, P] in xs's dtype (k over sqrt(P), divided in that
    dtype as the reference does), i and f [B, S, H] fp32.  The divisor is
    a device tensor made by a fill (capturable in a CUDA graph, and a true
    division: a host scalar divisor may become a reciprocal product)."""
    d, d_in, h, p = _dims(cfg)
    b, s, _ = xs.shape
    dt = xs.dtype
    q = torch.matmul(xs, params["wq"].to(dt)).reshape(b, s, h, p)
    k = torch.matmul(xs, params["wk"].to(dt)).reshape(b, s, h, p) \
        / torch.full((), math.sqrt(float(p)), dtype=dt, device=xs.device)
    v = torch.matmul(xs, params["wv"].to(dt)).reshape(b, s, h, p)
    i = torch.sigmoid(torch.matmul(xs, params["wi"].to(dt)).float())
    f = torch.sigmoid(torch.matmul(xs, params["wf"].to(dt)).float()
                      + params["fb"])
    return q, k, v, i, f


def mlstm_forward(cfg, params, x, state=None):
    """Chunk-parallel mLSTM.  x [B, S, D] -> (y [B, S, D], final state
    (C [B, H, P, P], n [B, H, P]) fp32).  ``S`` must be a multiple of the
    chunk (or under it), as in the reference: nothing is padded."""
    d, d_in, h, p = _dims(cfg)
    b, s, _ = x.shape
    xs, z = _up(params, x)
    q, k, v, i, f = _mlstm_qkvif(cfg, params, xs)

    qf = min(cfg.ssm.chunk_size, s)
    nc = max(1, s // qf)
    assert nc * qf == s, f"seq {s} not divisible by chunk {qf}"
    qc = q.reshape(b, nc, qf, h, p).float()
    kc = k.reshape(b, nc, qf, h, p).float()
    vc = v.reshape(b, nc, qf, h, p).float()
    ic = i.reshape(b, nc, qf, h)
    log_f = torch.log(f + 1e-9).reshape(b, nc, qf, h)

    # intra-chunk: D[i, j] = prod_{j<t<=i} f_t * i_j.  Above the diagonal
    # dif > 0 and exp could overflow, so the mask comes before the
    # exponent: no inf ever meets a 0
    cum = torch.cumsum(log_f, dim=2)
    dif = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,Qi,Qj,H]
    mask = torch.tril(torch.ones((qf, qf), dtype=torch.bool,
                                 device=x.device))
    dec = torch.exp(dif.masked_fill(~mask[None, None, :, :, None],
                                    float("-inf")))
    scores = torch.einsum("bcihp,bcjhp->bcijh", qc, kc)
    w = scores * dec * ic[:, :, None, :, :]
    del dif, dec, scores
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, vc)
    # intra normalizer: q_i . (sum_j dec_ij i_j k_j) == sum_j w_ij
    nq_intra = torch.sum(w, dim=3)                          # [B,nc,Q,H]
    del w

    # chunk state contributions (k weighted first, then the outer product)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # [B,nc,Q,H]
    kw = kc * (decay_to_end * ic)[..., None]
    c_state = torch.einsum("bcjhk,bcjhv->bchkv", kw, vc)    # [B,nc,H,P,P]
    n_state = torch.sum(kw, dim=2)                          # [B,nc,H,P]
    c_decay = torch.exp(cum[:, :, -1, :])                   # [B,nc,H]

    if state is None:
        cmem = torch.zeros((b, h, p, p), dtype=torch.float32, device=x.device)
        nmem = torch.zeros((b, h, p), dtype=torch.float32, device=x.device)
    else:
        cmem, nmem = state
    c_init, n_init = [], []
    cm, nm = cmem, nmem
    for c in range(nc):                                     # lax.scan
        c_init.append(cm)                                   # before chunk
        n_init.append(nm)
        cm = cm * c_decay[:, c, :, None, None] + c_state[:, c]
        nm = nm * c_decay[:, c, :, None] + n_state[:, c]
    del c_state
    c_init = torch.stack(c_init, dim=1)                     # [B,nc,H,P,P]
    n_init = torch.stack(n_init, dim=1)                     # [B,nc,H,P]

    decay_from_start = torch.exp(cum)                       # [B,nc,Q,H]
    y_inter = torch.einsum("bcihk,bchkv->bcihv", qc, c_init) \
        * decay_from_start[..., None]
    n_inter = torch.einsum("bcihk,bchk->bcih", qc, n_init) * decay_from_start

    y_all = y_intra + y_inter                               # [B,nc,Q,H,P]
    nq = nq_intra + n_inter
    denom = torch.clamp(torch.abs(nq), min=1.0)[..., None]
    yv = (y_all / denom).reshape(b, s, d_in).to(x.dtype)
    return _gate_norm_down(params, yv, z, x.dtype), (cm, nm)


def mlstm_decode(cfg, params, x, state):
    """One-token mLSTM decode.  x [B, 1, D]; state = (C [B, H, P, P],
    n [B, H, P]) fp32.  Returns (y [B, 1, D], (C, n)): new tensors; the
    caller decides which rows store them."""
    d, d_in, h, p = _dims(cfg)
    b = x.shape[0]
    xs, z = _up(params, x)
    q, k, v, i, f = _mlstm_qkvif(cfg, params, xs)
    qf = q[:, 0].float()                                    # [B,H,P]
    kf = k[:, 0].float()
    vf = v[:, 0].float()
    i0, f0 = i[:, 0], f[:, 0]                               # [B,H]
    cmem, nmem = state
    cmem = cmem * f0[:, :, None, None] \
        + i0[:, :, None, None] * (kf[..., :, None] * vf[..., None, :])
    nmem = nmem * f0[:, :, None] + i0[:, :, None] * kf
    y = torch.einsum("bhk,bhkv->bhv", qf, cmem)
    denom = torch.clamp(torch.abs(torch.sum(qf * nmem, dim=-1)), min=1.0)
    y = (y / denom[:, :, None]).reshape(b, 1, d_in).to(x.dtype)
    return _gate_norm_down(params, y, z, x.dtype), (cmem, nmem)


def init_mlstm_state(cfg, batch: int, device="cpu"):
    """Zero (C [B, H, P, P], n [B, H, P]) fp32."""
    _, _, h, p = _dims(cfg)
    return (torch.zeros((batch, h, p, p), dtype=torch.float32, device=device),
            torch.zeros((batch, h, p), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(cfg):
    """Leaf specs of one sLSTM cell (``Model.init`` makes them)."""
    d, d_in, h, p = _dims(cfg)
    return {
        "up": scaled_init((d, 2 * d_in), d),
        "wz": scaled_init((d_in, d_in), d_in),
        "wi": scaled_init((d_in, d_in), d_in),
        "wf": scaled_init((d_in, d_in), d_in),
        "wo": scaled_init((d_in, d_in), d_in),
        # block-diagonal recurrent weights, per head [H, P, P]
        "rz": scaled_init((h, p, p), p),
        "ri": scaled_init((h, p, p), p),
        "rf": scaled_init((h, p, p), p),
        "ro": scaled_init((h, p, p), p),
        "fb": Leaf((d_in,), fill=3.0),
        "norm": Leaf((d_in,), fill=1.0),
        "down": scaled_init((d_in, d), d_in),
    }


def _recurrent(params):
    """The four recurrent weights in fp32 (cast once, not every step)."""
    return tuple(params[n].float() for n in ("rz", "ri", "rf", "ro"))


def _slstm_step(rec_w, carry, inp):
    """One sLSTM time step.  carry = (c, n, h, m), each [B, H, P] fp32;
    ``rec_w`` the fp32 (rz, ri, rf, ro).  Returns (new carry, h)."""
    c, n, hprev, m = carry
    xz, xi, xf, xo = inp                                    # [B,H,P] fp32
    rz, ri, rf, ro = rec_w

    def rec(r):
        return torch.einsum("bhp,hpq->bhq", hprev, r)

    zt = torch.tanh(xz + rec(rz))
    it = xi + rec(ri)
    ft = xf + rec(rf)
    ot = torch.sigmoid(xo + rec(ro))
    m_new = torch.maximum(ft + m, it)                       # stabilizer
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    hv = ot * c / torch.clamp(n, min=1.0)
    return (c, n, hv, m_new), hv


def _slstm_inputs(params, xs):
    """The four gate pre-activations from the cell input, fp32 (the
    forget gate's bias added)."""
    dt = xs.dtype
    xz = torch.matmul(xs, params["wz"].to(dt)).float()
    xi = torch.matmul(xs, params["wi"].to(dt)).float()
    xf = torch.matmul(xs, params["wf"].to(dt)).float() + params["fb"]
    xo = torch.matmul(xs, params["wo"].to(dt)).float()
    return xz, xi, xf, xo


def slstm_forward(cfg, params, x, state=None):
    """The sLSTM over the full sequence, a loop over time.  x [B, S, D]
    -> (y [B, S, D], final (c, n, h, m))."""
    d, d_in, h, p = _dims(cfg)
    b, s, _ = x.shape
    xs, z = _up(params, x)
    gates = [g.reshape(b, s, h, p) for g in _slstm_inputs(params, xs)]
    carry = init_slstm_state(cfg, b, x.device) if state is None else state
    rec_w = _recurrent(params)
    ys = []
    for t in range(s):
        carry, hv = _slstm_step(rec_w, carry, tuple(g[:, t] for g in gates))
        ys.append(hv)
    ys = torch.stack(ys, dim=1).reshape(b, s, d_in).to(x.dtype)
    return _gate_norm_down(params, ys, z, x.dtype), carry


def slstm_decode(cfg, params, x, state):
    """One-token sLSTM decode.  x [B, 1, D]; state (c, n, h, m) [B, H, P]
    fp32.  Returns (y [B, 1, D], new state); the caller decides which rows
    store it."""
    d, d_in, h, p = _dims(cfg)
    b = x.shape[0]
    xs, z = _up(params, x)
    gates = tuple(g.reshape(b, h, p)
                  for g in _slstm_inputs(params, xs[:, 0]))
    state, hv = _slstm_step(_recurrent(params), state, gates)
    ys = hv.reshape(b, 1, d_in).to(x.dtype)
    return _gate_norm_down(params, ys, z, x.dtype), state


def init_slstm_state(cfg, batch: int, device="cpu"):
    """Zero (c, n, h, m) [B, H, P] fp32: four distinct tensors (the
    reference returns one array four times, harmless there; the port
    stores state rows in place, so shared storage would alias them)."""
    _, _, h, p = _dims(cfg)
    return tuple(torch.zeros((batch, h, p), dtype=torch.float32,
                             device=device) for _ in range(4))
