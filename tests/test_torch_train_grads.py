"""Per-leaf gradients of the port's ``compute_loss`` against
``jax.value_and_grad`` of the reference's, on the same weights (reference
``Model.init`` bridged) and the reference's batches, for the families
beyond granite (tests/test_torch_training.py): deepseek-v3 (MLA, MoE aux
and the MTP loss), zamba2 (Mamba2 SSD and the shared attention, after the
SSD repair), whisper-base (encoder frames, cross-attention) and xlstm-350m
(mLSTM, sLSTM), all at smoke width.

Tolerance: ``GRAD_REL`` = 5e-2 relative L2 per leaf, as in
tests/test_torch_training.py (measured up to 2.9e-2 on deepseek's and
2.5e-2 on whisper's small-norm leaves); losses 3e-4 relative.

Router ties (deepseek): a top-k choice whose router probabilities are
within ``ROUTE_TIE`` of each other may fall either way when the hidden
states are an ulp apart, and a flipped choice moves that token's whole
gradient.  So the reference's choices are recorded (as outputs of its
jitted step) and the port's router takes them, but only where its own
choice differs by a tie, which the test asserts.
"""
import jax
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import InputShape as RefShape
from repro.data import batch_for_model as ref_batch
from repro.models import Model as RefModel
from repro.models import ffn as ref_ffn
from repro.training import train_loop as ref_tl
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model, ffn
from repro_torch.models.common import tree_leaves
from repro_torch.training import TrainConfig, compute_loss

torch.set_num_threads(1)

GRAD_REL = 5e-2
LOSS_RTOL = 3e-4
ROUTE_TIE = 1e-2


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    got = np.zeros_like(want) if got is None else got.float().numpy()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _compare(arch, b, s, monkeypatch=None):
    rcfg = ref_config(arch)
    rm = RefModel(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    rb = ref_batch(rcfg, RefShape("t", s, b, "train"), 3)
    routes = []
    if monkeypatch is not None:
        orig = ref_ffn._route

        def rec(x2d, w, k):
            out = orig(x2d, w, k)
            routes.append(out[1:])
            return out
        monkeypatch.setattr(ref_ffn, "_route", rec)

    def loss_fn(p, batch):
        routes.clear()
        loss, met = ref_tl.compute_loss(rm, p, batch,
                                        tcfg=ref_tl.TrainConfig())
        return loss, (met, list(routes))
    (_, (rmet, rroutes)), rg = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(rp, rb)

    tied = []
    if monkeypatch is not None:
        port_route, calls = ffn._route, iter(rroutes)

        def take_ties(x2d, w, k):
            gates, idx, probs = port_route(x2d, w, k)
            ridx = torch.from_numpy(np.asarray(next(calls)[0]))
            flips = (ridx != idx).any(1).nonzero()[:, 0].tolist()
            for row in flips:
                pr = probs[row].detach()
                gap = (pr[ridx[row].long()] - pr[idx[row].long()]).abs().max()
                assert gap < ROUTE_TIE, (row, ridx[row], idx[row])
            tied.append(len(flips))
            if flips:
                idx = ridx.to(idx.dtype)
                gates = torch.gather(probs, 1, idx.long())
                if k > 1:
                    gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                                min=1e-9)
            return gates, idx, probs
        monkeypatch.setattr(ffn, "_route", take_ties)

    tm = Model(get_config(arch), device="cpu")
    tp = _bridge(rp)
    tb = {k: _bridge(v) for k, v in rb.items()}
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, tmet = compute_loss(tm, tp, tb, tcfg=TrainConfig())
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert set(tmet) == set(rmet)
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k].detach()), float(rmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(flat) == len(tg)
    worst = 0.0
    for (path, want), got in zip(flat, tg):
        err = _rel_l2(got, want)
        worst = max(worst, err)
        assert err <= GRAD_REL, (jax.tree_util.keystr(path), err)
    print(f"{arch}: worst leaf {worst:.3e}; router rows tied {tied}")
    return tmet, dict(zip((jax.tree_util.keystr(p) for p, _ in flat),
                          zip(tg, (w for _, w in flat)))), tied


def test_deepseek_leaf_grads_match_reference(monkeypatch):
    """MLA + MoE: the aux loss and the MTP CE (labels and mask rolled by
    -1) feed the gradient; ``mtp/kind_is_moe`` gets none (a zero)."""
    tmet, grads, tied = _compare("deepseek-v3-671b-smoke", 2, 64,
                                 monkeypatch)
    assert {"aux", "mtp_ce"} <= set(tmet)
    assert len(tied) == 2                    # the MoE layer and MTP's
    got, want = grads["['mtp']['kind_is_moe']"]
    assert got is None and float(want) == 0.0


def test_zamba2_leaf_grads_match_reference():
    _compare("zamba2-1.2b-smoke", 2, 64)


def test_whisper_leaf_grads_match_reference():
    """The batch carries encoder frames; the decoder's cross-attention
    runs the unmasked Function both ways."""
    _compare("whisper-base-smoke", 2, 32)


def test_xlstm_leaf_grads_match_reference():
    _compare("xlstm-350m-smoke", 2, 64)
