"""The full-sequence forward of the port (``Model.forward``, DeepSeek-V3's
MTP head, ``resilient_forward``, ``softmax_cross_entropy``) against the
reference package on the same weights (reference ``Model.init`` bridged
to torch), on the CPU, where the self-attention runs the flash kernel's
plain version.

Tolerances.  The two packages round in different places: XLA keeps a
fused elementwise chain (the FFN's silu(a) * b) in fp32 and rounds once,
eager torch rounds after each op, so about half of a layer's bf16 outputs
are an ulp apart.  Final and MTP logits atol 2e-2 (read through the tied
embedding, std 0.02, as tests/test_torch_model.py holds decode logits);
exit logits atol 4e-2 (the exit head's W has std D^-1/2 = 1/16, so the
same hidden-state differences move them about three times as far); the
final hidden state atol 5e-2 (bf16 after the final norm: a few ulps of
2^-7 at unit scale); aux loss and cross entropy 1e-4 (fp32 from the same
routing); the forward against the port's own decode replay 0.1, the bound
the reference holds its own pair to (tests/test_model_units.py).

Router ties, as tests/test_torch_deepseek.py: every router call of both
packages is recorded, and a choice that differs must be a tie of the
reference's probabilities (within ``ROUTE_TIE``).  A flipped row also
moves the capacity order of the rows after it, so every row whose routing
or whose kept assignments differ is left out of that layer's outputs; the
MoE layer is the smoke model's last, so the final logits differ only in
those rows, while the MTP block attends over the sequence and leaves out
every later position of that sequence too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import resilience as ref_res
from repro.models import Model as RefModel
from repro.models import common as ref_common
from repro.models import ffn as ref_ffn
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import resilience
from repro_torch.models import Model, ffn
from repro_torch.models.common import softmax_cross_entropy

ATOL = 2e-2
EXIT_ATOL = 4e-2
HID_ATOL = 5e-2
AUX_ATOL = 1e-4
ROUTE_TIE = 1e-2
S_GRANITE = 96        # past the smoke model's 64-token long-mode window;
                      # one shape, so the reference's eager ops compile once


def _pair(arch, seed=0):
    rc, tc = ref_config(arch), get_config(arch)
    rm = RefModel(rc)
    rp = rm.init(jax.random.PRNGKey(seed))
    tm = Model(tc, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    return rm, rp, tm, tp


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-3-2b-smoke")


@pytest.fixture(scope="module")
def deepseek():
    return _pair("deepseek-v3-671b-smoke")


def _tokens(vocab, b, s, seed=1):
    toks = np.random.RandomState(seed).randint(0, vocab, (b, s))
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _close(got, want, atol=ATOL, rows=None):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("long_mode", [False, True])
def test_granite_forward_matches_reference(granite, long_mode):
    """Logits, exit logits, aux and hidden state; ``long_mode`` attends
    through the 64-token window at S 96."""
    rm, rp, tm, tp = granite
    jb, tb = _tokens(tm.cfg.vocab_size, 2, S_GRANITE)
    want = rm.forward(rp, jb, long_mode=long_mode)
    got = tm.forward(tp, tb, long_mode=long_mode)
    assert got.logits.shape == (2, S_GRANITE, tm.cfg.vocab_size)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden, atol=HID_ATOL)
    assert len(got.exit_logits) == len(want.exit_logits) == 1
    _close(got.exit_logits[0], want.exit_logits[0], atol=EXIT_ATOL)
    assert float(got.aux_loss) == float(want.aux_loss) == 0.0
    assert got.mtp_logits is None and want.mtp_logits is None


def test_forward_honours_given_positions(granite):
    rm, rp, tm, tp = granite
    jb, tb = _tokens(tm.cfg.vocab_size, 2, S_GRANITE)
    pos = np.tile(np.arange(S_GRANITE) + 7, (2, 1)).astype(np.int32)
    want = rm.forward(rp, {**jb, "positions": jnp.asarray(pos)}).logits
    got = tm.forward(tp, {**tb, "positions": torch.from_numpy(pos)}).logits
    _close(got, want)
    assert not np.allclose(got.numpy(), tm.forward(tp, tb).logits.numpy())


class Routes:
    """Every router call of both packages: (idx [T,k], probs [T,E])."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        ref_route, port_route = ref_ffn._route, ffn._route

        def rec_ref(x2d, w, k):
            out = ref_route(x2d, w, k)
            self.ref.append((np.asarray(out[1]), np.asarray(out[2])))
            return out

        def rec_port(x2d, w, k):
            out = port_route(x2d, w, k)
            self.port.append((out[1].numpy(), out[2].numpy()))
            return out
        monkeypatch.setattr(ref_ffn, "_route", rec_ref)
        monkeypatch.setattr(ffn, "_route", rec_port)

    def excused(self, call, cfg):
        """Token rows of router call ``call`` whose routing or kept
        assignments differ; asserts each routing difference is a tie."""
        (ri, rp), (ti, _) = self.ref[call], self.port[call]
        flips = np.nonzero((ri != ti).any(1))[0]
        for row in flips:
            gap = np.abs(rp[row][ri[row]] - rp[row][ti[row]]).max()
            assert gap < ROUTE_TIE, (call, row, ri[row], ti[row], rp[row])
        m = cfg.moe
        cap = ffn._capacity(ri.shape[0], m.num_experts, m.top_k,
                            m.capacity_factor)
        kept = [ffn._slots(torch.from_numpy(i.astype(np.int32)), 0,
                           m.num_experts, cap)[1].numpy() for i in (ri, ti)]
        moved = np.nonzero((kept[0] != kept[1]).any(1))[0]
        assert not len(moved) or len(flips), "kept rows moved without a tie"
        return sorted(set(flips) | set(moved))


def test_deepseek_forward_matches_reference(deepseek, monkeypatch):
    """MLA + MoE forward with capacity drops, and the MTP head."""
    rm, rp, tm, tp = deepseek
    b, s = 2, 32
    jb, tb = _tokens(tm.cfg.vocab_size, b, s)
    routes = Routes(monkeypatch)
    want = rm.forward(rp, jb)
    got = tm.forward(tp, tb)
    # router calls: the MoE layer, then the MTP block's MoE layer
    assert len(routes.ref) == len(routes.port) == 2
    main = routes.excused(0, tm.cfg)
    mtp = routes.excused(1, tm.cfg)
    cap = ffn._capacity(b * s, 4, 2, tm.cfg.moe.capacity_factor)
    counts = np.bincount(routes.ref[0][0].ravel(), minlength=4)
    print(f"capacity {cap}, assignments per expert {counts.tolist()}, "
          f"rows excused: main {main}, mtp {mtp}")
    keep = np.ones((b, s), bool)
    keep.reshape(-1)[main] = False
    _close(got.logits, want.logits, rows=keep)
    _close(got.hidden, want.hidden, rows=keep, atol=HID_ATOL)
    _close(got.exit_logits[0], want.exit_logits[0], atol=EXIT_ATOL)
    keep_mtp = keep.copy()
    for row in main:                     # the MTP block attends onwards
        keep_mtp[row // s, row % s:] = False
    keep_mtp.reshape(-1)[mtp] = False
    assert got.mtp_logits.shape == (b, s, tm.cfg.vocab_size)
    _close(got.mtp_logits, want.mtp_logits, rows=keep_mtp)
    assert keep_mtp.sum() >= s // 2
    # aux: the reference's router probabilities under the port's choices
    (_, rprobs), (tidx, _) = routes.ref[0], routes.port[0]
    want_aux = ffn._aux_loss(torch.tensor(rprobs), torch.tensor(tidx),
                             tm.cfg.moe.num_experts)
    np.testing.assert_allclose(float(got.aux_loss), float(want_aux), rtol=0,
                               atol=AUX_ATOL)
    if not main:
        np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                                   rtol=0, atol=AUX_ATOL)


def test_mtp_wraps_the_last_position(deepseek):
    """The MTP input at the last position takes the FIRST token's
    embedding (the reference's roll wraps around): changing token 0 moves
    the last position's MTP logits, and nothing else of the forward."""
    _, _, tm, tp = deepseek
    _, tb = _tokens(tm.cfg.vocab_size, 1, 12)
    other = tb["tokens"].clone()
    other[0, 0] = (other[0, 0] + 1) % tm.cfg.vocab_size
    a = tm.forward(tp, tb).mtp_logits
    bb = tm.forward(tp, {"tokens": other}).mtp_logits
    assert (a[0, -1] - bb[0, -1]).abs().max() > 1e-3


def test_mtp_params_bridge_leaf_for_leaf(deepseek):
    rm, rp, tm, tp = deepseek
    assert set(tp["mtp"]) == set(rp["mtp"]) == {"combine", "norm",
                                                "kind_is_moe", "layer"}
    assert float(tp["mtp"]["kind_is_moe"]) == 1.0
    np.testing.assert_array_equal(
        tp["mtp"]["combine"].view(torch.int16).numpy(),
        np.asarray(rp["mtp"]["combine"]).view(np.int16))


@pytest.mark.parametrize("dead", ["none", "first", "all"])
def test_resilient_forward_matches_reference(granite, dead):
    rm, rp, tm, tp = granite
    n = resilience.n_scan_blocks(tm)
    assert n == ref_res.n_scan_blocks(rm) == 2
    alive = np.ones(n, np.float32)
    if dead == "first":
        alive[0] = 0.0
    elif dead == "all":
        alive[:] = 0.0
    jb, tb = _tokens(tm.cfg.vocab_size, 2, S_GRANITE)
    want, want_ee = ref_res.resilient_forward(rm, rp, jb, jnp.asarray(alive))
    got, got_ee = resilience.resilient_forward(tm, tp, tb,
                                               torch.from_numpy(alive))
    _close(got, want)
    _close(got_ee[0], want_ee[0], atol=EXIT_ATOL)
    full = tm.forward(tp, tb)
    if dead == "none":
        _close(got, full.logits, atol=1e-3)
        _close(got_ee[0], full.exit_logits[0], atol=1e-3)
    else:
        assert torch.isfinite(got).all()
        assert (got - full.logits).abs().max() > 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_reference(masked):
    rs = np.random.RandomState(5)
    logits = (rs.randn(2, 7, 50) * 3).astype(np.float32)
    labels = rs.randint(0, 50, (2, 7))
    mask = (rs.rand(2, 7) > 0.4).astype(np.float32) if masked else None
    want = ref_common.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask) > 0)
    np.testing.assert_allclose(float(got), float(want), rtol=0,
                               atol=AUX_ATOL)


@pytest.mark.parametrize("arch", ["granite-3-2b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_forward_matches_own_decode_replay(arch):
    """The forward and the port's token-by-token replay through
    ``decode_step`` (a separate path) agree within the reference's bound;
    MoE at a capacity that drops nothing in the batched forward, as the
    reference's own test runs it."""
    cfg = get_config(arch)
    if cfg.moe.num_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    m = Model(cfg, device="cpu")
    params = m.init(0)
    _, tb = _tokens(cfg.vocab_size, 2, 16)
    fwd = m.forward(params, tb).logits
    replay, _ = m.prefill(params, tb)
    np.testing.assert_allclose(fwd.numpy(), replay.numpy(), rtol=0.1,
                               atol=0.1)
