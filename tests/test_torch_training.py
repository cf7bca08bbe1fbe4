"""The port's training path against the reference package on the CPU, on
the same weights (reference ``Model.init`` bridged) and the reference's
batches: granite-3-2b-smoke's per-leaf gradients of ``compute_loss``,
``apply_updates`` on identical gradients, ``lr_at``, three
``train_step``s (also microbatched) and the failout loss.

Tolerances (PERF.md §2).  Gradients: a relative L2 error per leaf of
``GRAD_REL`` = 5e-2.  The two packages round bf16 activations in
different places (XLA keeps fused elementwise chains in fp32), which
moves a forward's outputs by about an ulp (tests/test_torch_forward.py);
the backward compounds that through every layer, and measured errors
reach 1.2e-2 on granite and 2.5e-2 on whisper's small-norm leaves.
Losses and CE metrics: 3e-4 relative (fp32 means of ~7-9 over bf16
logits an ulp or two apart; measured up to 1.4e-4).  The
optimizer on identical gradients: bf16 params within one bf16 ulp (the
update is fp32 then rounded once; its fp32 inputs differ only in their
last bits), fp32 params, m and v within 1e-5 of each leaf's largest
magnitude: the global norm sums ~1.8M squares in another order (about
1e-6 apart), its clip scale enters v squared, and m cancels where a
step's gradient opposes the last.  ``lr_at`` is exact wherever no cosine
is taken and within 1e-6 relative on the cosine segment: XLA's and
PyTorch's fp32 cos differ in the last bit for a few per cent of inputs,
and 1 + cos cancels near the end of the schedule.  Train-step losses:
1e-3 relative per step, since the params after each step are within the
optimizer's rounding of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import InputShape as RefShape
from repro.data import batch_for_model as ref_batch
from repro.models import Model as RefModel
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_tl
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.resilience import failout
from repro_torch.models import Model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training import (OptimizerConfig, TrainConfig,
                                  apply_updates, compute_loss,
                                  init_optimizer, lr_at, make_train_step)
from repro_torch.training import train_loop

torch.set_num_threads(1)

GRAD_REL = 5e-2
LOSS_RTOL = 3e-4
LR_RTOL = 1e-6
STEP_RTOL = 1e-3
FP32_RTOL = 1e-5
ARCH = "granite-3-2b-smoke"


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def granite():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    return rm, rp, Model(get_config(ARCH), device="cpu")


def _batch(step, b=2, s=64, arch=ARCH):
    rb = ref_batch(ref_config(arch), RefShape("t", s, b, "train"), step)
    return rb, {k: _bridge(v) for k, v in rb.items()}


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    got = (np.zeros_like(want) if got is None
           else got.float().numpy())
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _port_grads(tm, tp, tb, tcfg, generator=None):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = compute_loss(tm, tp, tb, tcfg=tcfg, generator=generator)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss, metrics, grads


def _ref_grads(rm, rp, rb, tcfg, rng=None):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tl.compute_loss(rm, p, b, tcfg=tcfg, rng=rng),
        has_aux=True))
    (loss, metrics), grads = fn(rp, rb)
    return loss, metrics, grads


def test_granite_leaf_grads_match_reference(granite):
    """The BranchyNet joint loss (final CE + 0.3 x the exit's CE) and
    every leaf's gradient, the attention's through the Function's
    backward."""
    rm, rp, tm = granite
    tp = _bridge(rp)
    rb, tb = _batch(3)
    rl, rmet, rg = _ref_grads(rm, rp, rb, ref_tl.TrainConfig())
    tl, tmet, tg = _port_grads(tm, tp, tb, TrainConfig())
    assert set(tmet) == set(rmet) == {"ce", "exit0_ce", "aux", "loss"}
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(flat) == len(tg)
    for (path, want), got in zip(flat, tg):
        assert got is not None and got.dtype == getattr(
            torch, str(np.asarray(want).dtype)), path
        assert _rel_l2(got, want) <= GRAD_REL, (jax.tree_util.keystr(path),
                                                _rel_l2(got, want))


def _ulp_bf16(x):
    x = np.abs(np.asarray(x, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


def test_optimizer_matches_reference_on_identical_grads(granite):
    """Two AdamW steps (clipping active in the first) with the same
    gradients handed to both packages."""
    rm, rp, _ = granite
    tp = _bridge(rp)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    rcfg = ref_opt.OptimizerConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    rstate, tstate = ref_opt.init_optimizer(rp), init_optimizer(tp)
    rs = np.random.RandomState(0)
    for step, amp in ((1, 3.0), (2, 0.01)):
        leaves = jax.tree.leaves(rp)
        gs = [(amp * rs.randn(*np.shape(a))).astype(np.float32)
              for a in leaves]
        rgrads = jax.tree.unflatten(
            jax.tree.structure(rp),
            [jnp.asarray(g).astype(a.dtype) for g, a in zip(gs, leaves)])
        tgrads = _bridge(rgrads)
        rp, rstate, rmet = ref_opt.apply_updates(rcfg, rp, rgrads, rstate)
        tp, tstate, tmet = apply_updates(ocfg, tp, tgrads, tstate)
        assert int(tstate["step"]) == int(rstate["step"]) == step
        assert float(tmet["lr"]) == float(rmet["lr"])
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=FP32_RTOL)
        for want, got in zip(jax.tree.leaves(rp), tree_leaves(tp)):
            want = np.asarray(want)
            got = got.float().numpy()
            if want.dtype.name == "bfloat16":
                want = want.astype(np.float32)
                assert (np.abs(got - want) <= _ulp_bf16(want)).all()
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=FP32_RTOL * np.abs(want).max())
        for key in ("m", "v"):
            for want, got in zip(jax.tree.leaves(rstate[key]),
                                 tree_leaves(tstate[key])):
                want = np.asarray(want)
                assert got.dtype == torch.float32
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=FP32_RTOL * np.abs(want).max())


def test_none_grad_is_a_zero_grad(granite):
    """A leaf autograd leaves without a gradient updates as a zero
    gradient: its moments decay, and it moves only by weight decay."""
    _, rp, _ = granite
    tp = _bridge(rp)
    state = init_optimizer(tp)
    grads = tree_map(lambda p: None, tp)
    before = [p.clone() for p in tree_leaves(tp)]
    tp, state, met = apply_updates(OptimizerConfig(lr=1e-2, warmup_steps=0),
                                   tp, grads, state)
    assert float(met["grad_norm"]) == 0.0
    for b, p in zip(before, tree_leaves(tp)):
        if p.ndim < 2:
            assert torch.equal(b, p)


def test_lr_at_matches_reference():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    rcfg = ref_opt.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                   total_steps=100, min_lr_ratio=0.1)
    for s in range(130):
        want = np.float32(ref_opt.lr_at(rcfg, jnp.int32(s)))
        got = lr_at(cfg, torch.tensor(s, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32
        if s < 10 or s >= 100:
            assert got == want, s
        else:
            np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)
    assert float(lr_at(cfg, 0)) == 0.0
    assert abs(float(lr_at(cfg, 10)) - 1e-3) < 1e-9
    assert float(lr_at(cfg, 100)) == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_reference(granite, microbatches):
    rm, rp, tm = granite
    tp = _bridge(rp)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rstep = jax.jit(ref_tl.make_train_step(
        rm, ref_opt.OptimizerConfig(**ocfg),
        ref_tl.TrainConfig(microbatches=microbatches)))
    tstep = make_train_step(tm, OptimizerConfig(**ocfg),
                            TrainConfig(microbatches=microbatches))
    rstate, tstate = ref_opt.init_optimizer(rp), init_optimizer(tp)
    for i in range(3):
        rb, tb = _batch(i, b=4)
        rp, rstate, rmet = rstep(rp, rstate, rb, jax.random.PRNGKey(i))
        tp, tstate, tmet = tstep(tp, tstate, tb,
                                 torch.Generator().manual_seed(i))
        assert set(tmet) == set(rmet)
        for k in ("loss", "ce", "exit0_ce", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(rmet[k]),
                                       rtol=STEP_RTOL, err_msg=f"{k} {i}")
        np.testing.assert_allclose(float(tmet["lr"]), float(rmet["lr"]),
                                   rtol=LR_RTOL, atol=0)
    assert all(not p.requires_grad for p in tree_leaves(tp))


def test_exit_helpers_match_reference():
    """``entropy_of``, ``exit_mask`` and ``branchynet_loss_weights``."""
    from repro.core import early_exit as ref_ee
    from repro_torch.core import early_exit
    logits = np.random.RandomState(0).randn(3, 5, 50).astype(np.float32)
    logits[0] *= 20.0                       # peaked rows: low entropy
    want = np.asarray(ref_ee.entropy_of(jnp.asarray(logits)))
    got = early_exit.entropy_of(torch.from_numpy(logits).bfloat16())
    assert got.dtype == torch.float32                 # fp32 from bf16 too
    np.testing.assert_allclose(
        early_exit.entropy_of(torch.from_numpy(logits)).numpy(), want,
        rtol=1e-5, atol=1e-5)
    for thr in (0.2, 0.5, 0.9):
        w = np.asarray(ref_ee.exit_mask(jnp.asarray(logits), thr))
        g = early_exit.exit_mask(torch.from_numpy(logits), thr).numpy()
        assert g.dtype == bool and (g == w).all()
    assert early_exit.exit_mask(torch.from_numpy(logits), 0.5).any()
    for n in (0, 1, 2):
        assert early_exit.branchynet_loss_weights(n) == \
            ref_ee.branchynet_loss_weights(n)
    assert early_exit.branchynet_loss_weights(2, 0.5, 0.1) == \
        ref_ee.branchynet_loss_weights(2, 0.5, 0.1)


def test_failout_draws():
    """The alive mask's mean is survive_prob, and no draw is all dead."""
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([failout(gen, 8, 0.7) for _ in range(2000)])
    assert draws.dtype == torch.float32
    assert set(draws.unique().tolist()) <= {0.0, 1.0}
    assert abs(draws.mean().item() - 0.7) < 0.01
    rare = torch.stack([failout(gen, 2, 0.05) for _ in range(500)])
    assert (rare.sum(1) >= 1).all()
    assert (rare.sum(1) == 2).float().mean() > 0.8    # the all-dead draws
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(failout(g2, 8, 0.7), draws[0])


@pytest.mark.parametrize("mask", [(1.0, 0.0), (0.0, 1.0)])
def test_failout_loss_matches_reference(granite, monkeypatch, mask):
    """With both packages' failout patched to the same mask, the failout
    loss (resilient_forward, aux 0, no MTP) and its gradients agree."""
    rm, rp, tm = granite
    tp = _bridge(rp)
    monkeypatch.setattr(ref_tl, "failout",
                        lambda key, n, p: jnp.asarray(mask, jnp.float32))
    monkeypatch.setattr(train_loop, "failout",
                        lambda gen, n, p: torch.tensor(mask))
    rb, tb = _batch(5)
    tcfg = TrainConfig(failout_prob=0.25)
    rl, rmet, rg = _ref_grads(rm, rp, rb, ref_tl.TrainConfig(
        failout_prob=0.25), rng=jax.random.PRNGKey(0))
    tl, tmet, tg = _port_grads(tm, tp, tb, tcfg, torch.Generator())
    assert set(tmet) == set(rmet)
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(rg)[0],
                                 tg):
        assert _rel_l2(got, want) <= GRAD_REL, jax.tree_util.keystr(path)
