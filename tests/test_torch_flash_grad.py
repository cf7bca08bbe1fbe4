"""The gradient of the port's attention on the CPU: the flash backward's
plain version (``ref.flash_attention_bwd_ref``) against ``jax.vjp`` of the
reference's ``_sdpa`` under its ``make_mask``, and ``ops.flash_attention``
as a ``torch.autograd.Function`` against autograd through the plain
forward.  Also the two model-level repairs training needed: the SSD's
intra-chunk product out of place under autograd (zamba2), and a stacked
block's layers taken by one ``torch.unbind``.

Tolerances.  fp32 inputs: both sides compute the same formulas in fp32 in
another order, so 1e-5 of max(1, |want|).  bf16 inputs: the outputs are
rounded to bf16 once, and the plain backward takes D = rowsum(dO o O) from
the forward's bf16 output where autograd sums dP o P unrounded, so a
gradient may land one bf16 ulp away: 2e-2 of max(1, |want|), the
tolerance the backward kernel is held to on the card (PERF.md §2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model, blocks, ssm
from repro_torch.models.common import softmax_cross_entropy, tree_leaves, \
    tree_map

torch.set_num_threads(1)

FP32_TOL = 1e-5
BF16_TOL = 2e-2

CASES = [  # (causal, window, G, Sq, Skv)
    (True, 0, 1, 24, 24),
    (True, 0, 4, 24, 24),
    (True, 7, 1, 30, 30),
    (True, 7, 4, 30, 30),
    (True, 1, 4, 9, 9),          # every row sees a single key
    (False, 0, 1, 12, 40),       # cross-attention: no mask
    (False, 0, 4, 12, 40),
]


def _inputs(dtype, g, sq, skv, b=2, nkv=2, h=16, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, nkv * g, h).astype(np.float32)
    k = rs.randn(b, skv, nkv, h).astype(np.float32)
    v = rs.randn(b, skv, nkv, h).astype(np.float32)
    do = rs.randn(b, sq, nkv * g, h).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs() / want.abs().clamp(min=1)).max().item()


@pytest.mark.parametrize("causal,window,g,sq,skv", CASES)
def test_bwd_ref_matches_jax_vjp_of_reference_sdpa(causal, window, g, sq,
                                                   skv):
    q, k, v, do = _inputs(torch.float32, g, sq, skv)
    mask = ref_attn.make_mask(sq, skv, causal=causal, window=window)
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, vjp = jax.vjp(lambda a, b, c: ref_attn._sdpa(a, b, c, mask, scale),
                       *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=0,
                               atol=FP32_TOL)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                      window=window)
    for name, a, w in zip("qkv", got, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert _rel(a, torch.from_numpy(np.asarray(w))) <= FP32_TOL, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("causal,window,g,sq,skv", CASES)
def test_function_backward_matches_autograd_of_plain(dtype, tol, causal,
                                                     window, g, sq, skv):
    """The Function's CPU backward (the plain backward) equals autograd
    through the plain forward; the forward is the plain forward exactly,
    and CPU calls count no launch."""
    q, k, v, do = _inputs(dtype, g, sq, skv, seed=1)
    for t in (q, k, v):
        t.requires_grad_(True)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(plain, (q, k, v), do)
    assert torch.equal(out.detach(), plain.detach())
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        assert _rel(a, w) <= tol, (name, _rel(a, w))
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.LAUNCHES["flash_attention_bwd"] == 0


def test_function_saves_nothing_without_grad():
    """Serving calls it without grad: no graph, the plain forward's
    output as it is."""
    q, k, v, _ = _inputs(torch.bfloat16, 4, 16, 16)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=True))


def test_bwd_without_d_is_far_from_the_gradient():
    """The planted control of the card's checks: the backward handed a
    zero o takes D = rowsum(dO o O) = 0, so dS = P o dP; it misses dQ and
    dK by far more than the tolerance, and leaves dV as it is."""
    q, k, v, do = _inputs(torch.float32, 4, 24, 24, seed=2)
    o = ref.flash_attention_ref(q, k, v, causal=True)
    lse = ref.flash_attention_lse_ref(q, k, causal=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    bad = ref.flash_attention_bwd_ref(q, k, v, torch.zeros_like(o), do, lse,
                                      causal=True)
    assert _rel(bad[0], want[0]) > 10 * BF16_TOL
    assert _rel(bad[1], want[1]) > 10 * BF16_TOL
    assert torch.equal(bad[2], want[2])


def _zamba2():
    model = Model(get_config("zamba2-1.2b-smoke"), device="cpu")
    params = model.init(0)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, model.cfg.vocab_size, (2, 64)))
    return model, params, toks


def test_zamba2_backpropagates():
    """The SSD's intra-chunk product used to run in place on exp's output
    (``lmat.mul_``), which autograd refuses; every leaf that feeds the
    loss now gets a finite gradient."""
    model, params, toks = _zamba2()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = model.forward(params, {"tokens": toks})
    labels = torch.roll(toks, -1, 1)
    loss = softmax_cross_entropy(out.logits, labels) + sum(
        softmax_cross_entropy(el, labels) for el in out.exit_logits)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is not None and torch.isfinite(g.float()).all()
               for g in grads)
    mamba = params["blocks"][0]["mamba"]["in_proj"]
    assert grads[[id(p) for p in leaves].index(id(mamba))].abs().sum() > 0


def test_ssd_forward_is_the_same_with_and_without_grad():
    """The out-of-place product rounds as the in-place one did: the
    mixer's output and state are the same bits under autograd and
    without it."""
    model, params, toks = _zamba2()
    cfg = model.cfg
    lp = tree_map(lambda a: a[0], params["blocks"][0])["mamba"]
    x = (0.5 * torch.randn(2, 64, cfg.d_model,
                           generator=torch.Generator().manual_seed(3))
         ).to(torch.bfloat16)
    with torch.no_grad():
        y0, s0 = ssm.mamba2_forward(cfg, lp, x)
    xg = x.clone().requires_grad_(True)
    y1, s1 = ssm.mamba2_forward(cfg, lp, xg)
    assert y1.grad_fn is not None
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())


def test_scan_block_unbinds_layers_once():
    """``run_scan_block`` takes its layers as views from one unbind: the
    same forward bits as indexing a layer at a time, and the same
    gradient of the stacked leaves."""
    model = Model(get_config("granite-3-2b-smoke"), device="cpu")
    params = model.init(0)
    bp = params["blocks"][0]
    n = tree_leaves(bp)[0].shape[0]
    views = blocks._unbind_layers(bp)
    assert len(views) == n
    for i, lp in enumerate(views):
        for a, b in zip(tree_leaves(lp), tree_leaves(tree_map(
                lambda t: t[i], bp))):
            assert a.data_ptr() == b.data_ptr() and torch.equal(a, b)
    cfg = model.cfg
    x = (torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                     .manual_seed(4)) * 0.5).to(torch.bfloat16)
    pos = model.positions_for(2, 16)
    leaves = tree_leaves(bp)
    for p in leaves:
        p.requires_grad_(True)
    y, _ = blocks.run_scan_block(cfg, "dense", bp, x, pos, 0)
    want = x
    for i in range(n):
        want, _ = blocks.forward_layer(cfg, "dense",
                                       tree_map(lambda t: t[i], bp), want,
                                       pos, 0, None)
    assert torch.equal(y, want)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    g1 = torch.autograd.grad(y, leaves, dy.to(y.dtype))
    g2 = torch.autograd.grad(want, leaves, dy.to(y.dtype))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
