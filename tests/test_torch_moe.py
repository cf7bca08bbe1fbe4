"""The port's MoE layer against the reference's single-device form
(``repro.models.ffn``): capacity, routing (with the top-k tie order),
dispatch with capacity drops, the shared expert and the load-balance loss,
on the same weights (deepseek-v3-671b-smoke's MoE, reference init bridged).

Tolerances.  The router is a full-fp32 product of the same bf16 inputs in
both packages; only the order of its sums differs (probabilities within
1e-6).  The expert products run in bf16 with fp32 accumulation, and each
package rounds them to bf16 at the same points, so an output element lands
a bf16 ulp or two apart (|y| < 4 here, one ulp is at most 2^-6): atol
3e-2.  The aux loss is fp32 arithmetic on those probabilities: 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import ffn as ref_ffn
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import ffn

ARCH = "deepseek-v3-671b-smoke"


@pytest.fixture(scope="module")
def moe():
    cfg = ref_config(ARCH)
    rp = RefModel(cfg).init(jax.random.PRNGKey(1))
    r_moe = jax.tree.map(lambda a: a[0], rp["blocks"][1]["moe"])
    assert "shared" in r_moe
    t_moe = params_from_jax(jax.tree.map(np.asarray, r_moe))
    return cfg, get_config(ARCH), r_moe, t_moe


@pytest.mark.parametrize("tokens,experts,k,cf", [
    (16, 256, 8, 1.25), (1, 256, 8, 1.25), (2048, 256, 8, 1.25),
    (8, 4, 2, 0.25), (3, 4, 2, 1.25), (100, 7, 3, 1.0)])
def test_capacity_matches_reference(tokens, experts, k, cf):
    assert ffn._capacity(tokens, experts, k, cf) == ref_ffn._capacity(
        tokens, experts, k, cf)


def _dropped(idx, experts, capacity):
    """Assignments past their expert's capacity, counted in the row-major
    order of the (token, k) assignments (a plain loop)."""
    seen = np.zeros(experts, int)
    dropped = 0
    for e in idx.reshape(-1):
        dropped += seen[e] >= capacity
        seen[e] += 1
    return int(dropped)


def test_route_matches_reference_and_breaks_ties_by_index():
    """Gates, indices and probabilities on random rows, plus rows whose
    probabilities tie exactly (duplicated router columns): the lower
    expert index comes first, as ``jax.lax.top_k`` orders them."""
    rs = np.random.RandomState(0)
    d, e, k = 32, 8, 3
    w = rs.randn(d, e).astype(np.float32)
    w[:, 5] = w[:, 1]                          # experts 1 and 5 tie
    w[:, 6] = w[:, 2]                          # experts 2 and 6 tie
    x = rs.randn(12, d).astype(np.float32)
    x[:4] = 0.0                                # all-equal probabilities
    rg, ri, rpr = ref_ffn._route(jnp.asarray(x), jnp.asarray(w), k)
    tg, ti, tpr = ffn._route(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert ti.dtype == torch.int32
    assert ti[0].tolist() == [0, 1, 2]
    np.testing.assert_allclose(tg.numpy(), np.asarray(rg), atol=1e-6)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(rpr), atol=1e-6)


@pytest.mark.parametrize("tokens_for_capacity", [None, 2])
def test_moe_ffn_reference_matches(moe, tokens_for_capacity):
    """y and aux of the whole layer (routed experts + shared expert).
    ``tokens_for_capacity`` 2 gives each expert max(4, ceil(2*2*1.25/4))
    = 4 rows for 24 tokens' 48 assignments, so the capacity drops some:
    the test counts them and both packages must drop the same ones."""
    rcfg, tcfg, r_moe, t_moe = moe
    m = tcfg.moe
    rs = np.random.RandomState(2)
    x = rs.randn(4, 6, tcfg.d_model).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    ry, raux = ref_ffn.moe_ffn_reference(r_moe, xj, rcfg,
                                         tokens_for_capacity)
    ty, taux = ffn.moe_ffn_reference(t_moe, xt, tcfg, tokens_for_capacity)
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(ry, np.float32),
                               rtol=0, atol=3e-2)
    np.testing.assert_allclose(float(taux), float(raux), rtol=0, atol=1e-5)

    cap = ffn._capacity(tokens_for_capacity or 24, m.num_experts, m.top_k,
                        m.capacity_factor)
    _, idx, _ = ffn._route(xt.reshape(24, -1), t_moe["router"], m.top_k)
    _, kept = ffn._slots(idx, 0, m.num_experts, cap)
    dropped = _dropped(idx.numpy(), m.num_experts, cap)
    assert int((~kept).sum()) == dropped
    if tokens_for_capacity:
        assert cap == 4 and dropped > 0
    else:
        assert cap == math.ceil(24 * 2 * 1.25 / 4) and dropped == 0
    if tokens_for_capacity is None:
        yt, at = ffn.moe_ffn(t_moe, xt, tcfg)   # the single-device layer
        assert torch.equal(yt, ty) and torch.equal(at, taux)


def test_dropped_assignment_contributes_nothing(moe):
    """A capacity of 1 row per expert over 6 tokens: only the first
    assignment of each expert (row-major over (token, k)) is kept, a token
    with no kept assignment gets a zero routed output, and every dropped
    assignment points at the trash row e_loc * capacity."""
    _, tcfg, _, t_moe = moe
    m = tcfg.moe
    rs = np.random.RandomState(3)
    x2d = torch.from_numpy(rs.randn(6, tcfg.d_model).astype(np.float32)
                           ).bfloat16()
    gates, idx, _ = ffn._route(x2d, t_moe["router"], m.top_k)
    slot, kept = ffn._slots(idx, 0, m.num_experts, 1)
    assert int(kept.sum()) == len(set(idx.reshape(-1).tolist()))
    y = ffn._dispatch_compute_combine(x2d, gates, idx, t_moe, 0, 1, tcfg.act)
    for t in range(6):
        if not kept[t].any():
            assert not y[t].any()
    assert slot[~kept].eq(m.num_experts * 1).all()
