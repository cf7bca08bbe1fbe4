"""The port's dense GQA model against the reference package on the same
weights (granite-3-2b-smoke, reference ``Model.init`` bridged to torch).

Tolerances.  Both packages carry the hidden state in bf16 and return
logits as bf16 matmul results cast to fp32 (|logit| < 1.5 here, where a
bf16 ulp is 2^-7 = 0.0078).  XLA and torch sum the bf16 products in a
different order, so a logit may land one or two ulps apart: atol 2e-2.
Exit entropies (about log V = 6.9) come from those logits: atol 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.attention import PagedKV
from repro_torch.models.common import tree_leaves

ARCH = "granite-3-2b-smoke"
LOGIT_ATOL = 2e-2
ENT_ATOL = 5e-3


@pytest.fixture(scope="module")
def pair():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    return rm, rp, tm, tp


def _paged_table(b, pps, n_pages, seed):
    """Each row gets its own shuffled pages; the last row's tail entries
    are the sentinel n_pages (unallocated)."""
    perm = np.random.RandomState(seed).permutation(n_pages)
    tbl = perm[:b * pps].reshape(b, pps).astype(np.int32)
    tbl[-1, pps // 2:] = n_pages
    return tbl


def _assert_greedy_or_tie(got, want):
    """Greedy tokens agree, except where the reference's top-2 logits lie
    within a bf16 ulp (the tie rule of tests/test_scheduler.py)."""
    for g, w in zip(got, want):
        a, b = int(g.argmax()), int(w.argmax())
        assert a == b or 0.0 <= w[b] - w[a] < 1e-2, (a, b, w[b] - w[a])


def _op_pair(name):
    """(reference fn, port fn) over fp32 numpy inputs from one seed."""
    from repro.models import common as rc
    from repro.models import rope as rr
    from repro_torch.models import common as tc
    from repro_torch.models import rope as tr
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5, 4, 32).astype(np.float32)
    scale = rs.randn(32).astype(np.float32)
    bias = rs.randn(32).astype(np.float32)
    pos = rs.randint(0, 3000, (2, 5)).astype(np.int32)
    pos3 = rs.randint(0, 3000, (3, 2, 5)).astype(np.int32)
    j, t = jnp.asarray, torch.from_numpy
    return {
        "rmsnorm": (lambda: rc.rmsnorm(j(x), j(scale)),
                    lambda: tc.rmsnorm(t(x), t(scale))),
        "layernorm": (lambda: rc.layernorm(j(x), j(scale), j(bias)),
                      lambda: tc.layernorm(t(x), t(scale), t(bias))),
        "rope": (lambda: rr.apply_positional(j(x), j(pos), "rope", 1e4),
                 lambda: tr.apply_positional(t(x), t(pos), "rope", 1e4)),
        "mrope": (lambda: rr.apply_positional(j(x), j(pos3), "mrope", 1e6),
                  lambda: tr.apply_positional(t(x), t(pos3), "mrope", 1e6)),
        "mrope-text": (
            lambda: rr.apply_positional(j(x), j(pos), "mrope", 1e6),
            lambda: tr.apply_positional(t(x), t(pos), "mrope", 1e6)),
        "silu": (lambda: rc.activation("silu")(j(x)),
                 lambda: tc.activation("silu")(t(x))),
        "gelu": (lambda: rc.activation("gelu")(j(x)),
                 lambda: tc.activation("gelu")(t(x))),
    }[name]


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "rope", "mrope",
                                  "mrope-text", "silu", "gelu"])
def test_common_ops_match_reference(name):
    """Norms, rotary embeddings and activations in fp32 on the same inputs.
    Same formulas in the same precision; only libm's exp/sin/cos/rsqrt
    differ, by a few fp32 ulps of values below ~10 (atol 1e-5).  gelu must
    be the tanh form (the exact form is 4e-4 away)."""
    ref_fn, port_fn = _op_pair(name)
    np.testing.assert_allclose(port_fn().numpy(), np.asarray(ref_fn()),
                               rtol=1e-5, atol=1e-5)


def test_bridge_is_exact(pair):
    rm, rp, tm, tp = pair
    """Every leaf crosses the bridge bit for bit, bf16 included."""
    ref_leaves = jax.tree.leaves(rp)
    port_leaves = tree_leaves(tp)
    assert len(port_leaves) == len(ref_leaves)
    assert tp["embed"].dtype == torch.bfloat16
    for r, t in zip(ref_leaves, port_leaves):
        r = np.asarray(r)
        assert tuple(t.shape) == r.shape
        np.testing.assert_array_equal(
            t.view(torch.int16 if t.dtype == torch.bfloat16
                   else t.dtype).numpy(),
            r.view(np.int16) if r.dtype.name == "bfloat16" else r)


@pytest.mark.parametrize("arena", ["contiguous", "paged", "ring"])
def test_decode_step_matches_reference(pair, arena):
    """Six decode steps at ragged per-slot positions: logits and exit
    entropies allclose, greedy tokens equal.  ``ring`` is the long-mode
    ring-buffer cache (window 64 at smoke size), with positions that have
    wrapped around it."""
    rm, rp, tm, tp = pair
    b, page, pps = 3, 16, 2
    n_pages = b * pps + 2
    pos = np.array([0, 3, 9], np.int32)
    long_mode = arena == "ring"
    if arena == "paged":
        tbl = _paged_table(b, pps, n_pages, 0)
        rc = rm.init_decode_cache_paged(b, n_pages, page)
        tc = tm.init_decode_cache_paged(b, n_pages, page)
    else:
        rc = rm.init_decode_cache(b, 200, long_mode=long_mode)
        tc = tm.init_decode_cache(b, 200, long_mode=long_mode)
        if long_mode:
            assert tc["blocks"][0][0].shape[2] == 64
            pos = np.array([70, 130, 5], np.int32)
    rs = np.random.RandomState(1)
    for _ in range(6):
        toks = rs.randint(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        kw_r, kw_t = {"long_mode": long_mode}, {"long_mode": long_mode}
        if arena == "paged":
            mask = np.ones(b, bool)
            kw_r["paged"] = ref_attn.PagedKV(jnp.asarray(tbl),
                                             jnp.asarray(mask))
            kw_t["paged"] = PagedKV(torch.from_numpy(tbl),
                                    torch.from_numpy(mask))
        rl, ree, rc = rm.decode_step(rp, rc, jnp.asarray(toks),
                                     jnp.asarray(pos), **kw_r)
        tl, tee, tc = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                     torch.from_numpy(pos), **kw_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(tee.numpy(), np.asarray(ree), rtol=0,
                                   atol=ENT_ATOL)
        _assert_greedy_or_tie(tl.numpy(), np.asarray(rl))
        pos = pos + 1


def test_segments_equal_monolithic_step_at_threshold0(pair):
    """embed -> decode_segment* -> finalize with every slot alive is the
    monolithic decode_step, bit for bit (same torch ops in the same order);
    the fused probe's entropy matches both the step's exit entropy and the
    reference's probe."""
    rm, rp, tm, tp = pair
    b, s = 2, 16
    rs = np.random.RandomState(2)
    toks = rs.randint(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.array([3, 5], np.int32)
    mono_cache = tm.init_decode_cache(b, s)
    logits, ee, _ = tm.decode_step(tp, mono_cache,
                                   torch.from_numpy(toks).long(),
                                   torch.from_numpy(pos))
    cache = tm.init_decode_cache(b, s)
    alive = torch.ones(b, dtype=torch.bool)
    x = tm.embed_decode_tokens(tp, torch.from_numpy(toks).long())
    rx = rm.embed_decode_tokens(rp, jnp.asarray(toks))
    rcache = rm.init_decode_cache(b, s)
    probes = []
    for seg in tm.decode_segments:
        x, cache = tm.decode_segment(tp, cache, x, seg, torch.from_numpy(pos),
                                     alive)
        rx, rcache = rm.decode_segment(rp, rcache, rx,
                                       rm.decode_segments[seg.index],
                                       jnp.asarray(pos), jnp.ones(b, bool))
        if seg.exit_index is not None:
            ent = tm.exit_probe_entropy(tp, seg.exit_index, x)
            rent = rm.exit_probe_entropy(rp, seg.exit_index, rx)
            np.testing.assert_allclose(ent.numpy(), np.asarray(rent),
                                       rtol=0, atol=ENT_ATOL)
            probes.append(ent)
    assert torch.equal(tm.finalize_decode(tp, x), logits)
    for a, bb in zip(mono_cache["blocks"], cache["blocks"]):
        assert all(torch.equal(u, v) for u, v in zip(a, bb))
    # fp32 probe vs entropy of bf16-rounded logits: rounding only
    np.testing.assert_allclose(torch.stack(probes).numpy(), ee.numpy(),
                               rtol=0, atol=ENT_ATOL)


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_exited_rows_pass_through_and_skip_writes(pair, arena):
    """A row that is not alive keeps its hidden state and writes no KV in
    the segment, exactly as the reference's decode_segment."""
    rm, rp, tm, tp = pair
    b, page, pps = 3, 16, 1
    n_pages = b * pps
    rs = np.random.RandomState(3)
    toks = rs.randint(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.array([2, 4, 6], np.int32)
    alive = np.array([True, False, True])
    seg = tm.decode_segments[-1]
    kw_r, kw_t = {}, {}
    if arena == "paged":
        tbl = np.random.RandomState(4).permutation(n_pages).reshape(
            b, pps).astype(np.int32)
        rc = rm.init_decode_cache_paged(b, n_pages, page)
        tc = tm.init_decode_cache_paged(b, n_pages, page)
        kw_r["paged"] = ref_attn.PagedKV(jnp.asarray(tbl), jnp.asarray(alive))
        kw_t["paged"] = PagedKV(torch.from_numpy(tbl),
                                torch.from_numpy(alive))
    else:
        rc = rm.init_decode_cache(b, page)
        tc = tm.init_decode_cache(b, page)
    x = tm.embed_decode_tokens(tp, torch.from_numpy(toks).long())
    rx = rm.embed_decode_tokens(rp, jnp.asarray(toks))
    x, tc = tm.decode_segment(tp, tc, x, seg, torch.from_numpy(pos),
                              torch.from_numpy(alive), **kw_t)
    rx, rc = rm.decode_segment(rp, rc, rx, rm.decode_segments[-1],
                               jnp.asarray(pos), jnp.asarray(alive), **kw_r)
    np.testing.assert_allclose(x.float().numpy(),
                               np.asarray(rx, np.float32), rtol=0,
                               atol=LOGIT_ATOL)
    assert torch.equal(x[1], tm.embed_decode_tokens(
        tp, torch.from_numpy(toks).long())[1])
    for tb, rb in zip(tc["blocks"], rc["blocks"]):
        for t_leaf, r_leaf in zip(tb, rb):
            r_np = np.asarray(r_leaf, np.float32)
            np.testing.assert_allclose(t_leaf.float().numpy(), r_np, rtol=0,
                                       atol=LOGIT_ATOL)
            assert (t_leaf.float().numpy() == 0).sum() == (r_np == 0).sum()


def test_prefill_logits_match_reference(pair):
    rm, rp, tm, tp = pair
    toks = np.random.RandomState(5).randint(
        0, tm.cfg.vocab_size, (2, 7)).astype(np.int32)
    rl, _ = rm.prefill(rp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 7, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=0,
                               atol=LOGIT_ATOL)
