"""W8A8 experts (the reference's serving-time ``quantize_model_moe``) in
the port against the reference, on the CPU.

Which form of ``/ 127`` each quantizer takes.  Eagerly the reference
divides (``amax / 127``); under ``jax.jit`` XLA turns the division by the
constant into ``amax * fl(1/127)``, and the two differ in the last bit on
some rows (and then q may differ by one).  ``_quant_rows`` runs inside the
reference's jitted decode step and forward, so the port multiplies by
``fl(1/127)`` and is bit-exact to the jitted reference;
``quantize_expert_weights`` runs eagerly (``quantize_model_moe`` is called
outside any jit), so the port divides and is bit-exact to the eager
reference.  Each test below holds one form bit for bit and shows the other
form is the reference's under the other mode.

Tolerances: the MoE output through W8A8 experts 2e-2 (bf16 outputs;
activation rounding differs by one bf16 ulp here and there, and the
eager reference quantizes its rows with the other division form); the
bf16-vs-W8A8 relative error under 0.05, the bound of the reference's own
``test_w8a8_expert_matmul_close_to_bf16``.
"""
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
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.models import ffn
from repro_torch.models.common import tree_leaves

ARCH = "llama4-maverick-400b-a17b-smoke"
MOE_ATOL = 2e-2
REL_BOUND = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jbf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _tbf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _rows(n, d, seed, dtype):
    """Rows of mixed scales with a zero row, the same values (rounded to
    ``dtype``) for both packages."""
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((n, d)) * rs.uniform(0.01, 4, (n, 1))).astype(
        np.float32)
    x[3] = 0.0
    if dtype == "bf16":
        return _jbf16(x), _tbf16(x)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_quant_rows_matches_jitted_reference_bitwise(dtype):
    xj, xt = _rows(512, 256, 0, dtype)
    q, s = ffn._quant_rows(xt)
    jq, js = jax.jit(ref_ffn._quant_rows)(xj)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s[3].item() == np.float32(1e-8) and not q[3].any()
    # the eager reference divides: it differs from the port (and from its
    # own jitted form) on some rows, by one ulp of the scale
    eq, es = ref_ffn._quant_rows(xj)
    amax = np.abs(np.asarray(xj, np.float32)).max(-1, keepdims=True)
    divided = np.maximum(amax / np.float32(127), np.float32(1e-8))
    np.testing.assert_array_equal(_bits(es), _bits(divided))
    diff = _bits(es) != _bits(s.numpy())
    assert diff.any()
    np.testing.assert_array_max_ulp(np.asarray(es), s.numpy(), maxulp=1)
    same = ~diff[:, 0]
    np.testing.assert_array_equal(np.asarray(eq)[same], q.numpy()[same])


def test_quant_rows_equals_handoff_quantizer_bitwise():
    """``_quant_rows`` and the handoff quantizer's plain version
    (``ops.compress_rows`` on the CPU) share the scale formula and give
    the same bits.  The MoE keeps its own few torch ops all the same: the
    handoff kernel is counted as the migration path's, and its launches
    would blur that count."""
    xj, xt = _rows(256, 256, 1, "bf16")
    q, s = ffn._quant_rows(xt)
    hq, hs = ops.compress_rows(xt)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(hs.numpy()))
    np.testing.assert_array_equal(q.numpy(), hq.numpy())


def _moe_params(cfg, seed=0):
    params = ref_ffn.init_moe(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2
                        else a, params)


def _tree(p):
    return params_from_jax(jax.tree.map(np.asarray, p))


def test_quantize_expert_weights_matches_eager_reference_bitwise():
    rp = _moe_params(ref_config(ARCH))
    want = ref_ffn.quantize_expert_weights(rp)
    src = _tree(rp)
    got = ffn.quantize_expert_weights(src)
    assert set(got) == set(want)
    assert "wg" in src                     # the input dict is left alone
    for k in ("wg", "wu", "wd"):
        assert got[k + "_q"].dtype == torch.int8
        assert got[k + "_s"].shape == (*src[k].shape[:-2], 1,
                                       src[k].shape[-1])
        np.testing.assert_array_equal(got[k + "_q"].numpy(),
                                      np.asarray(want[k + "_q"]))
        np.testing.assert_array_equal(_bits(got[k + "_s"].numpy()),
                                      _bits(want[k + "_s"]))
    # under jax.jit the reference multiplies by fl(1/127) instead
    jitted = jax.jit(ref_ffn.quantize_expert_weights)(rp)
    w = np.abs(np.asarray(rp["wg"], np.float32)).max(-2, keepdims=True)
    recip = np.maximum(w * (np.float32(1) / np.float32(127)),
                       np.float32(1e-8))
    np.testing.assert_array_equal(_bits(jitted["wg_s"]), _bits(recip))
    assert (_bits(jitted["wg_s"]) != _bits(got["wg_s"].numpy())).any()


def test_quantize_works_one_expert_at_a_time(monkeypatch):
    """Every fp32 transient of the weight quantizer is one expert's [in,
    out] matrix, never the whole leaf."""
    sizes = []
    real = torch.round

    def rec(x, *a, **kw):
        sizes.append(x.numel())
        return real(x, *a, **kw)
    monkeypatch.setattr(torch, "round", rec)
    cfg = get_config(ARCH)
    w = torch.randn(2, cfg.moe.num_experts, 64, 48).bfloat16()
    q, s = ffn._quantize_weight(w)
    assert sizes == [64 * 48] * (2 * cfg.moe.num_experts)
    assert q.shape == w.shape and s.shape == (2, cfg.moe.num_experts, 1, 48)


def test_w8a8_plain_gemm_matches_int32_accumulator_bitwise():
    """The plain W8A8 GEMM (what the wrapper runs for CPU tensors) against
    the reference's ``dot_general(..., preferred_element_type=int32)``
    accumulator, scaled as the reference scales it, at llama4-smoke's
    expert shapes and a ragged one (C 5, N 300), with saturated
    +-127 operands included."""
    rs = np.random.RandomState(0)
    for e, c, k, n in ((4, 4, 256, 128), (4, 40, 128, 256), (3, 5, 64, 300)):
        aq = rs.randint(-127, 128, (e, c, k)).astype(np.int8)
        wq = rs.randint(-127, 128, (e, k, n)).astype(np.int8)
        aq[0, 0] = 127
        wq[0, :, 0] = 127
        a_s = rs.uniform(1e-4, 0.05, (e, c, 1)).astype(np.float32)
        w_s = rs.uniform(1e-4, 0.05, (e, 1, n)).astype(np.float32)
        acc = jax.lax.dot_general(jnp.asarray(aq), jnp.asarray(wq),
                                  (((2,), (1,)), ((0,), (0,))),
                                  preferred_element_type=jnp.int32)
        want = np.asarray(acc.astype(jnp.float32) * jnp.asarray(a_s)
                          * jnp.asarray(w_s))
        n0 = dict(ops.LAUNCHES)
        got = ops.w8a8_expert_matmul(*(torch.from_numpy(a)
                                       for a in (aq, a_s, wq, w_s)))
        assert ops.LAUNCHES == n0          # CPU tensors launch nothing
        assert got.dtype == torch.float32 and got.shape == (e, c, n)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        assert int(np.abs(np.asarray(acc)).max()) == k * 127 * 127


def test_q_expert_matmul_matches_jitted_reference_bitwise():
    """Quantized rows, the exact s32 sum and the two scale products: the
    port's ``_q_expert_matmul`` equals the jitted reference's bit for bit,
    on bf16 dispatch buffers and on the fp32 h of the down product."""
    cfg = get_config(ARCH)
    tq = ffn.quantize_expert_weights(_tree(_moe_params(ref_config(ARCH))))
    rs = np.random.RandomState(3)
    for key, d, dtype in (("wg", cfg.d_model, "bf16"),
                          ("wd", cfg.moe.d_ff_expert, "fp32")):
        x = (rs.standard_normal((cfg.moe.num_experts, 6, d)) * 0.5).astype(
            np.float32)
        xj, xt = ((_jbf16(x), _tbf16(x)) if dtype == "bf16"
                  else (jnp.asarray(x), torch.from_numpy(x)))
        wq, ws = tq[key + "_q"], tq[key + "_s"]
        want = jax.jit(ref_ffn._q_expert_matmul)(
            xj, jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()))
        got = ffn._q_expert_matmul(xt, wq, ws)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_moe_ffn_quantized_matches_reference_and_bf16():
    """``moe_ffn_reference`` on the W8A8 tree against the reference's (both
    the eager and the jitted one) within 2e-2, and the bf16-vs-W8A8
    relative error under 0.05 on both sides (the reference's own test's
    input: 0.5 N(0, 1), 2 x 16 tokens)."""
    rc, tc = ref_config(ARCH), get_config(ARCH)
    rp = _moe_params(rc)
    rq = ref_ffn.quantize_expert_weights(rp)
    tp = _tree(rp)
    tq = ffn.quantize_expert_weights(tp)
    x = 0.5 * np.random.RandomState(1).standard_normal(
        (2, 16, tc.d_model)).astype(np.float32)
    xj, xt = _jbf16(x), _tbf16(x)
    y_bf, _ = ffn.moe_ffn_reference(tp, xt, tc)
    y_q, aux = ffn.moe_ffn_reference(tq, xt, tc)
    assert y_q.dtype == torch.bfloat16
    for fn in (ref_ffn.moe_ffn_reference,
               jax.jit(ref_ffn.moe_ffn_reference, static_argnums=2)):
        r_q, r_aux = fn(rq, xj, rc)
        np.testing.assert_allclose(y_q.float().numpy(),
                                   np.asarray(r_q, np.float32), rtol=0,
                                   atol=MOE_ATOL)
        np.testing.assert_allclose(aux.item(), float(r_aux), rtol=1e-5)
    r_bf, _ = ref_ffn.moe_ffn_reference(rp, xj, rc)
    r_q, _ = ref_ffn.moe_ffn_reference(rq, xj, rc)
    rel_ref = float(np.linalg.norm(np.asarray(r_q, np.float32)
                                   - np.asarray(r_bf, np.float32))
                    / np.linalg.norm(np.asarray(r_bf, np.float32)))
    rel = float((y_q.float() - y_bf.float()).norm() / y_bf.float().norm())
    assert 0 < rel < REL_BOUND and 0 < rel_ref < REL_BOUND
    # the same routing and capacity as the bf16 layer: only the expert
    # products differ
    np.testing.assert_allclose(rel, rel_ref, rtol=0.5)


def test_quantize_model_moe_in_place_and_bridge_of_quantized_tree():
    """The port's ``quantize_model_moe`` on a bridged llama4-smoke tree
    equals the reference's on the same tree, leaf for leaf and bit for
    bit (int8 and fp32 leaves through the bridge alike); it works in
    place and drops the bf16 expert leaves; dense layers, attention and
    the shared expert keep their leaves."""
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    rq = ref_ffn.quantize_model_moe(rp)
    bridged = _tree(rq)
    tp = _tree(rp)
    dense_before = tp["blocks"][0]["a"]["ffn"]["w_gate"]
    shared_before = tp["blocks"][0]["b"]["moe"]["shared"]["w_up"]
    out = ffn.quantize_model_moe(tp)
    assert out is tp
    moe = tp["blocks"][0]["b"]["moe"]
    assert not {"wg", "wu", "wd"} & set(moe)
    assert tp["blocks"][0]["a"]["ffn"]["w_gate"] is dense_before
    assert moe["shared"]["w_up"] is shared_before

    def by_path(tree, pre=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in by_path(tree[k], f"{pre}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree)
                    for x in by_path(v, f"{pre}/{i}")]
        return [(pre, tree)]
    got, want = by_path(tp), by_path(bridged)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert sum(t.dtype == torch.int8 for _, t in want) == 3
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        va = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        vb = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        assert torch.equal(va, vb), path


def test_quantize_model_moe_leaves_dense_archs_alone():
    m = Model(get_config("yi-6b-smoke"), device="cpu")
    p = m.init(0)
    before = [t for t in tree_leaves(p)]
    ffn.quantize_model_moe(p)
    after = tree_leaves(p)
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))


def test_quantized_deepseek_decode_matches_reference():
    """The reference's end-to-end check on deepseek-v3-671b-smoke (MLA and
    a top-2 MoE with a shared expert, plus its MTP layer's experts):
    decode on the W8A8 tree stays close to bf16, on both sides, and the
    port's W8A8 logits match the reference's (rows without a router tie
    of the reference's probabilities)."""
    arch = "deepseek-v3-671b-smoke"
    rm = RefModel(ref_config(arch))
    rp = rm.init(jax.random.PRNGKey(0))
    rq = ref_ffn.quantize_model_moe(rp)
    tm = Model(get_config(arch), device="cpu")
    tp = _tree(rp)
    tq = ffn.quantize_model_moe(_tree(rp))
    assert "wg_q" in tq["mtp"]["layer"]["moe"]
    toks = np.ones((2, 1), np.int32)
    l_bf, _, _ = tm.decode_step(tp, tm.init_decode_cache(2, 16),
                                torch.from_numpy(toks).long(), 1)
    l_q, _, _ = tm.decode_step(tq, tm.init_decode_cache(2, 16),
                               torch.from_numpy(toks).long(), 1)
    assert (l_bf - l_q).abs().max() < 0.1 * (l_bf.abs().max() + 1.0)
    r_q, _, _ = jax.jit(rm.decode_step)(rq, rm.init_decode_cache(2, 16),
                                        jnp.asarray(toks), jnp.int32(1))
    np.testing.assert_allclose(l_q.numpy(), np.asarray(r_q), rtol=0,
                               atol=MOE_ATOL)


def test_plain_version_on_the_card_path_is_exact():
    """The card's plain version sums in fp64 one expert at a time; its
    arithmetic, run here in fp64 on the CPU, gives the int32 bmm's sum at
    the largest |sum| the kernel takes for llama4's K of 8192."""
    k = 8192
    aq = torch.full((1, 2, k), 127, dtype=torch.int8)
    aq[0, 1] = -127
    wq = torch.full((1, k, 4), 127, dtype=torch.int8)
    acc = torch.mm(aq[0].double(), wq[0].double()).to(torch.int32)
    assert torch.equal(acc, torch.bmm(aq.int(), wq.int())[0])
    assert acc.abs().max().item() == k * 127 * 127 < 2 ** 31
    ones = torch.ones((1, 2, 1)), torch.ones((1, 1, 4))
    got = ref.w8a8_expert_matmul_ref(aq, ones[0], wq, ones[1])
    assert torch.equal(got[0], acc.float())
