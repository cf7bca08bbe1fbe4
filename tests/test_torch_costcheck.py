"""The port's CST001 cost check on the CPU: every arena of the audit stack
(a tiered cluster with the speculative bridge, a paged prefix-cache
scheduler; granite-3-2b-smoke, max_len 32) counts the same matmul FLOPs
per token as the reference's ``decode_flops_per_token`` on its jaxprs,
within 2 %, inside ``TOLERANCE``; a perturbed analytic cost trips
CST001, also through the CLI; each kernel wrapper's FLOP formula equals
what ``FlopCounterMode`` counts of its plain version at three shapes; and
running a registered stage leaves the arena as it was."""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import (TOLERANCE, build_audit_stack,
                                  check_cost_graphs, stage_flops)
from repro_torch.core import paradigms
from repro_torch.kernels import ops, ref
from repro_torch.launch.analyze import main

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    return build_audit_stack("cpu")


@pytest.fixture(scope="module")
def ratios(stack):
    findings, ratios = check_cost_graphs(stack)
    assert findings == []
    return ratios


@pytest.fixture(scope="module")
def ref_ratios():
    """The reference's cost check on its own audit stack (jaxprs)."""
    from repro.analysis.costcheck import check_cost_graphs as ref_check
    from repro.analysis.jaxpr_audit import audit_serving_stack
    _, ctx = audit_serving_stack()
    findings, ratios = ref_check(ctx["stack"], ctx["jaxprs"])
    assert findings == []
    return ratios


def _scaled(factor):
    real = paradigms.analytic_step_cost

    def drifted(cfg, batch, seq_len):
        c = real(cfg, batch, seq_len)
        return dataclasses.replace(
            c, flops_per_token=c.flops_per_token * factor)
    return drifted


# ---------------------------------------------------------------------------
# the audit stack against the analytic cost and against the reference
# ---------------------------------------------------------------------------
def test_cost_ratios_inside_the_band(ratios):
    assert len(ratios) == 9
    lo, hi = TOLERANCE
    assert all(lo <= r["ratio"] <= hi for r in ratios.values()), ratios


def test_arenas_match_the_reference_audit_stack(ratios, ref_ratios):
    assert set(ratios) == set(ref_ratios)


def test_port_flops_per_token_match_the_reference(ratios, ref_ratios):
    """3.211e6 a decode arena (segments + finalize) and 3.736e6 a bridge
    arena (the monolithic step with every exit head's full logits)."""
    for key, r in ref_ratios.items():
        got = ratios[key]["measured_flops_per_token"]
        assert abs(got / r["measured_flops_per_token"] - 1.0) <= 0.02, key
        assert ratios[key]["analytic_flops_per_token"] \
            == r["analytic_flops_per_token"]
    assert ratios["paged"]["measured_flops_per_token"] == 3211264.0
    assert ratios["cluster/spec:target/target"][
        "measured_flops_per_token"] == 3735552.0


def test_only_the_paged_arena_counts_a_kernel_formula(ratios):
    """The paged arena's attention is the paged-GQA wrapper (its formula);
    the contiguous arenas' attention is plain einsum."""
    assert ratios["paged"]["kernel_flops_per_token"] > 0
    assert all(r["kernel_flops_per_token"] == 0
               for k, r in ratios.items() if k != "paged")


@pytest.mark.parametrize("factor", [100.0, 4.0, 0.25])
def test_perturbed_analytic_cost_trips_cst001(stack, ratios, monkeypatch,
                                              factor):
    monkeypatch.setattr(paradigms, "analytic_step_cost", _scaled(factor))
    tripped, scaled = check_cost_graphs(stack)
    assert sorted({f.rule for f in tripped}) == ["CST001"]
    assert len(tripped) == len(ratios)
    assert "tolerance" in tripped[0].message
    for key, r in scaled.items():
        assert math.isclose(r["ratio"] * factor, ratios[key]["ratio"])


def test_cli_passes_on_the_tree_and_fails_a_perturbed_cost(monkeypatch):
    """``python -m repro_torch.analysis`` (lint and cost check) exits 0
    against ``analysis_baseline_torch.json``, and 1 once the analytic cost
    drifts by 4x."""
    monkeypatch.chdir(REPO)
    assert main(["--device", "cpu"]) == 0
    monkeypatch.setattr(paradigms, "analytic_step_cost", _scaled(4.0))
    assert main(["--device", "cpu"]) == 1


# ---------------------------------------------------------------------------
# kernel FLOP formulas against FlopCounterMode on the plain versions
# ---------------------------------------------------------------------------
def _aten_flops(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return float(fc.get_total_flops())


def _paged_args(b, nq, nkv, hd, page, pps, seed):
    g = torch.Generator().manual_seed(seed)
    n_pages = b * pps
    q = torch.randn(b, 1, nq, hd, generator=g).bfloat16()
    pk, pv = (torch.randn(n_pages, page, nkv, hd, generator=g).bfloat16()
              for _ in range(2))
    tbl = torch.randperm(n_pages, generator=g).to(torch.int32).reshape(
        b, pps)
    pos = torch.randint(0, pps * page, (b,), generator=g, dtype=torch.int32)
    return q, pk, pv, tbl, pos


def _mla_args(b, n, r, hr, page, pps, seed):
    g = torch.Generator().manual_seed(seed)
    n_pages = b * pps
    ql = torch.randn(b, 1, n, r, generator=g).bfloat16()
    qr = torch.randn(b, 1, n, hr, generator=g).bfloat16()
    pc = torch.randn(n_pages, page, r, generator=g).bfloat16()
    pk = torch.randn(n_pages, page, hr, generator=g).bfloat16()
    tbl = torch.randperm(n_pages, generator=g).to(torch.int32).reshape(
        b, pps)
    pos = torch.randint(0, pps * page, (b,), generator=g, dtype=torch.int32)
    return ql, qr, pc, pk, tbl, pos


def _qkv(b, sq, skv, nq, nkv, hd, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, nq, hd, generator=g).bfloat16()
    k, v = (torch.randn(b, skv, nkv, hd, generator=g).bfloat16()
            for _ in range(2))
    return q, k, v


def _w8a8_args(e, c, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    aq = torch.randint(-127, 128, (e, c, k), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (e, k, n), generator=g).to(torch.int8)
    return (aq, torch.rand(e, c, 1, generator=g), wq,
            torch.rand(e, 1, n, generator=g))


def _check(wrapper, plain, formula, args, kname, **kw):
    """The formula equals FlopCounterMode's count of the plain version;
    the wrapper under ``count_flops`` adds the formula once and hides the
    plain version's products from the counter."""
    want = _aten_flops(plain, *args, **kw)
    assert formula == want
    with ops.count_flops() as kernels, FlopCounterMode(display=False) as fc:
        wrapper(*args, **kw)
    assert fc.get_total_flops() == 0
    assert kernels == {kname: want}


@pytest.mark.parametrize("t,d,v", [(16, 256, 1024), (3, 96, 1000),
                                   (40, 64, 513)])
def test_exit_head_formula(t, d, v):
    g = torch.Generator().manual_seed(t)
    x = torch.randn(t, d, generator=g).bfloat16()
    w = torch.randn(d, v, generator=g).bfloat16()
    _check(ops.exit_head_entropy, ref.exit_head_entropy_ref,
           ops.exit_head_flops(x, w), (x, w), "exit_head_entropy")


@pytest.mark.parametrize("shape", [(2, 4, 4, 64, 16, 2), (5, 8, 2, 64, 16, 3),
                                   (3, 12, 2, 128, 8, 5)])
def test_paged_gqa_formula(shape):
    args = _paged_args(*shape, seed=sum(shape))
    _check(ops.paged_gqa_attention, ref.paged_gqa_attention_ref,
           ops.paged_gqa_flops(*args), args,
           "paged_gqa_attention")


@pytest.mark.parametrize("shape", [(2, 4, 32, 16, 16, 2),
                                   (3, 8, 64, 16, 16, 3),
                                   (1, 16, 128, 64, 8, 4)])
def test_paged_mla_formula(shape):
    args = _mla_args(*shape, seed=sum(shape))
    _check(ops.paged_mla_attention, ref.paged_mla_attention_ref,
           ops.paged_mla_flops(*args), args,
           "paged_mla_attention", scale=0.125)


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 16, 16, 4, 2, 64), True, 0), ((1, 12, 20, 6, 2, 32), False, 0),
    ((2, 24, 24, 8, 8, 64), True, 8)])
def test_flash_attention_formulas(shape, causal, window):
    q, k, v = _qkv(*shape, seed=sum(shape))
    _check(ops.flash_attention, ref.flash_attention_ref,
           ops.flash_attention_flops(q, k), (q, k, v), "flash_attention",
           causal=causal, window=window)
    # the log-sum-exp comes with the forward: the same products
    with ops.count_flops() as kernels:
        ops.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    assert kernels == {"flash_attention": ops.flash_attention_flops(q, k)}
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    _check(ops.flash_attention_bwd, ref.flash_attention_bwd_ref,
           ops.flash_attention_bwd_flops(q, k), (q, k, v, o, o, lse),
           "flash_attention_bwd", causal=causal, window=window)


@pytest.mark.parametrize("shape", [(2, 4, 32, 16), (3, 5, 64, 8),
                                   (1, 7, 128, 12)])
def test_w8a8_formula(shape):
    args = _w8a8_args(*shape, seed=sum(shape))
    _check(ops.w8a8_expert_matmul, ref.w8a8_expert_matmul_ref,
           ops.w8a8_expert_flops(*args), args,
           "w8a8_expert_matmul")


@pytest.mark.parametrize("rows,d", [(4, 64), (9, 512), (1, 33)])
def test_int8_kernels_do_no_product(rows, d):
    x = torch.randn(rows, d)
    assert _aten_flops(ref.quantize_rows_ref, x) == 0
    with ops.count_flops() as kernels:
        q, s = ops.compress_rows(x)
        ops.decompress_rows(q, s)
    assert kernels == {}


def test_counting_nests_and_ends():
    x = torch.randn(2, 8).bfloat16()
    w = torch.randn(8, 16).bfloat16()
    with ops.count_flops() as outer:
        with ops.count_flops() as inner:
            ops.exit_head_entropy(x, w)
        ops.exit_head_entropy(x, w)
    assert inner == outer == {"exit_head_entropy": 512.0}
    assert ops._FLOPS is None
    assert _aten_flops(ops.exit_head_entropy, x, w) == 512.0


# ---------------------------------------------------------------------------
# the stage registry
# ---------------------------------------------------------------------------
def test_registries_name_the_stages_poll_dispatches(stack):
    paged = stack["paged"].audit_stages()
    assert set(paged) == {"prefill", "segment0", "segment1", "probe0",
                          "finalize"}
    tiers = stack["cluster"].audit_stages()
    assert set(tiers) == {"device", "edge", "cloud", "spec:target"}
    assert set(tiers["spec:target"]) == {
        f"{m}/{s}" for m in ("draft", "target")
        for s in ("prefill", "decode", "propose", "verify")}
    assert all(spec.name == key for key, spec in tiers["cloud"].items())


def test_async_arena_registers_its_window_step(stack):
    from repro_torch.serving import ContinuousBatchScheduler, SchedulerConfig
    model = stack["_model"]
    s = ContinuousBatchScheduler(
        model, stack["paged"].params, SchedulerConfig(
            n_slots=2, max_len=32, prefill_chunk=8, segmented=False,
            async_decode=True, readback_interval=4), device="cpu")
    stages = s.audit_stages()
    assert set(stages) == {"prefill", "decode", "decode_window"}
    # one window step is the monolithic decode step plus its commit
    assert stage_flops(stages["decode_window"]) == \
        stage_flops(stages["decode"])


def _state(s):
    from repro_torch.models.common import tree_leaves
    return ([t.clone() for t in tree_leaves(s.cache)], s._counters.clone(),
            dict(s.stage_calls), s.positions.copy(), s.active.copy())


def test_running_every_stage_leaves_a_live_arena_as_it_was(stack):
    """Mid-run, a paged arena's every stage runs on its example inputs;
    its cache, counters, stage calls and host state are untouched, and it
    then serves the same tokens as an arena never audited."""
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     SchedulerConfig)
    model, params = stack["_model"], stack["paged"].params

    def arena():
        s = ContinuousBatchScheduler(model, params, SchedulerConfig(
            n_slots=2, max_len=32, prefill_chunk=8, paged=True,
            page_size=16), device="cpu")
        s.ensure_spec(3)
        rs = np.random.RandomState(9)
        reqs = [Request(tokens=rs.randint(0, 1000, n).astype(np.int32),
                        max_new=8) for n in (9, 14)]
        for r in reqs:
            s.submit(r)
        s.poll()
        s.poll()
        return s, reqs
    s, reqs = arena()
    before = _state(s)
    stages = s.audit_stages()
    assert {"propose", "verify"} <= set(stages)
    for spec in stages.values():
        stage_flops(spec)
    after = _state(s)
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert torch.equal(before[1], after[1])
    assert before[2] == after[2]
    assert (before[3] == after[3]).all() and (before[4] == after[4]).all()
    s.run()
    plain, plain_reqs = arena()
    plain.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain_reqs]
