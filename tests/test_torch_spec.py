"""The port's speculative pairs against target-only greedy and against the
reference ``SpecPair``, on the CPU at smoke widths.

* A ``SpecPair`` (draft proposes k greedy tokens a round, the target
  verifies them in k write-gated monolithic steps) gives streams equal bit
  for bit to the port's own target-only greedy pool on the monolithic
  path: agreeable draft (shared params), forced rejection (a draft seeded
  7), and an MLA + MoE target (deepseek-v3 smoke), paged and contiguous.
* On the reference's weights (``bridge.params_from_jax``) the streams,
  rounds and committed counts equal the reference ``SpecPair``'s, with a
  bf16 top-2 tie of the reference's logits (within 1e-2) excused only as a
  tie, after which the comparison of that request stops.
* After every run the page pools are whole again (free count equal to
  the pool, every refcount zero) and no slot holds a request.
* ``spec_verify`` commits every acceptance length 1..k exactly.
* The tiered cluster's speculative bridge routes, commits and prices as
  the reference cluster's does, and an outage drains it.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import Scenario as RefScenario
from repro.core import TierOutage as RefTierOutage
from repro.models import Model as RefModel
from repro.serving import ClusterConfig as RefClusterConfig
from repro.serving import ModelGroup as RefGroup
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import SpecPair as RefSpecPair
from repro.serving import TieredServingCluster as RefCluster
from repro.serving.router import AdmissionRouter as RefRouter
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import Scenario, TierOutage
from repro_torch.models import Model
from repro_torch.serving.cluster import ClusterConfig, TieredServingCluster
from repro_torch.serving.multipool import ModelGroup, SpecPair
from repro_torch.serving.router import AdmissionRouter
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig)

DRAFT = "granite-3-2b-smoke"
MLA_TARGET = "deepseek-v3-671b-smoke"
DRAFT_PLAN, TARGET_PLAN = "granite-3-2b", "deepseek-v3-671b"
TIE = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed):
    rm = RefModel(ref_config(arch))
    rp = rm.init(jax.random.PRNGKey(seed))
    tm = Model(get_config(arch), device="cpu")
    return rm, rp, tm, params_from_jax(jax.tree.map(np.asarray, rp))


@pytest.fixture(scope="module")
def granite():
    return _pair(DRAFT, 0)


@pytest.fixture(scope="module")
def granite7():
    return _pair(DRAFT, 7)


@pytest.fixture(scope="module")
def deepseek():
    return _pair(MLA_TARGET, 1)


def _cfg(cls, **kw):
    base = dict(n_slots=2, max_len=48, prefill_chunk=8, exit_threshold=0.0)
    base.update(kw)
    return cls(**base)


def _paged(paged):
    return dict(paged=True, page_size=16) if paged else {}


def _serve(sched, req_cls, prompts, max_new):
    reqs = [req_cls(tokens=np.asarray(p, np.int32), max_new=max_new,
                    req_id=i) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return {r.req_id: list(r.out_tokens) for r in reqs}


def _target_only(tm, tp, prompts, max_new, **kw):
    """The port's target-only greedy pool on the monolithic path."""
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                              segmented=False, **kw),
                                 device="cpu")
    return _serve(s, Request, prompts, max_new)


def _ref_logits(rm, rp, prompt, tokens):
    seq = np.concatenate([np.asarray(prompt, np.int32),
                          np.asarray(tokens[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    return np.asarray(logits[0, len(prompt) - 1:])


def _tie_or_equal(rm, rp, prompt, got, want):
    """Equal streams, or a first difference at a bf16 top-2 tie of the
    reference's logits.  Returns whether they were equal."""
    if got == want:
        return True
    logs = _ref_logits(rm, rp, prompt, want)
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    gap = float(logs[k][want[k]] - logs[k][got[k]])
    assert 0.0 <= gap < TIE, f"token {k}: ref logit gap {gap:.3e}"
    return False


def _assert_clean(pair):
    """Every page back in the pool, every refcount zero, no slot bound."""
    for pool in pair.pools.values():
        assert not pool.has_work and not pool.active.any()
        assert all(r is None for r in pool.slot_req)
        if pool.page_alloc is not None:
            assert pool.page_alloc.free_count == pool.page_alloc.n_pages
            assert not pool.page_alloc.refcount.any()


def _spec_vs_ref(draft, target, prompts, max_new, paged):
    """The port's SpecPair and the reference's on the same weights: port
    streams equal the port's target-only greedy bit for bit, and the
    reference's streams under the tie rule; with no tie, the rounds and
    committed counts are equal too.  Returns the port pair."""
    drm, drp, dtm, dtp = draft
    trm, trp, ttm, ttp = target
    kw = _paged(paged)
    want = _target_only(ttm, ttp, prompts, max_new, **kw)
    pair = SpecPair(ModelGroup([("draft", dtm, dtp), ("target", ttm, ttp)]),
                    _cfg(SchedulerConfig, **kw), k=4)
    got = _serve(pair, Request, prompts, max_new)
    assert got == want
    _assert_clean(pair)
    ref = RefSpecPair(RefGroup([("draft", drm, drp), ("target", trm, trp)]),
                      _cfg(RefConfig, **kw), k=4)
    ref_got = _serve(ref, RefRequest, prompts, max_new)
    equal = all([_tie_or_equal(trm, trp, prompts[i], got[i], ref_got[i])
                 for i in got])
    if equal:
        assert pair.spec_stats() == ref.spec_stats()
    st = pair.spec_stats()
    assert st["committed"] == sum(len(v) - 1 for v in got.values()) \
        + len(got)                    # each stream's last sample discarded
    return pair


# ---------------------------------------------------------------------------
# losslessness: spec == target-only greedy, == the reference's SpecPair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_spec_parity_agreeable(granite, paged):
    """Shared params: the draft always agrees, so every round commits the
    whole window, and a second batch reuses the stages unchanged."""
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 1024, n) for n in (5, 12, 9)]
    pair = _spec_vs_ref(granite, granite, prompts, 10, paged)
    assert pair.spec_stats()["acceptance_len"] >= 3.0
    assert pair.jit_cache_sizes() == {"draft/propose": 1,
                                      "draft/verify": 1,
                                      "target/propose": 1,
                                      "target/verify": 1}


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_spec_parity_mla_moe_target(granite, deepseek, paged):
    """A deepseek-v3 (MLA + MoE) target behind a granite draft, a
    different model, so most windows reject: verify's gated writes keep
    the stream equal to target-only greedy."""
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 1024, n) for n in (6, 13, 9)]
    pair = _spec_vs_ref(granite, deepseek, prompts, 8, paged)
    assert pair.spec_stats()["acceptance_len"] < 3.0


def test_spec_forced_rejection_leaks_nothing(granite, granite7):
    """A draft seeded 7 disagrees at chance: nearly every round rejects
    the whole window.  Streams still equal target-only greedy and the
    reference's, and the drained pools hold no page and no reference."""
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 1024, n) for n in (7, 11)]
    pair = _spec_vs_ref(granite7, granite, prompts, 8, True)
    st = pair.spec_stats()
    assert st["acceptance_len"] < 1.5
    assert st["slot_rounds"] >= 12


def test_spec_round_is_one_readback(granite):
    """A propose and a verify each read back once (one ``.cpu()``)."""
    _, _, tm, tp = granite
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                              segmented=False),
                                 device="cpu")
    s.ensure_spec(4)
    s.submit(Request(tokens=np.arange(5, dtype=np.int32), max_new=12))
    while not s.active.any():
        s.prefill_poll()
    calls = []
    orig = torch.Tensor.cpu

    def counting(t, *a, **kw):
        calls.append(tuple(t.shape))
        return orig(t, *a, **kw)
    torch.Tensor.cpu = counting
    try:
        drafts = s.spec_propose(s.spec_window_lens())
        assert len(calls) == 1 and calls[0] == (2, 4)
        s.spec_verify(drafts, s.spec_window_lens())
        assert len(calls) == 2 and calls[1] == (2, 5)
    finally:
        torch.Tensor.cpu = orig


# ---------------------------------------------------------------------------
# the verify stage: every acceptance length 1..k
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_spec_verify_every_acceptance_length(granite, paged):
    """Crafted windows force each acceptance length 1..k: commits follow
    target-only greedy exactly, and a rejected position leaves the cache
    as it was (the next round's tokens would differ otherwise)."""
    _, _, tm, tp = granite
    K = 4
    kw = _paged(paged)
    prompt = np.random.RandomState(4).randint(0, 1024, 8)
    ref = _target_only(tm, tp, [prompt], 24, n_slots=1, **kw)[0]
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, n_slots=1,
                                              segmented=False, **kw),
                                 device="cpu")
    s.ensure_spec(K)
    r = Request(tokens=prompt.copy(), max_new=24, req_id=0)
    s.submit(r)
    while not (r.slot >= 0 and s.active[r.slot]):
        s.prefill_poll()
    for want in (1, 2, 3, 4, 2, 4):
        idx = len(r.out_tokens)
        truth = ref[idx:idx + K - 1]
        drafts = np.zeros((1, K - 1), np.int32)
        drafts[0, :len(truth)] = truth
        if want <= K - 1:             # corrupt entry want - 1
            drafts[0, want - 1] = (int(drafts[0, want - 1]) + 7) % 1024
        committed = s.spec_verify(drafts, s.spec_window_lens())
        assert int(committed[0]) == want
        assert r.out_tokens == ref[:len(r.out_tokens)]
    assert s.spec_rounds == 6 and s.spec_committed == 16
    assert s.jit_cache_sizes() == {"propose": 1, "verify": 1}
    assert s.flush_counters()[-1] == s.tokens_served == 16


# ---------------------------------------------------------------------------
# config-time rejections
# ---------------------------------------------------------------------------
def test_spec_config_rejections(granite):
    _, _, tm, tp = granite
    group = ModelGroup([("draft", tm, tp), ("target", tm, tp)])
    with pytest.raises(ValueError, match="temperature"):
        SpecPair(group, _cfg(SchedulerConfig, temperature=0.7), k=4)
    with pytest.raises(ValueError, match="exit_threshold"):
        SpecPair(group, _cfg(SchedulerConfig, exit_threshold=0.5), k=4)
    with pytest.raises(ValueError, match="async_decode"):
        SpecPair(group, _cfg(SchedulerConfig, async_decode=True,
                             segmented=False), k=4)
    with pytest.raises(ValueError, match="k must be"):
        SpecPair(group, _cfg(SchedulerConfig), k=1)
    with pytest.raises(ValueError, match="exactly 2"):
        SpecPair(ModelGroup([("only", tm, tp)]), _cfg(SchedulerConfig), k=4)
    # a draft with sequential state leaves (none is ported yet: a model
    # that reports a non-paged cache stands in for one)
    state_draft = types.SimpleNamespace(all_cache_paged=lambda: False)
    with pytest.raises(ValueError, match="sequential"):
        SpecPair(ModelGroup([("draft", state_draft, None),
                             ("target", tm, tp)]),
                 _cfg(SchedulerConfig), k=4)
    pair = SpecPair(group, _cfg(SchedulerConfig, segmented=True), k=4)
    assert not pair.cfg.segmented    # forced monolithic
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig),
                                 device="cpu")
    s.ensure_spec(4)
    with pytest.raises(ValueError, match="fixed per arena"):
        s.ensure_spec(3)


def test_cluster_spec_config_rejections(granite):
    _, _, tm, tp = granite
    group = ModelGroup([("small", tm, tp), ("big", tm, tp)])
    plan = {"small": get_config(DRAFT_PLAN), "big": get_config(TARGET_PLAN)}
    with pytest.raises(ValueError, match="spec_draft"):
        TieredServingCluster(group, scenario=Scenario.default(),
                             plan_cfg=plan,
                             cfg=ClusterConfig(spec_draft="nonexistent"))
    with pytest.raises(ValueError, match="ModelGroup"):
        TieredServingCluster(tm, tp, cfg=ClusterConfig(spec_draft="small"))


# ---------------------------------------------------------------------------
# admission: the speculative candidate, as the reference router prices it
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario,k,accept,exclude", [
    ("high_rtt_access", 6, 0.0, None),
    ("high_rtt_access", 4, 4.0, None),
    ("default", 6, 0.0, None),
    ("degraded_wan", 4, 4.0, ["edge"]),
])
def test_router_speculative_candidate_matches_reference(scenario, k, accept,
                                                        exclude):
    plan = {"draft": get_config(DRAFT_PLAN),
            "target": get_config(TARGET_PLAN)}
    ref_plan = {"draft": ref_config(DRAFT_PLAN),
                "target": ref_config(TARGET_PLAN)}
    r = AdmissionRouter(plan, getattr(Scenario, scenario)(),
                        stream_tokens=True, spec_draft="draft", spec_k=k)
    rr = RefRouter(ref_plan, getattr(RefScenario, scenario)(),
                   stream_tokens=True, spec_draft="draft", spec_k=k)
    r.spec_accept = rr.spec_accept = accept
    for prompt, new in ((16, 32), (64, 32), (200, 8)):
        d = r.route(prompt, new, model="target", exclude=exclude)
        want = rr.route(prompt, new, model="target", exclude=exclude)
        assert dataclasses.asdict(d) == dataclasses.asdict(want)
    if scenario == "high_rtt_access":
        assert d.paradigm == "speculative" or prompt == 200


# ---------------------------------------------------------------------------
# the cluster's speculative bridge, against the reference cluster
# ---------------------------------------------------------------------------
def _spec_cluster(cls, cfg_cls, group, scenario, max_new, prompts):
    """The reference cluster takes ``stream_tokens=True`` as its own test
    does; ``spec_draft`` implies it in both packages."""
    ref = cls is RefCluster
    plan = ref_config if ref else get_config
    extra = {"stream_tokens": True} if ref else {}
    cl = cls(group, scenario=scenario,
             plan_cfg={"small": plan(DRAFT_PLAN), "big": plan(TARGET_PLAN)},
             cfg=cfg_cls(base_slots=2, max_len=48, prefill_chunk=8,
                         exit_threshold=0.0, spec_draft="small", spec_k=6,
                         **extra))
    crs = [cl.submit(p.copy(), max_new=max_new, arrival=0.05 * i,
                     model="big") for i, p in enumerate(prompts)]
    cl.run()
    return cl, crs


def test_cluster_speculative_end_to_end(granite):
    rm, rp, tm, tp = granite
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 1024, n) for n in (8, 12, 10)]
    cl, crs = _spec_cluster(
        TieredServingCluster, ClusterConfig,
        ModelGroup([("small", tm, tp), ("big", tm, tp)]),
        Scenario.high_rtt_access(), 10, prompts)
    ref_cl, ref_crs = _spec_cluster(
        RefCluster, RefClusterConfig,
        RefGroup([("small", rm, rp), ("big", rm, rp)]),
        RefScenario.high_rtt_access(), 10, prompts)
    want = _target_only(tm, tp, prompts, 10)
    for i, (cr, rc) in enumerate(zip(crs, ref_crs)):
        assert cr.done and cr.decision.paradigm == "speculative"
        assert cr.final_tier == "cloud"
        assert list(cr.req.out_tokens) == want[i]
        _tie_or_equal(rm, rp, prompts[i], list(cr.req.out_tokens),
                      list(rc.req.out_tokens))
        assert dataclasses.asdict(cr.decision) \
            == dataclasses.asdict(rc.decision)
        np.testing.assert_allclose(cr.t_done_v, rc.t_done_v, rtol=1e-9)
    st, ref_st = cl.stats(), ref_cl.stats()
    sp, ref_sp = st["speculative"], ref_st["speculative"]
    assert sp["k"] == 6 and sp["draft"] == "small"
    assert sp["requests_completed"] == 3
    assert sp["acceptance_len"] >= 4.0 and sp["mean_speedup_x"] > 1.5
    for key in ("rounds", "slot_rounds", "committed", "drafted",
                "acceptance_len", "per_request_speedup"):
        assert sp[key] == ref_sp[key], key
    assert st["route_counts"] == ref_st["route_counts"]
    assert st["models"]["big"]["route_counts"] \
        == ref_st["models"]["big"]["route_counts"]
    for name, ts in st["tiers"].items():
        np.testing.assert_allclose(
            [ts["vclock_s"], ts["utilization"]],
            [ref_st["tiers"][name]["vclock_s"],
             ref_st["tiers"][name]["utilization"]], rtol=1e-9, atol=1e-12)
    # the measured acceptance fed back into admission pricing
    assert cl.router.spec_accept == pytest.approx(sp["acceptance_len"])
    assert cl.jit_cache_sizes()["spec:big"] == {
        "small/propose": 1, "small/verify": 1, "big/propose": 1,
        "big/verify": 1}
    for pair in cl._spec_pairs.values():
        _assert_clean(pair)


def test_cluster_speculative_outage_drains_to_survivors(granite):
    """The device tier dies at once: the bridge's requests requeue onto
    ordinary candidates and complete with the segmented pools' tokens,
    routed and priced as the reference cluster does."""
    rm, rp, tm, tp = granite
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 1024, n) for n in (8, 11)]
    sc = dataclasses.replace(Scenario.high_rtt_access(),
                             outages=(TierOutage("device", 0.0),))
    ref_sc = dataclasses.replace(RefScenario.high_rtt_access(),
                                 outages=(RefTierOutage("device", 0.0),))
    cl, crs = _spec_cluster(
        TieredServingCluster, ClusterConfig,
        ModelGroup([("small", tm, tp), ("big", tm, tp)]), sc, 8, prompts)
    ref_cl, ref_crs = _spec_cluster(
        RefCluster, RefClusterConfig,
        RefGroup([("small", rm, rp), ("big", rm, rp)]), ref_sc, 8, prompts)
    seg = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig),
                                   device="cpu")
    want = _serve(seg, Request, prompts, 8)
    for i, (cr, rc) in enumerate(zip(crs, ref_crs)):
        assert cr.done and cr.decision.paradigm != "speculative"
        assert list(cr.req.out_tokens) == want[i]
        assert (cr.decision.tier, cr.final_tier, cr.requeues) \
            == (rc.decision.tier, rc.final_tier, rc.requeues)
        np.testing.assert_allclose(cr.t_done_v, rc.t_done_v, rtol=1e-9)
    st, ref_st = cl.stats(), ref_cl.stats()
    for key in ("route_counts", "migration", "dead_tiers"):
        assert st[key] == ref_st[key], key
