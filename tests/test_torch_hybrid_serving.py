"""The hybrid Mamba2 family (zamba2-1.2b-smoke) served by the port's pools,
pairs, cluster and engine, on the CPU against dedicated schedulers,
target-only greedy and the reference on the same weights
(``bridge.params_from_jax``).

* granite, zamba2 and deepseek-v3 smoke in one ``MultiModelScheduler``
  equal dedicated schedulers bit for bit.
* A ``SpecPair`` with a zamba2 target and a granite draft (the two
  disagree, so drafts are rejected) equals target-only greedy bit for bit
  and the reference ``SpecPair`` under the tie rule (both tokens within
  1e-2 of the top logit of the reference's replay).
* The tiered cluster's routes, ledger and virtual latencies equal the
  reference cluster's, also with an edge outage that migrates state rows.
* ``ServingEngine`` equals a scheduler run, and its tiered path the
  single pool, bit for bit; ``serve_poisson`` drives a paged hybrid arena
  with no prefix hit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as core
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serving import ClusterConfig as RefClusterConfig
from repro.serving import ModelGroup as RefGroup
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import SpecPair as RefSpecPair
from repro.serving import TieredServingCluster as RefCluster
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_poisson
from repro_torch.models import Model
from repro_torch.serving import (ClusterConfig, ContinuousBatchScheduler,
                                 ModelGroup, MultiModelScheduler, Request,
                                 SchedulerConfig, SpecPair,
                                 TieredServingCluster)

ARCH = "zamba2-1.2b-smoke"
DRAFT = "granite-3-2b-smoke"
MOE = "deepseek-v3-671b-smoke"
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
def hybrid():
    return _pair(ARCH, 0)


@pytest.fixture(scope="module")
def granite():
    return _pair(DRAFT, 1)


@pytest.fixture(scope="module")
def deepseek():
    return _pair(MOE, 2)


def _tie_or_equal(rm, rp, prompt, got, want):
    """Equal streams, or a first difference at a top-2 tie of the
    reference's replay logits: both tokens within 1e-2 of the top logit
    (the reference's own batched run may take either side of such a tie).
    Returns whether they were equal."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return True
    seq = np.concatenate([prompt, np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    logs = np.asarray(logits[0, prompt.size - 1:])
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    top = float(logs[k].max())
    gaps = [top - float(logs[k][t]) for t in (got[k], want[k])]
    assert max(gaps) < TIE, f"token {k}: ref logit gaps {gaps}"
    return False


def _cfg(cls, **kw):
    base = dict(n_slots=2, max_len=64, prefill_chunk=8, page_size=16,
                exit_threshold=0.5)
    base.update(kw)
    return cls(**base)


def _serve(sched, req_cls, prompts, max_new, **kw):
    reqs = [req_cls(tokens=np.asarray(p, np.int32),
                    max_new=max_new[i] if isinstance(max_new, list)
                    else max_new, req_id=i, **kw)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.out_tokens) for r in reqs]


def _prompts(seed, lens, vocab=1024):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# pools, pairs and the cluster
# ---------------------------------------------------------------------------

def test_multi_pool_matches_dedicated(hybrid, granite, deepseek):
    """granite, zamba2 and deepseek-v3 smoke in one paged
    ``MultiModelScheduler``: each model's streams equal a dedicated
    scheduler's bit for bit."""
    entries = [(DRAFT, granite), (ARCH, hybrid), (MOE, deepseek)]
    group = ModelGroup([(n, e[2], e[3]) for n, e in entries])
    rs = np.random.RandomState(13)
    reqs = [(n, rs.randint(0, 1000, int(rs.randint(3, 12))).astype(np.int32))
            for _ in range(2) for n, _ in entries]
    pool = MultiModelScheduler(group, _cfg(SchedulerConfig, paged=True))
    got = [Request(tokens=p.copy(), max_new=5, model=m) for m, p in reqs]
    for r in got:
        pool.submit(r)
    pool.run()
    for name, (_, _, tm, tp) in entries:
        ded = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                                    paged=True),
                                       device="cpu")
        want = _serve(ded, Request, [p for m, p in reqs if m == name], 5)
        assert [r.out_tokens for r in got if r.model == name] == want
    assert pool.pools[ARCH].prefix_cache is None
    assert pool.pools[DRAFT].prefix_cache is not None


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_spec_pair_zamba2_target(hybrid, granite, paged):
    """A granite draft proposes k 4 for a zamba2 target: the two models
    disagree almost always (forced rejection), so nearly every round
    commits one token; no rejected position writes a state row, so the
    streams equal target-only greedy bit for bit and the reference
    ``SpecPair``'s under the tie rule, and no page leaks."""
    rm, rp, tm, tp = hybrid
    gm_r, gp_r, gm, gp = granite
    prompts = _prompts(14, (6, 11, 4))
    kw = dict(paged=paged, exit_threshold=0.0)
    pair = SpecPair(ModelGroup([(DRAFT, gm, gp), (ARCH, tm, tp)]),
                    _cfg(SchedulerConfig, **kw), k=4)
    got = _serve(pair, Request, prompts, 8)
    solo = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                                 segmented=False, **kw),
                                    device="cpu")
    assert got == _serve(solo, Request, prompts, 8)
    st = pair.spec_stats()
    assert st["rounds"] > 0 and st["committed"] <= 1.5 * st["slot_rounds"]
    ref = RefSpecPair(RefGroup([(DRAFT, gm_r, gp_r), (ARCH, rm, rp)]),
                      _cfg(RefConfig, **kw), k=4)
    want = _serve(ref, RefRequest, prompts, 8)
    for p, g, w in zip(prompts, got, want):
        _tie_or_equal(rm, rp, p, g, w)
    for pool in pair.pools.values():
        assert not pool.active.any()
        if pool.page_alloc is not None:
            assert pool.page_alloc.free_count == pool.page_alloc.n_pages


CLUSTER_RUNS = {
    "default": (lambda m: m.Scenario.default(), {}),
    "outage-paged": (lambda m: m.Scenario.tier_outage("edge", at=0.02),
                     dict(kv_handoff="raw", paged=True, page_size=16)),
}


def _run_cluster(cls, cfg_cls, mod, model, params, plan, run):
    scenario, extra = CLUSTER_RUNS[run]
    cl = cls(model, params, scenario=scenario(mod), plan_cfg=plan,
             cfg=cfg_cls(base_slots=2, max_len=48, prefill_chunk=8,
                         **extra))
    rs = np.random.RandomState(15)
    crs = [cl.submit(rs.randint(0, 1024, int(rs.randint(3, 12))),
                     max_new=5, arrival=0.01 * i, deadline=0.05)
           for i in range(6)]
    cl.run()
    return cl, crs


@pytest.mark.parametrize("run", list(CLUSTER_RUNS))
def test_cluster_matches_reference(hybrid, run):
    """zamba2 smoke behind the tiered cluster, planned as the published
    zamba2-1.2b: routes, the migration ledger, per-tier counts and the
    virtual latencies equal the reference cluster's; with an edge outage
    in-flight slots migrate with their state rows."""
    rm, rp, tm, tp = hybrid
    cl, crs = _run_cluster(TieredServingCluster, ClusterConfig, core, tm, tp,
                           get_config("zamba2-1.2b"), run)
    ref_cl, ref_crs = _run_cluster(RefCluster, RefClusterConfig, ref_core,
                                   rm, rp, ref_config("zamba2-1.2b"), run)
    st, want = cl.stats(), ref_cl.stats()
    assert st["completed"] == 6
    for key in ("requests", "completed", "splits", "route_counts",
                "migration", "dead_tiers", "resilience"):
        assert st.get(key) == want.get(key), key
    for name, ts in st["tiers"].items():
        ws = want["tiers"][name]
        for key in ("routed", "dead", "n_slots", "tokens"):
            assert ts[key] == ws[key], (name, key)
        np.testing.assert_allclose(
            [ts[k] for k in ("vclock_s", "utilization", "slot_occupancy")],
            [ws[k] for k in ("vclock_s", "utilization", "slot_occupancy")],
            rtol=1e-9, atol=1e-12)
    for cr, rc in zip(crs, ref_crs):
        assert (cr.decision.tier, cr.decision.paradigm, cr.final_tier,
                cr.migrations, cr.handoff_bytes) == (
            rc.decision.tier, rc.decision.paradigm, rc.final_tier,
            rc.migrations, rc.handoff_bytes)
        np.testing.assert_allclose([cr.t_done_v, cr.handoff_time],
                                   [rc.t_done_v, rc.handoff_time],
                                   rtol=1e-9, atol=1e-12)
        _tie_or_equal(rm, rp, np.asarray(cr.req.tokens, np.int32),
                      cr.req.out_tokens, rc.req.out_tokens)
    if run != "default":
        assert st["migration"]["outage_migrations"] >= 1


def test_engine_tiered_equals_single_pool(hybrid):
    """``ServingEngine`` on zamba2 smoke: ``generate`` equals a scheduler
    run bit for bit, and the tiered engine (planned as the published
    model: rows on the edge tier's two-slot pool reuse slots) equals the
    single pool bit for bit and routes as the reference engine does."""
    from repro.core import Scenario as RefScenario
    from repro.serving import ServeConfig as RefServeConfig
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.core import Scenario
    from repro_torch.serving import ServeConfig, ServingEngine
    rm, rp, tm, tp = hybrid
    prompts = np.random.RandomState(16).randint(0, 1024, (6, 24)).astype(
        np.int32)
    single = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5))
    want = single.generate(prompts, max_new=8)
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        n_slots=6, max_len=32, exit_threshold=0.5), device="cpu")
    assert want.tolist() == _serve(s, Request, list(prompts), 8)
    tiered = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5),
                           scenario=Scenario.default(),
                           plan_cfg=get_config("zamba2-1.2b"))
    assert tiered.generate(prompts, max_new=8).tolist() == want.tolist()
    ref = RefEngine(rm, rp, RefServeConfig(exit_threshold=0.5),
                    scenario=RefScenario.default(),
                    plan_cfg=ref_config("zamba2-1.2b"))
    ref.generate(jnp.asarray(prompts), max_new=8)
    assert tiered.route_counts == ref.route_counts
    assert sum(tiered.route_counts.values()) == 6
    # some tier's pool holds fewer slots than the rows it served
    assert any(n > tiered._cluster.tiers[t].sched.cfg.n_slots
               for t, n in tiered.route_counts.items())


def test_serve_poisson_paged_drive(hybrid):
    """``serve_poisson`` on the CPU, paged and segmented: every request
    completes, and no prompt page is shared."""
    _, _, tm, tp = hybrid
    st = serve_poisson(ARCH, rate=200.0, n_requests=4, slots=2,
                       prompt_len=24, max_new=4, paged=True,
                       prefix_share=0.5, prefix_len=16, params=tp,
                       device="cpu", quiet=True)
    assert st["tokens"] == 16 and st["prefix_hit_tokens"] == 0
    assert all(len(o) == 4 for o in st["outputs"])
