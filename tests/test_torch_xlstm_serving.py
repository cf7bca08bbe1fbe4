"""The xLSTM family (xlstm-350m-smoke) served by the port's pools, pairs,
cluster and engine, on the CPU against dedicated schedulers, target-only
greedy and the reference on the same weights (``bridge.params_from_jax``).

* granite, xlstm and zamba2 smoke (the reference's ``TRIO``) in one
  ``MultiModelScheduler`` equal dedicated schedulers bit for bit.
* A multi-model pool's migration routes each snapshot to its model's
  arena, and every stream continues bit for bit.
* A ``SpecPair`` with an xLSTM target and a granite draft equals
  target-only greedy bit for bit and the reference ``SpecPair`` under the
  tie rule (both tokens within 1e-2 of the top logit of the reference's
  replay); an xLSTM draft is refused, as the reference refuses it.
* The tiered cluster planned as the published xlstm-350m (alone, and
  beside granite in a group) gives the reference cluster's routes, ledger
  and virtual latencies.
* ``ServingEngine`` equals a scheduler run, and its tiered path the single
  pool, bit for bit; ``serve_poisson`` drives a paged xLSTM arena with no
  prefix hit.
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

ARCH = "xlstm-350m-smoke"
GRANITE = "granite-3-2b-smoke"
HYBRID = "zamba2-1.2b-smoke"
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
def xl():
    return _pair(ARCH, 0)


@pytest.fixture(scope="module")
def granite():
    return _pair(GRANITE, 1)


@pytest.fixture(scope="module")
def hybrid():
    return _pair(HYBRID, 2)


def _tie_or_equal(rm, rp, prompt, got, want):
    """Equal streams, or a first difference at a top-2 tie of the
    reference's replay logits: both tokens within 1e-2 of the top logit.
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
# pools and pairs
# ---------------------------------------------------------------------------

def test_multi_pool_trio_matches_dedicated(xl, granite, hybrid):
    """granite, xlstm and zamba2 smoke in one paged ``MultiModelScheduler``
    (an attention arena, a pool-free state arena and a hybrid): each
    model's streams equal a dedicated scheduler's bit for bit."""
    entries = [(GRANITE, granite), (ARCH, xl), (HYBRID, hybrid)]
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
    assert pool.pools[GRANITE].prefix_cache is not None


def test_multipool_migration_routes_by_model(xl, granite):
    """Snapshots carry their model name: a second multi-model pool imports
    each into the right arena, and both streams equal dedicated runs."""
    _, _, ga, pa_ = granite
    _, _, xm, xp = xl
    group = ModelGroup([("attn", ga, pa_), ("ssm", xm, xp)])
    pa, pb = _prompts(4, (7, 7))
    want = [_serve(ContinuousBatchScheduler(m, p, _cfg(SchedulerConfig),
                                            device="cpu"),
                   Request, [pr], 8)[0]
            for m, p, pr in ((ga, pa_, pa), (xm, xp, pb))]
    src = MultiModelScheduler(group, _cfg(SchedulerConfig))
    ra = Request(tokens=pa.copy(), max_new=8, model="attn")
    rb = Request(tokens=pb.copy(), max_new=8, model="ssm")
    src.submit(ra)
    src.submit(rb)
    for _ in range(5):
        src.poll()
    dst = MultiModelScheduler(group, _cfg(SchedulerConfig))
    for r in (ra, rb):
        assert not r.done
        snap = src.export_slot(r.slot, model=r.model)
        assert snap.model == r.model
        src.release_slot(r.slot, model=r.model)
        dst.import_slot(snap)
    dst.run()
    assert [ra.out_tokens, rb.out_tokens] == want


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_spec_pair_xlstm_target(xl, granite, paged):
    """A granite draft proposes k 4 for an xLSTM target: the two models
    disagree almost always (forced rejection), so nearly every round
    commits one token; no rejected position writes a state row, so the
    streams equal target-only greedy bit for bit and the reference
    ``SpecPair``'s under the tie rule, and no page leaks."""
    rm, rp, tm, tp = xl
    gm_r, gp_r, gm, gp = granite
    prompts = _prompts(14, (6, 11, 4))
    kw = dict(paged=paged, exit_threshold=0.0)
    pair = SpecPair(ModelGroup([(GRANITE, gm, gp), (ARCH, tm, tp)]),
                    _cfg(SchedulerConfig, **kw), k=4)
    got = _serve(pair, Request, prompts, 8)
    solo = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                                 segmented=False, **kw),
                                    device="cpu")
    assert got == _serve(solo, Request, prompts, 8)
    st = pair.spec_stats()
    assert st["rounds"] > 0 and st["committed"] <= 1.5 * st["slot_rounds"]
    ref = RefSpecPair(RefGroup([(GRANITE, gm_r, gp_r), (ARCH, rm, rp)]),
                      _cfg(RefConfig, **kw), k=4)
    want = _serve(ref, RefRequest, prompts, 8)
    for p, g, w in zip(prompts, got, want):
        _tie_or_equal(rm, rp, p, g, w)
    for pool in pair.pools.values():
        assert not pool.active.any()
        if pool.page_alloc is not None:
            assert pool.page_alloc.free_count == pool.page_alloc.n_pages


def test_spec_pair_refuses_xlstm_draft(xl, granite):
    """An xLSTM draft cannot rewind its state past a rejected window: the
    pair refuses it, as the reference's does."""
    rm, rp, tm, tp = xl
    gm_r, gp_r, gm, gp = granite
    with pytest.raises(ValueError, match="sequential"):
        SpecPair(ModelGroup([("draft", tm, tp), ("target", gm, gp)]),
                 _cfg(SchedulerConfig, exit_threshold=0.0), k=4)
    with pytest.raises(ValueError, match="sequential"):
        RefSpecPair(RefGroup([("draft", rm, rp), ("target", gm_r, gp_r)]),
                    _cfg(RefConfig, exit_threshold=0.0), k=4)


# ---------------------------------------------------------------------------
# the cluster and the engine
# ---------------------------------------------------------------------------

CLUSTER_RUNS = {
    "default": (lambda m: m.Scenario.default(), {}),
    "outage-paged": (lambda m: m.Scenario.tier_outage("edge", at=0.02),
                     dict(kv_handoff="raw", paged=True, page_size=16)),
}


def _run_cluster(cls, cfg_cls, mod, target, params, plan, run, models=("",)):
    scenario, extra = CLUSTER_RUNS[run]
    cl = cls(target, params, scenario=scenario(mod), plan_cfg=plan,
             cfg=cfg_cls(base_slots=2, max_len=48, prefill_chunk=8,
                         **extra))
    rs = np.random.RandomState(15)
    crs = [cl.submit(rs.randint(0, 1024, int(rs.randint(3, 12))),
                     max_new=4, arrival=0.01 * i, deadline=0.05,
                     **({"model": models[i % len(models)]}
                        if models != ("",) else {}))
           for i in range(6)]
    cl.run()
    return cl, crs


def _same_cluster_run(cl, crs, ref_cl, ref_crs, models):
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
        rm, rp = models[cr.req.model]
        _tie_or_equal(rm, rp, np.asarray(cr.req.tokens, np.int32),
                      cr.req.out_tokens, rc.req.out_tokens)
    return st


@pytest.mark.parametrize("run", list(CLUSTER_RUNS))
def test_cluster_matches_reference(xl, run):
    """xlstm smoke behind the tiered cluster, planned as the published
    xlstm-350m: routes, the migration ledger, per-tier counts and the
    virtual latencies equal the reference cluster's; with an edge outage
    in-flight slots migrate with their state rows."""
    rm, rp, tm, tp = xl
    cl, crs = _run_cluster(TieredServingCluster, ClusterConfig, core, tm, tp,
                           get_config("xlstm-350m"), run)
    ref_cl, ref_crs = _run_cluster(RefCluster, RefClusterConfig, ref_core,
                                   rm, rp, ref_config("xlstm-350m"), run)
    st = _same_cluster_run(cl, crs, ref_cl, ref_crs, {"": (rm, rp)})
    if run != "default":
        assert st["migration"]["outage_migrations"] >= 1


def test_cluster_multi_model_matches_reference(xl, granite):
    """granite and xlstm smoke in one group cluster, planned as yi-6b and
    xlstm-350m (the reference's heavy and light pair): per-model routes,
    tokens, the ledger and the virtual latencies equal the reference
    cluster's."""
    plans = {"heavy": "yi-6b", "light": "xlstm-350m"}
    pairs = {"heavy": granite, "light": xl}
    cl, crs = _run_cluster(
        TieredServingCluster, ClusterConfig, core,
        ModelGroup([(n, p[2], p[3]) for n, p in pairs.items()]), None,
        {n: get_config(v) for n, v in plans.items()}, "default",
        models=tuple(plans))
    ref_cl, ref_crs = _run_cluster(
        RefCluster, RefClusterConfig, ref_core,
        RefGroup([(n, p[0], p[1]) for n, p in pairs.items()]), None,
        {n: ref_config(v) for n, v in plans.items()}, "default",
        models=tuple(plans))
    st = _same_cluster_run(cl, crs, ref_cl, ref_crs,
                           {n: p[:2] for n, p in pairs.items()})
    for name in plans:
        assert st["models"][name]["route_counts"] \
            == ref_cl.stats()["models"][name]["route_counts"]
        assert st["models"][name]["tokens"] == 12


def test_engine_tiered_equals_single_pool(xl):
    """``ServingEngine`` on xlstm smoke: ``generate`` equals a scheduler
    run bit for bit, and the tiered engine (planned as the published
    model) equals the single pool bit for bit and routes as the reference
    engine does."""
    from repro.core import Scenario as RefScenario
    from repro.serving import ServeConfig as RefServeConfig
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.core import Scenario
    from repro_torch.serving import ServeConfig, ServingEngine
    rm, rp, tm, tp = xl
    prompts = np.random.RandomState(16).randint(0, 1024, (6, 24)).astype(
        np.int32)
    single = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5))
    want = single.generate(prompts, max_new=8)
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        n_slots=6, max_len=32, exit_threshold=0.5), device="cpu")
    assert want.tolist() == _serve(s, Request, list(prompts), 8)
    tiered = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5),
                           scenario=Scenario.default(),
                           plan_cfg=get_config("xlstm-350m"))
    assert tiered.generate(prompts, max_new=8).tolist() == want.tolist()
    ref = RefEngine(rm, rp, RefServeConfig(exit_threshold=0.5),
                    scenario=RefScenario.default(),
                    plan_cfg=ref_config("xlstm-350m"))
    ref.generate(jnp.asarray(prompts), max_new=8)
    assert tiered.route_counts == ref.route_counts
    assert sum(tiered.route_counts.values()) == 6


def test_serve_poisson_paged_drive(xl):
    """``serve_poisson`` on the CPU, paged and segmented: every request
    completes, and no prompt page is shared (an xLSTM arena has no prefix
    cache)."""
    _, _, tm, tp = xl
    st = serve_poisson(ARCH, rate=200.0, n_requests=4, slots=2,
                       prompt_len=24, max_new=4, paged=True,
                       prefix_share=0.5, prefix_len=16, params=tp,
                       device="cpu", quiet=True)
    assert st["tokens"] == 16 and st["prefix_hit_tokens"] == 0
    assert all(len(o) == 4 for o in st["outputs"])
