"""The port's tiered cloud/edge/device cluster against the reference's, on
the CPU (granite-3-2b-smoke executing, granite-3-2b planning).

* The copied planners (cost graphs, ``analytic_step_cost``,
  ``admission_decision``, ``plan_all``, ``derive_tier_slots``,
  ``compression_decision``, the router) give the reference's results
  exactly under every scenario.
* A ``TieredServingCluster`` run equals the reference cluster's on the
  same weights and trace: route counts, the migration ledger, each
  request's tiers, migrations and greedy tokens, and the virtual
  latencies to 1e-9.  Runs: the default scenario and an edge outage with
  raw handoffs (the trace of tests/test_migration.py), and an edge outage
  with paged arenas and forced int8 handoffs.
* ``serve_tiered_poisson`` drives the outage scenario end to end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.core import paradigms as ref_paradigms
from repro.core.cost_model import build_cost_graph as ref_graph
from repro.core.offload import compression_decision as ref_compression
from repro.launch.serve import serve_tiered_poisson as ref_serve_tiered
from repro.models import Model as RefModel
from repro.serving import ClusterConfig as RefClusterConfig
from repro.serving import TieredServingCluster as RefCluster
from repro.serving.cluster import derive_tier_slots as ref_derive_slots
from repro.serving.router import AdmissionRouter as RefRouter
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import paradigms
from repro_torch.core.cost_model import build_cost_graph
from repro_torch.core.offload import compression_decision
from repro_torch.launch.serve import serve_tiered_poisson
from repro_torch.models import Model
from repro_torch.serving.cluster import (ClusterConfig, TieredServingCluster,
                                         derive_tier_slots)
from repro_torch.serving.router import AdmissionRouter

ARCH = "granite-3-2b-smoke"
PLAN = "granite-3-2b"
SCENARIOS = ["default", "neurosurgeon_era", "degraded_wan",
             "high_rtt_access", "tier_outage"]


def _asdict(x):
    return dataclasses.asdict(x)


# ---------------------------------------------------------------------------
# the copied planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,seq", [(1, 16), (1, 64), (4, 256)])
def test_cost_graph_and_step_cost_equal(batch, seq):
    pc, rc = get_config(PLAN), ref_config(PLAN)
    assert _asdict(build_cost_graph(pc, batch, seq)) \
        == _asdict(ref_graph(rc, batch, seq))
    assert _asdict(paradigms.analytic_step_cost(pc, batch, seq)) \
        == _asdict(ref_paradigms.analytic_step_cost(rc, batch, seq))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_paradigm_plans_and_admission_equal(scenario):
    pc, rc = get_config(PLAN), ref_config(PLAN)
    sc = getattr(paradigms.Scenario, scenario)()
    rsc = getattr(ref_paradigms.Scenario, scenario)()
    assert _asdict(sc) == _asdict(rsc)
    for seq in (16, 64):
        g, rg = build_cost_graph(pc, 1, seq), ref_graph(rc, 1, seq)
        got = paradigms.plan_all(g, sc, deadline=0.2)
        want = ref_paradigms.plan_all(rg, rsc, deadline=0.2)
        assert got.keys() == want.keys()
        for k in got:
            assert _asdict(got[k]) == _asdict(want[k]), k
    kv = paradigms.kv_cache_bytes_per_token(pc)
    assert kv == ref_paradigms.kv_cache_bytes_per_token(rc)
    rs = np.random.RandomState(0)
    for _ in range(24):
        prompt, new = int(rs.randint(4, 60)), int(rs.randint(1, 40))
        kw = dict(
            deadline=[None, 0.05, 0.5][rs.randint(3)],
            queue_cost={t: float(rs.exponential(0.02))
                        for t in ("device", "edge", "cloud")},
            prefill_tokens=prompt, decode_tokens=new,
            kv_bytes_per_token=kv,
            exclude=[None, frozenset({"edge"}),
                     frozenset({"cloud"})][rs.randint(3)],
            stream_tokens=bool(rs.randint(2)), spec_k=int(rs.choice([0, 4])))
        g, rg = build_cost_graph(pc, 1, prompt + new), \
            ref_graph(rc, 1, prompt + new)
        assert _asdict(paradigms.admission_decision(g, sc, **kw)) \
            == _asdict(ref_paradigms.admission_decision(rg, rsc, **kw))


def test_slots_compression_and_router_equal():
    pc, rc = get_config(PLAN), ref_config(PLAN)
    sc, rsc = paradigms.Scenario.default(), ref_paradigms.Scenario.default()
    kv = paradigms.analytic_step_cost(pc, 1, 64).kv_bytes_per_token * 64
    for base in (1, 2, 8, 16):
        for tier in ("device", "edge", "cloud"):
            prof = paradigms._tier_profile(sc, tier)
            assert derive_tier_slots(prof, sc.cloud, base, kv) \
                == ref_derive_slots(paradigms._tier_profile(rsc, tier),
                                    rsc.cloud, base, kv)
    for nbytes in (1e3, 1e5, 1e7):
        for link in ("dev_edge", "edge_cloud", "dev_cloud"):
            for tier in ("device", "edge", "cloud"):
                assert _asdict(compression_decision(
                    nbytes, paradigms._tier_profile(sc, tier),
                    getattr(sc, link))) == _asdict(ref_compression(
                        nbytes, paradigms._tier_profile(rsc, tier),
                        getattr(rsc, link)))
    router, ref_router = AdmissionRouter(pc, sc), RefRouter(rc, rsc)
    rs = np.random.RandomState(1)
    for _ in range(16):
        args = (int(rs.randint(4, 30)), int(rs.randint(1, 20)))
        qc = {t: float(rs.exponential(0.01))
              for t in ("device", "edge", "cloud")}
        assert _asdict(router.route(*args, queue_cost=qc)) \
            == _asdict(ref_router.route(*args, queue_cost=qc))
    assert router.route_counts == ref_router.route_counts
    assert router.split_count == ref_router.split_count


# ---------------------------------------------------------------------------
# cluster runs against the reference cluster
# ---------------------------------------------------------------------------

RUNS = {
    "default-raw": (lambda m: m.Scenario.default(),
                    dict(kv_handoff="raw")),
    "outage-raw": (lambda m: m.Scenario.tier_outage("edge", at=0.03),
                   dict(kv_handoff="raw")),
    "outage-paged-int8": (lambda m: m.Scenario.tier_outage("edge", at=0.03),
                          dict(kv_handoff="int8", paged=True,
                               page_size=16)),
}


def _assert_greedy_equal(rm, rp, prompt, got, want):
    """Greedy tokens equal, except at a bf16 argmax tie of the reference
    (top-2 logits within 1e-2, the rule of tests/test_torch_scheduler.py);
    after such a flip the continuations diverge and the comparison stops."""
    if got == want:
        return
    seq = np.concatenate([prompt, np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    logs = np.asarray(logits[0, prompt.size - 1:])
    for k, (a, b) in enumerate(zip(got, want)):
        if a != b:
            gap = float(logs[k][b] - logs[k][a])
            assert 0.0 <= gap < 1e-2, \
                f"token {k}: got {a}, want {b}, ref logit gap {gap:.3e}"
            return
    assert len(got) == len(want)


def _trace(vocab):
    rs = np.random.RandomState(0)
    return [rs.randint(0, vocab, int(rs.randint(6, 13))) for _ in range(6)]


def _run(cluster_cls, cfg_cls, paradigm_mod, model, params, run):
    scenario, extra = RUNS[run]
    cl = cluster_cls(model, params, scenario(paradigm_mod),
                     plan_cfg=(get_config(PLAN) if cluster_cls
                               is TieredServingCluster else ref_config(PLAN)),
                     cfg=cfg_cls(base_slots=2, max_len=64, prefill_chunk=8,
                                 **extra))
    crs = [cl.submit(p.copy(), max_new=8, deadline=0.05, arrival=i * 0.002)
           for i, p in enumerate(_trace(model.cfg.vocab_size))]
    cl.run()
    return cl, crs


@pytest.fixture(scope="module")
def models():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    return rm, rp, tm, tp


@pytest.fixture(scope="module")
def ref_runs(models):
    rm, rp, _, _ = models
    return {run: _run(RefCluster, RefClusterConfig, ref_paradigms, rm, rp,
                      run) for run in RUNS}


@pytest.mark.parametrize("run", list(RUNS))
def test_cluster_run_matches_reference(models, ref_runs, run):
    rm, rp, tm, tp = models
    ref_cl, ref_crs = ref_runs[run]
    cl, crs = _run(TieredServingCluster, ClusterConfig, paradigms, tm, tp,
                   run)
    st, want = cl.stats(), ref_cl.stats()
    for key in ("requests", "completed", "splits", "route_counts",
                "migration", "dead_tiers", "resilience"):
        assert st.get(key) == want.get(key), key
    np.testing.assert_allclose(
        [st["p50_latency_s"], st["p95_latency_s"], st["deadline_hit_rate"]],
        [want["p50_latency_s"], want["p95_latency_s"],
         want["deadline_hit_rate"]], rtol=1e-9)
    for name, ts in st["tiers"].items():
        ws = want["tiers"][name]
        for key in ("routed", "dead", "n_slots", "tokens"):
            assert ts[key] == ws[key], (name, key)
        np.testing.assert_allclose(
            [ts[k] for k in ("vclock_s", "utilization", "slot_occupancy",
                             "measured_depth")],
            [ws[k] for k in ("vclock_s", "utilization", "slot_occupancy",
                             "measured_depth")], rtol=1e-9, atol=1e-12)
    for cr, rc in zip(crs, ref_crs):
        assert (cr.decision.tier, cr.decision.prefill_tier,
                cr.decision.paradigm, cr.final_tier, cr.migrations,
                cr.requeues, cr.handoff_bytes, cr.handoff_compressed) == (
            rc.decision.tier, rc.decision.prefill_tier, rc.decision.paradigm,
            rc.final_tier, rc.migrations, rc.requeues, rc.handoff_bytes,
            rc.handoff_compressed)
        np.testing.assert_allclose([cr.t_done_v, cr.handoff_time],
                                   [rc.t_done_v, rc.handoff_time],
                                   rtol=1e-9, atol=1e-12)
        _assert_greedy_equal(rm, rp, np.asarray(cr.req.tokens, np.int32),
                             cr.req.out_tokens, rc.req.out_tokens)
    if run != "default-raw":
        assert st["migration"]["outage_migrations"] >= 1
        assert all(cr.final_tier != "edge" for cr in crs if cr.migrations)
    if run == "outage-paged-int8":
        assert st["migration"]["compressed"] >= 1
        assert st["migration"]["bytes_moved"] < st["migration"]["bytes_raw"]


def test_unported_cluster_options_are_rejected(models):
    _, _, tm, tp = models
    # spec_draft is ported, for ModelGroup clusters only
    with pytest.raises(ValueError, match="ModelGroup"):
        TieredServingCluster(tm, tp, cfg=ClusterConfig(spec_draft="draft"))
    assert ClusterConfig(async_decode=True).async_decode   # ported
    with pytest.raises(ValueError, match="readback_interval"):
        TieredServingCluster(tm, tp, cfg=ClusterConfig(async_decode=True,
                                                       readback_interval=0))
    with pytest.raises(ValueError):
        ClusterConfig(kv_handoff="fp8")
    with pytest.raises(ValueError):
        TieredServingCluster([("a", tm, tp)], tp)


def test_serve_tier_outage_smoke():
    """The launch driver exposes the outage scenario end to end, with the
    reference driver's routes and migration ledger on the same trace."""
    kw = dict(rate=100.0, n_requests=8, base_slots=2, prompt_len=12,
              max_new=8, scenario="tier-outage", seed=0, quiet=True)
    stats = serve_tiered_poisson(ARCH, device="cpu", **kw)
    assert stats["completed"] == 8 and stats["tokens"] == 64
    assert stats["tiers"]["edge"]["dead"]
    assert "resilience" in stats and stats["wall_s"] > 0
    mig = stats["migration"]
    assert mig["outage_migrations"] + mig["requeued"] >= 1
    want = ref_serve_tiered(ARCH, **kw)
    assert stats["route_counts"] == want["route_counts"]
    assert stats["migration"] == want["migration"]
