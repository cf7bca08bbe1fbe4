"""The port's multi-model pools on the CPU at smoke widths: a trio of
granite-3-2b (dense GQA, head dim 64), yi-6b (dense GQA, G 2 at smoke
size) and deepseek-v3 (MLA + MoE) behind one ``MultiModelScheduler``.

* Each model's streams equal a dedicated port scheduler's fed the same
  requests, bit for bit, greedy and sampled (one generator seed).
* On the reference's weights the greedy streams equal the reference
  ``MultiModelScheduler``'s, a bf16 top-2 tie (or a router tie on the MoE
  model) excused only as a tie.
* The prefill budget is pool-wide, and exit counters are per arena.
* The tiered cluster over a ``ModelGroup`` gives the reference cluster's
  routes, migration ledger, per-model counts and virtual latencies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import Scenario as RefScenario
from repro.models import Model as RefModel
from repro.serving import ClusterConfig as RefClusterConfig
from repro.serving import ModelGroup as RefGroup
from repro.serving import MultiModelScheduler as RefPool
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import TieredServingCluster as RefCluster
from repro.serving.router import AdmissionRouter as RefRouter
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import Scenario
from repro_torch.launch.serve import (serve_multi_poisson,
                                      serve_multi_tiered_poisson)
from repro_torch.models import Model
from repro_torch.serving import (ContinuousBatchScheduler, ModelGroup,
                                 MultiModelScheduler, Request,
                                 SchedulerConfig, TieredServingCluster)
from repro_torch.serving.cluster import ClusterConfig
from repro_torch.serving.router import AdmissionRouter

TRIO = ("granite-3-2b-smoke", "yi-6b-smoke", "deepseek-v3-671b-smoke")
TIE = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trio():
    """(name, ref model, ref params, port model, port params) each."""
    out = []
    for i, arch in enumerate(TRIO):
        rm = RefModel(ref_config(arch))
        rp = rm.init(jax.random.PRNGKey(i))
        tm = Model(get_config(arch), device="cpu")
        out.append((arch, rm, rp, tm,
                    params_from_jax(jax.tree.map(np.asarray, rp))))
    return out


def _port_group(entries):
    return ModelGroup([(n, tm, tp) for n, _, _, tm, tp in entries])


def _ref_group(entries):
    return RefGroup([(n, rm, rp) for n, rm, rp, _, _ in entries])


def _requests(entries, rs, per_model=2, max_new=6):
    """(model, prompt) pairs alternating over the models."""
    out = []
    for _ in range(per_model):
        for name, _, _, tm, _ in entries:
            out.append((name, rs.randint(0, tm.cfg.vocab_size,
                                         int(rs.randint(3, 12)))
                        .astype(np.int32)))
    return out


def _cfg(cls, **kw):
    base = dict(n_slots=2, max_len=24, prefill_chunk=4)
    base.update(kw)
    return cls(**base)


def _submit(sched, req_cls, reqs, max_new=6):
    out = [req_cls(tokens=p.copy(), max_new=max_new, model=m, req_id=i)
           for i, (m, p) in enumerate(reqs)]
    for r in out:
        sched.submit(r)
    return out


def _tie_or_equal(rm, rp, prompt, got, want):
    """Equal streams, or a first difference at a top-2 tie (within 1e-2)
    of the reference's logits; the MoE model's router ties show up as
    such gaps too (``tests/test_torch_deepseek.py`` records them)."""
    if got == want:
        return
    seq = np.concatenate([prompt, np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    logs = np.asarray(logits[0, prompt.size - 1:])
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    gap = float(logs[k][want[k]] - logs[k][got[k]])
    assert 0.0 <= gap < TIE, f"token {k}: ref logit gap {gap:.3e}"


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_multi_pool_matches_dedicated_greedy(trio, paged):
    """All three models through one pool: each model's streams equal a
    dedicated port scheduler's bit for bit, its exit counters sum to its
    tokens, and the streams equal the reference pool's (tie rule)."""
    kw = dict(paged=True, page_size=8) if paged else {}
    reqs = _requests(trio, np.random.RandomState(0))
    pool = MultiModelScheduler(_port_group(trio),
                               _cfg(SchedulerConfig, **kw))
    got = _submit(pool, Request, reqs)
    pool.run()
    assert len(pool.completed) == len(reqs) and not pool.has_work
    for name, rm, rp, tm, tp in trio:
        ded = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, **kw),
                                       device="cpu")
        mine = [(m, p) for m, p in reqs if m == name]
        want = _submit(ded, Request, mine)
        ded.run()
        assert [r.out_tokens for r in got if r.model == name] \
            == [r.out_tokens for r in want], f"{name}: pooling changed it"
        arena = pool.pools[name]
        assert arena.flush_counters().sum() == arena.tokens_served == 12
        np.testing.assert_array_equal(arena.exit_counts, ded.exit_counts)
        if paged:
            assert arena.page_alloc.free_count + len(arena.prefix_cache) \
                == arena.page_alloc.n_pages
    ref = RefPool(_ref_group(trio), _cfg(RefConfig, **kw))
    ref_reqs = _submit(ref, RefRequest, reqs)
    ref.run()
    models = {name: (rm, rp) for name, rm, rp, _, _ in trio}
    for r, rr, (m, p) in zip(got, ref_reqs, reqs):
        _tie_or_equal(*models[m], p, r.out_tokens, rr.out_tokens)
    assert pool.tokens_served == ref.tokens_served == 36


def test_multi_pool_matches_dedicated_sampled(trio):
    """Sampling at T 0.8 from one generator seed: each arena draws the
    same key a dedicated scheduler given that seed draws, so the samples
    are the same too."""
    entries = trio[:2]
    reqs = _requests(entries, np.random.RandomState(1))
    pool = MultiModelScheduler(_port_group(entries),
                               _cfg(SchedulerConfig, temperature=0.8))
    got = _submit(pool, Request, reqs)
    gen = torch.Generator().manual_seed(7)
    pool.run(rng=gen)
    for name, _, _, tm, tp in entries:
        ded = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                                    temperature=0.8),
                                       device="cpu")
        want = _submit(ded, Request, [(m, p) for m, p in reqs
                                      if m == name])
        ded.run(rng=torch.Generator().manual_seed(7))
        assert [r.out_tokens for r in got if r.model == name] \
            == [r.out_tokens for r in want], f"{name}: samples diverged"
    greedy = MultiModelScheduler(_port_group(entries),
                                 _cfg(SchedulerConfig))
    g = _submit(greedy, Request, reqs)
    greedy.run()
    assert [r.out_tokens for r in g] != [r.out_tokens for r in got]


def test_multi_pool_cross_model_prefill_fairness(trio):
    """max_prefill_chunks_per_step=1 is pool-wide: one model's long
    admission spreads over many polls while the other model keeps
    decoding, and no poll runs more than one chunk over all models."""
    (name_a, _, _, ma, _), (name_b, _, _, mb, _) = trio[0], trio[1]
    pool = MultiModelScheduler(
        _port_group(trio[:2]),
        _cfg(SchedulerConfig, max_len=48, max_prefill_chunks_per_step=1))
    rs = np.random.RandomState(2)
    pool.submit(Request(tokens=rs.randint(0, ma.cfg.vocab_size, 4),
                        max_new=16, model=name_a))
    while not pool.pools[name_a].active.any():
        pool.poll()
    pool.submit(Request(tokens=rs.randint(0, mb.cfg.vocab_size, 16),
                        max_new=4, model=name_b))   # 16 tokens = 4 chunks
    reports = []
    while pool.has_work:
        reports.append(pool.poll())
    b_prefill = [r for r in reports if r.per_model.get(name_b)
                 and r.per_model[name_b].prefill_chunks]
    assert len(b_prefill) >= 4
    assert all(r.prefill_chunks <= 1 for r in reports)
    assert all(r.per_model[name_a].decode_stepped for r in b_prefill
               if name_a in r.per_model)
    assert any(r.per_model.get(name_a) for r in b_prefill)


def test_multi_pool_exit_counter_isolation(trio):
    """Serving one model leaves the other arena's exit counters alone."""
    (name_a, _, _, ma, _), (name_b, _, _, mb, _) = trio[0], trio[1]
    pool = MultiModelScheduler(_port_group(trio[:2]), _cfg(SchedulerConfig))
    rs = np.random.RandomState(3)
    pool.submit(Request(tokens=rs.randint(0, ma.cfg.vocab_size, 5),
                        max_new=7, model=name_a))
    pool.run()
    counts = pool.flush_counters()
    assert counts[name_a].sum() == 7 and counts[name_b].sum() == 0
    pool.submit(Request(tokens=rs.randint(0, mb.cfg.vocab_size, 4),
                        max_new=5, model=name_b))
    pool.run()
    counts = pool.flush_counters()
    assert counts[name_a].sum() == 7 and counts[name_b].sum() == 5
    st = pool.exit_stats()
    assert abs(sum(v for k, v in st[name_a].items()
                   if k.endswith("_frac")) - 1.0) < 1e-9
    with pytest.raises(KeyError):
        pool.submit(Request(tokens=np.arange(3), model="no-such-model"))


def test_router_routes_per_model_as_reference():
    """Per-model cost graphs: the same prompt prices the heavy model's
    request above the light one's, and every decision equals the
    reference router's."""
    plans = {"heavy": "mistral-nemo-12b", "light": "granite-3-2b"}
    r = AdmissionRouter({k: get_config(v) for k, v in plans.items()},
                        Scenario.default())
    rr = RefRouter({k: ref_config(v) for k, v in plans.items()},
                   RefScenario.default())
    for prompt, new in ((512, 32), (16, 8), (128, 64)):
        for m in plans:
            assert dataclasses.asdict(r.route(prompt, new, model=m)) \
                == dataclasses.asdict(rr.route(prompt, new, model=m))
    assert r.route_counts_by_model == rr.route_counts_by_model
    heavy, light = (r.route(512, 32, model=m) for m in plans)
    assert heavy.tier == "cloud"
    assert light.predicted_latency < heavy.predicted_latency


CLUSTER_RUNS = {
    "default": (lambda m: m.Scenario.default(), {}),
    "outage-paged-int8": (lambda m: m.Scenario.tier_outage("edge", at=0.03),
                          dict(kv_handoff="int8", paged=True, page_size=8)),
}


def _cluster(cls, cfg_cls, mod, plan, group, run, entries):
    scenario, extra = CLUSTER_RUNS[run]
    cl = cls(group, scenario=scenario(mod), plan_cfg=plan,
             cfg=cfg_cls(base_slots=2, max_len=48, prefill_chunk=8,
                         **extra))
    rs = np.random.RandomState(4)
    crs = []
    for i in range(6):
        name, _, _, tm, _ = entries[i % 2]
        crs.append(cl.submit(rs.randint(0, tm.cfg.vocab_size,
                                        int(rs.randint(3, 9))),
                             max_new=4, arrival=0.01 * i, deadline=0.05,
                             model=name))
    cl.run()
    return cl, crs


@pytest.mark.parametrize("run", list(CLUSTER_RUNS))
def test_cluster_multi_model_trace_matches_reference(trio, run):
    """A mixed granite / yi trace through the tiered cluster, planned as
    the full-size models: routes, the ledger, per-model counts and the
    virtual latencies equal the reference cluster's."""
    import repro.core as ref_core
    import repro_torch.core as core
    entries = trio[:2]
    plans = {entries[0][0]: "granite-3-2b", entries[1][0]: "yi-6b"}
    cl, crs = _cluster(TieredServingCluster, ClusterConfig, core,
                       {k: get_config(v) for k, v in plans.items()},
                       _port_group(entries), run, entries)
    ref_cl, ref_crs = _cluster(RefCluster, RefClusterConfig, ref_core,
                               {k: ref_config(v) for k, v in plans.items()},
                               _ref_group(entries), run, entries)
    st, want = cl.stats(), ref_cl.stats()
    assert st["completed"] == 6
    for key in ("requests", "completed", "splits", "route_counts",
                "migration", "dead_tiers", "resilience"):
        assert st.get(key) == want.get(key), key
    for name in plans:
        for key in ("routed", "route_counts", "tokens"):
            assert st["models"][name][key] == want["models"][name][key]
        assert st["models"][name]["tokens"] == 12
    for name, ts in st["tiers"].items():
        ws = want["tiers"][name]
        for key in ("routed", "dead", "n_slots", "tokens"):
            assert ts[key] == ws[key], (name, key)
        np.testing.assert_allclose(
            [ts[k] for k in ("vclock_s", "utilization", "slot_occupancy")],
            [ws[k] for k in ("vclock_s", "utilization", "slot_occupancy")],
            rtol=1e-9, atol=1e-12)
    models = {name: (rm, rp) for name, rm, rp, _, _ in entries}
    for cr, rc in zip(crs, ref_crs):
        assert (cr.decision.tier, cr.decision.paradigm, cr.final_tier,
                cr.migrations, cr.requeues, cr.handoff_bytes) == (
            rc.decision.tier, rc.decision.paradigm, rc.final_tier,
            rc.migrations, rc.requeues, rc.handoff_bytes)
        np.testing.assert_allclose([cr.t_done_v, cr.handoff_time],
                                   [rc.t_done_v, rc.handoff_time],
                                   rtol=1e-9, atol=1e-12)
        _tie_or_equal(*models[cr.req.model],
                      np.asarray(cr.req.tokens, np.int32),
                      cr.req.out_tokens, rc.req.out_tokens)
    if run != "default":
        assert st["migration"]["outage_migrations"] >= 1
        assert st["migration"]["compressed"] >= 1


def test_serve_multi_entry_points():
    """``serve_multi_poisson`` serves every request on its model's arena;
    ``serve_multi_tiered_poisson`` with a speculative draft routes as the
    reference entry point does on the same trace."""
    from repro.launch.serve import \
        serve_multi_tiered_poisson as ref_multi_tiered
    archs = ["granite-3-2b-smoke", "yi-6b-smoke"]
    st = serve_multi_poisson(archs, rate=200.0, n_requests=4, slots=2,
                             prompt_len=12, max_new=4, paged=True,
                             max_prefill_chunks=1, device="cpu",
                             quiet=True)
    assert st["tokens"] == 16 and st["polls"] > 0
    assert st["request_models"] == archs * 2
    assert all(st["models"][a]["tokens"] == 8 for a in archs)
    assert all(len(o) == 4 for o in st["outputs"])
    archs = ["granite-3-2b-smoke", "deepseek-v3-671b-smoke"]
    kw = dict(rate=50.0, n_requests=4, base_slots=2, prompt_len=12,
              max_new=10, threshold=0.0, scenario="high-rtt-access",
              spec_draft="granite-3-2b-smoke", spec_k=6, seed=0)
    st = serve_multi_tiered_poisson(archs, device="cpu", quiet=True, **kw)
    want = ref_multi_tiered(archs, quiet=True, **kw)
    assert st["completed"] == 4 and st["tokens"] == 40
    assert st["route_counts"] == want["route_counts"]
    for a in archs:
        assert st["models"][a]["route_counts"] \
            == want["models"][a]["route_counts"]
    assert st["speculative"]["requests_completed"] \
        == want["speculative"]["requests_completed"] >= 1
