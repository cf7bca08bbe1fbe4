"""The serving options the reference runs and the port now has, each on the
CPU against the reference on the same weights (``bridge.params_from_jax``)
or against the port's own default path.

* ``SchedulerConfig.long_mode``: ring caches at ``long_context_window``.
  The reference's greedy tokens under the tie rule (both tokens within
  1e-2 of the top logit of the reference's replay) past the wrap point;
  a migration past the wrap ships the whole ring and continues bit for
  bit (``tests/test_migration.py``'s ring test); a paged arena refuses a
  ring.
* ``SchedulerConfig.n_pages``: 0 keeps ``n_slots`` full rows; a smaller
  pool admits as many slots in fewer bytes, admission waits while the
  pool is full, the tokens equal the full pool's, and every page comes
  back.
* ``SchedulerConfig.prefix_cache``: off, a paged arena runs without the
  radix tree and equals the contiguous arena (``tests/test_paged.py``'s
  slot-reuse parity); on, a shared prefix hits and the tokens stay equal.
* ``ClusterConfig.temperature``: refused beside ``spec_draft``, as the
  reference refuses it; a sampled engine with a scenario now routes its
  rows, reproducibly from one generator seed.
* ``ClusterConfig.stream_tokens``: the router prices per-token downlinks
  without a draft, as the reference's does; with a draft the speculative
  bridge equals the reference cluster's.
* ``ClusterConfig.long_mode``, ``ServeConfig.long_mode`` and the CLI's
  ``--long`` / ``--prefill-chunk`` reach every pool (the port has no
  ``flush_every``: no poll reads the exit counters but a controller's).
"""
import dataclasses

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
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import ModelGroup as RefGroup
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import TieredServingCluster as RefCluster
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model
from repro_torch.serving import (ClusterConfig, ContinuousBatchScheduler,
                                 ModelGroup, Request, SchedulerConfig,
                                 ServeConfig, ServingEngine,
                                 TieredServingCluster)

ARCH = "granite-3-2b-smoke"
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
def granite():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    return rm, rp, tm, params_from_jax(jax.tree.map(np.asarray, rp))


def _tie_or_equal(rm, rp, prompt, got, want, long_mode=False):
    """Equal streams, or a first difference at a top-2 tie of the
    reference's replay logits (through the ring with ``long_mode``).
    Returns whether they were equal."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return True
    seq = np.concatenate([prompt, np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]},
                           long_mode=long_mode)
    logs = np.asarray(logits[0, prompt.size - 1:])
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    top = float(logs[k].max())
    gaps = [top - float(logs[k][t]) for t in (got[k], want[k])]
    assert max(gaps) < TIE, f"token {k}: ref logit gaps {gaps}"
    return False


def _serve(sched, req_cls, prompts, max_new):
    reqs = [req_cls(tokens=np.asarray(p, np.int32), max_new=max_new,
                    req_id=i) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.out_tokens) for r in reqs]


def _prompts(seed, lens, vocab=1024):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# SchedulerConfig.long_mode
# ---------------------------------------------------------------------------

def _ring_cfg(cls, n_slots=2, **kw):
    w = get_config(ARCH).long_context_window
    return cls(n_slots=n_slots, max_len=w + 16, prefill_chunk=4,
               long_mode=True, **kw)


def test_long_mode_ring_matches_reference(granite):
    """A prompt that wraps the 64-token ring and one that fills most of
    it, segmented and monolithic: the ring is the cache
    (``cache_len_for``), and the greedy tokens are the reference's under
    the tie rule.  One slot, reused by the second request, as the
    reference's ring test serves one request at a time: batched two or
    three rows wide, the port's bf16 projections round otherwise and tie
    two tokens exactly where the reference's gap is 0.0117 (``PERF.md``
    §7)."""
    rm, rp, tm, tp = granite
    w = tm.cfg.long_context_window
    prompts = _prompts(7, (w + 2, w - 20))
    for segmented in (True, False):
        s = ContinuousBatchScheduler(
            tm, tp, _ring_cfg(SchedulerConfig, 1, segmented=segmented),
            device="cpu")
        assert s.cache["blocks"][0][0].shape[2] == w
        got = _serve(s, Request, prompts, 10)
        want = _serve(RefScheduler(rm, rp, _ring_cfg(RefConfig, 1,
                                                     segmented=segmented)),
                      RefRequest, prompts, 10)
        for p, g, wt in zip(prompts, got, want):
            _tie_or_equal(rm, rp, p, g, wt, long_mode=True)


def test_ring_migration_past_wrap_stays_bit_identical(granite):
    """A ring (window 64 < context 80) has no truncatable time axis: every
    leaf ships whole, and a slot exported past the wrap point continues
    bit for bit in another arena."""
    _, _, tm, tp = granite
    w = tm.cfg.long_context_window
    prompt = _prompts(7, (w + 2,))[0]
    want = _serve(ContinuousBatchScheduler(tm, tp, _ring_cfg(SchedulerConfig),
                                           device="cpu"),
                  Request, [prompt], 10)[0]
    src = ContinuousBatchScheduler(tm, tp, _ring_cfg(SchedulerConfig),
                                   device="cpu")
    r = Request(tokens=prompt.copy(), max_new=10)
    src.submit(r)
    for _ in range(6):
        src.poll()
    assert not r.done
    snap = src.export_slot(r.slot)
    assert all(ax == -1 for ax in src._row_axes_flat)
    assert snap.position > w                       # exported past the wrap
    src.release_slot(r.slot)
    dst = ContinuousBatchScheduler(tm, tp, _ring_cfg(SchedulerConfig),
                                   device="cpu")
    dst.import_slot(snap)
    dst.run()
    assert r.done and r.out_tokens == want


def test_paged_arena_refuses_a_ring(granite):
    _, _, tm, tp = granite
    with pytest.raises(ValueError, match="ring-buffer"):
        ContinuousBatchScheduler(tm, tp, _ring_cfg(SchedulerConfig,
                                                   paged=True),
                                 device="cpu")


# ---------------------------------------------------------------------------
# SchedulerConfig.n_pages and prefix_cache
# ---------------------------------------------------------------------------

def _paged(**kw):
    return SchedulerConfig(n_slots=4, max_len=64, prefill_chunk=8,
                           paged=True, page_size=16, **kw)


def test_n_pages_smaller_pool_admits_within_its_bytes(granite):
    """Four slots over 5 pages instead of 16: each request takes two
    pages, so at most two run at once and admission waits for pages; the
    tokens equal the full pool's and the reference's small pool, and
    every page comes back (no prefix tree holds any)."""
    rm, rp, tm, tp = granite
    prompts = _prompts(3, (12, 20, 11, 17, 14))
    full = ContinuousBatchScheduler(tm, tp, _paged(prefix_cache=False),
                                    device="cpu")
    assert full.page_alloc.n_pages == 16
    want = _serve(full, Request, prompts, 6)
    small = ContinuousBatchScheduler(
        tm, tp, _paged(n_pages=5, prefix_cache=False), device="cpu")
    assert small.page_alloc.n_pages == 5
    reqs = [Request(tokens=p.copy(), max_new=6, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        small.submit(r)
    peak = 0
    while small.has_work:
        small.poll()
        peak = max(peak, int(small.active.sum()))
    assert peak == 2
    assert [list(r.out_tokens) for r in reqs] == want
    assert small.page_alloc.free_count == 5
    ref = RefScheduler(rm, rp, RefConfig(n_slots=4, max_len=64,
                                         prefill_chunk=8, paged=True,
                                         page_size=16, n_pages=5,
                                         prefix_cache=False))
    for p, g, w in zip(prompts, want, _serve(ref, RefRequest, prompts, 6)):
        _tie_or_equal(rm, rp, p, g, w)


def test_prefix_cache_switch(granite):
    """``prefix_cache=False``: no radix tree, and the paged arena equals
    the contiguous one through slot reuse (six prompts, two slots).  On
    (the default): a shared 32-token prefix hits, and the tokens stay
    the same."""
    _, _, tm, tp = granite
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 1024, 32).astype(np.int32)
    prompts = [np.concatenate([prefix, p]) if i % 2 else p
               for i, p in enumerate(_prompts(1, (5, 20, 14, 9, 6, 7)))]

    def cfg(**kw):
        return SchedulerConfig(n_slots=2, max_len=64, prefill_chunk=8,
                               page_size=16, **kw)

    want = _serve(ContinuousBatchScheduler(tm, tp, cfg(), device="cpu"),
                  Request, prompts, 6)
    off = ContinuousBatchScheduler(tm, tp, cfg(paged=True,
                                               prefix_cache=False),
                                   device="cpu")
    assert off.prefix_cache is None
    assert _serve(off, Request, prompts, 6) == want
    assert off.prefix_hit_tokens == 0
    on = ContinuousBatchScheduler(tm, tp, cfg(paged=True), device="cpu")
    assert on.prefix_cache is not None
    assert _serve(on, Request, prompts, 6) == want
    assert on.prefix_hit_tokens > 0


# ---------------------------------------------------------------------------
# ClusterConfig.temperature, stream_tokens, long_mode
# ---------------------------------------------------------------------------

def test_cluster_temperature_with_spec_draft_is_refused(granite):
    _, _, tm, tp = granite
    group = ModelGroup([("small", tm, tp), ("big", tm, tp)])
    plan = {"small": get_config("granite-3-2b"),
            "big": get_config("deepseek-v3-671b")}
    with pytest.raises(ValueError, match="temperature"):
        TieredServingCluster(
            group, scenario=core.Scenario.default(), plan_cfg=plan,
            cfg=ClusterConfig(spec_draft="small", temperature=0.5))


def test_sampled_engine_routes_with_a_scenario(granite):
    """A sampled engine given a scenario routes its rows through the tier
    pools, each sampling at the engine's temperature: the same generator
    seed draws the same tokens, another seed or greedy others."""
    _, _, tm, tp = granite
    prompts = np.random.RandomState(2).randint(0, 1024, (4, 12)).astype(
        np.int32)

    def gen(temperature, seed):
        eng = ServingEngine(tm, tp, ServeConfig(temperature=temperature),
                            scenario=core.Scenario.default(),
                            plan_cfg=get_config("granite-3-2b"))
        rng = None if seed is None else torch.Generator().manual_seed(seed)
        out = eng.generate(prompts, max_new=6, rng=rng).tolist()
        assert all(tr.sched.cfg.temperature == temperature
                   for tr in eng._cluster.tiers.values())
        assert sum(eng.route_counts.values()) == 4
        return out

    a, b = gen(0.8, 3), gen(0.8, 3)
    assert a == b and a != gen(0.8, 4) and a != gen(0.0, None)
    assert all(0 <= t < 1024 for row in a for t in row)


@pytest.mark.parametrize("stream", [False, True], ids=["off", "on"])
def test_cluster_stream_tokens_routes_as_reference(granite, stream):
    """``stream_tokens`` without a draft: the router prices each token's
    downlink exactly when asked, and every decision, tier count and
    virtual completion time equals the reference cluster's."""
    rm, rp, tm, tp = granite

    def run(cls, cfg_cls, mod, model, params, plan):
        cl = cls(model, params, scenario=mod.Scenario.high_rtt_access(),
                 plan_cfg=plan,
                 cfg=cfg_cls(base_slots=2, max_len=48, prefill_chunk=8,
                             stream_tokens=stream))
        rs = np.random.RandomState(5)
        crs = [cl.submit(rs.randint(0, 1024, int(n)), max_new=6,
                         arrival=0.02 * i, deadline=0.05)
               for i, n in enumerate((8, 30, 12, 5))]
        cl.run()
        return cl, crs

    cl, crs = run(TieredServingCluster, ClusterConfig, core, tm, tp,
                  get_config("granite-3-2b"))
    ref_cl, ref_crs = run(RefCluster, RefClusterConfig, ref_core, rm, rp,
                          ref_config("granite-3-2b"))
    assert cl.router.stream_tokens is stream
    for cr, rc in zip(crs, ref_crs):
        assert dataclasses.asdict(cr.decision) \
            == dataclasses.asdict(rc.decision)
        np.testing.assert_allclose(cr.t_done_v, rc.t_done_v, rtol=1e-9)
    assert cl.stats()["route_counts"] == ref_cl.stats()["route_counts"]


def test_cluster_spec_bridge_with_stream_tokens(granite):
    """The reference's own speculative cluster configuration
    (``stream_tokens=True`` beside ``spec_draft``) in both packages: the
    same decisions, acceptance and virtual latencies, and the port's
    streams equal the reference's under the tie rule."""
    rm, rp, tm, tp = granite

    def run(cls, cfg_cls, mod, group, plan):
        cl = cls(group, scenario=mod.Scenario.high_rtt_access(),
                 plan_cfg={"small": plan("granite-3-2b"),
                           "big": plan("deepseek-v3-671b")},
                 cfg=cfg_cls(base_slots=2, max_len=48, prefill_chunk=8,
                             exit_threshold=0.0, spec_draft="small",
                             spec_k=6, stream_tokens=True))
        rs = np.random.RandomState(5)
        prompts = [rs.randint(0, 1024, n) for n in (8, 12, 10)]
        crs = [cl.submit(p.copy(), max_new=10, arrival=0.05 * i,
                         model="big")
               for i, p in enumerate(prompts)]
        cl.run()
        return cl, crs, prompts

    cl, crs, prompts = run(TieredServingCluster, ClusterConfig, core,
                           ModelGroup([("small", tm, tp), ("big", tm, tp)]),
                           get_config)
    ref_cl, ref_crs, _ = run(RefCluster, RefClusterConfig, ref_core,
                             RefGroup([("small", rm, rp), ("big", rm, rp)]),
                             ref_config)
    for p, cr, rc in zip(prompts, crs, ref_crs):
        assert cr.decision.paradigm == "speculative"
        assert dataclasses.asdict(cr.decision) \
            == dataclasses.asdict(rc.decision)
        np.testing.assert_allclose(cr.t_done_v, rc.t_done_v, rtol=1e-9)
        _tie_or_equal(rm, rp, p, cr.req.out_tokens, rc.req.out_tokens)
    sp, ref_sp = cl.stats()["speculative"], ref_cl.stats()["speculative"]
    for key in ("rounds", "committed", "acceptance_len"):
        assert sp[key] == ref_sp[key], key


def test_cluster_long_mode_and_flush_every_reach_every_pool(granite):
    """``long_mode`` reaches the tier pools (and a speculative pair's),
    and a ring-mode cluster's routes and tokens equal the reference
    cluster's under the tie rule.  ``flush_every`` is the reference's
    alone: the port's polls read no counters."""
    rm, rp, tm, tp = granite
    w = tm.cfg.long_context_window

    def run(cls, cfg_cls, mod, model, params, plan):
        cl = cls(model, params, scenario=mod.Scenario.default(),
                 plan_cfg=plan,
                 cfg=cfg_cls(base_slots=2, max_len=w + 16, prefill_chunk=8,
                             long_mode=True))
        prompts = _prompts(9, (w + 4, 10, w - 8))
        crs = [cl.submit(p.copy(), max_new=8, arrival=0.01 * i)
               for i, p in enumerate(prompts)]
        cl.run()
        return cl, crs, prompts

    cl, crs, prompts = run(TieredServingCluster, ClusterConfig, core, tm, tp,
                           get_config("granite-3-2b"))
    for tr in cl.tiers.values():
        assert tr.sched.cfg.long_mode
    ref_cl, ref_crs, _ = run(RefCluster, RefClusterConfig, ref_core, rm, rp,
                             ref_config("granite-3-2b"))
    for p, cr, rc in zip(prompts, crs, ref_crs):
        assert cr.done and cr.final_tier == rc.final_tier
        _tie_or_equal(rm, rp, p, cr.req.out_tokens, rc.req.out_tokens,
                      long_mode=True)
    group = ModelGroup([("small", tm, tp), ("big", tm, tp)])
    spec = TieredServingCluster(
        group, scenario=core.Scenario.high_rtt_access(),
        plan_cfg={"small": get_config("granite-3-2b"),
                  "big": get_config("deepseek-v3-671b")},
        cfg=ClusterConfig(base_slots=2, max_len=48, exit_threshold=0.0,
                          spec_draft="small", long_mode=True))
    pair_cfg = spec._spec_pair("big").pools["big"].cfg
    assert pair_cfg.long_mode


def test_cli_long_and_prefill_chunk(granite, monkeypatch):
    """``--long`` and ``--prefill-chunk`` reach the scheduler of a Poisson
    run, the tiered cluster and a batch engine."""
    seen = []
    real = ContinuousBatchScheduler.__init__

    def spy(self, model, params, cfg=None, *a, **kw):
        seen.append(cfg)
        real(self, model, params, cfg, *a, **kw)

    monkeypatch.setattr(ContinuousBatchScheduler, "__init__", spy)
    common = ["--device", "cpu", "--arch", ARCH, "--long",
              "--prefill-chunk", "4", "--requests", "2", "--slots", "2",
              "--prompt-len", "80", "--max-new", "3", "--rate", "100"]
    serve_mod.main(["--mode", "poisson"] + common)
    assert seen[-1].long_mode and seen[-1].prefill_chunk == 4
    serve_mod.main(["--mode", "poisson", "--tiered"] + common)
    assert all(c.long_mode and c.prefill_chunk == 4 for c in seen[1:])
    n = len(seen)
    serve_mod.main(["--mode", "batch", "--device", "cpu", "--arch", ARCH,
                    "--long", "--batch", "2", "--prompt-len", "70",
                    "--max-new", "3"])
    assert len(seen) == n + 1 and seen[-1].long_mode
