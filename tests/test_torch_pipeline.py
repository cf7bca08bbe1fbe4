"""The port's async decode windows (``async_decode``) against its own sync
poll and against the reference's window pipeline, on the CPU.

The contract of tests/test_pipeline.py: token feedback and eos/max_new
termination on the device, one ring readback per committed window, and a
commit replay that reproduces the sync ``poll()`` bit for bit, eos and
max_new included, for granite-3-2b-smoke (GQA) and deepseek-v3-671b-smoke
(MLA + MoE), contiguous and paged, with windows of 3 and 4 steps (neither
divides ``max_new``).  On the CPU the window's step runs eagerly; the card
captures it as a CUDA graph (tests/test_torch_cuda.py).

Against the reference (same weights through ``bridge.params_from_jax``),
greedy tokens must be equal except at a bf16 tie of the reference's top-2
logits (within 1e-2: the parity contract of tests/test_torch_scheduler.py);
after such a flip the comparison of that request stops.  The cluster with
async pools must route, migrate and stamp virtual latencies exactly as the
reference cluster does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import paradigms as ref_paradigms
from repro.models import Model as RefModel
from repro.serving import ClusterConfig as RefClusterConfig
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import TieredServingCluster as RefCluster
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import paradigms
from repro_torch.models import Model
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig)
from repro_torch.serving.cluster import ClusterConfig, TieredServingCluster

GRANITE, DEEPSEEK = "granite-3-2b-smoke", "deepseek-v3-671b-smoke"
LOGIT_TIE = 1e-2
# (arch, paged, readback interval)
CASES = [(GRANITE, False, 3), (GRANITE, True, 4), (DEEPSEEK, False, 4),
         (DEEPSEEK, True, 3)]
IDS = ["granite-contig-r3", "granite-paged-r4", "deepseek-contig-r4",
       "deepseek-paged-r3"]

_MODELS = {}
_RUNS = {}


def _models(arch):
    if arch not in _MODELS:
        rm = RefModel(ref_config(arch))
        rp = rm.init(jax.random.PRNGKey(0))
        tm = Model(get_config(arch), device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, rp))
        _MODELS[arch] = (rm, rp, tm, tp)
    return _MODELS[arch]


def _prompts(vocab, n_req=5, prompt_len=6):
    rs = np.random.RandomState(7)
    return [rs.randint(0, vocab, int(rs.randint(max(1, prompt_len // 2),
                                                prompt_len + 1)))
            for _ in range(n_req)]


def _cfg(cls, async_decode, R, paged, max_new=7, slots=2, **kw):
    max_len = 6 + max_new
    if paged:
        max_len += (-max_len) % 16
    return cls(n_slots=slots, max_len=max_len, prefill_chunk=4,
               exit_threshold=0.0, segmented=False, paged=paged,
               async_decode=async_decode, readback_interval=R, **kw)


def _run(arch, *, ref, async_decode, R=3, paged=False, max_new=7,
         eos_ids=None):
    """One scheduler run over the seeded prompts (5 requests, 2 slots, so
    slots are reused); returns (scheduler, outputs by request)."""
    rm, rp, tm, tp = _models(arch)
    eos_ids = eos_ids or {}
    if ref:
        s = RefScheduler(rm, rp, _cfg(RefConfig, async_decode, R, paged,
                                      max_new))
        req = RefRequest
    else:
        s = ContinuousBatchScheduler(
            tm, tp, _cfg(SchedulerConfig, async_decode, R, paged, max_new),
            device="cpu")
        req = Request
    reqs = [req(tokens=p, max_new=max_new, req_id=j, eos_id=eos_ids.get(j))
            for j, p in enumerate(_prompts(tm.cfg.vocab_size))]
    for r in reqs:
        s.submit(r)
    s.run()
    return s, [list(r.out_tokens) for r in reqs]


def _case_runs(case):
    """Port sync, port async and reference async runs of one case."""
    if case not in _RUNS:
        arch, paged, R = case
        _RUNS[case] = {
            "port_sync": _run(arch, ref=False, async_decode=False, R=R,
                              paged=paged),
            "port_async": _run(arch, ref=False, async_decode=True, R=R,
                               paged=paged),
            "ref_async": _run(arch, ref=True, async_decode=True, R=R,
                              paged=paged)}
    return _RUNS[case]


def _assert_greedy_equal(rm, rp, prompt, got, want):
    """Equal, except at a bf16 argmax tie of the reference's top-2 logits
    (batch-1 prefill of the reference's own tokens)."""
    if got == want:
        return
    seq = np.concatenate([prompt, np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    logs = np.asarray(logits[0, prompt.size - 1:])
    for k, (a, b) in enumerate(zip(got, want)):
        if a != b:
            gap = float(logs[k][b] - logs[k][a])
            assert 0.0 <= gap < LOGIT_TIE, \
                f"token {k}: got {a}, want {b}, ref logit gap {gap:.3e}"
            return
    assert len(got) == len(want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_async_matches_sync_bit_for_bit(case):
    """Slot churn, re-admission and a window that does not divide
    max_new: the async pool's tokens, served-token count and exit counters
    equal the sync monolithic poll's, and the window is built once."""
    runs = _case_runs(case)
    s_sync, out_sync = runs["port_sync"]
    s_async, out_async = runs["port_async"]
    assert out_async == out_sync
    assert all(len(o) == 7 for o in out_async)
    assert s_async.tokens_served == s_sync.tokens_served
    np.testing.assert_array_equal(s_async.exit_counts, s_sync.exit_counts)
    assert s_async.jit_cache_sizes() == {"decode_window": 1}
    assert s_sync.jit_cache_sizes() == {}
    assert not s_async._win_q and s_async.peak_tokens_in_flight > 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_async_matches_reference_async(case):
    """The port's windows against the reference's on the same weights:
    tokens under the parity contract, served tokens and exit counts
    exactly."""
    arch = case[0]
    rm, rp, tm, _ = _models(arch)
    runs = _case_runs(case)
    s_port, out_port = runs["port_async"]
    s_ref, out_ref = runs["ref_async"]
    for p, got, want in zip(_prompts(tm.cfg.vocab_size), out_port, out_ref):
        _assert_greedy_equal(rm, rp, np.asarray(p, np.int32), got, want)
    assert s_port.tokens_served == s_ref.tokens_served
    np.testing.assert_array_equal(s_port.exit_counts, s_ref.exit_counts)
    assert s_port.peak_tokens_in_flight == s_ref.peak_tokens_in_flight


def test_eos_inside_window():
    """An eos found at readback, mid-window: the commit replay cuts the
    stream at the eos token, the trailing ring entries are dropped (no
    wasted slot-steps counted), and the freed slot is re-admitted without
    replaying the dead chain."""
    _, probe = _run(GRANITE, ref=False, async_decode=False)
    eos_ids = {0: probe[0][2]}       # third token, inside a 3-step window
    s_sync, out_sync = _run(GRANITE, ref=False, async_decode=False,
                            eos_ids=eos_ids)
    s_async, out_async = _run(GRANITE, ref=False, async_decode=True, R=3,
                              eos_ids=eos_ids)
    assert len(out_sync[0]) == 3 and out_sync[0][-1] == eos_ids[0]
    assert out_async == out_sync
    assert s_async.tokens_served == s_sync.tokens_served
    _, out_ref = _run(GRANITE, ref=True, async_decode=True, R=3,
                      eos_ids=eos_ids)
    rm, rp, tm, _ = _models(GRANITE)
    for p, got, want in zip(_prompts(tm.cfg.vocab_size), out_async, out_ref):
        _assert_greedy_equal(rm, rp, np.asarray(p, np.int32), got, want)


def test_sync_drains_and_export_works():
    """Export and release refuse a pool with windows in flight; sync()
    commits them, after which a live slot exports, imports into a sync
    pool and finishes there with the tokens an undisturbed run makes."""
    _, _, tm, tp = _models(GRANITE)
    cfg = _cfg(SchedulerConfig, True, 4, True, max_new=12, slots=2)
    prompt = np.arange(4) % tm.cfg.vocab_size
    undisturbed = Request(tokens=prompt, max_new=12)
    base = ContinuousBatchScheduler(tm, tp, cfg, device="cpu")
    base.submit(undisturbed)
    base.run()
    want = undisturbed.out_tokens
    src = ContinuousBatchScheduler(tm, tp, cfg, device="cpu")
    r = Request(tokens=prompt, max_new=12, req_id=0)
    src.submit(r)
    while not src._win_q:
        src.poll()
    with pytest.raises(RuntimeError, match="sync"):
        src.export_slot(r.slot)
    with pytest.raises(RuntimeError, match="sync"):
        src.release_slot(r.slot)
    with pytest.raises(RuntimeError, match="sync"):
        src.step()
    drained = src.sync()
    assert not src._win_q and not src._carry_valid and not drained
    assert 1 < len(r.out_tokens) < 12
    snap = src.export_slot(r.slot)
    src.release_slot(r.slot)
    dst = ContinuousBatchScheduler(
        tm, tp, _cfg(SchedulerConfig, False, 1, True, max_new=12, slots=2),
        device="cpu")
    dst.import_slot(snap)
    dst.run()
    assert r.done and r.out_tokens == want


def test_async_config_validation():
    """async_decode needs the monolithic step and a window of >= 1 step;
    both are refused at construction, with the reference's messages."""
    _, _, tm, tp = _models(GRANITE)
    with pytest.raises(ValueError, match="segmented"):
        ContinuousBatchScheduler(
            tm, tp, SchedulerConfig(n_slots=2, max_len=16,
                                    async_decode=True), device="cpu")
    with pytest.raises(ValueError, match="readback_interval"):
        ContinuousBatchScheduler(
            tm, tp, SchedulerConfig(n_slots=2, max_len=16, segmented=False,
                                    async_decode=True, readback_interval=0),
            device="cpu")


def test_one_ring_readback_per_decode_poll(monkeypatch):
    """In the decode phase an async poll reads back at most one ring (the
    scheduler's one readback function, counted by wrapping it) and makes
    no other token readback; the sync pool reads its tokens back once per
    step (``Tensor.cpu``)."""
    _, _, tm, tp = _models(GRANITE)

    def build(async_decode):
        s = ContinuousBatchScheduler(
            tm, tp, SchedulerConfig(n_slots=2, max_len=24, prefill_chunk=8,
                                    exit_threshold=0.0, segmented=False,
                                    async_decode=async_decode,
                                    readback_interval=4), device="cpu")
        for j in range(2):
            s.submit(Request(tokens=(np.arange(6) + j) % tm.cfg.vocab_size,
                             max_new=16, req_id=j))
        while s.queue or s._pending is not None:
            s.prefill_poll()
        return s

    cpu_calls = [0]
    real_cpu = torch.Tensor.cpu

    def counting_cpu(t, *a, **kw):
        cpu_calls[0] += 1
        return real_cpu(t, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)

    pool = build(async_decode=True)
    reads = [0]
    real_read = pool._read_ring

    def counting_read(win):
        reads[0] += 1
        return real_read(win)
    pool._read_ring = counting_read
    cpu_calls[0] = 0
    per_poll, committed = [], 0
    while pool.has_work:
        n0 = reads[0]
        rep = pool.poll()
        per_poll.append(reads[0] - n0)
        committed += rep.decode_steps
        if rep.decode_steps:
            assert reads[0] - n0 == 1
    assert max(per_poll) == 1 and cpu_calls[0] == 0
    assert committed == 16 and reads[0] == 4

    pool = build(async_decode=False)
    cpu_calls[0] = 0
    steps = 0
    while pool.has_work:
        steps += pool.poll().decode_steps
    assert steps == 16 and cpu_calls[0] == steps


CLUSTER_RUNS = {
    "outage-raw": (lambda m: m.Scenario.tier_outage("edge", at=0.01),
                   dict(kv_handoff="raw")),
    "outage-paged-int8": (lambda m: m.Scenario.tier_outage("edge", at=0.01),
                          dict(kv_handoff="int8", paged=True,
                               page_size=16)),
}


def _cluster_run(cluster_cls, cfg_cls, paradigm_mod, model, params, run,
                 plan):
    scenario, extra = CLUSTER_RUNS[run]
    cl = cluster_cls(model, params, scenario(paradigm_mod), plan_cfg=plan,
                     cfg=cfg_cls(base_slots=2, max_len=64, prefill_chunk=8,
                                 async_decode=True, readback_interval=3,
                                 **extra))
    rs = np.random.RandomState(0)
    trace = [rs.randint(0, model.cfg.vocab_size, int(rs.randint(6, 13)))
             for _ in range(6)]
    crs = [cl.submit(p.copy(), max_new=8, deadline=0.05, arrival=i * 0.002)
           for i, p in enumerate(trace)]
    cl.run()
    return cl, crs


@pytest.mark.parametrize("run", list(CLUSTER_RUNS))
def test_cluster_async_matches_reference(run):
    """Async tier pools (windows of 3): routes, the migration ledger, each
    request's tiers and migrations and the virtual latencies equal the
    reference cluster's; tokens under the parity contract."""
    rm, rp, tm, tp = _models(GRANITE)
    ref_cl, ref_crs = _cluster_run(RefCluster, RefClusterConfig,
                                   ref_paradigms, rm, rp, run,
                                   ref_config("granite-3-2b"))
    cl, crs = _cluster_run(TieredServingCluster, ClusterConfig, paradigms,
                           tm, tp, run, get_config("granite-3-2b"))
    st, want = cl.stats(), ref_cl.stats()
    for key in ("requests", "completed", "splits", "route_counts",
                "migration", "dead_tiers", "resilience"):
        assert st.get(key) == want.get(key), key
    assert st["migration"]["outage_migrations"] >= 1
    np.testing.assert_allclose(
        [st["p50_latency_s"], st["p95_latency_s"], st["deadline_hit_rate"]],
        [want["p50_latency_s"], want["p95_latency_s"],
         want["deadline_hit_rate"]], rtol=1e-9)
    for name, ts in st["tiers"].items():
        ws = want["tiers"][name]
        for key in ("routed", "dead", "n_slots", "tokens",
                    "peak_tokens_in_flight"):
            assert ts[key] == ws[key], (name, key)
        np.testing.assert_allclose(
            [ts[k] for k in ("vclock_s", "utilization", "slot_occupancy",
                             "measured_depth")],
            [ws[k] for k in ("vclock_s", "utilization", "slot_occupancy",
                             "measured_depth")], rtol=1e-9, atol=1e-12)
        assert st["jit_cache_sizes"][name]["decode_window"] \
            == want["jit_cache_sizes"][name]["decode_window"]
    for cr, rc in zip(crs, ref_crs):
        assert (cr.decision.tier, cr.decision.prefill_tier, cr.final_tier,
                cr.migrations, cr.requeues, cr.handoff_bytes,
                cr.handoff_compressed) == (
            rc.decision.tier, rc.decision.prefill_tier, rc.final_tier,
            rc.migrations, rc.requeues, rc.handoff_bytes,
            rc.handoff_compressed)
        np.testing.assert_allclose([cr.t_done_v, cr.handoff_time],
                                   [rc.t_done_v, rc.handoff_time],
                                   rtol=1e-9, atol=1e-12)
        _assert_greedy_equal(rm, rp, np.asarray(cr.req.tokens, np.int32),
                             cr.req.out_tokens, rc.req.out_tokens)


def test_async_frozen_rows_route_as_sync_inactive_rows():
    """deepseek-v3-671b-smoke, paged, 16 slots closed loop with max_new
    from 4 to 12: rows finish mid-window, and at 16 slots the MoE drops
    assignments past an expert's capacity, so a frozen row's garbage
    competes with live rows.  A frozen row reads an all-sentinel block
    table, as a slot the sync step has released does, so the async tokens
    equal the sync monolithic poll's bit for bit."""
    _, _, tm, tp = _models(DEEPSEEK)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, tm.cfg.vocab_size, int(rs.randint(4, 17)))
               for _ in range(16)]
    max_news = [4 + j // 2 for j in range(16)]
    outs = []
    for async_decode in (False, True):
        s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
            n_slots=16, max_len=32, prefill_chunk=16, exit_threshold=0.0,
            segmented=False, paged=True, async_decode=async_decode,
            readback_interval=4), device="cpu")
        reqs = [Request(tokens=p, max_new=n, req_id=j)
                for j, (p, n) in enumerate(zip(prompts, max_news))]
        for r in reqs:
            s.submit(r)
        s.run()
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[1]] == max_news
