"""The port's runtime guards on live CPU pools at smoke widths:
``SlotAudit`` catches a leaked slot, counter drift, a page-refcount
drift, a COW violation, orphaned draft shadows and an undelivered
cluster migration; ``no_recompile`` trips on a second window build and
on a rebound cache leaf; ``guard_sync_budget`` passes at bound 1 on an
async pool's decode phase, also past the old 32-step counter flush
(a controller's exact counter read is one more), and raises at bound 0
on a sync pool (and on a planted ``.item()``).  The port's runs that mirror the reference's
audited ones (``tests/test_scheduler.py:84``, ``test_paged.py:60``,
``test_multipool.py:69``, ``test_spec_decode.py:86,117,144,285``) run
again under ``SlotAudit``, with ``audit.polls > 0`` and the same tokens
as without it.

Every pool here holds the reference's weights (``bridge.params_from_jax``).
The audited runs are held against the reference's own scheduler, multipool,
``SpecPair`` and cluster on the same prompts, under the reference's
``SlotAudit``: equal streams, or a first difference at a bf16 top-2 tie of
the reference's logits (within 1e-2), as the port's parity tests excuse it.
The planted leaked slot and refcount drift are planted in the reference's
pool in the same state too, and its ``SlotAudit`` raises the same message."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.guards import GuardError as RefGuardError
from repro.analysis.guards import SlotAudit as RefSlotAudit
from repro.configs import get_config as ref_config
from repro.core import Scenario as RefScenario
from repro.models import Model as RefModel
from repro.serving import ClusterConfig as RefClusterConfig
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import ModelGroup as RefGroup
from repro.serving import MultiModelScheduler as RefPool
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import SpecPair as RefSpecPair
from repro.serving import TieredServingCluster as RefCluster
from repro_torch.analysis import (GuardError, SlotAudit, guard_polling,
                                  guard_sync_budget, no_recompile)
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import (AdaptiveExitController, ClusterConfig,
                                 ContinuousBatchScheduler, ModelGroup, MultiModelScheduler, Request,
                                 SchedulerConfig, SpecPair,
                                 TieredServingCluster)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIE = 1e-2


def _both(arch, seed=0):
    """``(ref model, ref params, port model, port params)``: the port holds
    the reference's weights."""
    rm = RefModel(ref_config(arch))
    rp = rm.init(jax.random.PRNGKey(seed))
    return (rm, rp, Model(get_config(arch), device="cpu"),
            params_from_jax(jax.tree.map(np.asarray, rp)))


@pytest.fixture(scope="module")
def ref_granite():
    return _both("granite-3-2b-smoke")


@pytest.fixture(scope="module")
def granite(ref_granite):
    _, _, m, p = ref_granite
    return m.cfg, m, p


def _base(kw):
    base = dict(n_slots=2, max_len=24, prefill_chunk=4)
    base.update(kw)
    return base


def _sched(granite, **kw):
    cfg, m, params = granite
    return ContinuousBatchScheduler(m, params, SchedulerConfig(**_base(kw)),
                                    device="cpu")


def _ref_sched(ref_granite, **kw):
    rm, rp, _, _ = ref_granite
    return RefScheduler(rm, rp, RefConfig(**_base(kw)))


def _serve(sched, prompts, max_new, *, audit=False, start=0, ref=False):
    """Submit and drain; returns ({req_id: tokens}, audit or None).  With
    ``ref`` the pool is the reference's, audited by the reference's
    ``SlotAudit``."""
    req_cls, audit_cls = (RefRequest, RefSlotAudit) if ref \
        else (Request, SlotAudit)
    a = audit_cls(sched).attach() if audit else None
    reqs = [req_cls(tokens=np.asarray(p, np.int32), max_new=max_new,
                    req_id=i) for i, p in enumerate(prompts, start=start)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    if a is not None:
        a.detach()
        assert a.polls > 0
    return {r.req_id: list(r.out_tokens) for r in reqs}, a


def _tie_or_equal(rm, rp, prompt, got, want):
    """Equal streams, or a first difference at a bf16 top-2 tie: both
    tokens within ``TIE`` of the top logit of the reference's batch-1
    prefill over the shared prefix.  ``want`` comes from a batched
    reference pool, which may itself take either side of such a tie, so
    the tie is checked from both tokens and not only from ``want``."""
    if got == want:
        return
    seq = np.concatenate([np.asarray(prompt, np.int32),
                          np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    logs = np.asarray(logits[0, len(prompt) - 1:], np.float32)
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    top = float(logs[k].max())
    for tok in (got[k], want[k]):
        gap = top - float(logs[k][tok])
        assert 0.0 <= gap < TIE, \
            f"token {k}: {tok} is {gap:.3e} below the ref's top logit"


def _against_ref(rm, rp, prompts, got, ref_got):
    assert sorted(got) == sorted(ref_got)
    for i, toks in got.items():
        _tie_or_equal(rm, rp, prompts[i], toks, ref_got[i])


# ---------------------------------------------------------------------------
# a guarded serve runs clean
# ---------------------------------------------------------------------------
def test_guarded_poll_runs_clean(granite):
    """A full serve under guard_polling + SlotAudit + no_recompile (the
    reference's ``test_guarded_poll_runs_clean``): slot accounting holds
    after every poll.  On the CPU guard_polling checks nothing."""
    cfg, m, _ = granite
    sched = _sched(granite, exit_threshold=0.85)
    rs = np.random.RandomState(0)
    for n in (4, 7, 3):
        sched.submit(Request(
            tokens=rs.randint(0, cfg.vocab_size, n).astype(np.int32),
            max_new=5))
    sched.set_rng(None)
    sched.poll()
    audit = SlotAudit(sched).attach()
    with no_recompile(sched), guard_polling(sched):
        while sched.has_work:
            sched.poll()
    audit.detach()
    assert audit.polls > 0
    assert all(r.done for r in sched.completed)
    assert len(sched.completed) == 3


# ---------------------------------------------------------------------------
# planted violations: SlotAudit
# ---------------------------------------------------------------------------
def _same_raise(port_check, ref_check, match):
    """Both audits raise on the same planted state, with the same text."""
    with pytest.raises(GuardError, match=match) as got:
        port_check()
    with pytest.raises(RefGuardError, match=match) as want:
        ref_check()
    assert str(got.value) == str(want.value)


def test_slot_audit_catches_leaked_slot(granite, ref_granite):
    sched, ref = _sched(granite), _ref_sched(ref_granite)
    _serve(sched, [np.arange(4)], 3)
    _serve(ref, [np.arange(4)], 3, ref=True)
    audit, ref_audit = SlotAudit(sched), RefSlotAudit(ref)
    for s in (sched, ref):
        s.active[0] = True          # seeded: active without a request
    _same_raise(audit.check, ref_audit.check, "active without a request")
    sched.active[0] = ref.active[0] = False
    sched.slot_req[1] = Request(tokens=np.arange(3, dtype=np.int32),
                                max_new=2)
    ref.slot_req[1] = RefRequest(tokens=np.arange(3, dtype=np.int32),
                                 max_new=2)
    _same_raise(audit.check, ref_audit.check, "leaked slot")


def test_slot_audit_catches_counter_drift(granite):
    sched = _sched(granite)
    _serve(sched, [np.arange(5)], 4)
    SlotAudit(sched).check()        # balanced after a clean drain
    sched.tokens_served += 1        # seeded drift
    with pytest.raises(GuardError, match="tokens_served"):
        SlotAudit(sched).check()


def _paged_mid_run(granite, ref_granite=None, **kw):
    """A paged pool with two live slots (admitted, prefilled, one decode
    step in): the port's, or with ``ref_granite`` the reference's."""
    make, req_cls, audit_cls = (
        (_sched, Request, SlotAudit) if ref_granite is None else
        (_ref_sched, RefRequest, RefSlotAudit))
    sched = make(granite if ref_granite is None else ref_granite,
                 n_slots=2, max_len=32, prefill_chunk=8, paged=True,
                 page_size=16, **kw)
    rs = np.random.RandomState(4)
    for n in (20, 18):
        sched.submit(req_cls(tokens=rs.randint(0, 1000, n).astype(np.int32),
                             max_new=6))
    while not sched.active.all():
        sched.poll()
    audit_cls(sched).check()
    return sched


def test_slot_audit_catches_refcount_drift(granite, ref_granite):
    sched = _paged_mid_run(granite)
    ref = _paged_mid_run(granite, ref_granite)
    np.testing.assert_array_equal(np.asarray(sched._tbl), ref._tbl)
    np.testing.assert_array_equal(np.asarray(sched.page_alloc.refcount),
                                  ref.page_alloc.refcount)
    pg = int(sched._tbl[0, 0])
    sched.page_alloc.refcount[pg] += 1
    ref.page_alloc.refcount[pg] += 1
    _same_raise(SlotAudit(sched).check, RefSlotAudit(ref).check,
                "refcount drift")
    sched.page_alloc.refcount[pg] -= 1
    SlotAudit(sched).check()


def test_slot_audit_catches_cow_violation(granite):
    """Two slots writing one physical page that the prefix tree does not
    own: slot 1's first table entry pointed at slot 0's page (its
    refcount raised to match, so only the sharing is wrong, and the page
    slot 1 dropped is still held)."""
    sched = _paged_mid_run(granite, prefix_cache=False)
    shared = int(sched._tbl[0, 0])
    sched._tbl[1, 0] = shared
    sched.page_alloc.refcount[shared] += 1
    with pytest.raises(GuardError, match="COW violation"):
        SlotAudit(sched).check()


def test_slot_audit_catches_a_freed_slot_still_mapping_pages(granite):
    sched = _paged_mid_run(granite)
    sched.active[1] = False
    sched.slot_req[1] = None
    with pytest.raises(GuardError, match="page leak"):
        SlotAudit(sched).check()


def _pair(granite, draft_params=None, **kw):
    cfg, m, params = granite
    base = dict(n_slots=2, max_len=48, prefill_chunk=8, exit_threshold=0.0)
    base.update(kw)
    return SpecPair(ModelGroup([
        ("draft", m, params if draft_params is None else draft_params),
        ("target", m, params)]), SchedulerConfig(**base), k=4)


def _pair_mid_run(granite):
    pair = _pair(granite)
    rs = np.random.RandomState(1)
    for n in (6, 9):
        pair.submit(Request(tokens=rs.randint(0, 1000, n).astype(np.int32),
                            max_new=10))
    drf = pair.pools["draft"]
    while not drf.active.all():
        pair.poll()
    SlotAudit(pair).check()
    return pair


def test_slot_audit_catches_an_untracked_draft_shadow(granite):
    pair = _pair_mid_run(granite)
    rid = next(iter(pair._pairs))
    del pair._pairs[rid]            # the shadow lives on, untracked
    with pytest.raises(GuardError, match="no tracked pair"):
        SlotAudit(pair).check()


def test_slot_audit_catches_a_done_target_with_a_live_shadow(granite):
    pair = _pair_mid_run(granite)
    req, shadow = next(iter(pair._pairs.values()))
    req.done = True                 # the target finished, the shadow not
    with pytest.raises(GuardError, match="orphaned draft slot"):
        SlotAudit(pair).check()


def test_slot_audit_catches_pair_resync_drift(granite):
    pair = _pair_mid_run(granite)
    req, shadow = next(iter(pair._pairs.values()))
    pair.pools["draft"].positions[shadow.slot] += 1
    with pytest.raises(GuardError, match="resync drift"):
        SlotAudit(pair).check()


# ---------------------------------------------------------------------------
# the tiered cluster: a migration and the speculative bridge, audited
# ---------------------------------------------------------------------------
# chip_smoke.py phase 15 (b)'s trace at smoke width: granite as the draft
# and the target of a high-RTT scenario whose device tier dies at 1.6 s
BRIDGE_MODELS = ("big", "big", "small", "small", "small", "small")


def _bridge_cluster(granite):
    from repro_torch.core import Scenario, TierOutage
    cfg, m, params = granite
    sc = dataclasses.replace(Scenario.high_rtt_access(),
                             outages=(TierOutage("device", 1.6),))
    cl = TieredServingCluster(
        ModelGroup([("small", m, params), ("big", m, params)]),
        scenario=sc, plan_cfg={"small": get_config("granite-3-2b"),
                               "big": get_config("deepseek-v3-671b")},
        cfg=ClusterConfig(base_slots=2, max_len=48, prefill_chunk=8,
                          exit_threshold=0.0, spec_draft="small", spec_k=4,
                          paged=True, page_size=16))
    rs = np.random.RandomState(3)
    lens = rs.randint(8, 17, len(BRIDGE_MODELS))
    crs = [cl.submit(rs.randint(0, cfg.vocab_size, int(n)), max_new=10,
                     arrival=0.05 * i, model=mod)
           for i, (n, mod) in enumerate(zip(lens, BRIDGE_MODELS))]
    return cl, crs


@pytest.fixture(scope="module")
def bridge_run(granite):
    """The bridge trace served twice: without and with SlotAudit."""
    plain, plain_crs = _bridge_cluster(granite)
    plain.run()
    cl, crs = _bridge_cluster(granite)
    with SlotAudit(cl) as audit:
        cl.run()
    return cl, crs, audit, [list(c.req.out_tokens) for c in plain_crs]


def test_audited_cluster_migrates_and_bridges(bridge_run):
    cl, crs, audit, plain = bridge_run
    st = cl.stats()
    assert audit.polls > 0
    assert st["dead_tiers"] == ["device"]
    assert st["migration"]["outage_migrations"] >= 1
    assert st["speculative"]["requests_completed"] >= 1
    assert all(c.done for c in crs)
    assert [list(c.req.out_tokens) for c in crs] == plain


def test_slot_audit_catches_undelivered_migration(bridge_run):
    cl = bridge_run[0]
    SlotAudit(cl).check()
    dead = cl.tiers["device"]
    dead.inbound.append((0.0, None, None, "edge"))
    try:
        with pytest.raises(GuardError, match="undelivered inbound"):
            SlotAudit(cl).check()
    finally:
        dead.inbound.pop()


def test_slot_audit_catches_an_orphaned_snapshot(bridge_run):
    cl = bridge_run[0]
    pool = cl.tiers["cloud"].sched.pools["small"]
    pool.n_exported += 1
    try:
        with pytest.raises(GuardError, match="orphaned snapshot"):
            SlotAudit(cl).check()
    finally:
        pool.n_exported -= 1
    SlotAudit(cl).check()


def test_slot_audit_catches_a_held_booking(bridge_run):
    cl = bridge_run[0]
    cr = cl.requests[0]
    cr.booked_slot = 0
    try:
        with pytest.raises(GuardError, match="ledger leak"):
            SlotAudit(cl).check()
    finally:
        cr.booked_slot = -1


# ---------------------------------------------------------------------------
# no_recompile: window builds and the captured graph's tensors
# ---------------------------------------------------------------------------
def _async_pool(granite, **kw):
    return _sched(granite, n_slots=2, max_len=32, prefill_chunk=8,
                  segmented=False, async_decode=True, readback_interval=4,
                  **kw)


def test_no_recompile_trips_on_first_and_second_build(granite):
    sched = _async_pool(granite, paged=True, page_size=16)
    with pytest.raises(GuardError, match="new stage build"):
        with no_recompile(sched):
            _serve(sched, [np.arange(6)], 6)      # the first build
    with no_recompile(sched):                      # steady state
        _serve(sched, [np.arange(9), np.arange(5)], 6, start=1)
    assert sched.jit_cache_sizes() == {"decode_window": 1}
    with pytest.raises(GuardError, match="decode_window: 1->2"):
        with no_recompile(sched):
            sched._window.prepare()                # a second capture


def test_no_recompile_trips_on_a_rebound_cache_leaf(granite):
    sched = _async_pool(granite, paged=True, page_size=16)
    _serve(sched, [np.arange(6)], 6)
    blocks = sched.cache["blocks"]
    first = blocks[0]               # layer 0's (K pool, V pool)
    leaf = first[0]
    with pytest.raises(GuardError, match="rebound"):
        with no_recompile(sched):
            blocks[0] = (leaf.clone(),) + tuple(first[1:])
    blocks[0] = first
    with pytest.raises(GuardError, match="re-typed"):
        with no_recompile(sched):
            sched._counters = sched._counters.long()
    with no_recompile(sched):       # writing in place is what a stage does
        leaf.zero_()


def test_no_recompile_ignores_pools_without_a_window(granite):
    sched = _sched(granite)
    _serve(sched, [np.arange(4)], 3)
    with no_recompile(sched):
        sched.cache = dict(sched.cache)   # no captured graph holds it


# ---------------------------------------------------------------------------
# guard_sync_budget
# ---------------------------------------------------------------------------
def _decode_phase(sched, prompts, max_new=16):
    """Admission and prefill outside the guard: the first tokens' readback
    and the uploads there have their own budget."""
    for j, p in enumerate(prompts):
        sched.submit(Request(tokens=np.asarray(p, np.int32),
                             max_new=max_new, req_id=j))
    while sched.queue or sched._pending is not None \
            or not sched.active.any():
        sched.poll()
    return sched


def test_sync_budget_passes_async_and_fails_sync(granite):
    """The reference's ``test_pipeline.py:194-201``: one ring readback a
    decode poll at bound 1; a sync pool reads back every step."""
    prompts = [(np.arange(6) + j) % 1000 for j in range(2)]
    pool = _decode_phase(_async_pool(granite), prompts)
    with guard_sync_budget(pool, bound=1) as stats:
        pool.run()
    assert stats["polls"] > 0 and stats["max_per_poll"] <= 1
    assert stats["syncs"] >= 1          # the ring readbacks happened

    pool = _decode_phase(_sched(granite, max_len=32, segmented=False),
                         prompts)
    with pytest.raises(GuardError, match="sync"):
        with guard_sync_budget(pool, bound=0):
            pool.run()


def test_sync_budget_holds_past_the_counter_flush_period(granite):
    """Forty decode steps, past the 32 between the counter flushes polls
    once made: an async pool still reads back one ring a poll and reads
    no counters.  A controller's update is an exact read, one more in the
    polls that run it."""
    prompts = [(np.arange(6) + j) % 1000 for j in range(2)]

    def pool():
        return _decode_phase(
            _sched(granite, max_len=64, prefill_chunk=8, segmented=False,
                   async_decode=True, readback_interval=4), prompts,
            max_new=40)
    plain = pool()
    with guard_sync_budget(plain, bound=1) as stats:
        while plain.has_work:
            plain.poll()
    assert stats["polls"] >= 10 and stats["max_per_poll"] == 1
    assert plain._step_idx > 32
    assert (plain.flushes, plain.flush_wait_ms_total) == (0, 0.0)

    steered = pool()
    steered.controller = AdaptiveExitController(0.5, threshold=0.3)
    steered.adaptive_every = 16
    with guard_sync_budget(steered, bound=2) as stats:
        while steered.has_work:
            steered.poll()
    assert stats["max_per_poll"] == 2 and steered.flushes >= 2


def test_sync_budget_counts_one_per_sync_step(granite):
    prompts = [(np.arange(6) + j) % 1000 for j in range(2)]
    pool = _decode_phase(_sched(granite, max_len=32, segmented=False),
                         prompts, max_new=8)
    with guard_sync_budget(pool, bound=1) as stats:
        while pool.has_work:
            pool.poll()
    assert stats["max_per_poll"] == 1
    assert stats["syncs"] == stats["polls"] == 7


def test_sync_budget_raises_on_a_planted_item(granite):
    prompts = [(np.arange(6) + j) % 1000 for j in range(2)]
    pool = _decode_phase(_async_pool(granite), prompts)
    pool.poll()                     # a window in flight: the next reads one
    served = pool.poll

    def planted(*a, **kw):
        rep = served(*a, **kw)
        pool._counters.sum().item()
        return rep
    pool.poll = planted
    with pytest.raises(GuardError, match="performed 2 device sync"):
        with guard_sync_budget(pool, bound=1):
            pool.poll()
    pool.poll = served
    with guard_sync_budget(pool, bound=1) as stats:
        pool.run()
    assert stats["max_per_poll"] <= 1


def test_sync_budget_restores_the_primitives(granite):
    before = (torch.Tensor.__dict__.get("cpu"), torch.cuda.synchronize)
    pool = _decode_phase(_async_pool(granite), [np.arange(6)])
    with guard_sync_budget(pool, bound=1):
        pool.run()
    assert (torch.Tensor.__dict__.get("cpu"), torch.cuda.synchronize) \
        == before


# ---------------------------------------------------------------------------
# the port's parity runs again under SlotAudit: same tokens as without, and
# the reference's tokens (tie rule) from the reference's pool, also audited
# ---------------------------------------------------------------------------
def test_audited_slot_reuse_matches_unaudited(granite, ref_granite):
    """``tests/test_scheduler.py:84``: 6 mixed-length requests through 2
    slots, every slot reused."""
    cfg, _, _ = granite
    rm, rp, _, _ = ref_granite
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in (5, 9, 16, 3, 12,
                                                          7)]
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4)
    want, _ = _serve(_sched(granite, **kw), prompts, 8)
    sched = _sched(granite, **kw)
    got, audit = _serve(sched, prompts, 8, audit=True)
    assert audit.polls > 0 and got == want
    assert sched.n_admitted == 6 and not sched.has_work
    ref_got, _ = _serve(_ref_sched(ref_granite, **kw), prompts, 8,
                        audit=True, ref=True)
    _against_ref(rm, rp, prompts, got, ref_got)


def test_audited_paged_parity_with_slot_reuse(granite, ref_granite):
    """``tests/test_paged.py:60``: the paged arena equals the contiguous
    one under the audit, its steady state builds nothing, and every page
    is back on the free list."""
    cfg, _, _ = granite
    rm, rp, _, _ = ref_granite
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, n)
               for n in (5, 20, 33, 9, 14, 7)]
    flat, _ = _serve(_sched(granite, n_slots=2, max_len=64,
                            prefill_chunk=8), prompts, 6)
    kw = dict(n_slots=2, max_len=64, prefill_chunk=8, paged=True,
              page_size=16, prefix_cache=False)
    want, _ = _serve(_sched(granite, **kw), prompts, 6)
    s = _sched(granite, **kw)
    audit = SlotAudit(s).attach()
    got, _ = _serve(s, prompts[:2], 6)
    with no_recompile(s):
        more, _ = _serve(s, prompts[2:], 6, start=2)
    audit.detach()
    got.update(more)
    assert audit.polls > 0
    assert got == want == flat
    assert s.page_alloc.free_count == s.page_alloc.n_pages
    ref_got, _ = _serve(_ref_sched(ref_granite, **kw), prompts, 6,
                        audit=True, ref=True)
    _against_ref(rm, rp, prompts, got, ref_got)


def test_audited_multipool_matches_unaudited():
    """``tests/test_multipool.py:69``: granite, yi and deepseek smoke in
    one pool, audited after every poll, against the reference's pool."""
    archs = ("granite-3-2b-smoke", "yi-6b-smoke", "deepseek-v3-671b-smoke")
    both = {arch: _both(arch) for arch in archs}
    rs = np.random.RandomState(0)
    reqs = [(arch, rs.randint(0, 1000, int(n)))
            for arch in archs for n in (5, 9)]

    def run(audit, ref=False):
        entries = [(a, *both[a][:2]) if ref else (a, *both[a][2:])
                   for a in archs]
        grp, pool_cls, cfg_cls, req_cls, audit_cls = (
            (RefGroup, RefPool, RefConfig, RefRequest, RefSlotAudit) if ref
            else (ModelGroup, MultiModelScheduler, SchedulerConfig, Request,
                  SlotAudit))
        pool = pool_cls(grp(entries), cfg_cls(n_slots=2, max_len=24,
                                              prefill_chunk=4))
        a = audit_cls(pool).attach() if audit else None
        rr = [req_cls(tokens=np.asarray(p, np.int32), max_new=6, model=name,
                      req_id=i) for i, (name, p) in enumerate(reqs)]
        for r in rr:
            pool.submit(r)
        pool.run()
        return [list(r.out_tokens) for r in rr], a
    want, _ = run(False)
    got, audit = run(True)
    assert audit.polls > 0 and got == want
    ref_got, ref_audit = run(True, ref=True)
    assert ref_audit.polls > 0
    for (arch, p), g, w in zip(reqs, got, ref_got):
        _tie_or_equal(*both[arch][:2], p, g, w)


def _ref_pair(draft, target, **kw):
    base = dict(n_slots=2, max_len=48, prefill_chunk=8, exit_threshold=0.0)
    base.update(kw)
    return RefSpecPair(RefGroup([("draft", *draft[:2]),
                                 ("target", *target[:2])]),
                       RefConfig(**base), k=4)


def test_audited_spec_pair_agreeable(granite, ref_granite):
    """``tests/test_spec_decode.py:86``: shared parameters, a second batch
    under no_recompile."""
    cfg, _, _ = granite
    rm, rp, _, _ = ref_granite
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in (5, 12, 9)]
    want, _ = _serve(_pair(granite), prompts, 10)
    pair = _pair(granite)
    audit = SlotAudit(pair).attach()
    got, _ = _serve(pair, prompts[:2], 10)
    with no_recompile(pair):
        more, _ = _serve(pair, prompts[2:], 10, start=2)
    audit.detach()
    got.update(more)
    assert audit.polls > 0 and got == want
    assert pair.spec_stats()["acceptance_len"] >= 3.0
    ref_got, _ = _serve(_ref_pair(ref_granite, ref_granite), prompts, 10,
                        audit=True, ref=True)
    _against_ref(rm, rp, prompts, got, ref_got)


def test_audited_spec_pair_mla_target(granite, ref_granite):
    """``tests/test_spec_decode.py:117``: an MLA + MoE target behind an
    attention draft, paged."""
    _, dm, dp = granite
    deepseek = _both("deepseek-v3-671b-smoke", seed=1)
    trm, trp, tm, tp = deepseek
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, tm.cfg.vocab_size, n) for n in (6, 13, 9)]
    kw = dict(paged=True, page_size=16)

    def pair():
        return SpecPair(ModelGroup([("draft", dm, dp), ("target", tm, tp)]),
                        SchedulerConfig(n_slots=2, max_len=48,
                                        prefill_chunk=8, exit_threshold=0.0,
                                        **kw), k=4)
    want, _ = _serve(pair(), prompts, 8)
    p = pair()
    got, audit = _serve(p, prompts, 8, audit=True)
    assert audit.polls > 0 and got == want
    for pool in p.pools.values():
        assert pool.page_alloc.free_count == pool.page_alloc.n_pages
    ref_got, _ = _serve(_ref_pair(ref_granite, deepseek, **kw), prompts, 8,
                        audit=True, ref=True)
    _against_ref(trm, trp, prompts, got, ref_got)


def test_audited_spec_forced_rejection(granite, ref_granite):
    """``tests/test_spec_decode.py:144``: a disagreeing draft (seed 7),
    paged; the audit holds and no page leaks."""
    cfg, m, _ = granite
    rm, rp, _, _ = ref_granite
    granite7 = _both("granite-3-2b-smoke", seed=7)
    other = granite7[3]
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in (7, 11)]
    kw = dict(paged=True, page_size=16)
    want, _ = _serve(_pair(granite, other, **kw), prompts, 8)
    pair = _pair(granite, other, **kw)
    got, audit = _serve(pair, prompts, 8, audit=True)
    assert audit.polls > 0 and got == want
    assert pair.spec_stats()["acceptance_len"] < 3.0
    for pool in pair.pools.values():
        assert pool.page_alloc.free_count == pool.page_alloc.n_pages
        assert not pool.page_alloc.refcount.any()
    ref_got, _ = _serve(_ref_pair(granite7, ref_granite, **kw), prompts, 8,
                        audit=True, ref=True)
    _against_ref(rm, rp, prompts, got, ref_got)


def test_audited_cluster_speculative_end_to_end(granite, ref_granite):
    """``tests/test_spec_decode.py:285``: the cluster's bridge at k 6 over
    a high-RTT access link."""
    from repro_torch.core import Scenario
    cfg, m, params = granite
    rm, rp, _, _ = ref_granite
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, cfg.vocab_size, n) for n in (8, 12, 10)]

    def run(audit, ref=False):
        grp, cl_cls, cc_cls, sc, plan, audit_cls = (
            (RefGroup, RefCluster, RefClusterConfig, RefScenario, ref_config,
             RefSlotAudit) if ref else
            (ModelGroup, TieredServingCluster, ClusterConfig, Scenario,
             get_config, SlotAudit))
        w = (rm, rp) if ref else (m, params)
        cl = cl_cls(
            grp([("small", *w), ("big", *w)]),
            scenario=sc.high_rtt_access(),
            plan_cfg={"small": plan("granite-3-2b"),
                      "big": plan("deepseek-v3-671b")},
            cfg=cc_cls(base_slots=2, max_len=48, prefill_chunk=8,
                       exit_threshold=0.0, spec_draft="small",
                       spec_k=6, stream_tokens=True))
        a = audit_cls(cl).attach() if audit else None
        crs = [cl.submit(p.copy(), max_new=10, arrival=0.05 * i,
                         model="big") for i, p in enumerate(prompts)]
        cl.run()
        assert all(c.decision.paradigm == "speculative" for c in crs)
        return [list(c.req.out_tokens) for c in crs], a
    want, _ = run(False)
    got, audit = run(True)
    assert audit.polls > 0 and got == want
    ref_got, ref_audit = run(True, ref=True)
    assert ref_audit.polls > 0
    for p, g, r in zip(prompts, got, ref_got):
        _tie_or_equal(rm, rp, p, g, r)
