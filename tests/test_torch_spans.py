"""The serving stack's spans and time counters on the CPU, at smoke width.

``serving/spans.py``: with no profiler running a span is one shared null
context and records nothing; under a CPU ``torch.profiler`` an async paged
scheduler opens every span of a poll, nested where the work happens
(``flush`` inside ``commit``, ``replay`` inside ``dispatch``), and the
spans of one window carry its sequence number.  The counters: no poll
reads the exit counters unless a controller's update does, and then the
read's wait leaves the poll's ``host_ms``; an exact read (``exit_stats``
/ ``flush_counters`` / ``run``) is exact, and ``reset_stats`` zeroes the
counts; ``prefill_poll`` counts its own time and tokens;
``Request.t_first`` falls between admission and completion.  The port's
trace reader (``launch/device_trace.py``) counts overlapping device
operations once and names each idle gap by the innermost serving span.
The analyzer's lint and ``guard_sync_budget`` pass with the spans open.
A paged admission's ``state_reset`` nests in ``admit`` and
``state_resets`` counts a state model's admitted slots; an eager decode
step opens the model's plan-step spans (``models/common.py``), a captured
one none.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.analysis import guard_sync_budget, lint_paths
from repro_torch.configs import get_config
from repro_torch.launch import device_trace
from repro_torch.launch.serve import poisson_trace, serve_poisson
from repro_torch.models import Model
from repro_torch.models import common
from repro_torch.serving import (AdaptiveExitController,
                                 ContinuousBatchScheduler, Request,
                                 SchedulerConfig)
from repro_torch.serving import spans as spans_mod
from repro_torch.serving.spans import span

ARCH = "granite-3-2b-smoke"
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def granite():
    m = Model(get_config(ARCH), device="cpu")
    return m, m.init(0)


def _sched(granite, **kw):
    m, p = granite
    base = dict(n_slots=2, max_len=32, prefill_chunk=4, paged=True,
                page_size=4, segmented=False, async_decode=True,
                readback_interval=3)
    base.update(kw)
    return ContinuousBatchScheduler(m, p, SchedulerConfig(**base),
                                    device="cpu")


def _submit(sched, n=3, max_new=7):
    reqs = [Request(tokens=(np.arange(5 + j) * 7 + j) % 500,
                    max_new=max_new) for j in range(n)]
    for r in reqs:
        sched.submit(r)
    return reqs


def _steered(sched, every):
    """``sched`` with a controller whose update, and so an exact counter
    read, runs once ``every`` tokens have been served since the last."""
    sched.controller = AdaptiveExitController(0.5, threshold=0.3)
    sched.adaptive_every = every
    return sched


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True)


def test_span_is_one_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = span("dispatch", 3), span("commit")
    assert a is b is spans_mod._NULL
    with a:
        pass
    # entered outside a profiler, it leaves nothing for a later one to read
    with _profile() as prof:
        pass
    assert not [e for e in prof.events()
                if e.name.startswith(spans_mod.PREFIX)]


def _parent(spans, i):
    """The innermost span enclosing ``spans[i]``: spans come ordered by
    (start, -end), so those enclosing it come before it."""
    name, a, b = spans[i]
    best = None
    for j, (n, x, y) in enumerate(spans):
        if j < i and x <= a and b <= y:
            if best is None or (x, -y) > best[1:]:
                best = (n, x, -y)
    return None if best is None else best[0]


def test_a_poll_opens_its_spans_where_the_work_happens(granite):
    sched = _steered(_sched(granite), 1)
    _submit(sched)
    with _profile() as prof:
        for _ in range(3):
            sched.poll()
        sched.sync()
        while sched.has_work:
            sched.poll()
    spans = device_trace.serving_spans(prof)
    names = {n for n, _, _ in spans}
    assert names >= {"poll", "admit", "prefill", "first_token", "dispatch",
                     "carry_load", "table_upload", "capture", "replay",
                     "ring_copy", "readback", "commit", "flush", "sync"}
    parents = {}
    for i, (n, _, _) in enumerate(spans):
        parents.setdefault(n, set()).add(_parent(spans, i))
    assert parents["flush"] <= {"commit"}
    assert parents["replay"] == {"dispatch"}
    assert parents["ring_copy"] == {"dispatch"}
    assert parents["capture"] == {"dispatch"}
    assert parents["carry_load"] == {"dispatch"}
    assert parents["first_token"] == {"prefill"}
    assert parents["commit"] <= {"poll", "sync"}
    assert parents["poll"] == {None}
    # the three spans of one window carry its sequence number, and the
    # trace reader joins its dispatch to its commit by it
    seqs = {}
    for e in prof.events():
        if e.name in ("repro.serving.dispatch", "repro.serving.readback",
                      "repro.serving.commit"):
            seqs.setdefault(e.name.rsplit(".", 1)[1], []).append(
                e.kwinputs["seq"])
    assert sorted(seqs["dispatch"]) == list(range(1, 1 + sched._win_seq))
    assert seqs["readback"] == seqs["commit"]
    assert set(seqs["commit"]) <= set(seqs["dispatch"])
    win = device_trace.window_ms(prof)
    assert sorted(win) == sorted(seqs["commit"])
    assert all(ms > 0.0 for ms in win.values())


class _SlowRead:
    """The exit counters, whose read back to the host takes ``delay`` s;
    ``reads`` counts those reads."""

    def __init__(self, t, delay):
        self.t, self.delay, self.reads = t, delay, 0

    def __iadd__(self, x):
        self.t += x
        return self

    def zero_(self):
        self.t.zero_()
        return self

    def cpu(self):
        self.reads += 1
        time.sleep(self.delay)
        return self.t.cpu()


def test_every_commit_flushes_and_the_wait_leaves_host_time(granite):
    """No commit reads the exit counters: no poll calls the slow read or
    reports a flush wait, and ``exit_counts`` keeps the last exact read.
    An exact read outside a poll (``exit_stats``) waits and counts;
    ``reset_stats`` zeroes every counter."""
    sched = _sched(granite)
    sched._counters = _SlowRead(sched._counters, 0.02)
    _submit(sched)
    commits = [0]
    commit = sched._commit_window

    def counted(*a):
        commits[0] += 1
        return commit(*a)
    sched._commit_window = counted
    while sched.has_work:
        t0 = time.perf_counter()
        rep = sched.poll()
        wall = (time.perf_counter() - t0) * 1e3
        split = rep.host_ms + rep.wait_ms + rep.flush_wait_ms
        assert 0.0 <= wall - split < 5.0, (wall, rep)
        assert rep.flush_wait_ms == 0.0
        assert not sched.exit_counts.any()
    assert commits[0] > 0 and sched.tokens_served > 0
    assert sched._counters.reads == 0
    assert (sched.flushes, sched.flush_wait_ms_total) == (0, 0.0)
    # an exact read outside a poll waits, and the wait counts
    sched.exit_stats()
    assert sched._counters.reads == 1
    assert sched.flushes == 1
    assert sched.flush_wait_ms_total >= 20.0
    assert sched.exit_counts.sum() == sched.tokens_served
    sched.reset_stats()
    assert (sched.flushes, sched.flush_wait_ms_total, sched.wait_ms_total,
            sched.host_ms_total, sched.prefill_ms_total,
            sched.prefill_tokens_total) == (0, 0.0, 0.0, 0.0, 0.0, 0)
    assert not sched.exit_counts.any()


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync", "async"])
def test_a_controller_read_waits_outside_host_time(granite, async_decode):
    """The controller's update reads the counters exactly inside a poll:
    that poll reports the read's wait as ``flush_wait_ms`` and leaves it
    out of ``host_ms``, and ``flushes`` counts every such read."""
    sched = _steered(_sched(granite, async_decode=async_decode), 4)
    sched._counters = _SlowRead(sched._counters, 0.02)
    _submit(sched, n=2, max_new=16)
    reading = 0
    while sched.has_work:
        n0 = sched.flushes
        t0 = time.perf_counter()
        rep = sched.poll()
        wall = (time.perf_counter() - t0) * 1e3
        split = rep.host_ms + rep.wait_ms + rep.flush_wait_ms
        assert 0.0 <= wall - split < 5.0, (wall, rep)
        reads = sched.flushes - n0
        if reads:
            reading += 1
            assert rep.flush_wait_ms >= 20.0 * reads
            assert rep.host_ms < wall - 20.0 * reads
        else:
            assert rep.flush_wait_ms == 0.0
    assert reading >= 2
    assert sched.flushes == sched._counters.reads
    assert sched.flush_wait_ms_total >= 20.0 * sched.flushes


def _exact(sched):
    """The counters as an exact read would give them, read without one."""
    return sched._counters.numpy().astype(np.int64) + sched._host_exit_extra


@pytest.mark.parametrize("read", ["exit_stats", "flush_counters", "run"])
def test_an_exact_read_is_exact(granite, read):
    """Polls leave ``exit_counts`` as the last exact read left it; after
    ``exit_stats`` / ``flush_counters`` / ``run`` it equals the device
    counters plus the host extras and sums to the tokens served."""
    sched = _sched(granite, async_decode=False)
    _submit(sched)
    while sched._step_idx < 6:
        sched.poll()
        assert not sched.exit_counts.any()
    assert _exact(sched).sum() == sched.tokens_served > 0
    if read == "run":
        sched.run()
    else:
        getattr(sched, read)()
    assert sched.flushes == 1
    assert sched.exit_counts.sum() == sched.tokens_served
    np.testing.assert_array_equal(sched.exit_counts, _exact(sched))


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync", "async"])
def test_reset_stats_zeroes_the_exit_counts(granite, async_decode):
    """After ``reset_stats`` no count from before it comes back: the next
    exact read covers only the tokens served after the reset."""
    sched = _sched(granite, async_decode=async_decode)
    _submit(sched, n=2, max_new=24)
    for _ in range(4):
        sched.poll()
    sched.sync()
    sched.exit_stats()
    assert sched.exit_counts.sum() == sched.tokens_served > 0
    sched.reset_stats()
    assert not sched.exit_counts.any() and not _exact(sched).any()
    while sched.has_work:
        sched.poll()
    sched.flush_counters()
    assert sched.exit_counts.sum() == sched.tokens_served > 0


def test_a_direct_prefill_poll_counts_its_time_and_tokens(granite):
    sched = _sched(granite, paged=False, async_decode=False)
    reqs = _submit(sched, n=2)
    while sched.queue or sched._pending is not None:
        sched.prefill_poll()
    assert sched.prefill_ms_total > 0.0
    assert sched.prefill_tokens_total == sum(r.tokens.size for r in reqs)
    assert sched.host_ms_total == 0.0           # no poll ran


@pytest.mark.parametrize("async_decode", [False, True])
def test_t_first_lies_between_admission_and_completion(granite,
                                                       async_decode):
    sched = _sched(granite, async_decode=async_decode)
    reqs = _submit(sched, n=3, max_new=4)
    sched.run()
    for r in reqs:
        assert r.done and len(r.out_tokens) == 4
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done
    # the third request waited for a slot: its first token came after
    # one of the first two had finished
    assert reqs[2].t_first >= min(reqs[0].t_done, reqs[1].t_done)


def test_the_windows_device_time_stays_zero_on_the_cpu(granite):
    sched = _sched(granite)
    _submit(sched)
    sched.run()
    assert sched.device_ms_total == 0.0
    assert sched.wait_ms_total >= 0.0 and sched.host_ms_total > 0.0


def test_serve_reports_time_to_first_token_and_the_split():
    st = serve_poisson(ARCH, rate=200.0, n_requests=4, slots=2,
                       prompt_len=8, max_new=4, paged=True,
                       async_decode=True, readback_interval=2,
                       device="cpu", quiet=True)
    assert 0.0 < st["p50_ttft_s"] <= st["p50_latency_s"]
    assert st["p50_ttft_s"] <= st["p95_ttft_s"] <= st["p95_latency_s"]
    assert st["device_ms"] == 0.0
    assert st["wait_ms"] >= 0.0 and st["flush_wait_ms"] >= 0.0
    assert st["host_ms"] > 0.0
    # every prompt of the trace replayed once (none shares a prefix), and
    # no counter read inside the trace (no controller runs)
    _, lengths = poisson_trace(np.random.RandomState(0), 200.0, 4, 8)
    assert st["prefill_tokens"] == int(np.sum(lengths))
    assert st["prefill_ms"] > 0.0
    assert st["flushes"] == 0 and st["decode_steps"] > 0


def test_the_lint_and_the_sync_budget_pass_with_the_spans_open(granite):
    root = spans_mod.__file__.rsplit("/", 1)[0]
    assert lint_paths([f"{root}/scheduler.py", f"{root}/window.py",
                       f"{root}/spans.py"]) == []
    sched = _sched(granite)
    _submit(sched, n=2, max_new=10)
    while sched.queue or sched._pending is not None \
            or not sched.active.any():
        sched.poll()
    with _profile() as prof:
        with guard_sync_budget(sched, bound=1) as stats:
            sched.run()
    assert stats["polls"] > 0 and stats["max_per_poll"] <= 1
    assert any(e.name == "repro.serving.readback" for e in prof.events())


# ---------------------------------------------------------------------------
# the port's trace reader on synthetic events (microseconds)
# ---------------------------------------------------------------------------
def _ev(name, a, b, dev=CPU, annotation=False, seq=None):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b),
                           is_user_annotation=annotation,
                           kwinputs={} if seq is None else {"seq": seq})


def _prof(*events):
    return SimpleNamespace(events=lambda: list(events))


def test_overlapping_operations_count_once():
    prof = _prof(_ev("paged_gqa_partial", 0, 100, CUDA),
                 _ev("paged_gqa_combine", 10, 110, CUDA),
                 _ev("gemm", 200, 300, CUDA),
                 _ev("bench.poll", 0, 300, CUDA, annotation=True),
                 _ev("repro.serving.replay", 0, 300, CUDA),
                 _ev("repro.serving.poll", 0, 400))
    ops = device_trace.device_ops(prof)
    assert [n for n, _, _ in ops] == ["paged_gqa_partial",
                                      "paged_gqa_combine", "gemm"]
    assert device_trace.busy_s(ops) == pytest.approx(210e-6)
    per = device_trace.by_name(ops)
    assert per["gemm"] == {"s": pytest.approx(100e-6), "launches": 1}
    assert device_trace.busy_s(device_trace.clip(ops, 50, 250)) \
        == pytest.approx(110e-6)


def test_idle_gaps_take_the_innermost_span_and_spans_their_self_time():
    prof = _prof(_ev("k", 0, 100, CUDA), _ev("k", 150, 300, CUDA),
                 _ev("bench.commit", 90, 160),
                 _ev("repro.serving.poll", 0, 400),
                 _ev("repro.serving.commit", 95, 160),
                 _ev("repro.serving.flush", 98, 140),
                 _ev("repro.serving.dispatch", 300, 380))
    ops = device_trace.device_ops(prof)
    spans = device_trace.serving_spans(prof)
    assert [n for n, _, _ in spans] == ["poll", "commit", "flush",
                                        "dispatch"]
    idle = device_trace.idle_gaps(ops, spans, 0, 420)
    # the gap from 100 opens inside the flush (the bench span is not the
    # program's); the one from 300 inside the dispatch
    assert idle == {"flush": pytest.approx(50e-6),
                    "dispatch": pytest.approx(120e-6)}
    # a gap where no span is open
    assert device_trace.idle_gaps(ops, spans, -50, 420)[
        device_trace.BETWEEN] == pytest.approx(50e-6)
    sec = device_trace.span_seconds(spans, 0, 400)
    assert sec["poll"]["total_s"] == pytest.approx(400e-6)
    assert sec["poll"]["self_s"] == pytest.approx((400 - 65 - 80) * 1e-6)
    assert sec["commit"]["self_s"] == pytest.approx((65 - 42) * 1e-6)
    assert sec["flush"] == {"total_s": pytest.approx(42e-6),
                            "self_s": pytest.approx(42e-6), "count": 1}
    # clipped to a window
    assert device_trace.span_seconds(spans, 120, 400)["flush"][
        "total_s"] == pytest.approx(20e-6)


def test_a_window_is_timed_from_its_dispatch_to_its_commit():
    prof = _prof(_ev("repro.serving.commit", 0, 40, seq=4),
                 _ev("repro.serving.dispatch", 50, 90, seq=5),
                 _ev("repro.serving.readback", 100, 900, seq=5),
                 _ev("repro.serving.commit", 900, 1050, seq=5),
                 _ev("bench.commit", 900, 1050),
                 _ev("repro.serving.dispatch", 1000, 1030, seq=6),
                 _ev("repro.serving.commit", 0, 5000, CUDA, seq=6))
    # window 4 was dispatched before the trace, window 6 not yet
    # committed in it (a device-side event is not the host's span)
    assert device_trace.window_ms(prof) == {5: pytest.approx(1.0)}


@pytest.mark.parametrize("arch,resets", [("zamba2-1.2b-smoke", 3),
                                         (ARCH, 0)])
def test_state_reset_nests_in_admit_and_counts_state_slots(arch, resets):
    """A paged admission zeroes the admitted slots' recurrent state rows
    inside ``state_reset``, itself inside ``admit``; ``state_resets``
    counts those slots for a state model and stays 0 for a dense one."""
    m = Model(get_config(arch), device="cpu")
    sched = _sched((m, m.init(0)), n_slots=3)
    _submit(sched)
    with _profile() as prof:
        sched.prefill_poll()
    spans = device_trace.serving_spans(prof)
    at = [i for i, (n, _, _) in enumerate(spans) if n == "state_reset"]
    assert at and all(_parent(spans, i) == "admit" for i in at)
    assert sched.state_resets == resets
    sched.reset_stats()
    assert sched.state_resets == 0


def _plan_spans(prof):
    return [e.name for e in prof.events()
            if e.name.startswith(common.SPAN_PREFIX)]


def test_plan_step_spans_on_an_eager_step_and_none_in_a_capture(
        monkeypatch):
    """An eager decode step inside a profiler opens one span a plan step,
    named by its kind; the trace reader sums each kind's device time (0 on
    the CPU).  While a CUDA graph is captured none is recorded, and with
    no profiler a span is the shared null context."""
    m = Model(get_config("zamba2-1.2b-smoke"), device="cpu")
    params = m.init(0)
    cache = m.init_decode_cache(2, 8)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    assert common.step_span("mamba") is common._NULL
    with _profile() as prof:
        m.decode_step(params, cache, tok, 0)
    names = _plan_spans(prof)
    kinds = [s[1] if s[0] == "scan" else {"shared_attn": "site"}.get(
        s[0], s[0]) for s in m.plan] + ["head"]
    assert names == [common.SPAN_PREFIX + k for k in kinds]
    assert set(device_trace.plan_device_s(prof)) == set(kinds)
    assert all(v == 0.0 for v in device_trace.plan_device_s(prof).values())
    monkeypatch.setattr(common, "_capturing", lambda: True)
    with _profile() as prof:
        m.decode_step(params, cache, tok, 1)
    assert _plan_spans(prof) == []
