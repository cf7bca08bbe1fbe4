"""The port's continuous-batching scheduler against the reference
scheduler on the same weights and prompts (granite-3-2b-smoke).

Five mixed-length prompts go through two slots, so slots are reused; the
fourth prompt shares its first page with the second, so the paged arena's
prefix cache hits.  Greedy tokens must be equal, except where the
reference's top-2 logits lie within a bf16 ulp (the tie rule of
tests/test_scheduler.py): after such a flip the continuations diverge and
the comparison stops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig)

ARCH = "granite-3-2b-smoke"
MAX_NEW = 6
# (paged, segmented, exit threshold): 1.01 makes every slot exit at the
# first probe (normalized entropy is < 1), so the exit path really runs
CASES = [(True, True, 0.5), (False, True, 0.5), (True, False, 0.5),
         (True, True, 1.01)]


def _prompts(vocab):
    rs = np.random.RandomState(0)
    ps = [rs.randint(0, vocab, n).astype(np.int32) for n in (5, 20, 33, 9)]
    ps.append(np.concatenate([ps[1][:16], rs.randint(0, vocab, 6)]).astype(
        np.int32))
    return ps


def _cfg(cls, paged, segmented, thr):
    return cls(n_slots=2, max_len=64, prefill_chunk=8, paged=paged,
               page_size=16, segmented=segmented, exit_threshold=thr)


@pytest.fixture(scope="module")
def models():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    return rm, rp, tm, tp


@pytest.fixture(scope="module")
def ref_runs(models):
    """One reference scheduler run per case, shared by the tests."""
    rm, rp, tm, _ = models
    runs = {}
    for case in CASES:
        s = RefScheduler(rm, rp, _cfg(RefConfig, *case))
        for i, p in enumerate(_prompts(tm.cfg.vocab_size)):
            s.submit(RefRequest(tokens=p, max_new=MAX_NEW, req_id=i))
        s.run()
        runs[case] = (s, {r.req_id: list(r.out_tokens) for r in s.completed})
    return runs


def _ref_logits(rm, rp, prompt, tokens):
    """Batch-1 reference logits at every generated position."""
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    return np.asarray(logits[0, prompt.size - 1:])


def _assert_greedy_equal(rm, rp, prompt, got, want):
    if got == want:
        return
    logs = _ref_logits(rm, rp, prompt, want)
    for k, (a, b) in enumerate(zip(got, want)):
        if a != b:
            gap = float(logs[k][b] - logs[k][a])
            assert 0.0 <= gap < 1e-2, \
                f"token {k}: got {a}, want {b}, ref logit gap {gap:.3e}"
            return
    assert len(got) == len(want)


@pytest.mark.parametrize("case", CASES,
                         ids=["paged-seg", "contig-seg", "paged-mono",
                              "paged-seg-exit"])
def test_greedy_outputs_match_reference(models, ref_runs, case):
    rm, rp, tm, tp = models
    ref_sched, want = ref_runs[case]
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, *case),
                                 device="cpu")
    prompts = _prompts(tm.cfg.vocab_size)
    reqs = [Request(tokens=p, max_new=MAX_NEW, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        s.submit(r)
    s.run()
    assert s.n_admitted == len(prompts) and not s.has_work
    slots = [r.slot for r in reqs]
    assert sorted(set(slots)) == [0, 1] and max(np.bincount(slots)) >= 2
    for r, p in zip(reqs, prompts):
        assert len(r.out_tokens) == MAX_NEW
        _assert_greedy_equal(rm, rp, p, r.out_tokens, want[r.req_id])
    np.testing.assert_array_equal(s.exit_counts, ref_sched.exit_counts)
    assert s.tokens_served == ref_sched.tokens_served
    paged, segmented, thr = case
    if paged:
        assert s.prefix_hit_tokens == ref_sched.prefix_hit_tokens > 0
        assert s.page_alloc.free_count + len(s.prefix_cache) \
            == s.page_alloc.n_pages
    if segmented:
        assert s.stage_calls == ref_sched.stage_calls
    if thr > 1.0:
        assert s.exit_counts[0] == s.tokens_served   # all exit at probe 0


def test_unported_options_are_rejected():
    """async_decode and sampled decode are ported: the config accepts
    them and refuses only what the reference refuses (async windows on the
    segmented step, a window of no steps)."""
    with pytest.raises(ValueError, match="segmented"):
        SchedulerConfig(async_decode=True)
    with pytest.raises(ValueError, match="readback_interval"):
        SchedulerConfig(async_decode=True, segmented=False,
                        readback_interval=0)
    assert SchedulerConfig(async_decode=True, segmented=False).async_decode
    assert SchedulerConfig(temperature=0.7).temperature == 0.7


def test_prefill_budget_interleaves_with_decode(models):
    """max_prefill_chunks_per_step=1: a long admission advances one chunk
    per poll while the in-flight slot keeps decoding."""
    _, _, tm, tp = models
    s = ContinuousBatchScheduler(
        tm, tp, SchedulerConfig(n_slots=2, max_len=64, prefill_chunk=8,
                                max_prefill_chunks_per_step=1, paged=True),
        device="cpu")
    rs = np.random.RandomState(7)
    s.submit(Request(tokens=rs.randint(0, 1000, 4), max_new=20))
    while not s.active.any():
        s.poll()
    s.submit(Request(tokens=rs.randint(0, 1000, 40), max_new=4))
    reps = [s.poll() for _ in range(3)]
    assert all(r.prefill_chunks <= 1 and r.decode_stepped for r in reps)
    s.run()
    assert len(s.completed) == 2
    assert torch.equal(s._counters.cpu().sum(), torch.tensor(s.tokens_served,
                                                             dtype=torch.int32))
