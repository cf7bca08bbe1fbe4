"""Sampled decode in the port (``temperature > 0`` with a generator).

The reference draws with ``jax.random.categorical`` on threefry bits; the
port draws Gumbel-max on a counter-based hash (``serving/sampling.py``).
The bits differ by design, so the draw is held to its distribution (a
chi-square test against ``softmax(logits / T)``), and the scheduler to
reproducibility and to the reference's "greedy unless an rng was given".
"""
import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig)
from repro_torch.serving import sampling

ARCH = "granite-3-2b-smoke"
T = 0.7


def _lowbias32(x: int) -> int:
    """The hash in plain 32-bit unsigned arithmetic."""
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_hash_is_lowbias32_without_overflow():
    """The int64 tensor form equals the 32-bit hash on edge values and
    random ones (its products stay below 2^49, so no step overflows)."""
    rs = np.random.RandomState(0)
    xs = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    xs += [int(v) for v in rs.randint(0, 2 ** 32, 256, dtype=np.int64)]
    got = sampling.hash32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [_lowbias32(x) for x in xs]


def test_gumbel_draws_follow_softmax():
    """20,000 draws at successive ticks from fixed logits (V 64, T 0.7,
    one fixed key) against softmax(logits / T): chi-square p > 1e-4, bins
    with an expected count under 5 pooled."""
    rs = np.random.RandomState(0)
    v, n = 64, 20000
    logits = torch.from_numpy((rs.randn(v) * 0.7).astype(np.float32))
    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    tok = sampling.sample_rows(logits.expand(n, v), T, key,
                               torch.arange(n, dtype=torch.int64))
    counts = np.bincount(tok.numpy(), minlength=v).astype(np.float64)
    p = torch.softmax(logits.double() / T, dim=-1).numpy()
    expect = p / p.sum() * n
    small = expect < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expect[~small], expect[small].sum())
    if not small.any():
        obs, exp = obs[:-1], exp[:-1]
    res = stats.chisquare(obs, exp)
    assert res.pvalue > 1e-4, res
    # the draw is random, not the argmax
    assert len(np.unique(tok.numpy())) > v // 2


@pytest.fixture(scope="module")
def model():
    m = Model(get_config(ARCH), device="cpu")
    return m, m.init(0)


def _serve(model, *, async_decode, temperature=T, seed=None, n=2, slots=2,
           max_new=6, R=3):
    """Serve ``n`` equal-length prompts; ``seed`` None = no generator."""
    m, params = model
    max_len = 6 + max_new
    max_len += (-max_len) % 16
    s = ContinuousBatchScheduler(m, params, SchedulerConfig(
        n_slots=slots, max_len=max_len, prefill_chunk=4, exit_threshold=0.0,
        segmented=not async_decode, paged=True, temperature=temperature,
        async_decode=async_decode, readback_interval=R), device="cpu")
    rs = np.random.RandomState(3)
    reqs = [Request(tokens=rs.randint(0, m.cfg.vocab_size, 5),
                    max_new=max_new, req_id=j) for j in range(n)]
    for r in reqs:
        s.submit(r)
    s.run(rng=None if seed is None
          else torch.Generator().manual_seed(seed))
    outs = [list(r.out_tokens) for r in reqs]
    assert all(len(o) == max_new for o in outs)
    assert all(0 <= t < m.cfg.vocab_size for o in outs for t in o)
    return outs


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync-seg", "async"])
def test_same_seed_same_samples(model, async_decode):
    """Three requests through two slots (one re-admission): the same
    generator seed gives the same tokens, another seed other ones."""
    a = _serve(model, async_decode=async_decode, seed=1, n=3)
    b = _serve(model, async_decode=async_decode, seed=1, n=3)
    c = _serve(model, async_decode=async_decode, seed=2, n=3)
    assert a == b and a != c


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync-seg", "async"])
def test_no_rng_is_greedy(model, async_decode):
    """temperature > 0 without a generator (``run()``, i.e. set_rng(None))
    gives the greedy tokens; with one the tokens are sampled."""
    greedy = _serve(model, async_decode=async_decode, temperature=0.0)
    assert _serve(model, async_decode=async_decode) == greedy
    assert _serve(model, async_decode=async_decode, seed=1) != greedy


def test_sync_and_async_samples_equal_when_ticks_align(model):
    """Two slots admitted together and max_new a multiple of R: the sync
    step and the window draw at the same ticks, so the samples agree (the
    first token's draw is the same admission draw in both)."""
    sync = _serve(model, async_decode=False, seed=5, max_new=6, R=3)
    assert _serve(model, async_decode=True, seed=5, max_new=6, R=3) == sync
