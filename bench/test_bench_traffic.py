"""The traffic generator: the same seed gives the same inputs, and every
seed the same multiset of sizes."""
import numpy as np
import pytest

from bench import traffic

SEEDS = [0, 7, 2**31 + 11, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_sessions_repeat_by_seed(seed):
    a = traffic.session_prompts(seed, 16, 16, 64, 49155)
    b = traffic.session_prompts(seed, 16, 16, 64, 49155)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(x.dtype == np.int32 and x.min() >= 0 and x.max() < 49155
               for x in a)


def test_seeds_change_order_not_sizes():
    a = traffic.prompt_lengths(1, 128, 16, 64)
    b = traffic.prompt_lengths(2, 128, 16, 64)
    assert not np.array_equal(a, b)
    assert sorted(a) == sorted(b)
    assert a.min() == 16 and a.max() == 64


@pytest.mark.parametrize("seed", SEEDS)
def test_waves_hold_the_same_lengths_under_every_seed(seed):
    a = traffic.prompt_lengths(seed, 128, 16, 64, 4)
    b = traffic.prompt_lengths(seed + 1, 128, 16, 64, 4)
    assert sorted(a) == sorted(traffic.prompt_lengths(seed, 128, 16, 64))
    for w in range(4):
        assert sorted(a[32 * w:32 * w + 32]) == sorted(b[32 * w:32 * w + 32])
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_score_batches_repeat_by_seed(seed):
    a = traffic.score_batches(seed, 2, 8, 64, 1000)
    b = traffic.score_batches(seed, 2, 8, 64, 1000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (8, 64) and not np.array_equal(a[0], a[1])


def test_sample_holds_the_longest():
    for seed in SEEDS:
        s = traffic.sample(seed, 128, 8, 77)
        assert 77 in s and len(set(s)) == 8 == len(s)
    assert traffic.sample(3, 4, 8, 2) == [0, 1, 2, 3]


def test_poisson_trace_repeats_by_seed():
    a = traffic.poisson_trace(np.random.RandomState(4), 5.0, 32, 128)
    b = traffic.poisson_trace(np.random.RandomState(4), 5.0, 32, 128)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.all(np.diff(a[0]) >= 0)
    assert a[1].min() >= 32 and a[1].max() <= 128
