"""The benchmark's one traffic generator.  It reads a traffic mix's data
file (``bench/traffic/<name>.json``) and a cell's sizes and draws the
inputs from the run's seed: the same seed gives the same inputs.

Every seed gets the same multiset of sizes (prompt lengths spread evenly
over the mix's range, the same in every admission wave) in another order, so a seed changes which session
holds which length and which tokens it reads, never how much work a run
does.

``poisson_trace`` is a copy of the program's open-loop arrival generator
(``serving/traces.py``), kept here for the arrival cells that are to
come: the yardstick may not change when the program does.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

SEED_MOD = 1 << 63                        # numpy and torch both take it


def rng(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of ``stream`` under ``seed`` (any integer)."""
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


def prompt_lengths(seed: int, n: int, lo: int, hi: int,
                   groups: int = 1) -> np.ndarray:
    """``n`` prompt lengths spread evenly over [lo, hi], the longest and
    the shortest always among them.  Dealt in turn into ``groups``
    consecutive groups (admission waves) of ``n // groups``, so each
    group holds the same lengths under every seed; each group in the
    seed's order."""
    lengths = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    if n % groups:
        raise ValueError(f"{n} sessions do not split into {groups} waves")
    g = rng(seed, 1)
    return np.concatenate([g.permutation(lengths[i::groups])
                           for i in range(groups)])


def session_prompts(seed: int, n: int, lo: int, hi: int, vocab: int,
                    groups: int = 1) -> List[np.ndarray]:
    """The prompts of ``n`` sessions: lengths as ``prompt_lengths``,
    tokens uniform over the vocabulary."""
    lengths = prompt_lengths(seed, n, lo, hi, groups)
    g = rng(seed, 2)
    return [g.integers(0, vocab, int(m), dtype=np.int64).astype(np.int32)
            for m in lengths]


def score_batches(seed: int, count: int, batch: int, seq: int,
                  vocab: int) -> List[np.ndarray]:
    """``count`` token batches [batch, seq], uniform over the vocabulary."""
    g = rng(seed, 3)
    return [g.integers(0, vocab, (batch, seq), dtype=np.int64)
            for _ in range(count)]


def sample(seed: int, n: int, k: int, must: int) -> List[int]:
    """``k`` distinct indices of ``n`` drawn from the seed, ``must``
    always among them (the check's sample, with the longest in it)."""
    rest = [i for i in rng(seed, 4).permutation(n).tolist() if i != must]
    return sorted([must] + rest[:max(0, min(k, n) - 1)])


def poisson_trace(rs: np.random.RandomState, rate: float, n_requests: int,
                  prompt_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Homogeneous Poisson arrivals (gaps drawn first, then lengths
    uniform in [max(1, prompt_len // 4), prompt_len])."""
    arrivals = np.cumsum(rs.exponential(1.0 / rate, n_requests))
    lengths = rs.randint(max(1, prompt_len // 4), prompt_len + 1,
                         n_requests)
    return arrivals, lengths
