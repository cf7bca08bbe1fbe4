"""Open-loop arrival-trace generators shared by the serving benchmarks.

Every serving driver used to hand-roll its own ``np.cumsum(exponential)``
arrivals; this module is the single source of truth so the Poisson bench,
the tiered bench, and the pipeline bench all replay the *same* trace for a
given seed.  All generators take a ``numpy.random.RandomState`` (not the
global RNG) and are deterministic: same state + same arguments = same
trace, bit for bit.

Generators return ``(arrivals, lengths)`` — absolute arrival offsets in
seconds (float64, non-decreasing) and per-request prompt lengths (ints in
``[max(1, prompt_len // 4), prompt_len]``) — except :func:`mixed_slo_trace`
which additionally returns a per-request SLO-class label array.

Kinds:

* ``poisson`` — homogeneous Poisson process at ``rate`` req/s
  (exponential inter-arrival gaps).  Bit-compatible with the historical
  inline generator in ``launch/serve.py``: the draw order (all gaps, then
  all lengths) is preserved so old seeds reproduce old traces.
* ``diurnal`` — sinusoidally-modulated Poisson (a compressed day/night
  cycle): instantaneous rate ``rate * (1 + amplitude * sin(...))``,
  realised by inverting the gap draw against the local rate.
* ``flash_crowd`` — Poisson baseline at ``rate`` with a fraction of the
  requests compressed into a short burst window at ``burst_factor`` times
  the base rate (the "everyone opens the app at once" shape that tiered
  admission must absorb).
* ``mixed_slo`` — Poisson arrivals plus a per-request SLO class drawn
  from ``classes`` with ``weights`` (e.g. interactive vs batch), for
  deadline-aware routing experiments.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["poisson_trace", "diurnal_trace", "flash_crowd_trace",
           "mixed_slo_trace", "make_trace", "TRACE_KINDS"]


def _lengths(rs: np.random.RandomState, prompt_len: int,
             n_requests: int) -> np.ndarray:
    """Uniform prompt lengths in [max(1, prompt_len//4), prompt_len]."""
    return rs.randint(max(1, prompt_len // 4), prompt_len + 1, n_requests)


def poisson_trace(rs: np.random.RandomState, rate: float, n_requests: int,
                  prompt_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Homogeneous Poisson arrivals.  Draw order (gaps first, lengths
    second) is load-bearing: it matches the inline generator the serving
    drivers shipped with, so existing seeds replay identical traces."""
    arrivals = np.cumsum(rs.exponential(1.0 / rate, n_requests))
    return arrivals, _lengths(rs, prompt_len, n_requests)


def diurnal_trace(rs: np.random.RandomState, rate: float, n_requests: int,
                  prompt_len: int, *, period_s: float = 60.0,
                  amplitude: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """Sinusoidally-modulated Poisson: the instantaneous rate swings
    ``rate * (1 ± amplitude)`` over ``period_s`` seconds.  Each gap is an
    exponential draw scaled by the local rate at the previous arrival —
    an order-preserving approximation of a non-homogeneous process that
    stays exactly reproducible from the seed."""
    assert 0.0 <= amplitude < 1.0, "amplitude must be in [0, 1)"
    gaps = rs.exponential(1.0, n_requests)
    arrivals = np.empty(n_requests, np.float64)
    t = 0.0
    for i in range(n_requests):
        local = rate * (1.0 + amplitude
                        * np.sin(2.0 * np.pi * t / period_s))
        t += gaps[i] / max(local, 1e-9)
        arrivals[i] = t
    return arrivals, _lengths(rs, prompt_len, n_requests)


def flash_crowd_trace(rs: np.random.RandomState, rate: float,
                      n_requests: int, prompt_len: int, *,
                      burst_frac: float = 0.3,
                      burst_factor: float = 10.0,
                      burst_at_frac: float = 0.5
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Poisson baseline with ``burst_frac`` of the requests compressed
    into a flash-crowd window starting ``burst_at_frac`` of the way into
    the baseline trace, arriving at ``burst_factor`` x the base rate.
    The merged trace is sorted, so downstream drivers see one
    non-decreasing arrival stream."""
    n_burst = int(n_requests * burst_frac)
    n_base = n_requests - n_burst
    base = np.cumsum(rs.exponential(1.0 / rate, n_base))
    start = (base[-1] if n_base else 0.0) * burst_at_frac
    burst = start + np.cumsum(
        rs.exponential(1.0 / (rate * burst_factor), n_burst))
    arrivals = np.sort(np.concatenate([base, burst]))
    return arrivals, _lengths(rs, prompt_len, n_requests)


def mixed_slo_trace(rs: np.random.RandomState, rate: float, n_requests: int,
                    prompt_len: int, *,
                    classes: Sequence[str] = ("interactive", "batch"),
                    weights: Optional[Sequence[float]] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Poisson arrivals with a per-request SLO class label drawn from
    ``classes`` (default 70/30 interactive/batch).  Returns
    ``(arrivals, lengths, slo_classes)``."""
    arrivals, lengths = poisson_trace(rs, rate, n_requests, prompt_len)
    if weights is None:
        weights = [0.7, 0.3] if len(classes) == 2 else None
    labels = rs.choice(np.asarray(classes, object), n_requests, p=weights)
    return arrivals, lengths, labels


TRACE_KINDS = {"poisson": poisson_trace,
               "diurnal": diurnal_trace,
               "flash_crowd": flash_crowd_trace,
               "mixed_slo": mixed_slo_trace}


def make_trace(kind: str, rs: np.random.RandomState, rate: float,
               n_requests: int, prompt_len: int, **kw):
    """Dispatch by trace kind name (see ``TRACE_KINDS``)."""
    if kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"choose from {sorted(TRACE_KINDS)}")
    return TRACE_KINDS[kind](rs, rate, n_requests, prompt_len, **kw)
