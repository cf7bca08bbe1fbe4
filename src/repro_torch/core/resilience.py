"""Failure-resilient distributed inference — deepFogGuard [68] / ResiliNet
[69], planner side: ``resilience_report`` gives the expected accuracy
under node-failure probabilities with and without skip hyperconnections
(the tiered cluster reports it after a tier outage).

A copy of the planner part of the reference package's
``core/resilience.py``; the skip-forward over dead blocks is not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ResilienceReport:
    survive_prob: float
    expected_accuracy_with_skip: float
    expected_accuracy_without_skip: float

    @property
    def gain(self) -> float:
        return (self.expected_accuracy_with_skip
                - self.expected_accuracy_without_skip)


def resilience_report(n_stages: int, stage_fail_prob: float,
                      acc_full: float = 0.92, acc_per_missing: float = 0.06,
                      ) -> ResilienceReport:
    """Expected accuracy under independent stage failures.

    Without skip hyperconnections any stage failure kills the pipeline
    (accuracy falls to chance ~ 0).  With them, each missing stage degrades
    accuracy by `acc_per_missing` (deepFogGuard's measured behaviour:
    graceful degradation instead of collapse)."""
    p = stage_fail_prob
    # with skip: expected missing stages = n*p
    exp_missing = n_stages * p
    acc_with = max(0.0, acc_full - acc_per_missing * exp_missing)
    # without: pipeline works only if ALL stages alive
    p_all = (1 - p) ** n_stages
    acc_without = acc_full * p_all
    return ResilienceReport(1 - p, acc_with, acc_without)
