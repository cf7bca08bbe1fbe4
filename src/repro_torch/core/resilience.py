"""Failure-resilient distributed inference — deepFogGuard [68] / ResiliNet
[69].

Skip hyperconnections: in a physically partitioned DNN, each stage's input
can bypass a failed stage and arrive from the nearest alive predecessor.
The segments are residual stacks, so the hyperconnection is an identity
bypass: a failed block contributes nothing and its input flows through.

- ``resilient_forward``: the full-sequence forward with a per-block
  ``alive`` mask; failed blocks (and the exit heads attached to them) are
  bypassed.
- ``failout``: ResiliNet's training-time stage dropout, an iid alive
  mask that ``training.compute_loss`` hands to ``resilient_forward``.
- ``resilience_report``: the expected accuracy under node-failure
  probabilities with and without skip hyperconnections (the tiered
  cluster reports it after a tier outage).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import apply_norm, unembed


def n_scan_blocks(model) -> int:
    return sum(1 for s in model.plan if s[0] == "scan")


def resilient_forward(model, params, batch, alive, *,
                      long_mode: bool = False):
    """Forward with a per-block alive mask (bool or float [n_blocks]).

    A failed block is an identity bypass (skip hyperconnection): x takes
    ``a * y + (1 - a) * x`` as in the reference, so an alive block's output
    passes unchanged.  An exit head after a failed block reads the bypassed
    hidden state.  Returns (logits, exit_logits) like ``Model.forward``
    (without aux)."""
    cfg = model.cfg
    x = model.embed_inputs(params, batch)
    bsz, seq = batch["tokens"].shape
    positions = model.positions_for(bsz, seq, model.frontend_tokens_of(batch))
    enc_out = (model.encode(params, batch["frames"])
               if cfg.family == "encdec" else None)
    alive = torch.as_tensor(alive, device=x.device)
    x, _, exit_logits = model.run_plan(params, x, positions,
                                       model._window(long_mode), alive,
                                       enc_out=enc_out)
    h = apply_norm(cfg.norm, x, params["final_norm"])
    return unembed(h, params.get("lm_head", params["embed"])), exit_logits


def failout(generator, n_blocks: int, survive_prob: float = 0.9):
    """ResiliNet failout: an iid Bernoulli(``survive_prob``) alive mask
    [n_blocks] fp32, drawn from ``generator`` on its device; a draw with
    every block dead becomes all alive, as in the reference."""
    probs = torch.full((n_blocks,), survive_prob, dtype=torch.float32,
                       device=generator.device)
    alive = torch.bernoulli(probs, generator=generator)
    if not bool(alive.any()):
        alive = torch.ones_like(alive)
    return alive


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
