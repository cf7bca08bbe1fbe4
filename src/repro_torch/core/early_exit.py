"""Early-exit machinery — BranchyNet [58], Edgent [47,48], SPINN [37].

Runtime side: entropy-threshold exit decisions, the serving exit
statistics and BranchyNet's joint training loss weights.  Planner side
(host): Edgent's joint (exit point, partition point) search and
SPINN-style progressive-inference expectations over a ``CostGraph``.  A copy of the parts of the reference package's
``core/early_exit.py`` that the serving path, training and the planners
use.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import (CostGraph, DeviceProfile, LinkProfile,
                                         compute_energy, compute_time)


def entropy_of(logits):
    """Softmax entropy over the last axis, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def exit_mask(logits, threshold: float):
    """BranchyNet policy: exit where normalized entropy < threshold.

    Entropy is normalized by log(V) so one threshold works across vocab
    sizes.  Returns a bool mask with the leading dims of ``logits``."""
    v = logits.shape[-1]
    return entropy_of(logits) / math.log(float(v)) < threshold


def first_exit_index(exit_entropies, threshold: float, vocab: int):
    """exit_entropies [n_exits, B] -> per-item first exit (n_exits = stayed).
    Entropy is normalized by log(V) so one threshold spans vocab sizes."""
    n = exit_entropies.shape[0]
    hit = exit_entropies / math.log(float(vocab)) < threshold  # [n_exits, B]
    idx = torch.argmax(hit.to(torch.int32), dim=0)   # argmax takes no bool
    return torch.where(hit.any(dim=0), idx, torch.full_like(idx, n))


def exit_stats_dict(exit_counts, tokens_served) -> dict:
    """Serving-side exit statistics from a first-exit histogram
    ``exit_counts [n_exits + 1]`` (last entry = ran full depth)."""
    total = max(1, int(sum(int(c) for c in exit_counts)))
    st = {f"exit{i}_frac": float(c) / total
          for i, c in enumerate(exit_counts[:-1])}
    st["full_depth_frac"] = float(exit_counts[-1]) / total
    st["tokens"] = float(tokens_served)
    return st


def branchynet_loss_weights(n_exits: int, final_weight: float = 1.0,
                            exit_weight: float = 0.3) -> Tuple[float, ...]:
    """Joint training weights (BranchyNet trains all exits jointly)."""
    return tuple([exit_weight] * n_exits + [final_weight])


# ---------------------------------------------------------------------------
# Exit accuracy / probability profiles
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExitProfile:
    """Measured (or modeled) per-exit behaviour.

    accuracies[e]   accuracy if forced to exit at boundary e (monotone-ish)
    exit_probs[e]   fraction of inputs whose entropy clears the threshold at
                    e (given they reached e)  — SPINN's rate curve
    """
    boundaries: Tuple[int, ...]       # segment index after which exit sits
    accuracies: Tuple[float, ...]     # len = n_exits + 1 (final head last)
    exit_probs: Tuple[float, ...]     # len = n_exits

    @staticmethod
    def default(n_segments: int, exit_segments: Sequence[int],
                final_acc: float = 0.92, floor_acc: float = 0.70,
                threshold: float = 0.5) -> "ExitProfile":
        """BranchyNet-shaped defaults: accuracy saturates with depth; exit
        rate grows with depth and with a looser threshold."""
        accs, probs = [], []
        for b in exit_segments:
            frac = (b + 1) / n_segments
            accs.append(floor_acc + (final_acc - floor_acc) * frac ** 0.5)
            probs.append(min(0.95, threshold * (0.4 + 0.8 * frac)))
        accs.append(final_acc)
        return ExitProfile(tuple(exit_segments), tuple(accs), tuple(probs))

    def reach_probs(self) -> Tuple[float, ...]:
        """P(input reaches exit e) and P(reaches final)."""
        out = []
        stay = 1.0
        for p in self.exit_probs:
            out.append(stay)
            stay *= (1.0 - p)
        out.append(stay)
        return tuple(out)

    def expected_accuracy(self) -> float:
        reach = self.reach_probs()
        acc = 0.0
        for e, p in enumerate(self.exit_probs):
            acc += reach[e] * p * self.accuracies[e]
        acc += reach[-1] * self.accuracies[-1]
        return acc


# ---------------------------------------------------------------------------
# Edgent: joint (exit depth, partition point) under a deadline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EdgentPlan:
    exit_index: int               # which exit head terminates the model
    cut: int                      # segments [0,cut) on device, rest on edge
    latency: float
    accuracy: float
    feasible: bool


def edgent_plan(graph: CostGraph, profile: ExitProfile,
                device: DeviceProfile, edge: DeviceProfile,
                link: LinkProfile, deadline: float) -> EdgentPlan:
    """Maximize accuracy s.t. latency <= deadline, jointly choosing the
    model right-size (exit) and the partition point — Edgent's DP, done
    exhaustively here (the chain is short: segments x exits)."""
    n = len(graph.segments)
    exits = list(profile.boundaries) + [n - 1]
    best: Optional[EdgentPlan] = None
    for ei, last_seg in enumerate(exits):
        acc = profile.accuracies[ei]
        m = last_seg + 1                      # model truncated to m segments
        for cut in range(m + 1):
            local_f = sum(s.flops for s in graph.segments[:cut])
            remote_f = sum(s.flops for s in graph.segments[cut:m])
            tx = (graph.input_bytes if cut == 0
                  else (graph.result_bytes if cut == m
                        else graph.segments[cut - 1].out_bytes))
            lat = (compute_time(local_f, device) + link.tx_time(tx)
                   + compute_time(remote_f, edge)
                   + (link.tx_time(graph.result_bytes) if cut < m else 0.0))
            cand = EdgentPlan(ei, cut, lat, acc, lat <= deadline)
            if cand.feasible and (best is None or not best.feasible
                                  or cand.accuracy > best.accuracy
                                  or (cand.accuracy == best.accuracy
                                      and cand.latency < best.latency)):
                best = cand
            elif best is None or (not best.feasible and cand.latency < best.latency):
                best = cand
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# SPINN: progressive inference expectation over a split
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpinnEstimate:
    expected_latency: float
    expected_device_energy: float
    expected_tx_bytes: float
    expected_accuracy: float


def spinn_estimate(graph: CostGraph, profile: ExitProfile, cut: int,
                   device: DeviceProfile, remote: DeviceProfile,
                   link: LinkProfile) -> SpinnEstimate:
    """Expected metrics when exits fire probabilistically: inputs exiting on
    the device side never cross the link (SPINN's synergy)."""
    n = len(graph.segments)
    reach = profile.reach_probs()
    lat = en = tx_bytes = 0.0
    # device-side segments
    p_alive = 1.0
    ei = 0
    for i, seg in enumerate(graph.segments):
        dev = device if i < cut else remote
        t = compute_time(seg.flops, dev)
        e = compute_energy(seg.flops, dev) if i < cut else 0.0
        lat += p_alive * t
        en += p_alive * e
        if seg.has_exit_after and ei < len(profile.exit_probs):
            p_alive *= (1.0 - profile.exit_probs[ei])
            ei += 1
        if i + 1 == cut:  # boundary crossing happens only for still-alive inputs
            b = seg.out_bytes * p_alive
            tx_bytes += b
            lat += p_alive * link.tx_time(seg.out_bytes)
            en += p_alive * link.tx_energy(seg.out_bytes)
    return SpinnEstimate(lat, en, tx_bytes, profile.expected_accuracy())
