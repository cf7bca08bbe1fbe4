"""Adaptive exit-threshold control (survey §7.3: data-driven adaptive
resource allocation; §6.3: dynamic task allocation based on device status).

The edge-device paradigm's knob is the entropy threshold: looser -> more
tokens exit early -> less compute/latency, lower accuracy.  This controller
closes the loop the surveyed systems leave open: given a latency target and
the expected per-segment cost, it adjusts the threshold online from the
observed exit fractions (multiplicative-increase / multiplicative-decrease,
bounded), so serving tracks its deadline as load or model depth changes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class AdaptiveExitController:
    """Tracks expected depth-per-token and steers the entropy threshold."""
    target_depth_fraction: float      # want E[segments run]/total <= this
    threshold: float = 0.5
    lo: float = 0.02
    hi: float = 0.98
    gain: float = 1.15

    def expected_depth_fraction(self, exit_fracs: Sequence[float],
                                boundaries: Sequence[float]) -> float:
        """exit_fracs[i] = fraction of tokens that exited at head i;
        boundaries[i] = depth fraction of exit i (e.g. layer/num_layers).
        The remainder runs full depth."""
        frac = 0.0
        used = 0.0
        for f, b in zip(exit_fracs, boundaries):
            frac += f * b
            used += f
        return frac + max(0.0, 1.0 - used) * 1.0

    def update_measured(self, depth_fraction: float) -> float:
        """The one control path: steer the threshold from a *measured* depth
        fraction — the scheduler reports the layer-weighted share of the
        stack its segment stages actually dispatched per token, so the knob
        tracks real truncated compute, not a histogram-derived estimate."""
        if depth_fraction > self.target_depth_fraction:
            self.threshold = min(self.hi, self.threshold * self.gain)
        else:
            self.threshold = max(self.lo, self.threshold / self.gain)
        return self.threshold

    def update(self, exit_fracs: Sequence[float],
               boundaries: Sequence[float]) -> float:
        """Estimate depth from exit fractions + static boundaries, then
        steer.  Kept for callers without segment reports (monolithic
        decode); the serving scheduler feeds ``update_measured`` directly."""
        return self.update_measured(
            self.expected_depth_fraction(exit_fracs, boundaries))
