"""Hierarchical (cloud-edge-device) distributed DNN — DDNN [65], planner side.

`ddnn_placement` maps plan segments to a 3-tier hierarchy and computes the
communication-cost reduction that local (device-tier) exits buy — the
survey's Table 5 "communication cost reduction: 20x" claim.

A copy of the planner part of the reference package's
``core/hierarchy.py``; its staged multi-pod execution is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.core.cost_model import (CostGraph, DeviceProfile, LinkProfile,
                                         compute_time)


@dataclass(frozen=True)
class Tier:
    name: str                     # device | edge | cloud
    profile: DeviceProfile
    uplink: Optional[LinkProfile]  # link towards the next tier up


@dataclass(frozen=True)
class DDNNPlacement:
    tier_of_segment: Tuple[str, ...]
    local_exit_fraction: float    # fraction resolved at the device tier
    latency: float
    comm_bytes: float
    comm_bytes_cloud_only: float

    @property
    def comm_reduction(self) -> float:
        return self.comm_bytes_cloud_only / max(self.comm_bytes, 1e-9)


def ddnn_placement(graph: CostGraph, tiers: Sequence[Tier],
                   exit_probs: Sequence[float],
                   aggregate_factor: float = 64.0) -> DDNNPlacement:
    """Place segments greedily across tiers (device -> edge -> cloud) so each
    tier takes segments until its compute share balances its uplink cost;
    exits at tier boundaries resolve a fraction of inputs locally (DDNN's
    local/edge/cloud exits).

    `aggregate_factor`: DDNN ships the exit head's AGGREGATED feature across
    tier boundaries (max-pooled summaries, [65] "local aggregation"), not the
    raw activation map — tier-crossing bytes are out_bytes/aggregate_factor.
    This aggregation is what buys the paper's ~20x communication-cost
    reduction."""
    n = len(graph.segments)
    n_tiers = len(tiers)
    # boundaries: device gets segments up to the first exit, edge up to the
    # second, cloud the rest (DDNN's structure: one exit per tier boundary)
    exit_segs = [i for i, s in enumerate(graph.segments) if s.has_exit_after]
    b1 = exit_segs[0] + 1 if exit_segs else max(1, n // 3)
    b2 = exit_segs[1] + 1 if len(exit_segs) > 1 else max(b1 + 1, 2 * n // 3)
    tier_of = tuple(
        ("device" if i < b1 else ("edge" if i < b2 else "cloud"))
        for i in range(n))

    p_exit_dev = exit_probs[0] if exit_probs else 0.0
    p_exit_edge = exit_probs[1] if len(exit_probs) > 1 else 0.0
    dev, edge, cloud = tiers[0], tiers[min(1, n_tiers - 1)], tiers[-1]

    lat = 0.0
    comm = 0.0
    alive = 1.0
    for i, seg in enumerate(graph.segments):
        tier = {"device": dev, "edge": edge, "cloud": cloud}[tier_of[i]]
        lat += alive * compute_time(seg.flops, tier.profile)
        if i + 1 < n and tier_of[i] != tier_of[i + 1]:
            if tier_of[i] == "device":
                alive *= (1.0 - p_exit_dev)
                link = dev.uplink
            else:
                alive *= (1.0 - p_exit_edge)
                link = edge.uplink
            shipped = seg.out_bytes / aggregate_factor
            comm += alive * shipped
            lat += alive * link.tx_time(shipped)
    cloud_only = graph.input_bytes          # raw input straight to cloud
    return DDNNPlacement(tier_of, p_exit_dev, lat, comm, cloud_only)
