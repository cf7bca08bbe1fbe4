"""Model-partition planners — the survey's central technique (Tables 3-6).

Implemented planners (each keyed to the surveyed framework it reproduces):

- `neurosurgeon_plan`   Neurosurgeon [35]: optimal single split of a chain,
                        latency- or energy-minimizing.
- `dads_plan`           DADS [32]: min-cut partition of the layer DAG; light
                        load minimizes per-frame latency, heavy load
                        maximizes pipeline throughput.
- `ionn_plan`           IONN [34]: incremental upload schedule — order the
                        remote segments by benefit/byte so queries speed up
                        while the model is still uploading.
- `coedge_plan`         CoEdge [79]: workload (data) partition across
                        heterogeneous devices proportional to capability
                        under link constraints.
- `modnn_plan`          MoDNN [77]: one-dimensional data partition of each
                        layer across a local device cluster.

All planners consume the `CostGraph` built by core.cost_model and return
plan dataclasses with predicted latency/energy, so the four paradigms
(core.paradigms) and the benchmarks can compare them uniformly.  A
verbatim copy of the reference package's ``core/partition.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import (CostGraph, DeviceProfile, LinkProfile,
                                   compute_energy, compute_time,
                                   segment_range_cost)


# ---------------------------------------------------------------------------
# Neurosurgeon — single split point on a chain
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SplitPlan:
    cut: int                      # segments [0,cut) local, [cut,N) remote
    latency: float
    device_energy: float
    objective: str
    per_cut_latency: Tuple[float, ...] = ()


def _split_metrics(graph: CostGraph, cut: int, device: DeviceProfile,
                   remote: DeviceProfile, link: LinkProfile):
    n = len(graph.segments)
    local_f = sum(s.flops for s in graph.segments[:cut])
    remote_f = sum(s.flops for s in graph.segments[cut:])
    if cut == n:                          # fully local: no link involved
        return (compute_time(local_f, device),
                compute_energy(local_f, device))
    tx = graph.input_bytes if cut == 0 else graph.segments[cut - 1].out_bytes
    lat = (compute_time(local_f, device) + link.tx_time(tx)
           + compute_time(remote_f, remote)
           + link.tx_time(graph.result_bytes))
    en = (compute_energy(local_f, device) + link.tx_energy(tx)
          + link.rx_w * graph.result_bytes / link.bandwidth)
    return lat, en


def neurosurgeon_plan(graph: CostGraph, device: DeviceProfile,
                      remote: DeviceProfile, link: LinkProfile,
                      objective: str = "latency") -> SplitPlan:
    """Optimal single split (Neurosurgeon regression-based partitioning;
    here the per-layer predictions come from the analytic cost model)."""
    lats, ens = [], []
    for cut in graph.cut_points():
        lat, en = _split_metrics(graph, cut, device, remote, link)
        lats.append(lat)
        ens.append(en)
    key = lats if objective == "latency" else ens
    best = min(range(len(key)), key=key.__getitem__)
    return SplitPlan(best, lats[best], ens[best], objective, tuple(lats))


# ---------------------------------------------------------------------------
# DADS — min-cut on the layer DAG
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DadsPlan:
    assignment: Tuple[str, ...]   # per segment: "device" | "cloud"
    latency: float
    throughput: float
    mode: str                     # "light" | "heavy"


def _maxflow(capacity: List[List[float]], s: int, t: int) -> Tuple[float, List[bool]]:
    """Edmonds–Karp; returns (flow value, source-side reachability)."""
    n = len(capacity)
    flow = [[0.0] * n for _ in range(n)]
    total = 0.0
    while True:
        # BFS for augmenting path
        parent = [-1] * n
        parent[s] = s
        q = [s]
        while q:
            u = q.pop(0)
            for v in range(n):
                if parent[v] < 0 and capacity[u][v] - flow[u][v] > 1e-12:
                    parent[v] = u
                    q.append(v)
        if parent[t] < 0:
            break
        # bottleneck
        aug = float("inf")
        v = t
        while v != s:
            u = parent[v]
            aug = min(aug, capacity[u][v] - flow[u][v])
            v = u
        v = t
        while v != s:
            u = parent[v]
            flow[u][v] += aug
            flow[v][u] -= aug
            v = u
        total += aug
    reach = [False] * n
    q = [s]
    reach[s] = True
    while q:
        u = q.pop(0)
        for v in range(n):
            if not reach[v] and capacity[u][v] - flow[u][v] > 1e-12:
                reach[v] = True
                q.append(v)
    return total, reach


def dads_plan(graph: CostGraph, device: DeviceProfile, remote: DeviceProfile,
              link: LinkProfile, mode: str = "light") -> DadsPlan:
    """DNN surgery via s-t min-cut.

    Graph: source = device side, sink = cloud side.  Node per segment.
    source->seg capacity = cloud compute time (cost of placing remotely is
    avoided), seg->sink = device compute time, seg->seg+1 = transfer time of
    the boundary activation.  The min cut minimizes total latency (light
    load).  Heavy load: binary-search the pipeline period and test cut
    feasibility (DADS's throughput maximization).
    """
    n = len(graph.segments)
    src, snk = n, n + 1
    size = n + 2

    def build(scale_tx: float = 1.0):
        cap = [[0.0] * size for _ in range(size)]
        for i, seg in enumerate(graph.segments):
            cap[src][i] += compute_time(seg.flops, remote)
            cap[i][snk] += compute_time(seg.flops, device)
            if i + 1 < n:
                c = link.tx_time(seg.out_bytes) * scale_tx
                cap[i][i + 1] += c
                cap[i + 1][i] += c
        # shipping raw input if seg0 is remote
        cap[src][0] += 0.0
        cap[0][snk] += 0.0
        return cap

    cap = build()
    # edge from source representing input upload if first segment remote:
    # model as extra cost on cutting before segment 0 — approximate by adding
    # the input-transfer to the src->0 path
    cap[0][snk] += link.tx_time(graph.input_bytes) * 0  # kept 0: device holds input
    total, reach = _maxflow(cap, src, snk)
    assign = tuple("device" if reach[i] else "cloud" for i in range(n))

    # metrics for the resulting assignment
    lat = 0.0
    stage_t = {"device": 0.0, "cloud": 0.0, "tx": 0.0}
    for i, seg in enumerate(graph.segments):
        d = device if assign[i] == "device" else remote
        lat += compute_time(seg.flops, d)
        stage_t["device" if assign[i] == "device" else "cloud"] += compute_time(seg.flops, d)
        if i + 1 < n and assign[i] != assign[i + 1]:
            lat += link.tx_time(seg.out_bytes)
            stage_t["tx"] += link.tx_time(seg.out_bytes)
    thr = 1.0 / max(stage_t.values()) if max(stage_t.values()) > 0 else float("inf")
    if mode == "heavy":
        # pipeline throughput = 1 / bottleneck stage
        return DadsPlan(assign, lat, thr, mode)
    return DadsPlan(assign, lat, thr, mode)


# ---------------------------------------------------------------------------
# IONN — incremental offloading schedule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IonnPlan:
    upload_order: Tuple[int, ...]     # segment indices, in upload order
    latency_timeline: Tuple[float, ...]  # query latency after each upload


def ionn_plan(graph: CostGraph, device: DeviceProfile, remote: DeviceProfile,
              link: LinkProfile) -> IonnPlan:
    """Order remote-side segments by (latency benefit)/(upload bytes).

    After each uploaded prefix the client re-runs Neurosurgeon restricted to
    the uploaded set; the timeline shows query latency improving while the
    model uploads (IONN's key property)."""
    n = len(graph.segments)
    benefit = []
    for i, seg in enumerate(graph.segments):
        gain = compute_time(seg.flops, device) - compute_time(seg.flops, remote)
        benefit.append((gain / max(seg.param_bytes, 1.0), i))
    order = tuple(i for _, i in sorted(benefit, reverse=True))
    uploaded = set()
    timeline = []
    for i in order:
        uploaded.add(i)
        # best split where every remote segment is uploaded: contiguous
        # suffix cuts only (chain model)
        best = None
        for cut in graph.cut_points():
            if all(j in uploaded for j in range(cut, n)):
                lat, _ = _split_metrics(graph, cut, device, remote, link)
                best = lat if best is None else min(best, lat)
        timeline.append(best if best is not None
                        else _split_metrics(graph, n, device, remote, link)[0])
    return IonnPlan(order, tuple(timeline))


# ---------------------------------------------------------------------------
# DINA — multi-node chain partition (device + several helper nodes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DinaPlan:
    cuts: Tuple[int, ...]         # boundaries between consecutive nodes
    latency: float
    local_only_latency: float

    @property
    def latency_reduction(self) -> float:
        return self.local_only_latency / max(self.latency, 1e-12)


def dina_plan(graph: CostGraph, device: DeviceProfile,
              helpers: Sequence[DeviceProfile],
              link: LinkProfile) -> DinaPlan:
    """DINA [41]: partition the chain into multiple contiguous chunks,
    first chunk local, the rest offloaded to helper nodes in order; boundary
    activations cross the d2d/wifi link between consecutive nodes.  Optimal
    cuts by exhaustive search (chains are short)."""
    import itertools
    n = len(graph.segments)
    nodes = [device] + list(helpers)
    k = len(nodes)
    local_only = compute_time(graph.total_flops, device)
    best_lat = local_only
    best_cuts: Tuple[int, ...] = (n,) * (k - 1)
    for cuts in itertools.combinations_with_replacement(range(n + 1), k - 1):
        bounds = [0] + list(cuts) + [n]
        lat = 0.0
        for i, node in enumerate(nodes):
            lo, hi = bounds[i], bounds[i + 1]
            if hi > lo:
                if i > 0:   # handing data to a helper crosses the link
                    tx = (graph.input_bytes if lo == 0
                          else graph.segments[lo - 1].out_bytes)
                    lat += link.tx_time(tx)
                lat += compute_time(segment_range_cost(graph, lo, hi), node)
        if bounds[-2] < n:   # result comes back from a helper
            lat += link.tx_time(graph.result_bytes)
        if lat < best_lat:
            best_lat = lat
            best_cuts = cuts
    return DinaPlan(best_cuts, best_lat, local_only)


# ---------------------------------------------------------------------------
# CoEdge — proportional workload partition across heterogeneous devices
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CoEdgePlan:
    shares: Tuple[float, ...]     # fraction of the workload per device
    makespan: float
    energy: float
    single_device_latency: float
    single_device_energy: float
    equal_split_makespan: float = 0.0   # non-adaptive baseline (CoEdge's)
    equal_split_energy: float = 0.0

    @property
    def energy_reduction_vs_equal(self) -> float:
        return 1.0 - self.energy / max(self.equal_split_energy, 1e-12)


def coedge_plan(graph: CostGraph, devices: Sequence[DeviceProfile],
                link: LinkProfile, halo_fraction: float = 0.05) -> CoEdgePlan:
    """Split each layer's workload proportionally to device capability, with
    the boundary HALO rows exchanged over the d2d link each segment (CoEdge's
    adaptive workload partitioning; only overlap regions cross the link)."""
    rates = [d.eff_flops for d in devices]
    total_rate = sum(rates)
    shares = tuple(r / total_rate for r in rates)
    flops = graph.total_flops
    makespan = max(flops * s / d.eff_flops for s, d in zip(shares, devices))
    # per-segment halo exchange: each device ships its boundary rows
    halo = sum(s.out_bytes * halo_fraction / max(len(devices), 1)
               for s in graph.segments[:-1])
    makespan += link.tx_time(halo) * 0.5
    energy = sum(compute_energy(flops * s, d) for s, d in zip(shares, devices))
    energy += link.tx_energy(halo) * len(devices) * 0.5
    single = min(devices, key=lambda d: compute_time(flops, d))
    worst = max(devices, key=lambda d: compute_time(flops, d))
    # CoEdge's baseline: non-adaptive equal split — the slowest device sets
    # the makespan and everyone else burns idle power waiting
    k = len(devices)
    eq_times = [compute_time(flops / k, d) for d in devices]
    eq_makespan = max(eq_times) + link.tx_time(halo) * 0.5
    eq_energy = sum(compute_energy(flops / k, d)
                    + (eq_makespan - t) * d.idle_w
                    for t, d in zip(eq_times, devices))
    return CoEdgePlan(shares, makespan, energy,
                      compute_time(flops, worst),
                      compute_energy(flops, worst),
                      eq_makespan, eq_energy)


# ---------------------------------------------------------------------------
# MoDNN — 1-D data partition of each layer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoDNNPlan:
    n_devices: int
    speedup: float
    data_delivery_bytes: float


def modnn_plan(graph: CostGraph, devices: Sequence[DeviceProfile],
               link: LinkProfile, halo_fraction: float = 0.05) -> MoDNNPlan:
    """Layer-wise 1-D partition: each device computes a slice of every layer,
    synchronizing only the HALO rows at partition boundaries (MoDNN's
    MapReduce-style partitioning exchanges overlap regions, not full maps)."""
    k = len(devices)
    base = compute_time(graph.total_flops, devices[0])
    per_dev = compute_time(graph.total_flops / k, devices[0])
    sync_bytes = sum(s.out_bytes * halo_fraction * (k - 1) / k
                     for s in graph.segments)
    t = per_dev + link.tx_time(sync_bytes / k)
    return MoDNNPlan(k, base / t, sync_bytes)
