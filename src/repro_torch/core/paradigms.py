"""The four collaborative DNN inference paradigms (survey §2.3, Fig. 2).

Each paradigm binds the survey's key technologies (partition, early exit,
hierarchy, compression, resilience) into one `CollaborationPlan` for a given
workload + hardware scenario:

  1. cloud-device     — Neurosurgeon/DADS split over a WAN link; objective
                        emphasis: total latency (survey §3).
  2. edge-device      — Edgent joint exit+partition over WiFi; objective:
                        accuracy under a deadline (survey §4).
  3. cloud-edge-device — DDNN 3-tier placement with per-tier exits;
                        objective: total cost + resilience (survey §5).
  4. device-device    — CoEdge/MoDNN data partition across a local cluster;
                        objective: latency + energy (survey §6).

These are the host-side planners, a verbatim copy of the reference
package's ``core/paradigms.py``; the serving router
(``serving/router.py``) calls ``admission_decision`` per request.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import (TABLE2, LINKS, CostGraph, DeviceProfile,
                                   LinkProfile, build_cost_graph,
                                   compute_energy, compute_time,
                                   kv_cache_bytes_per_token)
from repro_torch.core.early_exit import (EdgentPlan, ExitProfile, SpinnEstimate,
                                   edgent_plan, spinn_estimate)
from repro_torch.core.hierarchy import DDNNPlacement, Tier, ddnn_placement
from repro_torch.core.offload import CompressionDecision, compression_decision
from repro_torch.core.partition import (CoEdgePlan, DadsPlan, SplitPlan,
                                  coedge_plan, dads_plan, modnn_plan,
                                  neurosurgeon_plan)
from repro_torch.core.resilience import ResilienceReport, resilience_report


@dataclass(frozen=True)
class AnalyticStepCost:
    """The per-token analytic cost of one (model, batch, context) workload —
    the numbers every admission/routing price in this module is built from,
    exposed as one introspectable record so the static cost cross-check
    (``repro.analysis.costcheck``) can hold them against what the compiled
    serving stages actually compute."""
    model: str
    batch: int
    seq_len: int
    flops_per_token: float         # forward FLOPs amortized per token
    param_bytes: float             # resident weight bytes (whole model)
    act_bytes_per_token: float     # boundary activation a partition ships
    kv_bytes_per_token: float      # KV-cache growth per decoded token


def analytic_step_cost(cfg, batch: int, seq_len: int) -> AnalyticStepCost:
    """Analytic per-token step cost for ``cfg`` at the given workload —
    the single source the cluster's ``_tok_flops``/KV budgets and the
    router's pricing derive from (both go through ``build_cost_graph``,
    so auditing this function audits them)."""
    g = build_cost_graph(cfg, batch, seq_len)
    tokens = float(batch * seq_len)
    return AnalyticStepCost(
        model=cfg.name, batch=batch, seq_len=seq_len,
        flops_per_token=g.total_flops / tokens,
        param_bytes=sum(s.param_bytes for s in g.segments),
        act_bytes_per_token=(g.segments[0].out_bytes / tokens
                             if g.segments else 0.0),
        kv_bytes_per_token=kv_cache_bytes_per_token(cfg))


@dataclass(frozen=True)
class TierOutage:
    """A scheduled tier failure: ``tier`` goes dark once the serving
    cluster's virtual clock reaches ``at`` seconds.  The runtime response
    (deepFogGuard-style graceful degradation, survey §5) is a drain: the
    dead tier's in-flight slots are exported and re-imported elsewhere."""
    tier: str
    at: float


@dataclass(frozen=True)
class Scenario:
    """A hardware scenario the paradigms plan against."""
    device: DeviceProfile
    edge: DeviceProfile
    cloud: DeviceProfile
    dev_edge: LinkProfile
    dev_cloud: LinkProfile
    edge_cloud: LinkProfile
    d2d: LinkProfile
    peers: Tuple[DeviceProfile, ...] = ()
    # scheduled tier failures the serving cluster reacts to mid-trace
    outages: Tuple[TierOutage, ...] = ()

    @staticmethod
    def default() -> "Scenario":
        return Scenario(
            device=TABLE2["jetson-tx2"],
            edge=TABLE2["jetson-agx-xavier"],
            cloud=TABLE2["v100"],
            dev_edge=LINKS["wifi"],
            dev_cloud=LINKS["wan"],
            edge_cloud=LINKS["lan"],
            d2d=LINKS["d2d"],
            peers=(TABLE2["jetson-tx2"], TABLE2["jetson-nano"],
                   TABLE2["raspberry-pi-4b"], TABLE2["jetson-tx2"]),
        )

    @staticmethod
    def neurosurgeon_era() -> "Scenario":
        """Hardware matching the cloud-device papers' testbeds (Jetson-TK1
        class device, V100-class cloud, WiFi uplink) — used to validate the
        survey's Table-3 effectiveness bands."""
        sc = Scenario.default()
        return dataclasses.replace(sc, device=TABLE2["jetson-tk1"],
                                   dev_cloud=LINKS["wifi"])

    @staticmethod
    def degraded_wan() -> "Scenario":
        """Default hardware behind a congested WAN (1 Mbps, 500 ms RTT) —
        the survey's motivating failure mode for cloud-only inference (§1):
        admission routing must shift traffic off the cloud tier."""
        sc = Scenario.default()
        return dataclasses.replace(
            sc, dev_cloud=LinkProfile("wan-degraded", 1 * 1e6 / 8, 0.5))

    @staticmethod
    def high_rtt_access(rtt: float = 0.25) -> "Scenario":
        """Default hardware, but the CLIENT's access link is high-latency
        in both directions (satellite / congested last mile): every path
        out of the device pays ``rtt`` seconds per round trip, while the
        edge<->cloud backbone stays fast.  This is the regime cross-tier
        speculative decoding targets — interactive decode on any remote
        tier is RTT-bound, so shipping k draft tokens per round trip beats
        streaming one token per round trip."""
        sc = Scenario.default()
        return dataclasses.replace(
            sc,
            dev_edge=LinkProfile("access-rtt-edge",
                                 sc.dev_edge.bandwidth, rtt),
            dev_cloud=LinkProfile("access-rtt-wan",
                                  sc.dev_cloud.bandwidth, rtt))

    @staticmethod
    def tier_outage(tier: str = "edge", at: float = 0.05) -> "Scenario":
        """Default hardware, but ``tier`` dies once the serving cluster's
        virtual clock reaches ``at`` seconds (mid-trace for the smoke
        workloads) — the survey's resilience scenario (§5, deepFogGuard/
        ResiliNet): in-flight requests on the dead tier must be drained to
        the surviving tiers without recomputing their prefill."""
        sc = Scenario.default()
        return dataclasses.replace(sc, outages=(TierOutage(tier, at),))


@dataclass
class CollaborationPlan:
    paradigm: str
    latency: float
    energy: float
    accuracy: float
    comm_bytes: float
    details: Dict[str, object] = field(default_factory=dict)

    # baselines for the survey's effectiveness comparisons
    cloud_only_latency: float = 0.0
    device_only_latency: float = 0.0
    cloud_only_energy: float = 0.0
    device_only_energy: float = 0.0

    @property
    def latency_reduction(self) -> float:
        return self.cloud_only_latency / max(self.latency, 1e-12)

    @property
    def energy_reduction(self) -> float:
        return 1.0 - self.energy / max(self.cloud_only_energy, 1e-12)


def _baselines(graph: CostGraph, sc: Scenario, link: LinkProfile):
    """(cloud-only latency/energy, device-only latency/energy)."""
    f = graph.total_flops
    cl = (link.tx_time(graph.input_bytes) + compute_time(f, sc.cloud)
          + link.tx_time(graph.result_bytes))
    ce = link.tx_energy(graph.input_bytes)
    dl = compute_time(f, sc.device)
    de = compute_energy(f, sc.device)
    return cl, ce, dl, de


# ---------------------------------------------------------------------------
# Paradigm planners
# ---------------------------------------------------------------------------

def plan_cloud_device(graph: CostGraph, sc: Scenario,
                      objective: str = "latency") -> CollaborationPlan:
    ns = neurosurgeon_plan(graph, sc.device, sc.cloud, sc.dev_cloud, objective)
    dd = dads_plan(graph, sc.device, sc.cloud, sc.dev_cloud, "light")
    comp = compression_decision(
        graph.segments[max(ns.cut - 1, 0)].out_bytes, sc.device, sc.dev_cloud)
    lat = ns.latency
    if comp.compress and 0 < ns.cut < len(graph.segments):
        lat = lat - comp.tx_time_raw + comp.tx_time_compressed
    cl, ce, dl, de = _baselines(graph, sc, sc.dev_cloud)
    return CollaborationPlan(
        "cloud-device", lat, ns.device_energy, 0.92,
        graph.segments[max(ns.cut - 1, 0)].out_bytes if ns.cut else graph.input_bytes,
        {"neurosurgeon": ns, "dads": dd, "compression": comp},
        cl, dl, ce, de)


def plan_edge_device(graph: CostGraph, sc: Scenario, deadline: float,
                     threshold: float = 0.5) -> CollaborationPlan:
    prof = ExitProfile.default(
        len(graph.segments),
        [i for i, s in enumerate(graph.segments) if s.has_exit_after],
        threshold=threshold)
    eg = edgent_plan(graph, prof, sc.device, sc.edge, sc.dev_edge, deadline)
    sp = spinn_estimate(graph, prof, eg.cut, sc.device, sc.edge, sc.dev_edge)
    cl, ce, dl, de = _baselines(graph, sc, sc.dev_edge)
    return CollaborationPlan(
        "edge-device", sp.expected_latency, sp.expected_device_energy,
        sp.expected_accuracy, sp.expected_tx_bytes,
        {"edgent": eg, "spinn": sp, "profile": prof},
        cl, dl, ce, de)


def plan_cloud_edge_device(graph: CostGraph, sc: Scenario,
                           stage_fail_prob: float = 0.05) -> CollaborationPlan:
    tiers = (Tier("device", sc.device, sc.dev_edge),
             Tier("edge", sc.edge, sc.edge_cloud),
             Tier("cloud", sc.cloud, None))
    prof = ExitProfile.default(
        len(graph.segments),
        [i for i, s in enumerate(graph.segments) if s.has_exit_after])
    dd = ddnn_placement(graph, tiers, prof.exit_probs)
    res = resilience_report(3, stage_fail_prob)
    cl, ce, dl, de = _baselines(graph, sc, sc.dev_cloud)
    energy = compute_energy(
        sum(s.flops for i, s in enumerate(graph.segments)
            if dd.tier_of_segment[i] == "device"), sc.device)
    return CollaborationPlan(
        "cloud-edge-device", dd.latency, energy, prof.expected_accuracy(),
        dd.comm_bytes, {"ddnn": dd, "resilience": res},
        cl, dl, ce, de)


def plan_device_device(graph: CostGraph, sc: Scenario) -> CollaborationPlan:
    peers = sc.peers or (sc.device,) * 4
    ce_plan = coedge_plan(graph, peers, sc.d2d)
    mo = modnn_plan(graph, peers, sc.d2d)
    cl, cel, dl, de = _baselines(graph, sc, sc.dev_cloud)
    return CollaborationPlan(
        "device-device", ce_plan.makespan, ce_plan.energy, 0.92,
        mo.data_delivery_bytes, {"coedge": ce_plan, "modnn": mo},
        cl, dl, cel, de)


def plan_all(graph: CostGraph, sc: Optional[Scenario] = None,
             deadline: float = 0.1) -> Dict[str, CollaborationPlan]:
    sc = sc or Scenario.default()
    return {
        "cloud-device": plan_cloud_device(graph, sc),
        "edge-device": plan_edge_device(graph, sc, deadline),
        "cloud-edge-device": plan_cloud_edge_device(graph, sc),
        "device-device": plan_device_device(graph, sc),
    }


# ---------------------------------------------------------------------------
# Admission-time tier selection (serving runtime entry point)
# ---------------------------------------------------------------------------

TIERS = ("device", "edge", "cloud")


@dataclass(frozen=True)
class AdmissionDecision:
    """Per-request tier choice the serving router acts on.

    ``tier`` owns the decode slot; ``prefill_tier`` differs only for a
    prefill/decode split, where ``transfer_delay`` is the simulated KV-cache
    handoff between the two tiers."""
    tier: str                          # decode tier: device | edge | cloud
    prefill_tier: str                  # == tier unless split
    paradigm: str                      # planner behind the winning candidate
    predicted_latency: float           # planner latency, queue excluded
    effective_latency: float           # + queueing penalty at the decode tier
    transfer_delay: float = 0.0        # prefill->decode handoff (split only)
    feasible: bool = True              # meets the deadline (if one was given)
    details: Dict[str, object] = field(default_factory=dict)

    @property
    def is_split(self) -> bool:
        return self.prefill_tier != self.tier


def _tier_profile(sc: Scenario, tier: str) -> DeviceProfile:
    return {"device": sc.device, "edge": sc.edge, "cloud": sc.cloud}[tier]


def admission_decision(graph: CostGraph, sc: Scenario, *,
                       deadline: Optional[float] = None,
                       queue_cost: Optional[Dict[str, float]] = None,
                       prefill_tokens: Optional[int] = None,
                       decode_tokens: int = 0,
                       kv_bytes_per_token: float = 0.0,
                       allow_split: bool = True,
                       exclude: Optional[frozenset] = None,
                       stream_tokens: bool = False,
                       spec_k: int = 0,
                       spec_accept: float = 0.0,
                       spec_draft_frac: float = 0.1
                       ) -> AdmissionDecision:
    """Pick the serving tier for ONE request at admission time.

    Candidates come from the paradigm planners over ``graph`` (the request's
    whole prompt+decode workload): Neurosurgeon's optimal cloud-device split,
    Edgent's deadline-driven edge-device plan, DDNN's 3-tier placement, plus
    device-local execution and (optionally) prefill/decode disaggregation
    splits — prefill on a compute-rich tier, KV cache shipped over the
    inter-tier link, decode on a cheaper tier.  ``queue_cost[tier]`` is the
    router's estimate of queueing delay at each tier's slot pool and is
    charged to the candidate's decode tier, so a congested pool sheds load.
    ``exclude`` drops every candidate touching a named tier (prefill or
    decode side) — dead tiers after an outage must not win placement.

    ``stream_tokens`` opts into interactive-decode pricing: a remote decode
    tier pays one downlink round trip PER TOKEN (each sampled token streams
    back to the device-side client as it lands), which is the regime where
    cloud decode becomes latency-bound on WAN-heavy links.  Under it, a
    ``spec_k >= 2`` enables the **speculative** candidate: a draft model on
    the device tier proposes k-token windows, the cloud tier verifies each
    window in one batched dispatch, and the link carries one uplink of k
    token ids + one downlink of the accept length per ROUND instead of one
    RTT per token — rounds shrink by the expected acceptance length
    ``spec_accept`` (measured by the serving cluster; defaults to the
    midpoint (k+1)/2).  ``spec_draft_frac`` prices the draft model's
    per-token compute as a fraction of the target's.
    """
    qc = queue_cost or {}
    dead = exclude or frozenset()
    dl = float("inf") if deadline is None else deadline
    cands: List[AdmissionDecision] = []
    tok_bytes = 4.0                    # one int32 token id on the wire

    def add(tier, paradigm, lat, *, prefill_tier=None, transfer=0.0, **det):
        if tier in dead or (prefill_tier or tier) in dead:
            return
        if (stream_tokens and decode_tokens > 0 and tier != "device"
                and paradigm != "speculative"):
            # interactive decode on a remote tier: every sampled token pays
            # the downlink back to the device-side client
            link = sc.dev_cloud if tier == "cloud" else sc.dev_edge
            lat = lat + decode_tokens * link.tx_time(tok_bytes)
        eff = lat + qc.get(tier, 0.0)
        cands.append(AdmissionDecision(
            tier, prefill_tier or tier, paradigm, lat, eff,
            transfer_delay=transfer, feasible=eff <= dl, details=det))

    # device-local: no link at all (the request is born on the device tier)
    add("device", "device-local",
        compute_time(graph.total_flops, sc.device))

    # cloud-device (Neurosurgeon): cut==N means fully local, which the
    # device-local candidate already covers; cut>0 splits device+cloud
    ns = neurosurgeon_plan(graph, sc.device, sc.cloud, sc.dev_cloud)
    if ns.cut < len(graph.segments):
        add("cloud", "cloud-device/neurosurgeon", ns.latency, neurosurgeon=ns)

    # edge-device (Edgent): joint exit+partition under the deadline
    prof = ExitProfile.default(
        len(graph.segments),
        [i for i, s in enumerate(graph.segments) if s.has_exit_after])
    eg = edgent_plan(graph, prof, sc.device, sc.edge, sc.dev_edge, dl)
    m = (list(prof.boundaries) + [len(graph.segments) - 1])[eg.exit_index] + 1
    add("device" if eg.cut >= m else "edge", "edge-device/edgent",
        eg.latency, edgent=eg)

    # cloud-edge-device (DDNN): the decode slot lives where the final
    # segments are placed
    tiers3 = (Tier("device", sc.device, sc.dev_edge),
              Tier("edge", sc.edge, sc.edge_cloud),
              Tier("cloud", sc.cloud, None))
    dd = ddnn_placement(graph, tiers3, prof.exit_probs)
    add(dd.tier_of_segment[-1], "cloud-edge-device/ddnn", dd.latency, ddnn=dd)

    # prefill/decode disaggregation: prefill on the compute-rich tier, ship
    # the KV cache down one link, decode near the client
    if (allow_split and kv_bytes_per_token > 0.0 and prefill_tokens
            and decode_tokens > 0):
        total_tok = prefill_tokens + decode_tokens
        pf_flops = graph.total_flops * prefill_tokens / total_tok
        tok_flops = graph.total_flops / total_tok
        kv_bytes = kv_bytes_per_token * prefill_tokens
        for pf_tier, dec_tier, up, kv_link, down in (
                ("cloud", "edge", sc.dev_cloud, sc.edge_cloud, sc.dev_edge),
                ("edge", "device", sc.dev_edge, sc.dev_edge, None)):
            transfer = kv_link.tx_time(kv_bytes)
            lat = (up.tx_time(graph.input_bytes)
                   + compute_time(pf_flops, _tier_profile(sc, pf_tier))
                   + transfer
                   + decode_tokens * compute_time(
                       tok_flops, _tier_profile(sc, dec_tier))
                   + (down.tx_time(graph.result_bytes) if down else 0.0))
            add(dec_tier, f"split/{pf_tier}-prefill",
                lat, prefill_tier=pf_tier, transfer=transfer,
                kv_bytes=kv_bytes)

    # cross-tier speculative decoding: a draft model on the DEVICE tier
    # proposes spec_k tokens per round, the cloud tier verifies the window
    # in one batched dispatch.  The WAN carries k token ids up and the
    # accept length + one corrected token down once per ROUND, so the link
    # cost shrinks by the acceptance length relative to streaming one RTT
    # per token.  The candidate straddles device+cloud: either tier being
    # dead kills it (the draft runs outside the `add` tier bookkeeping, so
    # the device check is explicit here).
    if (stream_tokens and spec_k >= 2 and decode_tokens > 0
            and prefill_tokens and "device" not in dead):
        total_tok = prefill_tokens + decode_tokens
        tok_flops = graph.total_flops / total_tok
        pf_flops = graph.total_flops * prefill_tokens / total_tok
        accept = spec_accept if spec_accept > 0.0 else (spec_k + 1) / 2.0
        accept = min(float(accept), float(spec_k))
        rounds = int(-(-decode_tokens // accept))
        draft_tok = spec_draft_frac * compute_time(tok_flops, sc.device)
        # the verify is ONE fixed-shape batched dispatch over k positions:
        # decode on serving batch sizes is memory-bandwidth-bound, so the
        # extra positions ride the same weight pass — charge one step, not
        # k sequential steps (the standard speculative-decoding economics)
        verify = compute_time(tok_flops, sc.cloud)
        per_round = (spec_k * draft_tok
                     + sc.dev_cloud.tx_time(tok_bytes * spec_k)
                     + verify
                     + sc.dev_cloud.tx_time(tok_bytes * 2.0))
        lat = (sc.dev_cloud.tx_time(graph.input_bytes)
               + max(compute_time(pf_flops, sc.cloud),
                     spec_draft_frac * compute_time(pf_flops, sc.device))
               + rounds * per_round)
        add("cloud", "speculative", lat,
            spec_k=spec_k, accept_est=accept, rounds=rounds,
            per_round=per_round)

    assert cands, f"no admissible tier (excluded: {sorted(dead)})"
    feas = [c for c in cands if c.feasible]
    pool = feas or cands
    return min(pool, key=lambda c: c.effective_latency)
