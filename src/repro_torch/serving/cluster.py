"""Tiered serving cluster: one scheduler pool per cloud/edge/device tier,
fed by the paradigm-planner admission router.

The runtime form of the survey's collaborative-inference thesis, ported
from the reference package's ``serving/cluster.py`` for a single model:
the cluster owns a ``ContinuousBatchScheduler`` pool per tier whose slot
count is derived from the tier's ``DeviceProfile`` (compute share and
KV-arena memory), and an ``AdmissionRouter`` picks a tier per request from
prompt length, deadline and the current per-tier queue cost.

Execution vs. simulation: every pool runs the same real model on the one
local device, so outputs are exact, while tier heterogeneity lives in a
**virtual clock** per tier, priced from the planners' modelled profiles
(``core.cost_model.TABLE2`` / ``LINKS``):

* a pool decode step advances the tier clock by ``compute_time`` of the
  model's per-token FLOPs on that tier's profile, scaled by the measured
  depth fraction the segment pipeline dispatched (early exits truncate
  compute);
* prefill chunks advance it by the replayed prompt tokens' cost;
* a request becomes admissible after its uplink transfer
  (``LinkProfile.tx_time`` of the prompt bytes);
* completion stamps the tier clock plus the downlink result transfer and
  releases the unused tail of the admission-time slot booking.

The virtual clocks are the planners' model, not times of the card: the
reported latencies and utilizations are modelled, and only the wall time
around ``run()`` is measured.

**Cross-tier migration is real.**  A prefill/decode split prefills in the
prefill tier's pool; once the prefill lands the slot is lifted out with
``export_slot`` (rows truncated to the written prefix), crosses the
inter-tier link (int8 through the ``compress_rows`` kernel when
``core.offload.compression_decision`` says the link is slow enough, or
always with ``kv_handoff="int8"``) and is restored with ``import_slot`` in
the decode tier's pool.  The link is charged the snapshot's measured
payload bytes.  A ``Scenario.tier_outage`` kills a tier mid-trace: its
in-flight slots migrate to surviving tiers without re-running prefill,
queued and still-prefilling requests are re-routed and restart, and
``stats()`` reports the migration ledger and the resilience report.

``async_decode`` runs every tier pool's decode as windows of
``readback_interval`` steps (monolithic pools): tier clocks charge every
committed step, and a pool's windows in flight are drained
(``_sync_pool``) before a slot leaves it.

Not ported yet (``ValueError``): multi-model ``ModelGroup`` clusters and
the speculative device/cloud pair (``spec_draft``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.cost_model import (DeviceProfile, LinkProfile,
                                         compute_time)
from repro_torch.core.offload import compression_decision, measured_tx_time
from repro_torch.core.paradigms import (AdmissionDecision, Scenario,
                                        _tier_profile, analytic_step_cost)
from repro_torch.core.resilience import resilience_report
from repro_torch.models.model import Model
from repro_torch.serving.router import AdmissionRouter
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig, SlotSnapshot)

KV_HANDOFFS = ("auto", "raw", "int8")


@dataclasses.dataclass
class ClusterConfig:
    base_slots: int = 8                # cloud-tier pool size; others derived
    max_len: int = 256                 # per-slot capacity in every pool
    prefill_chunk: int = 16
    exit_threshold: float = 0.5
    # one prefill chunk per poll so admissions interleave with decode
    max_prefill_chunks_per_step: int = 1
    # cross-tier KV handoff: "auto" = int8 when compression_decision says
    # the link pays for it, "raw" = always bf16 rows (exact continuation),
    # "int8" = always quantize
    kv_handoff: str = "auto"
    # outage response: True migrates in-flight slots (no prefill re-run),
    # False requeues them from the prompt (the recompute baseline)
    migrate_on_outage: bool = True
    # paged KV arenas in every pool: migrations ship pages, skipping those
    # the destination's prefix tree already holds
    paged: bool = False
    page_size: int = 16
    spec_draft: str = ""               # not ported: rejected
    # decode windows in every tier pool (scheduler ``async_decode``):
    # tier clocks charge per committed step, migrations drain in-flight
    # windows first; forces monolithic pools
    async_decode: bool = False
    readback_interval: int = 8

    def __post_init__(self):
        if self.kv_handoff not in KV_HANDOFFS:
            raise ValueError(f"kv_handoff must be one of {KV_HANDOFFS}")
        if self.spec_draft:
            raise ValueError("repro_torch: the speculative device/cloud "
                             "pair (spec_draft) is not ported yet")


@dataclasses.dataclass
class ClusterRequest:
    """A routed request: the scheduler ``Request`` plus virtual-time and
    routing metadata."""
    req: Request
    arrival: float
    deadline: Optional[float]
    decision: AdmissionDecision
    ready_at: float                    # arrival + uplink (+ split handoff)
    t_done_v: float = math.nan         # tier clock + downlink at completion
    # admission-time slot booking, reconciled at completion; released0 is
    # the slot's cumulative released time at booking, so stacked bookings
    # never release the same slack twice
    booked_tier: str = ""
    booked_slot: int = -1
    booked_until: float = 0.0
    booked_released0: float = 0.0
    # split decisions also book their prefill tier's slot for the prompt
    # replay, released when the prefill lands
    pf_booked_tier: str = ""
    pf_booked_slot: int = -1
    pf_booked_until: float = 0.0
    pf_booked_released0: float = 0.0
    # migration ledger: final_tier is the tier whose pool completed the
    # request; handoff bytes are the exported snapshots' measured payloads
    final_tier: str = ""
    migrations: int = 0
    requeues: int = 0
    handoff_bytes: float = 0.0
    handoff_time: float = 0.0
    handoff_compressed: bool = False

    @property
    def done(self) -> bool:
        return not math.isnan(self.t_done_v)

    @property
    def latency(self) -> float:
        return self.t_done_v - self.arrival

    @property
    def met_deadline(self) -> bool:
        return self.deadline is None or self.latency <= self.deadline


def derive_tier_slots(profile: DeviceProfile, ref: DeviceProfile,
                      base_slots: int, kv_bytes_per_slot: float) -> int:
    """Slot count for a tier pool: the cloud reference gets ``base_slots``;
    weaker tiers scale down with effective compute, floored at one slot and
    capped by fitting the KV arena in half the tier's memory."""
    compute_cap = int(round(base_slots * profile.eff_flops / ref.eff_flops))
    mem_cap = int(0.5 * profile.mem_bytes // max(kv_bytes_per_slot, 1.0))
    return max(1, min(base_slots, max(1, compute_cap), max(1, mem_cap)))


@dataclasses.dataclass
class TierRuntime:
    """One tier's pool plus its virtual-time accounting."""
    name: str
    profile: DeviceProfile
    uplink: Optional[LinkProfile]      # client <-> tier path (None = local)
    sched: ContinuousBatchScheduler
    tok_cost: float                    # virtual seconds per token
    slots_total: int
    vclock: float = 0.0
    busy: float = 0.0                  # vclock share spent doing work
    decode_steps: int = 0
    slot_tokens: int = 0               # sum of active slots over decode steps
    routed: int = 0
    waiting: List[ClusterRequest] = dataclasses.field(default_factory=list)
    # rows of the admission currently prefilling: [(cluster req, prompt len)]
    prefill_rows: List[tuple] = dataclasses.field(default_factory=list)
    # admission-time estimate of when each slot frees up (virtual seconds),
    # the router's queue-cost signal, and the cumulative time released
    # per slot (monotone)
    slot_avail: List[float] = dataclasses.field(default_factory=list)
    slot_released: List[float] = dataclasses.field(default_factory=list)
    # migrated slots in flight TO this tier: (ready_at, snapshot, cluster
    # request, source tier name); the source prices a re-send if this tier
    # dies while the payload is in flight
    inbound: List["tuple[float, SlotSnapshot, ClusterRequest, str]"] = \
        dataclasses.field(default_factory=list)
    dead: bool = False                 # tier outage fired

    def book(self, ready: float, service: float):
        """Reserve the earliest slot for ``service`` virtual seconds from
        no earlier than ``ready``.  Returns ``(slot, until, released0)``."""
        sa = self.slot_avail
        i = min(range(len(sa)), key=sa.__getitem__)
        sa[i] = max(ready, sa[i]) + service
        return i, sa[i], self.slot_released[i]

    @property
    def utilization(self) -> float:
        # capped at 1: split prefills charge busy time without occupying
        # the decode pool's clock
        return min(1.0, self.busy / self.vclock) if self.vclock > 0 else 0.0

    @property
    def slot_occupancy(self) -> float:
        cap = self.slots_total * self.decode_steps
        return self.slot_tokens / cap if cap else 0.0


def _pctl(lats: List[float], q: float) -> float:
    """Percentile over completed-request latencies; ``nan`` when none have
    completed."""
    return float(np.percentile(np.asarray(lats), q)) if lats \
        else float("nan")


class TieredServingCluster:
    """Cloud/edge/device scheduler pools behind one admission router.

    ``model`` is the port's ``Model`` (one model; ``params`` its weights),
    run on the model's device by every pool.  ``plan_cfg`` (default: the
    model's own config) feeds the router's cost graphs and the per-tier
    virtual step costs; pass the full-size config when serving a smoke
    model so the tier economics stay realistic.
    """

    def __init__(self, model, params, scenario: Optional[Scenario] = None,
                 plan_cfg=None, cfg: Optional[ClusterConfig] = None):
        if not isinstance(model, Model):
            raise ValueError("repro_torch: multi-model (ModelGroup) clusters "
                             "are not ported yet; pass one Model")
        self.cfg = cfg = ClusterConfig() if cfg is None else cfg
        self.scenario = scenario or Scenario.default()
        self.model = model
        self.params = params
        self.plan_cfg = plan_cfg if plan_cfg is not None else model.cfg
        self.router = AdmissionRouter(self.plan_cfg, self.scenario)
        # per-token compute of the planned model at the pool's context size
        c = analytic_step_cost(self.plan_cfg, 1, cfg.max_len)
        self._tok_flops = c.flops_per_token
        kv_slot = c.kv_bytes_per_token * cfg.max_len

        sc = self.scenario
        scfg = SchedulerConfig(
            n_slots=cfg.base_slots, max_len=cfg.max_len,
            prefill_chunk=cfg.prefill_chunk,
            exit_threshold=cfg.exit_threshold,
            max_prefill_chunks_per_step=cfg.max_prefill_chunks_per_step,
            paged=cfg.paged, page_size=cfg.page_size,
            segmented=not cfg.async_decode, async_decode=cfg.async_decode,
            readback_interval=cfg.readback_interval)
        self.tiers: Dict[str, TierRuntime] = {}
        for name, uplink in (("device", None), ("edge", sc.dev_edge),
                             ("cloud", sc.dev_cloud)):
            prof = _tier_profile(sc, name)
            slots = derive_tier_slots(prof, sc.cloud, cfg.base_slots, kv_slot)
            sched = ContinuousBatchScheduler(
                model, params, dataclasses.replace(scfg, n_slots=slots),
                device=model.device)
            self.tiers[name] = TierRuntime(
                name, prof, uplink, sched,
                tok_cost=compute_time(self._tok_flops, prof),
                slots_total=slots, slot_avail=[0.0] * slots,
                slot_released=[0.0] * slots)
        self.requests: List[ClusterRequest] = []
        self._cr_of: Dict[int, ClusterRequest] = {}   # id(Request) -> wrapper
        self.dead: Set[str] = set()    # tiers lost to a Scenario outage
        # cluster-wide migration ledger (bytes are measured payload bytes)
        self.migration_stats: Dict[str, float] = {
            "split_handoffs": 0, "outage_migrations": 0, "requeued": 0,
            "compressed": 0, "bytes_moved": 0.0, "bytes_raw": 0.0,
            "transfer_s": 0.0}

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def queue_costs(self, arrival: float = 0.0) -> Dict[str, float]:
        """Estimated queueing delay per tier for a request arriving at
        ``arrival`` on the virtual clock: how long past its arrival the
        tier's earliest slot frees up."""
        return {name: max(0.0, min(tr.slot_avail) - arrival)
                for name, tr in self.tiers.items()}

    def virtual_now(self) -> float:
        """The cluster-wide virtual timestamp (latest tier clock)."""
        return max(tr.vclock for tr in self.tiers.values())

    def submit(self, tokens, *, max_new: int = 32,
               deadline: Optional[float] = None, arrival: float = 0.0,
               eos_id: Optional[int] = None) -> ClusterRequest:
        """Route one request and enqueue it at the chosen tier.
        ``arrival`` is the request's birth on the virtual clock."""
        toks = np.asarray(tokens).reshape(-1)
        if toks.size + max_new > self.cfg.max_len:
            raise ValueError(f"prompt {toks.size} + max_new {max_new} "
                             f"exceeds cluster max_len {self.cfg.max_len}")
        d = self.router.route(toks.size, max_new, deadline=deadline,
                              queue_cost=self.queue_costs(arrival),
                              exclude=self.dead or None)
        cr = ClusterRequest(Request(tokens=toks, max_new=max_new,
                                    eos_id=eos_id),
                            arrival, deadline, d, ready_at=arrival)
        self._place(cr, arrival)
        self.tiers[cr.decision.tier].routed += 1
        self.requests.append(cr)
        self._cr_of[id(cr.req)] = cr
        return cr

    def _place(self, cr: ClusterRequest, arrival: float):
        """Stage a routed request at its starting tier and book the decode
        slot.  A split starts in the prefill tier's pool and migrates to
        the decode tier once its prefill lands (``_poll_tier``)."""
        d = cr.decision
        tr = self.tiers[d.tier]
        prompt_bytes = float(cr.req.tokens.size * 4)
        home = self.tiers[d.prefill_tier] if d.is_split else tr
        up = home.uplink.tx_time(prompt_bytes) if home.uplink else 0.0
        cr.ready_at = arrival + up
        # an outage re-route arrives with live bookings: release them first
        if cr.booked_slot >= 0 and cr.booked_tier:
            self._reconcile_booking(self.tiers[cr.booked_tier], cr)
        self._release_pf_booking(cr)
        dec_ready = cr.ready_at
        if d.is_split:
            # the prefill slot is occupied while the prompt replays there;
            # the decode booking starts after prefill + the planned handoff
            est_pf = cr.req.tokens.size * home.tok_cost
            cr.pf_booked_tier = home.name
            (cr.pf_booked_slot, cr.pf_booked_until,
             cr.pf_booked_released0) = home.book(cr.ready_at, est_pf)
            dec_ready += est_pf + d.transfer_delay
        service = (cr.req.max_new if d.is_split
                   else cr.req.tokens.size + cr.req.max_new) * tr.tok_cost
        cr.booked_tier = tr.name
        cr.booked_slot, cr.booked_until, cr.booked_released0 = \
            tr.book(dec_ready, service)
        home.waiting.append(cr)

    # ------------------------------------------------------------------
    # pool stepping + virtual-time accounting
    # ------------------------------------------------------------------
    def _release_ready(self, tr: TierRuntime):
        """Move waiting requests whose transfers have landed into the pool
        queue, import inbound slots whose handoff has landed (when a slot
        is free), and fast-forward an idle tier's clock to the next
        arrival or handoff."""
        if not tr.waiting and not tr.inbound:
            return
        if not tr.sched.has_work:
            pend = [c.ready_at for c in tr.waiting] \
                + [t for t, _, _, _ in tr.inbound]
            tr.vclock = max(tr.vclock, min(pend))
        still_in = []
        for item in tr.inbound:
            ready, snap, _, _ = item
            if ready <= tr.vclock and tr.sched.free_slots():
                tr.sched.import_slot(snap)
            else:
                still_in.append(item)
        tr.inbound = still_in
        still = []
        for cr in tr.waiting:
            if cr.ready_at <= tr.vclock:
                tr.sched.submit(cr.req)
            else:
                still.append(cr)
        tr.waiting = still

    def _reconcile_booking(self, tr: TierRuntime, cr: ClusterRequest):
        """Release the unused tail of the admission-time slot booking (EOS
        or truncated depth can finish well before ``booked_until``)."""
        if cr.booked_slot < 0:
            return
        self._release_slot_booking(tr, cr.booked_slot, cr.booked_until,
                                   cr.booked_released0)
        cr.booked_slot = -1            # released exactly once

    @staticmethod
    def _release_slot_booking(tr: TierRuntime, i: int, until: float,
                              released0: float):
        """Return a booking's unused tail to ``slot_avail``, measured
        against the slot's released-time delta since booking."""
        sa, rel = tr.slot_avail, tr.slot_released
        overhang = (until - (rel[i] - released0)) - tr.vclock
        if overhang > 0.0:
            new = max(tr.vclock, sa[i] - overhang)
            rel[i] += sa[i] - new      # record what actually came back
            sa[i] = new

    def _release_pf_booking(self, cr: ClusterRequest):
        """Release a split request's prefill-tier booking (prefill done,
        completion or an outage re-route)."""
        if cr.pf_booked_slot < 0:
            return
        self._release_slot_booking(
            self.tiers[cr.pf_booked_tier], cr.pf_booked_slot,
            cr.pf_booked_until, cr.pf_booked_released0)
        cr.pf_booked_slot = -1

    def _stamp_done(self, tr: TierRuntime, r: Request):
        """A request completed in ``tr``'s pool: stamp the tier clock plus
        the downlink and release its bookings."""
        cr = self._cr_of[id(r)]
        down = (tr.uplink.tx_time(len(r.out_tokens) * 4.0)
                if tr.uplink else 0.0)
        cr.t_done_v = tr.vclock + down
        cr.final_tier = tr.name
        self._release_pf_booking(cr)   # EOS at admission on the pf tier
        self._reconcile_booking(self.tiers[cr.booked_tier or tr.name], cr)

    def _sync_pool(self, tr: TierRuntime):
        """Drain a tier pool's async decode windows before a slot leaves
        it (split handoff, outage drain): commit every window in flight,
        charge the tier clock for the drained steps (windows run full
        depth), and stamp the completions the drain surfaced; no later
        poll reports them.  No-op for sync pools."""
        if not tr.sched.cfg.async_decode:
            return
        steps0, toks0 = tr.sched._step_idx, tr.sched.tokens_served
        done = tr.sched.sync()
        steps = tr.sched._step_idx - steps0
        cost = tr.tok_cost * steps
        tr.vclock += cost
        tr.busy += cost
        tr.decode_steps += steps
        tr.slot_tokens += tr.sched.tokens_served - toks0
        for r in done:
            self._stamp_done(tr, r)

    def _poll_tier(self, tr: TierRuntime) -> bool:
        if tr.dead:
            return False
        self._release_ready(tr)
        if not tr.sched.has_work:
            return False
        rep = tr.sched.poll()
        went_live: List[ClusterRequest] = []
        if rep.admitted:
            tr.prefill_rows = [(self._cr_of[id(r)], r.tokens.size)
                               for r in rep.admitted]
        if rep.prefill_chunks:
            # replayed prompt tokens are charged to this tier (split
            # requests prefill here for real)
            chunk = self.cfg.prefill_chunk
            lo = rep.prefill_chunk_start * chunk
            hi = lo + rep.prefill_chunks * chunk
            cost = 0.0
            for _, plen in tr.prefill_rows:
                cost += min(max(plen - lo, 0), hi - lo) * tr.tok_cost
            tr.vclock += cost
            tr.busy += cost
        if rep.prefill_done:
            went_live = [cr for cr, _ in tr.prefill_rows]
            tr.prefill_rows = []
        if rep.decode_stepped:
            # the truncated step cost: the layer-weighted share of the stack
            # the segment pipeline dispatched, for every step committed
            # (an async readback commits a whole window)
            depth = rep.decode_depth_frac \
                if rep.decode_depth_frac > 0.0 else 1.0
            steps = rep.decode_steps or 1
            cost = tr.tok_cost * depth * steps
            tr.vclock += cost
            tr.busy += cost
            tr.decode_steps += steps
            tr.slot_tokens += rep.n_active * steps
        for r in rep.completed:
            self._stamp_done(tr, r)
        # splits whose prefill just landed leave for their decode tier (the
        # poll above ran this tier's decode step: a clean token boundary);
        # if the decode tier died meanwhile, fail over to a survivor,
        # possibly this tier, where the slot simply stays.  Async pools
        # drain their windows first: the export must see committed state
        if any(cr.decision.is_split and cr.decision.tier != tr.name
               and not cr.req.done for cr in went_live):
            self._sync_pool(tr)
        for cr in went_live:
            self._release_pf_booking(cr)   # prompt replay is over
            if (cr.decision.is_split and cr.decision.tier != tr.name
                    and not cr.req.done):
                dst = self.tiers[cr.decision.tier]
                if dst.dead:
                    dst = self._failover_tier(cr, tr.vclock)
                remaining = max(1, cr.req.max_new - len(cr.req.out_tokens))
                if dst is tr:
                    self._rebook(cr, tr, tr.vclock, remaining)
                    continue
                self._migrate_one(tr, dst, cr, count_key="split_handoffs")
                if dst.name != cr.booked_tier:
                    self._rebook(cr, dst, tr.vclock, remaining)
        return rep.worked

    # ------------------------------------------------------------------
    # cross-tier migration (real export -> link -> import)
    # ------------------------------------------------------------------
    def _kv_link(self, a: str, b: str) -> LinkProfile:
        """The link a slot snapshot crosses between two tiers."""
        sc = self.scenario
        return {frozenset(("device", "edge")): sc.dev_edge,
                frozenset(("edge", "cloud")): sc.edge_cloud,
                frozenset(("device", "cloud")): sc.dev_cloud}[
                    frozenset((a, b))]

    def _migrate_one(self, src: TierRuntime, dst: TierRuntime,
                     cr: ClusterRequest, *, count_key: str,
                     depart: Optional[float] = None):
        """Move one in-flight slot from ``src``'s pool to ``dst``'s: export
        the snapshot, choose raw or int8 for the link, charge the link the
        snapshot's measured payload bytes (plus the quantize compute on the
        source tier), and queue the import at ``dst``.

        ``depart`` is when the payload leaves ``src`` (default: its tier
        clock).  Outage drains pass the outage time: the dead tier's clock
        may lag the cluster's."""
        slot = cr.req.slot
        link = self._kv_link(src.name, dst.name)
        # decide from the layout-derived raw size before exporting, so the
        # slot is snapshotted exactly once
        raw_bytes = src.sched.slot_payload_bytes(slot)
        dec = compression_decision(raw_bytes, src.profile, link)
        use_int8 = self.cfg.kv_handoff == "int8" or (
            self.cfg.kv_handoff == "auto" and dec.compress)
        # page-granular handoff: pages the destination's prefix tree
        # already holds are skipped (borrowed back at import)
        snap = src.sched.export_slot(slot, compress=use_int8,
                                     skip_keys=dst.sched.prefix_keys())
        overhead = 0.0
        if use_int8:
            overhead = dec.quant_overhead
            src.busy += overhead       # the sender quantizes on its silicon
        src.sched.release_slot(slot)
        t_tx = measured_tx_time(snap.payload_bytes, link,
                                quant_overhead=overhead)
        t0 = src.vclock if depart is None else max(depart, src.vclock)
        dst.inbound.append((t0 + t_tx, snap, cr, src.name))
        cr.migrations += 1
        cr.handoff_bytes += snap.payload_bytes
        cr.handoff_time += t_tx
        cr.handoff_compressed = cr.handoff_compressed or use_int8
        ms = self.migration_stats
        ms[count_key] += 1
        ms["compressed"] += int(use_int8)
        ms["bytes_moved"] += snap.payload_bytes
        ms["bytes_raw"] += raw_bytes
        ms["transfer_s"] += t_tx

    # ------------------------------------------------------------------
    # tier outages: drain the dead tier (Scenario.outages)
    # ------------------------------------------------------------------
    def _check_outages(self):
        for o in self.scenario.outages:
            tr = self.tiers.get(o.tier)
            if tr is None or tr.dead:
                continue
            if self.virtual_now() >= o.at:
                self._drain_tier(tr)

    def _failover_tier(self, cr: ClusterRequest, now: float) -> TierRuntime:
        """Cheapest surviving tier for an in-flight request: queueing delay
        plus the remaining decode at that tier's rate."""
        remaining = max(1, cr.req.max_new - len(cr.req.out_tokens))
        alive = [t for t in self.tiers.values() if not t.dead]
        if not alive:
            raise RuntimeError("every tier is dead")
        return min(alive, key=lambda t: max(
            0.0, min(t.slot_avail) - now) + remaining * t.tok_cost)

    def _rebook(self, cr: ClusterRequest, dst: TierRuntime, ready: float,
                tokens: int):
        """Move a request's slot booking to ``dst``, first releasing any
        prior booking (one left on a surviving tier would never be
        reconciled)."""
        if cr.booked_slot >= 0 and cr.booked_tier:
            self._reconcile_booking(self.tiers[cr.booked_tier], cr)
        cr.booked_tier = dst.name
        cr.booked_slot, cr.booked_until, cr.booked_released0 = \
            dst.book(ready, tokens * dst.tok_cost)

    def _drain_tier(self, tr: TierRuntime):
        """Tier outage: mark ``tr`` dead and move every request off it.
        Active decode slots migrate (export -> handoff -> import) without
        re-running prefill, or with ``migrate_on_outage=False`` restart
        from the prompt.  Queued and still-prefilling requests are
        re-routed from scratch, and snapshots in flight toward the dead
        tier are redirected to a survivor."""
        tr.dead = True
        self.dead.add(tr.name)
        now = self.virtual_now()
        # the dying pool's windows in flight decoded before the outage:
        # commit them, so the exports below ship committed state
        self._sync_pool(tr)
        redo = list(tr.waiting)
        tr.waiting = []
        for r in tr.sched.drain_queue() + tr.sched.cancel_pending():
            redo.append(self._cr_of[id(r)])
        inbound, tr.inbound = tr.inbound, []
        for slot, r in tr.sched.active_requests():
            cr = self._cr_of[id(r)]
            dst = self._failover_tier(cr, now)
            if self.cfg.migrate_on_outage:
                # depart at the outage moment, as the requeue baseline does
                self._migrate_one(tr, dst, cr,
                                  count_key="outage_migrations", depart=now)
                self._rebook(cr, dst, now,
                             max(1, r.max_new - len(r.out_tokens)))
            else:
                tr.sched.release_slot(slot)
                r.out_tokens, r.slot, r.done = [], -1, False
                prompt_bytes = float(r.tokens.size * 4)
                cr.ready_at = now + (dst.uplink.tx_time(prompt_bytes)
                                     if dst.uplink else 0.0)
                cr.decision = dataclasses.replace(
                    cr.decision, tier=dst.name, prefill_tier=dst.name)
                dst.routed += 1
                cr.requeues += 1
                self.migration_stats["requeued"] += 1
                self._release_pf_booking(cr)
                self._rebook(cr, dst, cr.ready_at,
                             r.tokens.size + r.max_new)
                dst.waiting.append(cr)
        for _, snap, cr, src_name in inbound:
            # a handoff still in flight toward the dead tier: the source
            # re-sends it to a survivor and the new hop is charged
            dst = self._failover_tier(cr, now)
            if dst.name == src_name:
                arrive = now           # back home: the rows never left
            else:
                t_tx = measured_tx_time(snap.payload_bytes,
                                        self._kv_link(src_name, dst.name))
                arrive = now + t_tx
                cr.handoff_bytes += snap.payload_bytes
                cr.handoff_time += t_tx
                self.migration_stats["bytes_moved"] += snap.payload_bytes
                self.migration_stats["transfer_s"] += t_tx
            dst.inbound.append((arrive, snap, cr, src_name))
            self._rebook(cr, dst, arrive,
                         max(1, cr.req.max_new - len(cr.req.out_tokens)))
        for cr in redo:
            # never admitted here: re-route among the survivors and start
            # over (no prefill has completed)
            d = self.router.route(
                cr.req.tokens.size, cr.req.max_new, deadline=cr.deadline,
                queue_cost=self.queue_costs(now), exclude=self.dead)
            cr.decision = d
            cr.requeues += 1
            self.migration_stats["requeued"] += 1
            self.tiers[d.tier].routed += 1
            self._place(cr, now)

    def poll(self) -> bool:
        """One round over all tier pools (scheduled outages fire first).
        Returns whether any worked."""
        self._check_outages()
        worked = False
        for tr in self.tiers.values():
            worked = self._poll_tier(tr) or worked
        return worked

    @property
    def has_work(self) -> bool:
        return any(tr.waiting or tr.inbound or tr.sched.has_work
                   for tr in self.tiers.values() if not tr.dead)

    def run(self):
        """Drain every pool (all submitted requests complete)."""
        while self.has_work:
            if not self.poll():        # pragma: no cover - defensive
                break
        for tr in self.tiers.values():
            tr.sched.flush_counters()

    def clear_completed(self):
        """Drop completed requests from the cluster's retention (the pools'
        completed lists and the router's decision log included).  Router
        counts and tier clocks survive; ``stats()`` afterwards covers only
        still-tracked requests."""
        done = [cr for cr in self.requests if cr.done]
        for cr in done:
            self._cr_of.pop(id(cr.req), None)
        self.requests = [cr for cr in self.requests if not cr.done]
        self.router.decisions.clear()
        for tr in self.tiers.values():
            tr.sched.completed.clear()

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Route counts, migration ledger and per-tier accounting.  Every
        latency and utilization here is on the virtual clocks (modelled by
        the planners' tier profiles); ``host_ms``/``device_ms`` are the
        pools' measured wall-time split.  ``stage_calls`` counts each
        pool's segment, probe and finalize dispatches; ``jit_cache_sizes``
        each pool's decode-window builds (async pools)."""
        done = [cr for cr in self.requests if cr.done]
        lats = [cr.latency for cr in done]
        per_tier = {}
        for name, tr in self.tiers.items():
            tl = [cr.latency for cr in done
                  if (cr.final_tier or cr.decision.tier) == name]
            per_tier[name] = {
                "routed": tr.routed,
                "dead": tr.dead,
                "n_slots": tr.slots_total,
                "vclock_s": tr.vclock,
                "utilization": tr.utilization,
                "slot_occupancy": tr.slot_occupancy,
                "tokens": tr.sched.tokens_served,
                "measured_depth": tr.sched.measured_depth_fraction(),
                "p50_latency_s": _pctl(tl, 50),
                "p95_latency_s": _pctl(tl, 95),
                "host_ms": tr.sched.host_ms_total,
                "device_ms": tr.sched.device_ms_total,
                "peak_tokens_in_flight": tr.sched.peak_tokens_in_flight,
                "stage_calls": dict(tr.sched.stage_calls),
            }
        out: Dict[str, object] = {
            "requests": len(self.requests),
            "completed": len(done),
            "splits": self.router.split_count,
            "route_counts": dict(self.router.route_counts),
            "p50_latency_s": _pctl(lats, 50),
            "p95_latency_s": _pctl(lats, 95),
            "deadline_hit_rate": (sum(cr.met_deadline for cr in done)
                                  / len(done) if done else 1.0),
            "migration": dict(self.migration_stats),
            "tiers": per_tier,
            "jit_cache_sizes": {n: tr.sched.jit_cache_sizes()
                                for n, tr in self.tiers.items()},
        }
        if self.dead or self.scenario.outages:
            # survey §5 resilience accounting: expected accuracy with the
            # drain vs a pipeline that collapses with any dead tier
            rr = resilience_report(len(self.tiers),
                                   len(self.dead) / len(self.tiers))
            out["dead_tiers"] = sorted(self.dead)
            out["resilience"] = {
                "survive_prob": rr.survive_prob,
                "expected_accuracy_with_skip":
                    rr.expected_accuracy_with_skip,
                "expected_accuracy_without_skip":
                    rr.expected_accuracy_without_skip,
                "gain": rr.gain,
            }
        return out
