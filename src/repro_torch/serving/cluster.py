"""Tiered serving cluster: one scheduler pool per cloud/edge/device tier,
fed by the paradigm-planner admission router.

The runtime form of the survey's collaborative-inference thesis, ported
from the reference package's ``serving/cluster.py``: the cluster owns a
scheduler pool per tier whose slot count is derived from the tier's
``DeviceProfile`` (compute share and KV-arena memory), and an
``AdmissionRouter`` picks a tier per request from prompt length, deadline
and the current per-tier queue cost.

**Multi-model tiers**: built over a ``ModelGroup``, each tier's pool is a
``MultiModelScheduler`` with one arena per named model, each with its own
slot count (from that model's KV size) and its own virtual per-token cost
(from that model's plan config).  Routing is per (model, request): a heavy
model's request can land on the cloud pool while a light model's stays on
the device within one trace.  A plain ``Model`` keeps one arena per tier,
keyed ``""``.

Execution vs. simulation: every pool runs the same real model on the one
local device, so outputs are exact, while tier heterogeneity lives in a
**virtual clock** per tier, priced from the planners' modelled profiles
(``core.cost_model.TABLE2`` / ``LINKS``):

* a pool decode step advances the tier clock by ``compute_time`` of each
  stepped model's per-token FLOPs on that tier's profile, scaled by the
  measured depth fraction its segment pipeline dispatched (early exits
  truncate compute);
* prefill chunks advance it by the replayed prompt tokens' cost at the
  prefilling model's rate;
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

**Cross-tier speculative decoding** (``spec_draft``, group clusters): the
router also prices a speculative candidate, a draft model on the device
tier proposing ``spec_k`` tokens a round and the target verifying them on
the cloud tier, one uplink of k token ids and one downlink of the accepted
count a round instead of a round trip a token.  Requests routed
speculative run through a ``SpecPair`` bridge (``_poll_spec``) whose
measured acceptance feeds back into ``router.spec_accept``; an outage of
either end drains the bridge (``_drain_spec``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Union

import numpy as np

from repro_torch.core.cost_model import (DeviceProfile, LinkProfile,
                                         compute_time,
                                         kv_cache_bytes_per_token)
from repro_torch.core.offload import compression_decision, measured_tx_time
from repro_torch.core.paradigms import (AdmissionDecision, Scenario,
                                        _tier_profile, analytic_step_cost)
from repro_torch.core.resilience import resilience_report
from repro_torch.models.model import Model
from repro_torch.serving.multipool import (ModelGroup, MultiModelScheduler,
                                           SpecPair)
from repro_torch.serving.router import AdmissionRouter
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig, SlotSnapshot,
                                           StageSpec)

KV_HANDOFFS = ("auto", "raw", "int8")


@dataclasses.dataclass
class ClusterConfig:
    base_slots: int = 8                # cloud-tier pool size; others derived
    max_len: int = 256                 # per-slot capacity in every pool
    prefill_chunk: int = 16
    exit_threshold: float = 0.5
    temperature: float = 0.0          # 0 = greedy; rejected with spec_draft
    long_mode: bool = False
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
    # cross-tier speculative decoding (group clusters): ``spec_draft`` names
    # the entry that drafts on the device tier while the target verifies
    # on the cloud tier ("" = off).  ``stream_tokens`` makes the router
    # price each token's downlink, where the speculative candidate can
    # win; spec_draft implies it.  ``spec_k`` is the draft window a round;
    # ``spec_draft_frac`` prices the draft's compute for admission when it
    # has no plan config
    spec_draft: str = ""
    spec_k: int = 4
    stream_tokens: bool = False
    spec_draft_frac: float = 0.1
    # decode windows in every tier pool (scheduler ``async_decode``):
    # tier clocks charge per committed step, migrations drain in-flight
    # windows first; forces monolithic pools
    async_decode: bool = False
    readback_interval: int = 8

    def __post_init__(self):
        if self.kv_handoff not in KV_HANDOFFS:
            raise ValueError(f"kv_handoff must be one of {KV_HANDOFFS}")


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
    # admission-time slot booking of the model's arena, reconciled at
    # completion; released0 is the slot's cumulative released time at
    # booking, so stacked bookings never release the same slack twice
    booked_model: str = ""
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
    """One tier's pool plus its virtual-time accounting.  Per-model state
    is keyed by model name ("" in a single-model cluster)."""
    name: str
    profile: DeviceProfile
    uplink: Optional[LinkProfile]      # client <-> tier path (None = local)
    sched: Union[ContinuousBatchScheduler, MultiModelScheduler]
    tok_cost: Dict[str, float]         # virtual seconds per token, per model
    slots_total: int                   # summed over the models' arenas
    vclock: float = 0.0
    busy: float = 0.0                  # vclock share spent doing work
    decode_steps: int = 0
    slot_tokens: int = 0               # sum of active slots over decode steps
    routed: int = 0
    waiting: List[ClusterRequest] = dataclasses.field(default_factory=list)
    # rows of each model's admission currently prefilling:
    # model -> [(cluster req, prompt len)]
    prefill_rows: Dict[str, List[tuple]] = dataclasses.field(
        default_factory=dict)
    # per model: admission-time estimate of when each slot frees up
    # (virtual seconds), the router's queue-cost signal, and the
    # cumulative time released per slot (monotone)
    slot_avail: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    slot_released: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    # migrated slots in flight TO this tier: (ready_at, snapshot, cluster
    # request, source tier name); the source prices a re-send if this tier
    # dies while the payload is in flight
    inbound: List["tuple[float, SlotSnapshot, ClusterRequest, str]"] = \
        dataclasses.field(default_factory=list)
    dead: bool = False                 # tier outage fired

    def book(self, model: str, ready: float, service: float):
        """Reserve the earliest slot of ``model``'s arena for ``service``
        virtual seconds from no earlier than ``ready``.  Returns
        ``(slot, until, released0)``."""
        sa = self.slot_avail[model]
        i = min(range(len(sa)), key=sa.__getitem__)
        sa[i] = max(ready, sa[i]) + service
        return i, sa[i], self.slot_released[model][i]

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

    ``model`` is the port's ``Model`` (one model; ``params`` its weights)
    or a ``ModelGroup`` (each tier pool multiplexes one arena per entry;
    ``params`` is ignored).  Every pool runs on its model's device.
    ``plan_cfg`` (default: each model's own config) feeds the router's
    cost graphs and the per-tier virtual step costs: pass the full-size
    config, or a ``{name: config}`` dict for a group, when serving smoke
    models so the tier economics stay realistic.
    """

    def __init__(self, model, params=None, scenario: Optional[Scenario] = None,
                 plan_cfg=None, cfg: Optional[ClusterConfig] = None):
        self.cfg = cfg = ClusterConfig() if cfg is None else cfg
        self.scenario = scenario or Scenario.default()
        if isinstance(model, ModelGroup):
            self.group: Optional[ModelGroup] = model
            self.model = model[model.default].model
            self.params = model[model.default].params
            if plan_cfg is None:
                plan_cfgs = {e.name: e.model.cfg for e in model}
            elif isinstance(plan_cfg, dict):
                plan_cfgs = {e.name: plan_cfg.get(e.name, e.model.cfg)
                             for e in model}
            else:                      # one plan config for every entry
                plan_cfgs = {e.name: plan_cfg for e in model}
            self._model_names = model.names
            router_cfg = plan_cfgs
        elif isinstance(model, Model):
            self.group = None
            self.model = model
            self.params = params
            plan_cfgs = {"": plan_cfg if plan_cfg is not None else model.cfg}
            self._model_names = [""]
            router_cfg = plan_cfgs[""]
        else:
            raise ValueError("TieredServingCluster serves a Model or a "
                             "ModelGroup")
        self.plan_cfgs = plan_cfgs
        self.plan_cfg = plan_cfgs[self._model_names[0]]
        self.spec_enabled = bool(cfg.spec_draft)
        if self.spec_enabled:
            if self.group is None:
                raise ValueError("ClusterConfig.spec_draft requires a "
                                 "ModelGroup cluster (the draft must be a "
                                 "named group entry)")
            if cfg.spec_draft not in self.group:
                raise ValueError(f"spec_draft {cfg.spec_draft!r} is not a "
                                 f"group entry (group has "
                                 f"{self.group.names})")
            if cfg.temperature > 0.0:
                raise ValueError(
                    "spec_draft + temperature>0 is rejected at config "
                    "time: lossless speculation verifies the target's "
                    "argmax (see SpecPair); use temperature=0")
        self.router = AdmissionRouter(
            router_cfg, self.scenario,
            stream_tokens=cfg.stream_tokens or self.spec_enabled,
            spec_k=cfg.spec_k if self.spec_enabled else 0,
            spec_draft=cfg.spec_draft,
            spec_draft_frac=cfg.spec_draft_frac)
        # per-token compute of each planned model at the pool's context size
        self._tok_flops: Dict[str, float] = {}
        kv_slot: Dict[str, float] = {}
        for name, pc in plan_cfgs.items():
            c = analytic_step_cost(pc, 1, cfg.max_len)
            self._tok_flops[name] = c.flops_per_token
            kv_slot[name] = c.kv_bytes_per_token * cfg.max_len

        sc = self.scenario
        scfg = SchedulerConfig(
            n_slots=cfg.base_slots, max_len=cfg.max_len,
            prefill_chunk=cfg.prefill_chunk,
            exit_threshold=cfg.exit_threshold,
            temperature=cfg.temperature, long_mode=cfg.long_mode,
            max_prefill_chunks_per_step=cfg.max_prefill_chunks_per_step,
            paged=cfg.paged, page_size=cfg.page_size,
            segmented=not cfg.async_decode, async_decode=cfg.async_decode,
            readback_interval=cfg.readback_interval)
        self.tiers: Dict[str, TierRuntime] = {}
        for name, uplink in (("device", None), ("edge", sc.dev_edge),
                             ("cloud", sc.dev_cloud)):
            prof = _tier_profile(sc, name)
            slots = {m: derive_tier_slots(prof, sc.cloud, cfg.base_slots,
                                          kv_slot[m])
                     for m in self._model_names}
            if self.group is not None:
                sched: Union[ContinuousBatchScheduler, MultiModelScheduler] \
                    = MultiModelScheduler(self.group, scfg,
                                          slots_per_model=slots)
            else:
                sched = ContinuousBatchScheduler(
                    model, params,
                    dataclasses.replace(scfg, n_slots=slots[""]),
                    device=model.device)
            self.tiers[name] = TierRuntime(
                name, prof, uplink, sched,
                tok_cost={m: compute_time(self._tok_flops[m], prof)
                          for m in self._model_names},
                slots_total=sum(slots.values()),
                slot_avail={m: [0.0] * n for m, n in slots.items()},
                slot_released={m: [0.0] * n for m, n in slots.items()})
        self.requests: List[ClusterRequest] = []
        self._cr_of: Dict[int, ClusterRequest] = {}   # id(Request) -> wrapper
        self.dead: Set[str] = set()    # tiers lost to a Scenario outage
        # cluster-wide migration ledger (bytes are measured payload bytes)
        self.migration_stats: Dict[str, float] = {
            "split_handoffs": 0, "outage_migrations": 0, "requeued": 0,
            "compressed": 0, "bytes_moved": 0.0, "bytes_raw": 0.0,
            "transfer_s": 0.0}
        # the speculative bridge: one SpecPair per target model, built at
        # its first speculative admission (a trace that never routes
        # speculative holds no pair arenas), its waiting and live
        # requests, and the measured round counters behind
        # ``router.spec_accept`` and ``stats()["speculative"]``
        self._spec_pairs: Dict[str, SpecPair] = {}
        self._spec_waiting: List[ClusterRequest] = []
        self._spec_live: Dict[int, ClusterRequest] = {}
        self._spec_pf: Dict[str, Dict[str, List[int]]] = {}
        self.spec_counters: Dict[str, float] = {
            "rounds": 0, "slot_rounds": 0, "committed": 0, "drafted": 0}

    def _resolve_model(self, model: Optional[str]) -> str:
        if self.group is not None:
            return self.group.resolve(model or "")
        return ""

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def queue_costs(self, arrival: float = 0.0,
                    model: Optional[str] = None) -> Dict[str, float]:
        """Estimated queueing delay per tier for a ``model`` request
        arriving at ``arrival`` on the virtual clock: how long past its
        arrival the tier's earliest slot of that model's arena frees up."""
        m = self._resolve_model(model)
        return {name: max(0.0, min(tr.slot_avail[m]) - arrival)
                for name, tr in self.tiers.items()}

    def virtual_now(self) -> float:
        """The cluster-wide virtual timestamp (latest tier clock)."""
        return max(tr.vclock for tr in self.tiers.values())

    def submit(self, tokens, *, max_new: int = 32,
               deadline: Optional[float] = None, arrival: float = 0.0,
               eos_id: Optional[int] = None, frames=None,
               model: Optional[str] = None) -> ClusterRequest:
        """Route one request and enqueue it at the chosen tier.
        ``arrival`` is the request's birth on the virtual clock; ``frames``
        [Tenc, D] are an encdec request's encoder inputs; ``model`` names
        the group entry that serves it (None = the default)."""
        m = self._resolve_model(model)
        toks = np.asarray(tokens).reshape(-1)
        if toks.size + max_new > self.cfg.max_len:
            raise ValueError(f"prompt {toks.size} + max_new {max_new} "
                             f"exceeds cluster max_len {self.cfg.max_len}")
        route_kw = {"model": m} if self.group is not None else {}
        d = self.router.route(toks.size, max_new, deadline=deadline,
                              queue_cost=self.queue_costs(arrival, model=m),
                              exclude=self.dead or None, **route_kw)
        cr = ClusterRequest(Request(tokens=toks, max_new=max_new,
                                    eos_id=eos_id, frames=frames, model=m),
                            arrival, deadline, d, ready_at=arrival)
        cr.booked_model = m
        self._place(cr, arrival)
        self.tiers[cr.decision.tier].routed += 1
        self.requests.append(cr)
        self._cr_of[id(cr.req)] = cr
        return cr

    def _place(self, cr: ClusterRequest, arrival: float):
        """Stage a routed request at its starting tier and book the decode
        slot.  A split starts in the prefill tier's pool and migrates to
        the decode tier once its prefill lands (``_poll_tier``); a
        speculative decision goes to the bridge (``_place_spec``)."""
        d, m = cr.decision, cr.booked_model
        if d.paradigm == "speculative":
            if self.spec_enabled and m != self.cfg.spec_draft:
                self._place_spec(cr, arrival)
                return
            # the draft cannot speculate against itself: serve it as a
            # plain cloud decode
            cr.decision = d = dataclasses.replace(d, paradigm="cloud-stream")
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
            est_pf = cr.req.tokens.size * home.tok_cost[m]
            cr.pf_booked_tier = home.name
            (cr.pf_booked_slot, cr.pf_booked_until,
             cr.pf_booked_released0) = home.book(m, cr.ready_at, est_pf)
            dec_ready += est_pf + d.transfer_delay
        service = (cr.req.max_new if d.is_split
                   else cr.req.tokens.size + cr.req.max_new) * tr.tok_cost[m]
        cr.booked_tier = tr.name
        cr.booked_slot, cr.booked_until, cr.booked_released0 = \
            tr.book(m, dec_ready, service)
        home.waiting.append(cr)

    # ------------------------------------------------------------------
    # cross-tier speculative decoding (device draft, cloud verify)
    # ------------------------------------------------------------------
    def _place_spec(self, cr: ClusterRequest, arrival: float):
        """Stage a speculative request: the prompt crosses the device-cloud
        link once so the cloud target can prefill (the device draft
        prefills the same prompt locally; the bridge poll charges it), and
        the cloud verify slot is booked like a plain cloud decode."""
        m = cr.booked_model
        cloud = self.tiers["cloud"]
        prompt_bytes = float(cr.req.tokens.size * 4)
        cr.ready_at = arrival + self.scenario.dev_cloud.tx_time(prompt_bytes)
        if cr.booked_slot >= 0 and cr.booked_tier:
            self._reconcile_booking(self.tiers[cr.booked_tier], cr)
        self._release_pf_booking(cr)
        service = (cr.req.tokens.size + cr.req.max_new) * cloud.tok_cost[m]
        cr.booked_tier = "cloud"
        cr.booked_slot, cr.booked_until, cr.booked_released0 = \
            cloud.book(m, cr.ready_at, service)
        self._spec_waiting.append(cr)

    def _spec_pair(self, m: str) -> SpecPair:
        """The ``SpecPair`` serving speculative requests for target ``m``,
        built on first use: its draft arena stands in for the device tier,
        its target arena for the cloud tier, with one slot count for both
        (pairing is 1:1), the smaller of the two tiers' derived counts.
        ``exit_threshold`` is 0: verify always runs full depth."""
        if m not in self._spec_pairs:
            cfg, sc = self.cfg, self.scenario
            draft = cfg.spec_draft
            kv = {n: kv_cache_bytes_per_token(self.plan_cfgs[n])
                  * cfg.max_len for n in (draft, m)}
            n = max(1, min(
                derive_tier_slots(sc.device, sc.cloud, cfg.base_slots,
                                  kv[draft]),
                derive_tier_slots(sc.cloud, sc.cloud, cfg.base_slots,
                                  kv[m])))
            # no async_decode: a propose/verify round is host lockstep
            self._spec_pairs[m] = SpecPair(
                ModelGroup([self.group[draft], self.group[m]]),
                SchedulerConfig(
                    n_slots=n, max_len=cfg.max_len,
                    prefill_chunk=cfg.prefill_chunk, exit_threshold=0.0,
                    long_mode=cfg.long_mode,
                    max_prefill_chunks_per_step=(
                        cfg.max_prefill_chunks_per_step),
                    paged=cfg.paged, page_size=cfg.page_size),
                k=cfg.spec_k, slots_per_model={draft: n, m: n})
            self._spec_pf[m] = {draft: [], m: []}
        return self._spec_pairs[m]

    def _poll_spec(self) -> bool:
        """One bridge round over the speculative pairs.  The device and
        cloud clocks run in lockstep: draft compute on the device clock, a
        k-token-id uplink, the verify on the cloud clock, the accepted
        count's downlink, and both clocks land on the round's end.  The
        link is charged once a round, from the measured drafted and
        committed counts."""
        if not self.spec_enabled:
            return False
        dev, cloud = self.tiers["device"], self.tiers["cloud"]
        if dev.dead or cloud.dead:
            return False               # _drain_spec requeued these
        # admit waiting requests whose uplink landed; an otherwise idle
        # cloud fast-forwards to the next arrival (as _release_ready does)
        if (self._spec_waiting and not cloud.sched.has_work
                and not cloud.waiting
                and not any(p.has_work for p in self._spec_pairs.values())):
            nxt = min(c.ready_at for c in self._spec_waiting)
            cloud.vclock = max(cloud.vclock, nxt)
        still = []
        for cr in self._spec_waiting:
            if cr.ready_at <= cloud.vclock:
                self._spec_pair(cr.booked_model).submit(cr.req)
                self._spec_live[id(cr.req)] = cr
            else:
                still.append(cr)
        self._spec_waiting = still
        draft, link = self.cfg.spec_draft, self.scenario.dev_cloud
        worked = False
        for m, pair in self._spec_pairs.items():
            if not pair.has_work:
                continue
            rep = pair.poll()
            worked = worked or rep.worked
            rows = self._spec_pf[m]
            chunk = self.cfg.prefill_chunk
            # prompt replay: the target prefills on the cloud clock, the
            # draft's shadow on the device clock, each at its model's rate
            for name, tr_, rate in ((draft, dev, dev.tok_cost[draft]),
                                    (m, cloud, cloud.tok_cost[m])):
                sub = rep.per_model.get(name)
                if sub is None:
                    continue
                if sub.admitted:
                    rows[name] = [r.tokens.size for r in sub.admitted]
                if sub.prefill_chunks:
                    lo = sub.prefill_chunk_start * chunk
                    hi = lo + sub.prefill_chunks * chunk
                    cost = sum(min(max(p - lo, 0), hi - lo)
                               for p in rows.get(name, ())) * rate
                    tr_.vclock += cost
                    tr_.busy += cost
                if sub.prefill_done:
                    rows[name] = []
            if rep.spec_rounds:
                # the draft proposes k sequential steps on the device
                # clock; the verify is one batched pass on the cloud clock
                # (memory-bound decode absorbs the extra positions), as the
                # admission candidate prices it
                draft_c = rep.spec_drafted * dev.tok_cost[draft]
                verify_c = rep.spec_rounds * cloud.tok_cost[m]
                t_end = (max(dev.vclock, cloud.vclock) + draft_c
                         + link.tx_time(4.0 * pair.k) + verify_c
                         + link.tx_time(8.0))
                dev.vclock = cloud.vclock = t_end
                dev.busy += draft_c
                cloud.busy += verify_c
                cloud.decode_steps += 1
                cloud.slot_tokens += rep.n_active
                self.spec_counters["rounds"] += rep.spec_rounds
                self.spec_counters["slot_rounds"] += rep.n_active
                self.spec_counters["committed"] += rep.spec_committed
                self.spec_counters["drafted"] += rep.spec_drafted
            for r in rep.completed:
                cr = self._cr_of.get(id(r))
                if cr is None:
                    continue
                # the last tokens rode this round's downlink
                cr.t_done_v = cloud.vclock
                cr.final_tier = "cloud"
                self._reconcile_booking(
                    self.tiers[cr.booked_tier or "cloud"], cr)
                self._spec_live.pop(id(r), None)
        # feed the measured acceptance (committed tokens per slot-round)
        # back into admission pricing once there is signal
        if self.spec_counters["slot_rounds"] >= 4:
            self.router.spec_accept = (self.spec_counters["committed"]
                                       / self.spec_counters["slot_rounds"])
        return worked

    def _drain_spec(self) -> List[ClusterRequest]:
        """Device or cloud died: the lockstep bridge cannot continue.
        Every speculative request restarts from its prompt among the
        survivors and the pairs are dropped.  The router cannot produce a
        speculative decision while device or cloud is excluded, so the
        restarts land on ordinary candidates."""
        redo = self._spec_waiting + [cr for cr in self._spec_live.values()
                                     if not cr.done]
        self._spec_waiting = []
        self._spec_live.clear()
        self._spec_pairs.clear()
        self._spec_pf.clear()
        for cr in redo:
            r = cr.req
            r.out_tokens, r.slot, r.done = [], -1, False
            r.spec_rounds = 0
        return redo

    # ------------------------------------------------------------------
    # pool stepping + virtual-time accounting
    # ------------------------------------------------------------------
    def _release_ready(self, tr: TierRuntime):
        """Move waiting requests whose transfers have landed into the pool
        queue, import inbound slots whose handoff has landed (when a slot
        of their arena is free), and fast-forward an idle tier's clock to
        the next arrival or handoff."""
        if not tr.waiting and not tr.inbound:
            return
        if not tr.sched.has_work:
            pend = [c.ready_at for c in tr.waiting] \
                + [t for t, _, _, _ in tr.inbound]
            tr.vclock = max(tr.vclock, min(pend))
        still_in = []
        for item in tr.inbound:
            ready, snap, _, _ = item
            if ready <= tr.vclock and tr.sched.free_slots(model=snap.model):
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
        self._release_slot_booking(tr, cr.booked_model, cr.booked_slot,
                                   cr.booked_until, cr.booked_released0)
        cr.booked_slot = -1            # released exactly once

    @staticmethod
    def _release_slot_booking(tr: TierRuntime, m: str, i: int, until: float,
                              released0: float):
        """Return a booking's unused tail to ``slot_avail``, measured
        against the slot's released-time delta since booking."""
        sa, rel = tr.slot_avail[m], tr.slot_released[m]
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
            self.tiers[cr.pf_booked_tier], cr.booked_model,
            cr.pf_booked_slot, cr.pf_booked_until, cr.pf_booked_released0)
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

    def _arenas(self, tr: TierRuntime):
        """``[(model, scheduler)]`` of a tier pool's arenas."""
        if self.group is not None:
            return list(tr.sched.pools.items())
        return [("", tr.sched)]

    def _sync_pool(self, tr: TierRuntime):
        """Drain a tier pool's async decode windows before a slot leaves
        it (split handoff, outage drain): commit every window in flight,
        charge the tier clock for the drained steps at each model's rate
        (windows run full depth), and stamp the completions the drain
        surfaced; no later poll reports them.  No-op for sync pools."""
        if not tr.sched.cfg.async_decode:
            return
        arenas = self._arenas(tr)
        steps0 = [a._step_idx for _, a in arenas]
        toks0 = [a.tokens_served for _, a in arenas]
        done = tr.sched.sync()
        cost = 0.0
        steps_max = 0
        for (m, a), s0, t0 in zip(arenas, steps0, toks0):
            steps = a._step_idx - s0
            cost += tr.tok_cost[m] * steps
            steps_max = max(steps_max, steps)
            tr.slot_tokens += a.tokens_served - t0
        tr.vclock += cost
        tr.busy += cost
        tr.decode_steps += steps_max
        for r in done:
            self._stamp_done(tr, r)

    def _poll_tier(self, tr: TierRuntime) -> bool:
        if tr.dead:
            return False
        self._release_ready(tr)
        if not tr.sched.has_work:
            return False
        rep = tr.sched.poll()
        # a single-model pool's report is its own (sole) sub-report
        subs = rep.per_model if rep.per_model else {"": rep}
        decode_cost = 0.0
        went_live: List[ClusterRequest] = []
        for m, sub in subs.items():
            if sub.admitted:
                tr.prefill_rows[m] = [(self._cr_of[id(r)], r.tokens.size)
                                      for r in sub.admitted]
            if sub.prefill_chunks:
                # replayed prompt tokens are charged to this tier at the
                # model's rate (split requests prefill here for real)
                chunk = self.cfg.prefill_chunk
                lo = sub.prefill_chunk_start * chunk
                hi = lo + sub.prefill_chunks * chunk
                cost = 0.0
                for _, plen in tr.prefill_rows.get(m, ()):
                    cost += min(max(plen - lo, 0), hi - lo) * tr.tok_cost[m]
                tr.vclock += cost
                tr.busy += cost
            if sub.prefill_done:
                went_live += [cr for cr, _ in tr.prefill_rows.get(m, ())]
                tr.prefill_rows[m] = []
            if sub.decode_stepped:
                # the truncated step cost: the layer-weighted share of the
                # stack the segment pipeline dispatched, for every step
                # committed (an async readback commits a whole window)
                depth = sub.decode_depth_frac \
                    if sub.decode_depth_frac > 0.0 else 1.0
                decode_cost += (tr.tok_cost[m] * depth
                                * (sub.decode_steps or 1))
        if rep.decode_stepped:
            tr.vclock += decode_cost
            tr.busy += decode_cost
            steps = rep.decode_steps or 1
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
        m, slot = cr.booked_model, cr.req.slot
        link = self._kv_link(src.name, dst.name)
        # decide from the layout-derived raw size before exporting, so the
        # slot is snapshotted exactly once
        raw_bytes = src.sched.slot_payload_bytes(slot, model=m)
        dec = compression_decision(raw_bytes, src.profile, link)
        use_int8 = self.cfg.kv_handoff == "int8" or (
            self.cfg.kv_handoff == "auto" and dec.compress)
        # page-granular handoff: pages the destination's prefix tree
        # already holds are skipped (borrowed back at import)
        snap = src.sched.export_slot(slot, model=m, compress=use_int8,
                                     skip_keys=dst.sched.prefix_keys(model=m))
        overhead = 0.0
        if use_int8:
            overhead = dec.quant_overhead
            src.busy += overhead       # the sender quantizes on its silicon
        src.sched.release_slot(slot, model=m)
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
        of its model's arena plus the remaining decode at that tier's
        rate."""
        m = cr.booked_model
        remaining = max(1, cr.req.max_new - len(cr.req.out_tokens))
        alive = [t for t in self.tiers.values() if not t.dead]
        if not alive:
            raise RuntimeError("every tier is dead")
        return min(alive, key=lambda t: max(
            0.0, min(t.slot_avail[m]) - now) + remaining * t.tok_cost[m])

    def _rebook(self, cr: ClusterRequest, dst: TierRuntime, ready: float,
                tokens: int):
        """Move a request's slot booking to ``dst``, first releasing any
        prior booking (one left on a surviving tier would never be
        reconciled)."""
        if cr.booked_slot >= 0 and cr.booked_tier:
            self._reconcile_booking(self.tiers[cr.booked_tier], cr)
        m = cr.booked_model
        cr.booked_tier = dst.name
        cr.booked_slot, cr.booked_until, cr.booked_released0 = \
            dst.book(m, ready, tokens * dst.tok_cost[m])

    def _drain_tier(self, tr: TierRuntime):
        """Tier outage: mark ``tr`` dead and move every request off it.
        Active decode slots migrate (export -> handoff -> import) without
        re-running prefill, or with ``migrate_on_outage=False`` restart
        from the prompt.  Queued and still-prefilling requests are
        re-routed from scratch, snapshots in flight toward the dead tier
        are redirected to a survivor, and a dead device or cloud tier
        drains the speculative bridge."""
        tr.dead = True
        self.dead.add(tr.name)
        now = self.virtual_now()
        # the dying pool's windows in flight decoded before the outage:
        # commit them, so the exports below ship committed state
        self._sync_pool(tr)
        redo = list(tr.waiting)
        tr.waiting = []
        if self.spec_enabled and tr.name in ("device", "cloud"):
            redo += self._drain_spec()
        for r in tr.sched.drain_queue() + tr.sched.cancel_pending():
            redo.append(self._cr_of[id(r)])
        inbound, tr.inbound = tr.inbound, []
        for m, slot, r in tr.sched.active_requests():
            cr = self._cr_of[id(r)]
            dst = self._failover_tier(cr, now)
            if self.cfg.migrate_on_outage:
                # depart at the outage moment, as the requeue baseline does
                self._migrate_one(tr, dst, cr,
                                  count_key="outage_migrations", depart=now)
                self._rebook(cr, dst, now,
                             max(1, r.max_new - len(r.out_tokens)))
            else:
                tr.sched.release_slot(slot, model=m)
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
            route_kw = ({"model": cr.booked_model}
                        if self.group is not None else {})
            d = self.router.route(
                cr.req.tokens.size, cr.req.max_new, deadline=cr.deadline,
                queue_cost=self.queue_costs(now, model=cr.booked_model),
                exclude=self.dead, **route_kw)
            cr.decision = d
            cr.requeues += 1
            self.migration_stats["requeued"] += 1
            self.tiers[d.tier].routed += 1
            self._place(cr, now)

    def poll(self) -> bool:
        """One round over all tier pools and the speculative bridge
        (scheduled outages fire first).  Returns whether any worked."""
        self._check_outages()
        worked = False
        for tr in self.tiers.values():
            worked = self._poll_tier(tr) or worked
        worked = self._poll_spec() or worked
        return worked

    @property
    def has_work(self) -> bool:
        return any(tr.waiting or tr.inbound or tr.sched.has_work
                   for tr in self.tiers.values() if not tr.dead) \
            or bool(self._spec_waiting) \
            or any(p.has_work for p in self._spec_pairs.values())

    def run(self):
        """Drain every pool (all submitted requests complete)."""
        while self.has_work:
            if not self.poll():        # pragma: no cover - defensive
                break
        for tr in self.tiers.values():
            tr.sched.flush_counters()
        for pair in self._spec_pairs.values():
            pair.flush_counters()

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
            for _, pool in self._arenas(tr):
                pool.completed.clear()
        for pair in self._spec_pairs.values():
            pair.completed.clear()
            for pool in pair.pools.values():
                pool.completed.clear()

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def jit_cache_sizes(self) -> Dict[str, Dict[str, int]]:
        """Each tier pool's stage builds, plus a ``"spec:<model>"`` entry
        per speculative pair built."""
        out = {n: tr.sched.jit_cache_sizes()
               for n, tr in self.tiers.items()}
        for m, pair in self._spec_pairs.items():
            out[f"spec:{m}"] = pair.jit_cache_sizes()
        return out

    def audit_stages(self) -> Dict[str, Dict[str, StageSpec]]:
        """Each tier pool's stage registry, plus a ``"spec:<model>"`` entry
        per speculative pair built (the key scheme of
        ``jit_cache_sizes``)."""
        out = {n: tr.sched.audit_stages() for n, tr in self.tiers.items()}
        for m, pair in self._spec_pairs.items():
            out[f"spec:{m}"] = pair.audit_stages()
        return out

    def stats(self) -> Dict[str, object]:
        """Route counts, migration ledger and per-tier accounting.  Every
        latency and utilization here is on the virtual clocks (modelled by
        the planners' tier profiles); ``host_ms``, ``wait_ms`` and
        ``flush_wait_ms`` are the pools' measured wall-time split, and
        ``device_ms`` their decode windows' device time.  ``stage_calls``
        counts each pool's segment, probe and finalize dispatches;
        ``jit_cache_sizes`` each pool's stage builds.  Group clusters add
        ``models`` (per-model routes, tokens and latencies); a
        ``spec_draft`` cluster adds ``speculative`` (measured rounds,
        acceptance and each request's tokens per round)."""
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
                "wait_ms": tr.sched.wait_ms_total,
                "flush_wait_ms": tr.sched.flush_wait_ms_total,
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
            "jit_cache_sizes": self.jit_cache_sizes(),
        }
        if self.spec_enabled:
            cnt = self.spec_counters
            spec_done = [cr for cr in done
                         if cr.decision.paradigm == "speculative"]
            # each request's tokens per verify round, against one token a
            # round trip when streaming
            attr = [{"req_id": cr.req.req_id,
                     "tokens": len(cr.req.out_tokens),
                     "rounds": cr.req.spec_rounds,
                     "speedup_x": (len(cr.req.out_tokens)
                                   / max(1, cr.req.spec_rounds))}
                    for cr in spec_done]
            out["speculative"] = {
                "k": self.cfg.spec_k,
                "draft": self.cfg.spec_draft,
                "rounds": cnt["rounds"],
                "slot_rounds": cnt["slot_rounds"],
                "committed": cnt["committed"],
                "drafted": cnt["drafted"],
                "acceptance_len": (cnt["committed"]
                                   / max(1, cnt["slot_rounds"])),
                "requests_completed": len(spec_done),
                "p50_latency_s": _pctl([cr.latency for cr in spec_done],
                                       50),
                "per_request_speedup": attr,
                "mean_speedup_x": (sum(a["speedup_x"] for a in attr)
                                   / len(attr) if attr else float("nan")),
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
        if self.group is not None:
            per_model = {}
            for m in self._model_names:
                ml = [cr.latency for cr in done if cr.req.model == m]
                per_model[m] = {
                    "routed": sum(
                        self.router.route_counts_by_model[m].values()),
                    "route_counts": dict(
                        self.router.route_counts_by_model[m]),
                    "tokens": sum(tr.sched.pools[m].tokens_served
                                  for tr in self.tiers.values()),
                    "p50_latency_s": _pctl(ml, 50),
                    "p95_latency_s": _pctl(ml, 95),
                }
            out["models"] = per_model
        return out
