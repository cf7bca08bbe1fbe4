"""Multi-model slot pools: one scheduler multiplexing heterogeneous models,
and speculative pairs (the port of the reference's ``serving/multipool.py``).

The survey's tiers are not single-model: an edge node serves a zoo of
heterogeneous DNNs at once (multi-tenant edge serving).  A ``ModelGroup``
of named ``(model, params)`` entries is served by one
``MultiModelScheduler`` behind one queue and one ``poll()`` loop:

* **Per-model arenas.**  Each entry owns a full single-model
  ``ContinuousBatchScheduler``: its own KV arena, block table and exit
  counters.  Models share no device buffer, so each model's outputs equal
  a dedicated single-model scheduler's fed the same requests (greedy and
  sampled alike: every arena hashes the same sampling key with its own
  ticks, as a dedicated scheduler given the same generator would).
* **One queue, one poll.**  ``submit()`` takes a ``Request`` whose
  ``model`` names the arena ("" = the group's first entry); ``poll()``
  rounds over the arenas and returns one ``StepReport`` whose
  ``per_model`` holds the arenas' sub-reports (the tiered cluster charges
  per-model step costs from those).
* **Cross-model prefill fairness.**  ``cfg.max_prefill_chunks_per_step``
  is a pool-wide budget: one poll runs at most that many prefill chunks
  summed over every model, handed out round-robin (the first claim
  rotates), so one model's long admission cannot starve another's decode.

``SpecPair`` is the speculative mode of the pool: a draft arena proposes k
greedy tokens a round and the target arena verifies them, committing the
longest accepted prefix plus one corrected (or bonus) token.  Its streams
equal target-only greedy decode bit for bit.

Typical use::

    group = ModelGroup([("small", model_a, params_a),
                        ("big", model_b, params_b)])
    pool = MultiModelScheduler(group, SchedulerConfig(n_slots=4))
    pool.submit(Request(tokens=p1, max_new=16, model="small"))
    pool.submit(Request(tokens=p2, max_new=16, model="big"))
    pool.run()
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig, StageSpec,
                                           StepReport)


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One named model of a group."""
    name: str
    model: Any
    params: Any


class ModelGroup:
    """An ordered, named collection of ``(model, params)`` entries
    (``(name, model, params)`` tuples or ``ModelEntry`` instances).  The
    first entry is the default model (what ``Request.model=""`` means)."""

    def __init__(self, entries: Sequence):
        ents = [e if isinstance(e, ModelEntry) else ModelEntry(*e)
                for e in entries]
        if not ents:
            raise ValueError("empty ModelGroup")
        names = [e.name for e in ents]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names: {names}")
        self._entries: Dict[str, ModelEntry] = {e.name: e for e in ents}

    @property
    def names(self) -> List[str]:
        return list(self._entries)

    @property
    def default(self) -> str:
        return next(iter(self._entries))

    def resolve(self, name: str) -> str:
        """A request's model key as an entry name ("" = the default)."""
        if not name:
            return self.default
        if name not in self._entries:
            raise KeyError(f"unknown model {name!r} (group has "
                           f"{self.names})")
        return name

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[ModelEntry]:
        return iter(self._entries.values())

    def __getitem__(self, name: str) -> ModelEntry:
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries


def _add_prefill(rep: StepReport, sub: StepReport):
    """Fold an arena's admission and prefill fields into the aggregate."""
    rep.admitted += sub.admitted
    rep.prefill_chunks += sub.prefill_chunks
    rep.prefill_tokens += sub.prefill_tokens
    rep.prefill_done = rep.prefill_done or sub.prefill_done
    rep.completed += sub.completed


class MultiModelScheduler:
    """One serving pool multiplexing the arenas of a ``ModelGroup``.

    Has the single-model scheduler's surface that external drivers use
    (``submit`` / ``poll`` / ``run`` / ``has_work`` / ``completed`` /
    ``sync`` / ``flush_counters`` / ``exit_stats`` / ``jit_cache_sizes`` and
    the slot-migration entry points, which take ``model=``), so the tiered
    cluster drives either.  Each arena runs on its model's device.
    ``slots_per_model`` overrides ``cfg.n_slots`` per entry (the tiered
    cluster derives slot counts from each model's KV size).
    """

    def __init__(self, group: ModelGroup, cfg: SchedulerConfig = None,
                 slots_per_model: Optional[Dict[str, int]] = None):
        cfg = SchedulerConfig() if cfg is None else cfg
        self.group = group
        self.cfg = cfg
        self.pools: Dict[str, ContinuousBatchScheduler] = {}
        for e in group:
            pcfg = cfg
            if slots_per_model and e.name in slots_per_model:
                pcfg = dataclasses.replace(cfg,
                                           n_slots=slots_per_model[e.name])
            self.pools[e.name] = ContinuousBatchScheduler(
                e.model, e.params, pcfg, device=e.model.device)
        self.completed: List[Request] = []
        self.n_submitted = 0
        self._rr = 0                   # rotating first claim on the budget

    # ------------------------------------------------------------------
    # the single-model scheduler's driver surface
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue one request on its model's arena."""
        req.model = self.group.resolve(req.model)
        if req.req_id < 0:
            req.req_id = self.n_submitted
        self.n_submitted += 1
        self.pools[req.model].submit(req)

    def set_rng(self, rng):
        """Install one sampling generator into every arena and reset their
        tick counters.  Each arena draws its key from the generator in the
        same state, so every arena samples as a dedicated scheduler given
        that generator would; the generator ends one draw further on, as
        after a dedicated scheduler's ``set_rng``."""
        if rng is None:
            for pool in self.pools.values():
                pool.set_rng(None)
            return
        state = rng.get_state()
        for pool in self.pools.values():
            rng.set_state(state)
            pool.set_rng(rng)

    @property
    def has_work(self) -> bool:
        return any(p.has_work for p in self.pools.values())

    @property
    def tokens_served(self) -> int:
        return sum(p.tokens_served for p in self.pools.values())

    @property
    def depth_weighted_tokens(self) -> float:
        return sum(p.depth_weighted_tokens for p in self.pools.values())

    @property
    def host_ms_total(self) -> float:
        return sum(p.host_ms_total for p in self.pools.values())

    @property
    def wait_ms_total(self) -> float:
        return sum(p.wait_ms_total for p in self.pools.values())

    @property
    def flush_wait_ms_total(self) -> float:
        return sum(p.flush_wait_ms_total for p in self.pools.values())

    @property
    def device_ms_total(self) -> float:
        return sum(p.device_ms_total for p in self.pools.values())

    @property
    def peak_tokens_in_flight(self) -> int:
        return max(p.peak_tokens_in_flight for p in self.pools.values())

    @property
    def stage_calls(self) -> Dict[str, int]:
        """``"model/stage" -> dispatches`` over every arena."""
        return {f"{n}/{k}": v for n, p in self.pools.items()
                for k, v in p.stage_calls.items()}

    def poll(self) -> StepReport:
        """One pool round: each arena with work admits, prefills and
        decodes once, sharing the pool-wide prefill budget round-robin.
        Returns the aggregate ``StepReport`` with the per-model
        sub-reports attached."""
        rep = StepReport()
        budget = self.cfg.max_prefill_chunks_per_step
        names = list(self.pools)
        start = self._rr % len(names)
        self._rr += 1
        used = 0
        active_depth = 0.0
        for name in names[start:] + names[:start]:
            pool = self.pools[name]
            if not pool.has_work:
                continue
            if budget <= 0:            # unbounded per arena (the default)
                sub = pool.poll()
            else:
                sub = pool.poll(prefill_budget=max(0, budget - used))
                used += sub.prefill_chunks
            rep.per_model[name] = sub
            _add_prefill(rep, sub)
            rep.decode_stepped = rep.decode_stepped or sub.decode_stepped
            rep.n_active += sub.n_active
            rep.decode_segments_run += sub.decode_segments_run
            # steps committed is a per-round gauge (the arenas commit in
            # parallel rounds); dispatches, times and in-flight tokens add
            rep.decode_steps = max(rep.decode_steps, sub.decode_steps)
            rep.decode_dispatched += sub.decode_dispatched
            rep.host_ms += sub.host_ms
            rep.wait_ms += sub.wait_ms
            rep.flush_wait_ms += sub.flush_wait_ms
            rep.tokens_in_flight += sub.tokens_in_flight
            active_depth += sub.decode_depth_frac * sub.n_active
        if rep.n_active:               # active-slot-weighted mean depth
            rep.decode_depth_frac = active_depth / rep.n_active
        self.completed += rep.completed
        return rep

    def tick(self) -> bool:
        return self.poll().worked

    def sync(self) -> List[Request]:
        """Drain every arena's async decode windows (no-op for sync
        arenas).  Returns the requests the drain completed; as with the
        single-pool ``sync()``, the caller stamps them."""
        out: List[Request] = []
        for pool in self.pools.values():
            out += pool.sync()
        self.completed += out
        return out

    def run(self, rng=None):
        """Drain the queue and every arena to completion."""
        self.set_rng(rng)
        while self.has_work:
            if not self.poll().worked:  # pragma: no cover - defensive
                break
        self.flush_counters()

    # ------------------------------------------------------------------
    # slot migration: delegates to the named arena (snapshots carry their
    # model name, so an import routes itself)
    # ------------------------------------------------------------------
    def _pool(self, model: str) -> ContinuousBatchScheduler:
        return self.pools[self.group.resolve(model)]

    def export_slot(self, slot: int, *, model: str = "",
                    compress: bool = False, skip_keys=frozenset()):
        return self._pool(model).export_slot(slot, compress=compress,
                                             skip_keys=skip_keys)

    def import_slot(self, snap) -> int:
        return self._pool(snap.model).import_slot(snap)

    def prefix_keys(self, model: str = ""):
        return self._pool(model).prefix_keys()

    def slot_payload_bytes(self, slot: int, *, model: str = "") -> int:
        return self._pool(model).slot_payload_bytes(slot)

    def free_slots(self, model: str = ""):
        return self._pool(model).free_slots()

    def active_requests(self):
        """``[(model, slot, request)]`` across every arena."""
        return [(name, slot, r) for name, pool in self.pools.items()
                for _, slot, r in pool.active_requests()]

    def release_slot(self, slot: int, *, model: str = ""):
        return self._pool(model).release_slot(slot)

    def drain_queue(self) -> List[Request]:
        return [r for pool in self.pools.values()
                for r in pool.drain_queue()]

    def cancel_pending(self) -> List[Request]:
        return [r for pool in self.pools.values()
                for r in pool.cancel_pending()]

    # ------------------------------------------------------------------
    # statistics: per model (the arenas' counters are disjoint buffers)
    # ------------------------------------------------------------------
    def flush_counters(self) -> Dict[str, Any]:
        return {n: p.flush_counters() for n, p in self.pools.items()}

    def reset_stats(self):
        for p in self.pools.values():
            p.reset_stats()
        self.completed.clear()

    def measured_depth_fraction(self) -> float:
        served = self.tokens_served
        if not served:
            return 1.0
        return self.depth_weighted_tokens / served

    def exit_stats(self) -> Dict[str, Dict[str, float]]:
        return {n: p.exit_stats() for n, p in self.pools.items()}

    def jit_cache_sizes(self) -> Dict[str, int]:
        """``"model/stage" -> builds``, each bounded by 1."""
        return {f"{name}/{stage}": v for name, pool in self.pools.items()
                for stage, v in pool.jit_cache_sizes().items()}

    def audit_stages(self) -> Dict[str, StageSpec]:
        """``"model/stage" -> StageSpec`` over every arena (the key scheme
        of ``jit_cache_sizes``)."""
        return {f"{name}/{stage}": dataclasses.replace(
                    spec, name=f"{name}/{stage}")
                for name, pool in self.pools.items()
                for stage, spec in pool.audit_stages().items()}


class SpecPair(MultiModelScheduler):
    """Speculative decoding in a two-entry pool: the first entry drafts,
    the second is the target.  Every request is served by the target
    arena; the draft arena mirrors it with a shadow request, proposes a
    k-token window each round (``spec_propose``), and the target verifies
    the window (``spec_verify``), committing the longest accepted prefix
    plus one corrected (or bonus) token.

    Commits are the target's own full-depth argmax, so the streams equal
    target-only greedy decode on the monolithic path bit for bit.  That
    contract rejects, at config time: ``temperature > 0`` (a sampled
    stream would silently degrade to greedy), ``exit_threshold > 0``
    (verify runs full depth), ``async_decode`` (a round is host lockstep)
    and ``k < 2``.  The arenas run the monolithic ``decode_step``
    (``segmented`` is forced off): verify is exactly that step.

    The draft must have a position-indexed cache (``all_cache_paged()``):
    its stale rows past an accept point are overwritten before any read
    reaches them, where a sequential state could not be rewound.  The
    target gates every verify write by the on-device accept mask, so
    rejected positions are never written at all.
    """

    def __init__(self, group: ModelGroup, cfg: SchedulerConfig = None,
                 *, k: int = 4,
                 slots_per_model: Optional[Dict[str, int]] = None):
        cfg = SchedulerConfig() if cfg is None else cfg
        if len(group) != 2:
            raise ValueError(f"SpecPair needs exactly 2 models (draft, "
                             f"target), got {group.names}")
        if cfg.temperature > 0.0:
            raise ValueError(
                "SpecPair + temperature>0 is rejected at config time: "
                "lossless speculation verifies the target's argmax, so a "
                "sampled stream would silently degrade to greedy. Use "
                "temperature=0, or serve sampled traffic through a plain "
                "pool.")
        if cfg.exit_threshold > 0.0:
            raise ValueError(
                "SpecPair + exit_threshold>0 is rejected at config time: "
                "verify always runs the target at full depth, so "
                "early-exited target-only output would diverge. Use "
                "exit_threshold=0.")
        if cfg.async_decode:
            raise ValueError(
                "SpecPair + async_decode is rejected at config time: the "
                "propose/verify round is host lockstep (the draft window "
                "feeds the same round's verify), so decode windows cannot "
                "overlap it.")
        if k < 2:
            raise ValueError(f"SpecPair window k must be >= 2, got {k}")
        draft_name = group.names[0]
        if not group[draft_name].model.all_cache_paged():
            raise ValueError(
                f"SpecPair draft model {draft_name!r} has sequential state "
                "cache leaves; a rejected window cannot rewind them. Use a "
                "position-indexed (attention or MLA) draft.")
        cfg = dataclasses.replace(cfg, segmented=False)
        super().__init__(group, cfg, slots_per_model=slots_per_model)
        self.draft_name, self.target_name = group.names
        self.k = k
        for pool in self.pools.values():
            pool.ensure_spec(k)
        # req_id -> (target request, draft shadow request)
        self._pairs: Dict[int, Tuple[Request, Request]] = {}
        # one per (request, verify round): the acceptance length's
        # denominator, independent of how many slots share a round
        self.slot_rounds = 0

    def submit(self, req: Request):
        """Serve ``req`` on the target; a shadow request mirrors it on the
        draft arena.  An encdec request (one with frames) is refused, as
        the reference refuses it."""
        if req.frames is not None:
            raise ValueError("SpecPair: encdec requests unsupported")
        req.model = self.target_name
        if req.req_id < 0:
            req.req_id = self.n_submitted
        self.n_submitted += 1
        shadow = Request(tokens=np.asarray(req.tokens).reshape(-1),
                         max_new=req.max_new, eos_id=req.eos_id,
                         req_id=req.req_id, model=self.draft_name)
        self._pairs[req.req_id] = (req, shadow)
        self.pools[self.target_name].submit(req)
        self.pools[self.draft_name].submit(shadow)

    def _reap(self):
        """Release draft slots whose target request has finished.  A
        shadow still inside a staged prefill is reaped on a later poll,
        once live (releasing it mid-flight would let the pending admission
        re-activate the freed slot)."""
        drf = self.pools[self.draft_name]
        for rid in list(self._pairs):
            req, shadow = self._pairs[rid]
            if not req.done:
                continue
            if shadow.slot >= 0 and drf.slot_req[shadow.slot] is shadow:
                if not drf.active[shadow.slot]:
                    continue           # staged mid-prefill: reap later
                drf.release_slot(shadow.slot)
            elif shadow in drf.queue:
                drf.queue.remove(shadow)
            del self._pairs[rid]

    def _live_pairs(self) -> List[Tuple[int, int]]:
        """(target slot, draft slot) of every request live in both arenas:
        a target slot whose draft mirror is still prefilling waits."""
        tgt = self.pools[self.target_name]
        drf = self.pools[self.draft_name]
        return [(req.slot, shadow.slot)
                for req, shadow in self._pairs.values()
                if req.slot >= 0 and tgt.active[req.slot]
                and shadow.slot >= 0 and drf.active[shadow.slot]]

    def poll(self) -> StepReport:
        """One pool round: both arenas admit and prefill under the shared
        budget, then one speculation round runs: the draft proposes, the
        target verifies and commits.  ``per_model`` carries the draft and
        target sub-reports, with the propose and verify accounting split
        as the tiered cluster charges it.  ``wait_ms`` (the two
        readbacks), ``flush_wait_ms`` (any counter flush) and ``host_ms``
        (the rest) split the round's wall time."""
        t_poll = time.perf_counter()
        tgt = self.pools[self.target_name]
        drf = self.pools[self.draft_name]
        wait0 = tgt.wait_ms_total + drf.wait_ms_total
        flush0 = tgt.flush_wait_ms_total + drf.flush_wait_ms_total
        rep = StepReport()
        budget = self.cfg.max_prefill_chunks_per_step
        sub_t = tgt.prefill_poll(None if budget <= 0 else budget)
        sub_d = drf.prefill_poll(
            None if budget <= 0 else max(0, budget - sub_t.prefill_chunks))
        self._reap()                   # eos on an admission's first token
        pairs = self._live_pairs()
        if pairs:
            self.slot_rounds += len(pairs)
            for tslot, _ in pairs:
                tgt.slot_req[tslot].spec_rounds += 1
            for tslot, dslot in pairs:
                drf.spec_resync_from(dslot, tgt, tslot)
            win = tgt.spec_window_lens()
            win_t = np.zeros(tgt.cfg.n_slots, np.int32)
            win_d = np.zeros(drf.cfg.n_slots, np.int32)
            for tslot, dslot in pairs:
                win_t[tslot] = win[tslot]
                win_d[dslot] = win[tslot]
            drafts = drf.spec_propose(win_d)
            drafts_t = np.zeros((tgt.cfg.n_slots, self.k - 1), np.int32)
            for tslot, dslot in pairs:
                drafts_t[tslot] = drafts[dslot, :self.k - 1]
            done_before = len(tgt.completed)
            committed = tgt.spec_verify(drafts_t, win_t)
            sub_t.completed += tgt.completed[done_before:]
            self._reap()
            for tslot, dslot in pairs:     # positions agree again
                if drf.active[dslot] and tgt.active[tslot]:
                    drf.spec_resync_from(dslot, tgt, tslot)
            rep.decode_stepped = True
            rep.n_active = len(pairs)
            rep.spec_rounds = 1
            rep.spec_committed = int(committed.sum())
            rep.spec_drafted = int(win_d.sum())
            sub_d.spec_rounds = sub_t.spec_rounds = 1
            sub_d.spec_drafted = rep.spec_drafted
            sub_t.spec_committed = rep.spec_committed
            sub_t.decode_stepped = sub_d.decode_stepped = True
            sub_t.n_active = sub_d.n_active = len(pairs)
            sub_t.decode_depth_frac = sub_d.decode_depth_frac = 1.0
        for name, sub in ((self.draft_name, sub_d),
                          (self.target_name, sub_t)):
            rep.per_model[name] = sub
            _add_prefill(rep, sub)
        self.completed += rep.completed
        rep.wait_ms = tgt.wait_ms_total + drf.wait_ms_total - wait0
        rep.flush_wait_ms = (tgt.flush_wait_ms_total
                             + drf.flush_wait_ms_total - flush0)
        rep.host_ms = ((time.perf_counter() - t_poll) * 1e3 - rep.wait_ms
                       - rep.flush_wait_ms)
        return rep

    def spec_stats(self) -> Dict[str, float]:
        """Measured speculation: verify rounds, slot-rounds (request-round
        participations), committed tokens, and the acceptance length,
        committed tokens per slot-round: the factor by which a request's
        per-token round trips shrink on a cross-tier link."""
        tgt = self.pools[self.target_name]
        return {"k": float(self.k), "rounds": float(tgt.spec_rounds),
                "slot_rounds": float(self.slot_rounds),
                "committed": float(tgt.spec_committed),
                "acceptance_len": (tgt.spec_committed
                                   / max(1, self.slot_rounds))}
