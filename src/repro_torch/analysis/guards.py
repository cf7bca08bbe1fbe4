"""Runtime invariant guards for the port's serving stack.

All opt-in: tests and ``chip_smoke.py`` attach them; serving pays
nothing.

* :func:`no_recompile`: the scheduler / pool / cluster built at most
  ``bound`` new decode stages inside the block (``jit_cache_sizes()``
  deltas: the async window's CUDA-graph captures, its eager builds on the
  CPU, and the speculative stages), and every cache or arena tensor that
  a built window's graph holds kept its address, dtype and shape (the
  torch meaning of the reference's JXP004 / JXP005: a stage that rebinds
  a cache leaf, or widens it, breaks a captured graph without an error).
* :func:`guard_polling`: on the card every ``poll()`` runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so any synchronizing call
  inside it raises.  On the CPU nothing synchronizes, and it is a no-op.
* :func:`guard_sync_budget`: count the explicit readbacks each
  ``poll()`` makes and raise the moment one poll exceeds ``bound``.  The
  async pipeline's contract is at most one readback per window (the ring
  wait); a sync pool reads back every step.
* :class:`SlotAudit`: wraps ``poll()`` and re-checks the slot accounting
  after every round: free+staged+live slots partition the pool,
  positions and steps stay in range, block tables and the prefix tree
  account for every page reference, booking ledgers balance, and at
  completion the exit-counter histogram equals ``tokens_served`` and no
  migration is left undelivered.  Speculative pairs (standalone or the
  cluster's bridge) also get the pair invariants: after every verify
  round the draft shadow's position, pending token and steps equal its
  target slot's, finished targets leave no live shadow behind, and every
  live draft slot belongs to a tracked pair.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves
from repro_torch.serving.scheduler import ContinuousBatchScheduler
from repro_torch.serving.window import DecodeWindow, RingHandle


class GuardError(AssertionError):
    """A runtime invariant guard tripped."""


def _arenas(target: Any) -> Iterator[Tuple[str, ContinuousBatchScheduler]]:
    """``(prefix, arena)`` for every scheduler arena of a scheduler, a
    multi-model pool or a cluster (its tiers and speculative pairs)."""
    if isinstance(target, ContinuousBatchScheduler):
        yield "", target
    elif hasattr(target, "tiers"):
        for name, tr in target.tiers.items():
            for sub, arena in _arenas(tr.sched):
                yield f"{name}/{sub}" if sub else name, arena
        for m, pair in getattr(target, "_spec_pairs", {}).items():
            for sub, arena in _arenas(pair):
                yield f"spec:{m}/{sub}", arena
    elif hasattr(target, "pools"):
        for name, pool in target.pools.items():
            yield name, pool


# ---------------------------------------------------------------------------
# no_recompile: build counts and the captured graphs' tensors
# ---------------------------------------------------------------------------
def _flat_cache_sizes(target: Any) -> Dict[str, int]:
    """Flatten (possibly nested, e.g. cluster tier -> stage) cache-size
    dicts to ``"tier/stage" -> n``."""
    out: Dict[str, int] = {}

    def rec(prefix: str, d: Dict[str, Any]) -> None:
        for k, v in d.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                rec(key, v)
            else:
                out[key] = int(v)

    rec("", target.jit_cache_sizes())
    return out


def _held_tensors(target: Any) -> Dict[str, Tuple[int, torch.dtype,
                                                   Tuple[int, ...]]]:
    """``name -> (data_ptr, dtype, shape)`` of every tensor a built
    decode window reads or writes through a pointer it keeps: the arena's
    cache leaves, block table, exit counters and sampling key."""
    out = {}
    for prefix, s in _arenas(target):
        if s._window is None or not s._window.captures:
            continue
        named = [(f"cache[{i}]", t)
                 for i, t in enumerate(tree_leaves(s.cache))
                 if isinstance(t, torch.Tensor)]
        named += [("_counters", s._counters), ("_key_dev", s._key_dev)]
        if s.page_alloc is not None:
            named.append(("_tbl_buf", s._tbl_buf))
        for name, t in named:
            key = f"{prefix}/{name}" if prefix else name
            out[key] = (t.data_ptr(), t.dtype, tuple(t.shape))
    return out


@contextlib.contextmanager
def no_recompile(target: Any, *, bound: int = 0) -> Iterator[None]:
    """Assert ``target`` built at most ``bound`` new decode stages inside
    the block, and that no tensor a built window holds was rebound,
    re-typed or reshaped."""
    before = _flat_cache_sizes(target)
    held = _held_tensors(target)
    yield
    after = _flat_cache_sizes(target)
    grown: Dict[str, tuple] = {}
    total = 0
    for key, n_after in after.items():
        n_before = before.get(key, 0)
        delta = n_after - max(0, n_before)
        if delta > 0:
            grown[key] = (n_before, n_after)
            total += delta
    if total > bound:
        detail = ", ".join(f"{k}: {a}->{b}"
                           for k, (a, b) in sorted(grown.items()))
        raise GuardError(
            f"no_recompile(bound={bound}): {total} new stage build(s) inside "
            f"guarded block ({detail}): a fixed-shape stage was rebuilt")
    now = _held_tensors(target)
    moved = [f"{k}: {held[k][1]} {held[k][2]} at {held[k][0]:#x} -> "
             f"{now[k][1]} {now[k][2]} at {now[k][0]:#x}"
             for k in sorted(held) if k in now and now[k] != held[k]]
    if moved:
        raise GuardError(
            "no_recompile: a tensor a captured decode graph holds was "
            "rebound, re-typed or reshaped inside guarded block ("
            + "; ".join(moved) + "): the graph would read the old one")


# ---------------------------------------------------------------------------
# guard_polling: any synchronizing call inside poll() raises on the card
# ---------------------------------------------------------------------------
_ALLOWED = [0]          # > 0 inside _allow_syncs: the guards stand aside


@contextlib.contextmanager
def _allow_syncs() -> Iterator[None]:
    """Suspend guard_polling's sync debug mode and guard_sync_budget's
    count (the audit's own counter flush)."""
    _ALLOWED[0] += 1
    prev = torch.cuda.get_sync_debug_mode() \
        if torch.cuda.is_available() else 0
    if prev:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if prev:
            torch.cuda.set_sync_debug_mode(prev)
        _ALLOWED[0] -= 1


def _on_card(target: Any) -> bool:
    return any(s.device.type == "cuda" for _, s in _arenas(target))


@contextlib.contextmanager
def guard_polling(target: Any) -> Iterator[Any]:
    """Patch ``target.poll`` so every call runs under
    ``torch.cuda.set_sync_debug_mode("error")`` when the target's arenas
    are on the card: a synchronizing call inside the hot loop (``.cpu()``,
    ``.item()``, a pageable copy, ``torch.cuda.synchronize``) raises,
    while setup and teardown outside ``poll()`` stay unrestricted.  An
    async pool's decode polls pass: their one wait is the ring's event
    wait.  Start it after the first window's capture (a capture
    synchronizes the card).  On the CPU nothing synchronizes, so the
    guard wraps ``poll`` and checks nothing."""
    orig = target.poll
    on_card = _on_card(target)

    def guarded(*a: Any, **kw: Any):
        if not on_card:
            return orig(*a, **kw)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    target.poll = guarded
    try:
        yield target
    finally:
        target.poll = orig


# ---------------------------------------------------------------------------
# guard_sync_budget: explicit readbacks per poll
# ---------------------------------------------------------------------------
_MISSING = object()


def _readback_points() -> List[Tuple[Any, str]]:
    """(owner, attribute) of every readback primitive the budget counts:
    ``Tensor.cpu``, ``Tensor.item``, ``Tensor.tolist``,
    ``RingHandle.read``, ``torch.cuda.Event.synchronize``,
    ``torch.cuda.Stream.synchronize`` and ``torch.cuda.synchronize``."""
    return [(torch.Tensor, "cpu"), (torch.Tensor, "item"),
            (torch.Tensor, "tolist"), (RingHandle, "read"),
            (torch.cuda.Event, "synchronize"),
            (torch.cuda.Stream, "synchronize"), (torch.cuda, "synchronize")]


@contextlib.contextmanager
def guard_sync_budget(target: Any, *, bound: int = 1
                      ) -> Iterator[Dict[str, int]]:
    """Patch ``target.poll`` so each call counts its explicit readbacks
    and raise :class:`GuardError` the moment one poll exceeds ``bound``.

    A readback is one call of a primitive of ``_readback_points``; a call
    made inside another (``RingHandle.read``'s event wait) is the same
    readback, and a window's capture (``DecodeWindow.prepare``, which
    synchronizes the card once) is a build, not a readback.  So a poll
    counts the same on the CPU and on the card, and device-side work never
    counts.  A sync pool reads back once per decode step (plus a segmented
    step's probe reads); an async pool's decode poll reads one ring.  An
    exact counter read (``exit_stats``, a controller's update) is one
    more.  Attach it around the decode phase (admission and prefill done)
    for a tight bound.

    Yields a stats dict (``polls``, ``syncs``, ``max_per_poll``) that keeps
    updating while the guard is attached."""
    orig_poll = target.poll
    stats = {"polls": 0, "syncs": 0, "max_per_poll": 0}
    points = _readback_points() + [(DecodeWindow, "prepare")]

    def counted(*a: Any, **kw: Any):
        n = [0]
        depth = [0]
        saved = [(owner, attr, owner.__dict__.get(attr, _MISSING))
                 for owner, attr in points]

        def spy(fn, counts):
            def wrapper(*fa: Any, **fkw: Any):
                if counts and depth[0] == 0 and not _ALLOWED[0]:
                    n[0] += 1
                depth[0] += 1
                try:
                    return fn(*fa, **fkw)
                finally:
                    depth[0] -= 1
            return wrapper

        for owner, attr in points:
            setattr(owner, attr, spy(getattr(owner, attr),
                                     owner is not DecodeWindow))
        try:
            rep = orig_poll(*a, **kw)
        finally:
            for owner, attr, old in saved:
                if old is _MISSING:
                    delattr(owner, attr)
                else:
                    setattr(owner, attr, old)
        stats["polls"] += 1
        stats["syncs"] += n[0]
        stats["max_per_poll"] = max(stats["max_per_poll"], n[0])
        if n[0] > bound:
            raise GuardError(
                f"guard_sync_budget(bound={bound}): poll {stats['polls']} "
                f"performed {n[0]} device sync(s): the pipeline allows at "
                f"most {bound} per poll")
        return rep

    target.poll = counted
    try:
        yield stats
    finally:
        target.poll = orig_poll


# ---------------------------------------------------------------------------
# SlotAudit: slot accounting / booking-ledger invariants after every poll
# ---------------------------------------------------------------------------
class SlotAudit:
    """Re-checks pool invariants after every ``poll()``.

    ``SlotAudit(sched).attach()`` wraps the target's ``poll``; call
    ``detach()`` (or use as a context manager) to restore.  Works on a
    ``ContinuousBatchScheduler``, a ``MultiModelScheduler`` or
    ``SpecPair`` (audits every per-model arena), or a
    ``TieredServingCluster`` (audits every tier's pool plus the booking
    ledgers and migration queues).
    """

    def __init__(self, target: Any):
        self.target = target
        self.polls = 0
        self._orig_poll: Optional[Any] = None

    # -- lifecycle ----------------------------------------------------------
    def attach(self) -> "SlotAudit":
        assert self._orig_poll is None, "already attached"
        orig = self.target.poll

        def audited(*a: Any, **kw: Any):
            rep = orig(*a, **kw)
            self.check()
            return rep

        self._orig_poll = orig
        self.target.poll = audited
        return self

    def detach(self) -> None:
        if self._orig_poll is not None:
            self.target.poll = self._orig_poll
            self._orig_poll = None

    def __enter__(self) -> "SlotAudit":
        return self.attach()

    def __exit__(self, *exc: Any) -> None:
        self.detach()

    # -- checks -------------------------------------------------------------
    def check(self) -> None:
        self.polls += 1
        violations: List[str] = []
        t = self.target
        if hasattr(t, "tiers"):
            self._check_cluster(t, violations)
        elif hasattr(t, "pools"):
            for name, pool in t.pools.items():
                self._check_pool(pool, violations, prefix=f"pool {name}: ")
                if not t.has_work:
                    self._check_pool_idle(pool, violations,
                                          prefix=f"pool {name}: ")
            if hasattr(t, "draft_name"):   # SpecPair pair invariants
                self._check_spec_pair(t, violations)
        else:
            self._check_pool(t, violations)
            if not t.has_work:
                self._check_pool_idle(t, violations)
        if violations:
            raise GuardError(
                "slot audit failed after poll "
                f"{self.polls}:\n  " + "\n  ".join(violations))

    # one ContinuousBatchScheduler arena, between polls -----------------
    @staticmethod
    def _check_pool(s: Any, out: List[str], prefix: str = "") -> None:
        n = s.cfg.n_slots
        staged = set(s._pending.slots) if s._pending is not None else set()
        for i in range(n):
            booked = s.slot_req[i] is not None
            live = bool(s.active[i])
            if live and not booked:
                out.append(f"{prefix}slot {i} active without a request "
                           f"(free+active != slots)")
            if booked and not live and i not in staged:
                out.append(f"{prefix}slot {i} holds a request but is neither "
                           f"live nor staged for prefill (leaked slot)")
            if live and booked:
                r = s.slot_req[i]
                if not (0 <= s.positions[i] <= s.cfg.max_len):
                    out.append(f"{prefix}slot {i} position "
                               f"{int(s.positions[i])} outside "
                               f"[0, {s.cfg.max_len}]")
                if s.steps_taken[i] > r.max_new:
                    out.append(f"{prefix}slot {i} ran {int(s.steps_taken[i])} "
                               f"decode steps > max_new {r.max_new}")
        for r in s.completed:
            if not r.done:
                out.append(f"{prefix}completed request {r.req_id} not "
                           f"marked done")
        if getattr(s, "page_alloc", None) is not None:
            SlotAudit._check_pages(s, out, prefix)

    # paged arena: block tables + prefix tree partition the page pool ----
    @staticmethod
    def _check_pages(s: Any, out: List[str], prefix: str = "") -> None:
        alloc = s.page_alloc
        n_pages = alloc.n_pages
        staged = set(s._pending.slots) if s._pending is not None else set()
        refs = np.zeros(n_pages, np.int64)
        for i in range(s.cfg.n_slots):
            row = s._tbl[i]
            held = row[row < n_pages]
            if s.slot_req[i] is None and i not in staged:
                if held.size:
                    out.append(f"{prefix}freed slot {i} still maps "
                               f"{held.size} page(s) (page leak)")
                continue
            if np.unique(held).size != held.size:
                out.append(f"{prefix}slot {i} maps the same page twice "
                           f"(table corruption)")
            for pg in held:
                refs[int(pg)] += 1
        trie_pages = (s.prefix_cache.pages()
                      if s.prefix_cache is not None else {})
        for pg in trie_pages:
            refs[pg] += 1
        # 1) allocator refcounts == slot references + trie residency
        bad = np.nonzero(refs != alloc.refcount)[0]
        for pg in bad[:8]:
            out.append(f"{prefix}page {int(pg)} refcount "
                       f"{int(alloc.refcount[pg])} != {int(refs[pg])} "
                       f"observed owner(s) (refcount drift)")
        # 2) a page mapped by >1 slot must be prefix-shared (trie-resident):
        # otherwise two requests would write the same physical page
        multi = np.nonzero(refs > 1)[0]
        for pg in multi:
            slot_refs = int(refs[pg]) - (1 if int(pg) in trie_pages else 0)
            if slot_refs > 1 and int(pg) not in trie_pages:
                out.append(f"{prefix}page {int(pg)} shared by {slot_refs} "
                           f"slots without prefix-tree ownership (COW "
                           f"violation)")
        # 3) free list and referenced pages partition the pool exactly
        free = set(alloc._free)
        used = set(np.nonzero(refs)[0].tolist())
        both = free & used
        for pg in sorted(both)[:8]:
            out.append(f"{prefix}page {int(pg)} is simultaneously free and "
                       f"referenced")
        if len(free) + len(used) != n_pages or (free | used) != set(
                range(n_pages)):
            out.append(f"{prefix}page partition broken: {len(free)} free + "
                       f"{len(used)} referenced != {n_pages} pool pages")

    # …and once the pool is fully drained -------------------------------
    @staticmethod
    def _check_pool_idle(s: Any, out: List[str], prefix: str = "") -> None:
        if any(q is not None for q in s.slot_req):
            return                      # not actually idle (defensive)
        # the exit histogram must balance the served-token count exactly;
        # flushing reads the counters back, so it runs outside any sync
        # guard (the audit runs inside guard_polling's poll in tests)
        with _allow_syncs():
            counts = s.flush_counters()
        total = int(np.sum(counts))
        if total != s.tokens_served:
            out.append(f"{prefix}exit-counter histogram sums to {total} but "
                       f"tokens_served is {s.tokens_served} (alive-mask / "
                       f"counter drift)")

    # SpecPair: draft/target agreement + shadow-slot hygiene -------------
    @staticmethod
    def _check_spec_pair(p: Any, out: List[str], prefix: str = "") -> None:
        tgt = p.pools[p.target_name]
        drf = p.pools[p.draft_name]
        shadow_of = {}                 # draft slot -> req_id (live shadows)
        for rid, (req, shadow) in p._pairs.items():
            d_live = (shadow.slot >= 0 and drf.active[shadow.slot]
                      and drf.slot_req[shadow.slot] is shadow)
            if req.done:
                # a finished target must not leave a LIVE shadow behind:
                # its slot (and page refcounts) would leak until the pool
                # drains.  Staged-mid-prefill shadows are reaped later by
                # design and stay tracked in _pairs meanwhile.
                if d_live:
                    out.append(f"{prefix}request {rid} done but its draft "
                               f"shadow still holds live slot "
                               f"{shadow.slot} (orphaned draft slot)")
                continue
            if d_live:
                shadow_of[shadow.slot] = rid
            if not (d_live and req.slot >= 0 and tgt.active[req.slot]):
                continue               # pair not live in both arenas yet
            ts, ds = req.slot, shadow.slot
            # post-round resync contract: the draft mirrors the target's
            # commit state exactly before the next propose reads it
            if int(drf.positions[ds]) != int(tgt.positions[ts]):
                out.append(f"{prefix}pair {rid}: draft position "
                           f"{int(drf.positions[ds])} != target position "
                           f"{int(tgt.positions[ts])} (resync drift)")
            if int(drf.current_tok[ds]) != int(tgt.current_tok[ts]):
                out.append(f"{prefix}pair {rid}: draft pending token "
                           f"{int(drf.current_tok[ds])} != target's "
                           f"{int(tgt.current_tok[ts])} (resync drift)")
            if int(drf.steps_taken[ds]) != int(tgt.steps_taken[ts]):
                out.append(f"{prefix}pair {rid}: draft steps "
                           f"{int(drf.steps_taken[ds])} != target steps "
                           f"{int(tgt.steps_taken[ts])}")
        for i in range(drf.cfg.n_slots):
            r = drf.slot_req[i]
            if r is not None and drf.active[i] and r.req_id not in p._pairs:
                out.append(f"{prefix}draft slot {i} live for request "
                           f"{r.req_id} with no tracked pair (orphaned "
                           f"shadow)")

    # tiered cluster: bookings, ledgers, migration queues ----------------
    def _check_cluster(self, c: Any, out: List[str]) -> None:
        for name, tr in c.tiers.items():
            sched = tr.sched
            pools = sched.pools.values() if hasattr(sched, "pools") \
                else [sched]
            for p in pools:
                self._check_pool(p, out, prefix=f"tier {name}: ")
            for m, sa in tr.slot_avail.items():
                if len(sa) != len(tr.slot_released[m]):
                    out.append(f"tier {name}: slot_avail/{m} and "
                               f"slot_released/{m} ledgers diverged "
                               f"({len(sa)} vs {len(tr.slot_released[m])})")
        for m, pair in getattr(c, "_spec_pairs", {}).items():
            for name, p in pair.pools.items():
                self._check_pool(p, out, prefix=f"spec {m}/{name}: ")
            self._check_spec_pair(pair, out, prefix=f"spec {m}: ")
        for cr in c.requests:
            if cr.done and (cr.booked_slot >= 0 or cr.pf_booked_slot >= 0):
                out.append(f"request {cr.req.req_id} done but still holds a "
                           f"slot booking (ledger leak)")
            if cr.booked_slot >= 0 and cr.booked_tier:
                tr = c.tiers.get(cr.booked_tier)
                if tr is not None and not tr.dead:
                    sa = tr.slot_avail.get(cr.booked_model, [])
                    if not (0 <= cr.booked_slot < len(sa)):
                        out.append(f"request {cr.req.req_id} booked slot "
                                   f"{cr.booked_slot} outside tier "
                                   f"{cr.booked_tier}'s ledger")
        if not c.has_work:
            for cr in c.requests:
                if cr.booked_slot >= 0 or cr.pf_booked_slot >= 0:
                    out.append(f"idle cluster: request {cr.req.req_id} "
                               f"still holds a booking")
            exported = imported = 0
            for name, tr in c.tiers.items():
                if tr.inbound:
                    out.append(f"idle cluster: tier {name} has "
                               f"{len(tr.inbound)} undelivered inbound "
                               f"migration(s) (orphaned snapshots)")
                sched = tr.sched
                pools = sched.pools.values() if hasattr(sched, "pools") \
                    else [sched]
                for p in pools:
                    exported += p.n_exported
                    imported += p.n_imported
                    self._check_pool_idle(p, out, prefix=f"tier {name}: ")
            if exported != imported:
                out.append(f"idle cluster: {exported} slots exported but "
                           f"{imported} imported (orphaned snapshot)")
            if getattr(c, "_spec_waiting", None):
                out.append(f"idle cluster: {len(c._spec_waiting)} "
                           f"speculative request(s) stuck in the bridge "
                           f"admission queue")
            stuck = [cr for cr in getattr(c, "_spec_live", {}).values()
                     if not cr.done]
            if stuck:
                out.append(f"idle cluster: {len(stuck)} speculative "
                           f"request(s) live in the bridge but not done")
            for m, pair in getattr(c, "_spec_pairs", {}).items():
                for name, p in pair.pools.items():
                    self._check_pool_idle(p, out,
                                          prefix=f"spec {m}/{name}: ")
