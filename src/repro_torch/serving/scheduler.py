"""Continuous-batching serving scheduler: request queue + slot-based KV cache.

The port of the reference's single-model ``ContinuousBatchScheduler``:

* A FIFO request queue feeding a fixed pool of ``n_slots`` decode slots;
  per-slot position/length/state live on the host as numpy vectors.
* **Chunked prefill**: an admitted request's prompt is replayed through
  ``Model.decode_step`` ``prefill_chunk`` tokens per round;
  ``max_prefill_chunks_per_step`` caps the chunks one ``poll()`` runs so a
  long admission interleaves with in-flight decode.
* **Paged KV arena** (``paged=True``): attention caches are a global pool
  of ``page_size``-token pages addressed through per-slot block tables,
  with the radix prefix cache skipping prefill chunks whose pages are
  already resident.  The host block table is uploaded only when it
  changed.
* **Depth-segmented decode** (default): one decode step runs
  ``segment0 -> probe0 -> segment1 -> ... -> finalize``; each probe is the
  fused exit-head entropy kernel, slots whose normalized entropy clears the
  threshold stop being ``alive`` (hidden passthrough, no KV writes), and
  the host stops dispatching segments once no active slot is alive.
  ``segmented=False`` runs the monolithic ``decode_step`` instead.
* **Device exit counters**, read to the host only when asked:
  ``flush_counters()`` / ``exit_stats()`` / ``run()`` and the controller's
  update read them exactly, waiting for the device; no poll reads them
  otherwise, and ``exit_counts`` holds the last exact read.
  An optional ``controller`` (``serving/adaptive.py``) steers the exit
  threshold from the measured depth every ``adaptive_every`` served tokens.
* **State rows** (hybrid Mamba2 models): per-slot SSM and conv rows beside
  the paged pools, zeroed at admission, written only by live rows, and
  shipped whole by a migration; such arenas run without the prefix cache.
* **Encoder-decoder models** (whisper; contiguous arenas only): each
  request carries its encoder frames [Tenc, D]; admission runs them
  through the encoder into the admitted rows' cross-attention caches,
  which the merge copies into the arena's own tensors in place, and a
  migration ships them whole (their shape does not depend on
  ``max_len``).
* **Sampled decode** (``temperature > 0`` and an rng from ``set_rng`` or
  ``run(rng=)``; greedy otherwise): Gumbel-max draws from a counter-based
  hash of (key, tick, slot, token) (``serving/sampling.py``).
* **Async decode windows** (``async_decode``, monolithic only): decode runs
  as windows of ``readback_interval`` steps with token feedback and
  eos/max_new termination on the device (``serving/window.py``: one CUDA
  graph of one step replayed R times on the card); ``poll()`` dispatches
  window N+1 from the device carry before it reads window N's token ring
  back, and replays that ring through the sync commit rules.
* **Slot migration**: ``export_slot`` lifts one slot's serving state (cache
  rows truncated to the written prefix, or the slot's pages in paged
  arenas, plus position, pending token and request) out of the arena as a
  ``SlotSnapshot``; ``import_slot`` restores it into any same-model arena,
  even one with another slot count, and greedy decoding continues
  mid-flight with no prefill replay.  ``compress=True`` ships every float
  leaf as int8 rows with per-row fp32 scales through the
  ``kernels.ops.compress_rows`` / ``decompress_rows`` kernels.  This is the
  primitive behind the tiered cluster's prefill/decode splits and its
  failover when a tier dies.
* **Speculative stages** (``ensure_spec``, ``spec_propose``,
  ``spec_verify``; driven by ``serving/multipool.py: SpecPair``): a draft
  arena proposes a k-token window, a target arena verifies it, both as k
  write-gated monolithic ``decode_step`` calls with one readback a round.
  Rejected positions never write the cache.
* **Multi-model pools** (``serving/multipool.py``) run one of these arenas
  per model: ``Request.model`` names the arena, and
  ``poll(prefill_budget=)`` shares one prefill budget across them.
* **Spans and time counters**: while a ``torch.profiler`` collects, a poll
  opens the spans of ``serving/spans.py`` where its work happens
  (``poll``; ``admit`` > ``state_reset``; ``prefill`` >
  ``first_token``; ``dispatch`` >
  ``carry_load``, ``table_upload``, ``capture``, ``replay``,
  ``ring_copy``; ``readback``; ``commit`` > ``flush``; and ``sync``).
  Always on: each poll's wall time splits into ``host_ms`` (host work),
  ``wait_ms`` (blocked in a token or ring readback) and ``flush_wait_ms``
  (blocked in an exact counter read), summed in ``host_ms_total``,
  ``wait_ms_total`` and ``flush_wait_ms_total`` (with ``flushes``);
  ``device_ms_total`` adds each committed window's device time between
  its two events, and ``prefill_ms_total`` / ``prefill_tokens_total``
  count ``prefill_poll``'s wall time and replayed prompt tokens;
  ``state_resets`` counts the admitted slots whose recurrent state rows
  (Mamba2, xLSTM) were zeroed.  An eager decode step inside a profiler
  also opens the model's ``repro.model.<kind>`` spans, one a plan step
  (``models/common.py: step_span``).

Host/device traffic per sync decode step: one upload of (tokens,
positions, active), one upload of the block table when it changed (into
one persistent buffer), one read per exit probe (the intended
short-circuit), and one readback of the step's tokens.  An async window
uploads nothing when it chains from the carry (a fresh dispatch writes the
carry through pinned staging), and reads its [B, R] ring back once.  A
migration moves each exported leaf to the host once and back once.  A
speculation round uploads its inputs once and reads back once: the drafts
after a propose, the greedy tokens and accepted counts after a verify.

Typical use::

    sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
        n_slots=8, max_len=192, exit_threshold=0.6))
    for prompt in prompts:
        sched.submit(Request(tokens=prompt, max_new=32))
    sched.run()
    outs = [r.out_tokens for r in sched.completed]
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, FrozenSet, List, Optional

import numpy as np
import torch

from repro_torch.core.early_exit import exit_stats_dict, first_exit_index
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import PagedKV
from repro_torch.models.blocks import PAGED_KINDS
from repro_torch.models.common import resolve_device, tree_leaves, tree_map
from repro_torch.serving import sampling
from repro_torch.serving.paged import (PageAllocator, RadixPrefixCache,
                                       chunk_digests)
from repro_torch.serving.spans import span
from repro_torch.serving.window import DecodeWindow, RingHandle

FIRST_TICK = 1_000_003                 # tick base of first-token draws


@dataclasses.dataclass
class Request:
    """One serving request.  ``tokens`` is the prompt [S0] int;
    ``out_tokens`` is filled by the scheduler (the first token comes from
    the prompt's last logits)."""
    tokens: Any
    max_new: int = 32
    eos_id: Optional[int] = None
    frames: Any = None                 # [Tenc, D] for encdec (whisper) archs
    req_id: int = -1
    # model name in a multi-model pool ("" = the pool's default model); a
    # single-model scheduler ignores it
    model: str = ""
    # --- filled by the scheduler ---
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0               # the first token appended
    t_done: float = 0.0
    slot: int = -1
    done: bool = False
    # verify rounds this request took part in (SpecPair only)
    spec_rounds: int = 0


@dataclasses.dataclass
class SchedulerConfig:
    n_slots: int = 8
    max_len: int = 256                 # per-slot logical sequence capacity
    prefill_chunk: int = 16            # tokens per prefill round
    exit_threshold: float = 0.5
    temperature: float = 0.0           # 0 = greedy
    # ring caches at the model's long_context_window (contiguous arenas)
    long_mode: bool = False
    max_prefill_chunks_per_step: int = 0   # 0 = whole prompt in one poll
    segmented: bool = True
    # paged arena: a global pool of page_size-token pages through per-slot
    # block tables.  n_pages=0 sizes it to n_slots full rows (the
    # contiguous arena's bytes); a smaller pool admits more slots in the
    # same bytes, and admission waits while it is full.  prefix_cache
    # turns on the radix prefix tree, which stays off for models with
    # state rows (a skipped replay would leave their states unprimed)
    paged: bool = False
    page_size: int = 16
    n_pages: int = 0
    prefix_cache: bool = True
    # decode windows of readback_interval monolithic steps, read back once
    # each (serving/window.py); the segmented step's per-probe host
    # short-circuit would be a sync point inside a window
    async_decode: bool = False
    readback_interval: int = 8

    def __post_init__(self):
        if self.async_decode:
            if self.segmented:
                raise ValueError(
                    "async_decode requires segmented=False: the segment "
                    "pipeline's per-probe host short-circuit is a sync "
                    "point inside the zero-readback decode window")
            if self.readback_interval < 1:
                raise ValueError("readback_interval must be >= 1")


@dataclasses.dataclass
class StepReport:
    """What one ``poll()`` did."""
    admitted: List[Request] = dataclasses.field(default_factory=list)
    prefill_chunks: int = 0
    prefill_chunk_start: int = 0       # index of the first chunk advanced
    prefill_tokens: int = 0
    prefill_done: bool = False
    decode_stepped: bool = False
    n_active: int = 0
    decode_segments_run: int = 0
    decode_depth_frac: float = 0.0
    # decode steps committed this poll (a whole window's at an async
    # readback, 1 for a stepped sync poll) and windows dispatched: a
    # dispatch-only poll did device work though nothing committed yet
    decode_steps: int = 0
    decode_dispatched: int = 0
    # the poll's wall time split three ways: blocked in the token or ring
    # readback, blocked in an exact counter read, and host work
    host_ms: float = 0.0
    wait_ms: float = 0.0
    flush_wait_ms: float = 0.0
    tokens_in_flight: int = 0          # in dispatched, unread windows
    # speculative rounds (SpecPair): verify rounds, tokens they committed
    # and draft tokens proposed
    spec_rounds: int = 0
    spec_committed: int = 0
    spec_drafted: int = 0
    completed: List[Request] = dataclasses.field(default_factory=list)
    # multi-model pools: the per-model sub-reports behind this aggregate
    # (empty for a single-model scheduler)
    per_model: Dict[str, "StepReport"] = dataclasses.field(
        default_factory=dict)

    @property
    def worked(self) -> bool:
        return bool(self.admitted) or self.prefill_chunks > 0 \
            or self.decode_stepped or self.decode_dispatched > 0


@dataclasses.dataclass
class SlotSnapshot:
    """One slot's serving state, lifted out of an arena by ``export_slot``
    and restorable into any same-model arena by ``import_slot`` (the two
    arenas may have different slot counts: the payload is one slot's rows).

    ``payload`` holds the slot's cache leaves as host tensors, each leaf's
    time axis truncated to the written prefix (paged arenas: the page axis
    cut to the shipped pages ``[page_skip, page_used)``): the bytes a
    migration really ships.  With ``compressed`` the float leaves are int8
    rows and ``scales[i]`` their per-row fp32 scales (None for a leaf
    shipped raw).  ``payload_bytes`` is the size of exactly those tensors;
    the tiered cluster charges link time from it.

    Host-side request state rides along (position, pending token, decode
    steps taken, the live ``Request``); exit counts stay with the arena
    that served each token.  Greedy continuation after a raw import is
    exact.  Paged snapshots carry the slot's prompt-page digest chain:
    ``page_skip`` leading pages the destination already holds are borrowed
    from its prefix cache on import instead of crossing the link.
    """
    req: Request
    position: int
    current_tok: int
    steps_taken: int
    compressed: bool
    payload: List[Any]                # host tensors, time axes truncated
    scales: List[Optional[Any]]       # per-leaf fp32 scales (compressed)
    payload_bytes: int
    paged: bool = False
    page_skip: int = 0
    page_used: int = 0
    page_digests: List[Any] = dataclasses.field(default_factory=list)
    model: str = ""                   # the exporting request's model name


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class _InFlight:
    """A dispatched, unread decode window: its ring, the mask of slots in
    its chain, how many of them were alive at dispatch, and its sequence
    number (the ``seq`` of its dispatch, readback and commit spans)."""
    ring: RingHandle
    part: Any                          # np [n_slots] bool
    alive_hint: int
    seq: int = 0


@dataclasses.dataclass
class _PendingPrefill:
    """An admission whose chunked prompt replay is still in flight."""
    reqs: List[Request]
    slots: List[int]
    tokens: Any                        # np [n_slots, n_chunks*chunk] int32
    lengths: Any                       # np [n_slots] int32
    lengths_d: Any                     # device copy
    admit: Any                         # np [n_slots] bool
    cache: Any                         # private cache (contiguous arenas)
    last: Any                          # carried last-real-token logits
    next_chunk: int = 0
    n_chunks: int = 0
    start: Any = None                  # np [n_slots] replay start (paged)
    start_d: Any = None


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage that ``poll`` dispatches, described for the analyzer
    (``repro_torch.analysis``): ``fn(*make_args())`` runs it once on
    example inputs at the arena's own shapes, and ``batch`` is the rows
    one call decodes (the cost check's divisor to FLOPs per token)."""
    name: str
    fn: Callable[..., Any]
    make_args: Callable[[], tuple]
    batch: int


class ContinuousBatchScheduler:
    """Slot-based continuous batching over ``Model.decode_step``.

    Runs on the model's device (``device`` must match it; CUDA by default).
    The KV caches and the exit counters are updated in place.  An optional
    ``controller`` (``AdaptiveExitController``) is driven from the flushed
    counters every ``adaptive_every`` served tokens.
    """

    def __init__(self, model, params, cfg: SchedulerConfig = None,
                 device="cuda", controller=None):
        cfg = SchedulerConfig() if cfg is None else cfg
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"scheduler device {self.device} != model "
                             f"device {model.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.controller = controller
        self.adaptive_every = 64
        b = cfg.n_slots
        mcfg = model.cfg
        self._vocab = mcfg.vocab_size
        self._n_exits = model.n_exits

        self.page_alloc: Optional[PageAllocator] = None
        self.prefix_cache: Optional[RadixPrefixCache] = None
        self.prefix_hit_tokens = 0
        self.prefill_chunks_skipped = 0
        if cfg.paged:
            if mcfg.family == "encdec":
                raise ValueError("paged mode: encdec unsupported")
            if model._window(cfg.long_mode) != 0:
                raise ValueError("paged mode: ring-buffer windows unsupported")
            if cfg.page_size <= 0 or cfg.max_len % cfg.page_size:
                raise ValueError("paged mode: max_len must be a multiple of "
                                 "page_size")
            self._pps = cfg.max_len // cfg.page_size
            n_pages = cfg.n_pages or b * self._pps
            self.page_alloc = PageAllocator(n_pages, cfg.page_size)
            # a prefix hit skips replaying the shared pages: sound only if
            # they fully determine the skipped positions, i.e. every cache
            # leaf is pool-backed (no SSM or xLSTM state rows to prime)
            if cfg.prefix_cache and model.all_cache_paged():
                self.prefix_cache = RadixPrefixCache(self.page_alloc)
            # host block table, sentinel = n_pages; written into one
            # persistent device buffer when dirty (a decode window's graph
            # keeps its pointer)
            self._tbl = np.full((b, self._pps), n_pages, np.int32)
            self._tbl_buf = torch.empty((b, self._pps), dtype=torch.int32,
                                        device=self.device)
            self._tbl_dirty = True
            self._slot_digests: List[List[bytes]] = [[] for _ in range(b)]

        self.queue: deque = deque()
        self.completed: List[Request] = []
        self.positions = np.zeros(b, np.int64)     # next decode position
        self.active = np.zeros(b, bool)
        self.current_tok = np.zeros(b, np.int32)   # token each slot feeds next
        self.steps_taken = np.zeros(b, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.tokens_served = 0
        self.exit_counts = np.zeros(self._n_exits + 1, np.int64)
        self.depth_weighted_tokens = 0.0
        # served tokens and their depth since the controller last moved
        self._tokens_since_adapt = 0
        self._depth_since_adapt = 0.0
        self._last_segments_run = 0
        self._last_depth_frac = 0.0
        self._last_step_active = 0
        self.n_admitted = 0
        self.n_submitted = 0
        self._step_idx = 0
        self._pending: Optional[_PendingPrefill] = None
        # time accounting (``reset_stats`` zeroes the totals): a poll's
        # waits on readbacks and on the counter flush, so far this poll
        self._wait_s = 0.0
        self._flush_s = 0.0
        self.host_ms_total = 0.0           # polls' wall time less both waits
        self.wait_ms_total = 0.0           # blocked in token/ring readbacks
        self.flush_wait_ms_total = 0.0     # blocked in the counter flush
        self.flushes = 0
        self.device_ms_total = 0.0         # windows' device time (events)
        self.prefill_ms_total = 0.0        # wall time of prefill_poll
        self.prefill_tokens_total = 0      # prompt tokens it replayed
        self.state_resets = 0              # admitted slots' state rows zeroed
        # sampling: per-run tick counters, reset by set_rng / run() so the
        # same (requests, rng) reproduce the same samples
        self._rng: Optional[torch.Generator] = None
        self._rng_tick = 0
        self._admit_tick = 0
        # async decode: FIFO of dispatched, unread windows; the carry is
        # valid while host state equals the window's device carry
        # (admission, import and sync invalidate it)
        self._win_q: deque = deque()
        self._win_seq = 0                  # windows dispatched
        self._carry_valid = False
        self._window: Optional[DecodeWindow] = None
        self.peak_tokens_in_flight = 0
        # speculation (ensure_spec): the window width, fixed per arena;
        # verify-committed tokens count in the no-exit bucket on the host
        self._spec_k = 0
        self.spec_rounds = 0
        self.spec_committed = 0
        self._host_exit_extra = np.zeros(self._n_exits + 1, np.int64)

        dev = self.device
        self._counters = torch.zeros(self._n_exits + 1, dtype=torch.int32,
                                     device=dev)
        self._key_dev = torch.zeros(2, dtype=torch.int64, device=dev)
        # hashed (slot, token) counters of the sampling noise (shapes only)
        self._sample_ctr = None
        if cfg.temperature > 0.0:
            self._sample_ctr = sampling.counter_rows(
                torch.arange(b, dtype=torch.int64, device=dev), self._vocab)
        self._alive0 = torch.ones(b, dtype=torch.bool, device=dev)
        self._first_exit0 = torch.full((b,), self._n_exits,
                                       dtype=torch.int64, device=dev)
        self._segments = model.decode_segments
        self.stage_calls: Dict[str, int] = {}
        if cfg.segmented:
            for name in self._stage_names():
                self.stage_calls[name] = 0
        self.n_exported = 0
        self.n_imported = 0
        self._row_struct_flat, self._row_axes_flat = self._detect_row_layout()
        self.cache = self._init_cache()

    def _init_cache(self):
        cfg = self.cfg
        if cfg.paged:
            return self.model.init_decode_cache_paged(
                cfg.n_slots, self.page_alloc.n_pages, cfg.page_size)
        return self.model.init_decode_cache(cfg.n_slots, cfg.max_len,
                                            long_mode=cfg.long_mode)

    def _stage_names(self) -> List[str]:
        names = []
        for seg in self._segments:
            names.append(f"segment{seg.index}")
            if seg.exit_index is not None:
                names.append(f"probe{seg.exit_index}")
        names.append("finalize")
        return names

    def _threshold(self) -> float:
        """The exit threshold of the next step: the controller's, if one
        is set."""
        if self.controller is not None:
            return self.controller.threshold
        return self.cfg.exit_threshold

    def _upload(self, arr: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _put(self, dst, arr):
        """Write a host array into the persistent device buffer ``dst`` in
        place.  On the card the bytes go through pinned staging with a
        ``non_blocking`` copy, which does not wait for the stream (a
        pageable copy would wait for every window in flight); the caching
        host allocator keeps the staging block until the copy has run."""
        src = torch.from_numpy(np.ascontiguousarray(arr)).to(dst.dtype)
        if dst.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _tbl_dev(self):
        """The device block table, rewritten in place only when a host-side
        allocation or release changed it."""
        if self._tbl_dirty:
            with span("table_upload"):
                self._put(self._tbl_buf, self._tbl)
            self._tbl_dirty = False
        return self._tbl_buf

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        toks = np.asarray(req.tokens).reshape(-1)
        if toks.size < 1 or req.max_new < 1:
            raise ValueError("empty prompt or max_new < 1")
        if toks.size + req.max_new > self.cfg.max_len:
            raise ValueError(f"prompt {toks.size} + max_new {req.max_new} "
                             f"exceeds max_len {self.cfg.max_len}")
        if self.model.cfg.family == "encdec" and req.frames is None:
            raise ValueError("encdec request needs frames")
        req.tokens = toks.astype(np.int32)
        if req.req_id < 0:
            req.req_id = self.n_submitted
        req.t_submit = time.time()
        self.n_submitted += 1
        self.queue.append(req)

    def set_rng(self, rng: Optional[torch.Generator]):
        """Install a sampling generator (None = greedy) and reset the tick
        counters, so the same (requests, generator seed) reproduce the same
        samples.  One 64-bit key is drawn from ``rng``; with
        ``temperature > 0`` every draw hashes it with its tick."""
        self._rng = rng
        self._rng_tick = 0
        self._admit_tick = 0
        if rng is not None:
            self._put(self._key_dev, np.asarray(sampling.draw_key(rng),
                                                np.int64))

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any()) \
            or self._pending is not None

    def tick(self) -> bool:
        """One admission/prefill/decode round; False = idle."""
        return self.poll().worked

    def poll(self, prefill_budget: Optional[int] = None) -> StepReport:
        """One scheduler round: begin an admission if slots are free,
        advance at most ``max_prefill_chunks_per_step`` prefill chunks, then
        run one pool decode step.  ``prefill_budget`` overrides that cap for
        this poll (0 runs no chunk; a multi-model pool shares one budget
        across its arenas this way).  With ``async_decode`` the decode half
        is the window pipeline (``_poll_async``)."""
        with span("poll"):
            if self.cfg.async_decode:
                return self._poll_async(prefill_budget)
            return self._poll_sync(prefill_budget)

    def _poll_sync(self, prefill_budget: Optional[int]) -> StepReport:
        """One sync round: ``prefill_poll``, then one ``step()``."""
        t_poll = time.perf_counter()
        self._wait_s = self._flush_s = 0.0
        rep = self.prefill_poll(prefill_budget)
        done_before = len(self.completed)
        rep.decode_stepped = self.step()
        rep.decode_steps = 1 if rep.decode_stepped else 0
        rep.n_active = self._last_step_active
        if rep.decode_stepped:
            rep.decode_segments_run = self._last_segments_run
            rep.decode_depth_frac = self._last_depth_frac
        rep.completed += self.completed[done_before:]
        self._split_time(rep, t_poll)
        return rep

    def _split_time(self, rep: StepReport, t_poll: float):
        """Split the poll's wall time since ``t_poll``: its waits on
        readbacks and on exact counter reads, and host work, the rest."""
        rep.wait_ms = self._wait_s * 1e3
        rep.flush_wait_ms = self._flush_s * 1e3
        rep.host_ms = ((time.perf_counter() - t_poll) * 1e3 - rep.wait_ms
                       - rep.flush_wait_ms)
        self.host_ms_total += rep.host_ms

    def prefill_poll(self, prefill_budget: Optional[int] = None
                     ) -> StepReport:
        """Admission + chunked prefill only, no decode step (SpecPair
        drives its arenas' admissions through this).  ``prefill_budget``
        as in ``poll``.  Its wall time counts in ``prefill_ms_total`` and
        the prompt tokens it replays in ``prefill_tokens_total``, whether
        ``poll`` or a caller runs it."""
        t0 = time.perf_counter()
        rep = StepReport()
        done_before = len(self.completed)
        if self._pending is None and self.queue:
            with span("admit"):
                rep.admitted = self._begin_admit()
        if self._pending is not None and (prefill_budget is None
                                          or prefill_budget > 0):
            cap = self.cfg.max_prefill_chunks_per_step \
                if prefill_budget is None else prefill_budget
            with span("prefill"):
                self._advance_prefill(cap, rep)
        rep.completed = self.completed[done_before:]
        self.prefill_tokens_total += rep.prefill_tokens
        self.prefill_ms_total += (time.perf_counter() - t0) * 1e3
        return rep

    def run(self, rng: Optional[torch.Generator] = None):
        """Drain the queue and all slots to completion; greedy unless an
        ``rng`` is given (and ``temperature > 0``)."""
        self.set_rng(rng)
        while self.has_work:
            if not self.poll().worked:  # pragma: no cover - defensive
                break
        self.flush_counters()

    # ------------------------------------------------------------------
    # admission: chunked prefill into freed slots
    # ------------------------------------------------------------------
    def _reserve_pages(self, slot: int, r: Request) -> Optional[int]:
        """Paged admission: reserve the slot's whole page budget (prompt +
        max_new), borrowing shared prefix pages from the radix tree first.
        Returns the replay start token, or None when the pool cannot fit
        the request (the caller defers it, head-of-line)."""
        P = self.page_alloc.page_size
        plen = r.tokens.size
        total = -(-(plen + r.max_new) // P)
        digests = chunk_digests(r.tokens, P)
        shared: List[int] = []
        if self.prefix_cache is not None:
            # the last prompt token always replays, so its logits are real
            shared = self.prefix_cache.match(digests[:(plen - 1) // P],
                                             r.tokens)
        need = total - len(shared)
        if self.page_alloc.free_count < need and self.prefix_cache is not None:
            self.prefix_cache.evict_until(need)
        if self.page_alloc.free_count < need:
            for pg in shared:
                self.page_alloc.release(pg)
            return None
        row = shared + self.page_alloc.alloc(need)
        self._tbl[slot, :total] = row
        self._tbl[slot, total:] = self.page_alloc.n_pages
        self._tbl_dirty = True
        self._slot_digests[slot] = digests
        self.prefix_hit_tokens += len(shared) * P
        return len(shared) * P

    def _begin_admit(self) -> List[Request]:
        """Reserve free slots for queued requests and stage their prompts
        as a pending chunked prefill (paged arenas prefill straight into
        their reserved pages; contiguous ones into a private cache)."""
        free = [i for i in range(self.cfg.n_slots) if self.slot_req[i] is None]
        if not free or not self.queue:
            return []
        take: List[int] = []
        reqs: List[Request] = []
        starts: Dict[int, int] = {}
        for slot in free:
            if not self.queue:
                break
            r = self.queue[0]
            if self.page_alloc is not None:
                st = self._reserve_pages(slot, r)
                if st is None:
                    break              # pool full: defer, keep FIFO order
                starts[slot] = st
            self.queue.popleft()
            take.append(slot)
            reqs.append(r)
        if not reqs:
            return []
        b, chunk = self.cfg.n_slots, self.cfg.prefill_chunk
        n_chunks = -(-max(r.tokens.size for r in reqs) // chunk)
        tokens = np.zeros((b, n_chunks * chunk), np.int32)
        lengths = np.zeros(b, np.int32)
        admit = np.zeros(b, bool)
        start = np.zeros(b, np.int32)
        now = time.time()
        for slot, r in zip(take, reqs):
            tokens[slot, : r.tokens.size] = r.tokens
            lengths[slot] = r.tokens.size
            admit[slot] = True
            start[slot] = starts.get(slot, 0)
            r.slot, r.t_admit = slot, now
            self.slot_req[slot] = r
        if self.page_alloc is not None:
            fresh = None               # paged prefill writes the pool itself
            with span("state_reset"):
                self._reset_states(take)
        else:
            fresh = self._init_cache()
            if self.model.cfg.family == "encdec":
                self._prime_cross(fresh, take, reqs)
        self._pending = _PendingPrefill(
            reqs=reqs, slots=take, tokens=tokens, lengths=lengths,
            lengths_d=self._upload(lengths), admit=admit, cache=fresh,
            last=torch.zeros((b, self._vocab), dtype=torch.float32,
                             device=self.device),
            n_chunks=n_chunks, start=start, start_d=self._upload(start))
        return reqs

    def _prime_cross(self, cache, slots: List[int], reqs: List[Request]):
        """Encdec admission: the admitted rows' frames (zeros in the other
        rows, as the reference) through the encoder into ``cache``'s cross
        rows.  ``cache`` is the admission's private cache; the merge at
        the end of the prefill copies the admitted rows into the arena's
        own tensors in place, which a captured decode window reads."""
        from repro_torch.serving.engine import prime_whisper_cross_cache
        mcfg = self.model.cfg
        frames = torch.zeros((self.cfg.n_slots, mcfg.encdec.encoder_seq_len,
                              mcfg.d_model), dtype=torch.bfloat16,
                             device=self.device)
        for slot, r in zip(slots, reqs):
            f = r.frames
            if not isinstance(f, torch.Tensor):
                f = torch.from_numpy(np.asarray(f, np.float32))
            frames[slot] = f.to(self.device).to(torch.bfloat16)
        prime_whisper_cross_cache(self.model, self.params, cache, frames)

    def _reset_states(self, slots: List[int]):
        """Zero the state rows (batch axis 1 of a stacked block) of the
        admitted ``slots``, in place: a paged arena prefills in place,
        and a slot's rows would otherwise carry its previous occupant's
        final state (every state initializer is zeros).  Pool leaves are
        fresh pages and need nothing."""
        kinds = self.model.scan_block_kinds()
        if all(k in PAGED_KINDS for k in kinds):
            return
        self.state_resets += len(slots)
        idx = self._upload(np.asarray(slots, np.int64))
        for kind, c in zip(kinds, self.cache["blocks"]):
            if kind not in PAGED_KINDS:
                tree_map(lambda a: a.index_fill_(1, idx, 0), c)

    def _prefill_chunk(self, p: _PendingPrefill, lo: int, hi: int):
        """Replay prompt tokens [lo, hi) of every row: a row writes its
        cache only while start <= t < length, and the logits of its last
        real token are carried in ``p.last``."""
        model = self.model
        toks = self._upload(p.tokens[:, lo:hi]).long()
        t_dev = torch.arange(lo, hi, device=self.device)
        paged = self.page_alloc is not None
        cache = self.cache if paged else p.cache
        lm = self.cfg.long_mode
        for i in range(hi - lo):
            t = t_dev[i]
            act = (t < p.lengths_d) & (t >= p.start_d)
            if paged:
                logits, _, _ = model.decode_step(
                    self.params, cache, toks[:, i:i + 1], t, long_mode=lm,
                    paged=PagedKV(self._tbl_dev(), act))
            else:
                logits, _, _ = model.decode_step(
                    self.params, cache, toks[:, i:i + 1], t, long_mode=lm,
                    write_mask=act)
            p.last = torch.where((t == p.lengths_d - 1)[:, None], logits,
                                 p.last)

    def _chunk_skippable(self, p: _PendingPrefill, lo: int, hi: int) -> bool:
        """A chunk is skipped when no admitted row has a token to replay
        in [lo, hi): prefix-cache resident (start >= hi) or past the
        prompt (length <= lo)."""
        rows = p.admit
        return bool(np.all((p.start[rows] >= hi) | (p.lengths[rows] <= lo)))

    def _advance_prefill(self, max_chunks: int, rep: StepReport):
        """Run up to ``max_chunks`` pending prefill chunks (<= 0 = all);
        when the last one lands, merge the rows into the pool (contiguous
        arenas), publish prompt pages to the prefix tree, and go live."""
        p = self._pending
        chunk = self.cfg.prefill_chunk
        paged = self.page_alloc is not None
        rep.prefill_chunk_start = p.next_chunk
        budget = max_chunks if max_chunks > 0 else p.n_chunks
        ci = p.next_chunk
        while ci < p.n_chunks and budget > 0:
            lo, hi = ci * chunk, (ci + 1) * chunk
            if paged and self._chunk_skippable(p, lo, hi):
                self.prefill_chunks_skipped += 1
                ci += 1
                continue
            self._prefill_chunk(p, lo, hi)
            rep.prefill_tokens += int(np.sum(np.clip(
                np.minimum(p.lengths, hi) - np.maximum(p.start, lo), 0,
                None)))
            rep.prefill_chunks += 1
            budget -= 1
            ci += 1
        p.next_chunk = ci
        if p.next_chunk < p.n_chunks:
            return
        if not paged:
            self.cache = self.model.merge_decode_cache(
                self._upload(p.admit), p.cache, self.cache)
        if self.prefix_cache is not None:
            for slot, r in zip(p.slots, p.reqs):
                n_full = r.tokens.size // self.page_alloc.page_size
                if n_full:
                    self.prefix_cache.insert(
                        self._slot_digests[slot][:n_full], r.tokens,
                        [int(pg) for pg in self._tbl[slot, :n_full]])
        with span("first_token"):
            first = self._first_tokens(p)          # one readback
        now = time.time()
        for slot, r in zip(p.slots, p.reqs):
            tok0 = int(first[slot])
            r.out_tokens.append(tok0)
            r.t_first = now
            self.positions[slot] = p.lengths[slot]
            self.current_tok[slot] = tok0
            self.steps_taken[slot] = 0
            self.active[slot] = True
            self.n_admitted += 1
            if r.eos_id is not None and tok0 == r.eos_id:
                self._finish(slot)
        self._pending = None
        rep.prefill_done = True
        # new live slots: the next decode window must be a fresh dispatch
        self._carry_valid = False

    def _sampling(self) -> bool:
        """Sampled decode needs both temperature > 0 and a generator."""
        return self.cfg.temperature > 0.0 and self._rng is not None

    def _first_tokens(self, p: _PendingPrefill) -> np.ndarray:
        """Each admitted row's first token from its last prompt logits:
        greedy, or (sampling) a draw at tick ``FIRST_TICK + admit_tick``,
        one tick per admitted request in slot order, as the reference's
        ``_sample_first``.  Returns [n_slots] (rows not admitted: 0)."""
        if not self._sampling():
            return torch.argmax(p.last, dim=-1).cpu().numpy()
        ticks = []
        for _ in p.slots:
            self._admit_tick += 1
            ticks.append(FIRST_TICK + self._admit_tick)
        rows = self._upload(np.asarray(p.slots, np.int64))
        tok = sampling.sample_rows(
            p.last.index_select(0, rows), self.cfg.temperature,
            self._key_dev, self._upload(np.asarray(ticks, np.int64)))
        first = np.zeros(self.cfg.n_slots, np.int64)
        first[p.slots] = tok.cpu().numpy()
        return first

    # ------------------------------------------------------------------
    # decode: one fixed-shape step over the whole pool
    # ------------------------------------------------------------------
    def _count_exits(self, logits, first_exit, active, tick=None):
        """Greedy tokens, the sampled draw at ``tick`` (None: no draw) and
        the first-exit histogram update, shared by the monolithic step, the
        segmented finalize and the decode window."""
        greedy = torch.argmax(logits, dim=-1)
        sampled = None
        if tick is not None:
            sampled = sampling.sample(logits, self.cfg.temperature,
                                      self._key_dev, tick, self._sample_ctr)
        hist = torch.nn.functional.one_hot(first_exit, self._n_exits + 1)
        self._counters += torch.sum(hist * active[:, None], dim=0,
                                    dtype=torch.int32)
        return greedy, sampled

    def _step_tick(self):
        """The sync step's draw tick on the device (None: greedy)."""
        if not self._sampling():
            return None
        return torch.full((1,), self._rng_tick, dtype=torch.int64,
                          device=self.device)

    def _probe(self, exit_index: int, x, alive, first_exit, thr: float):
        """Exit decision after a segment: fused entropy (no [B,V] logits),
        normalized by log(V)."""
        ent = self.model.exit_probe_entropy(self.params, exit_index, x)
        hit = alive & (ent / float(np.log(float(self._vocab))) < thr)
        return alive & ~hit, first_exit.masked_fill(hit, exit_index)

    def _step_segmented(self, tokens, positions, active_d, thr, tick):
        """One decode step through the segment pipeline: run a segment,
        probe its exit head, drop exited slots from ``alive``, and stop
        once no *active* slot is alive (the host short-circuit where early
        exits save compute).  ``alive`` starts all-true: inactive rows
        compute garbage as in the monolithic step; counters are masked by
        ``active`` and the short-circuit consults active rows only."""
        model = self.model
        alive = self._alive0
        first_exit = self._first_exit0
        x = emb = model.embed_decode_tokens(self.params, tokens)
        layers_run = segs_run = 0
        probing = thr > 0.0            # normalized entropy >= 0: no exits
        for seg in self._segments:
            x = self._segment(seg, x, positions, alive, active_d, emb)
            self.stage_calls[f"segment{seg.index}"] += 1
            layers_run += seg.layers
            segs_run += 1
            if seg.exit_index is None or not probing:
                continue
            alive, first_exit = self._probe(seg.exit_index, x, alive,
                                            first_exit, thr)
            self.stage_calls[f"probe{seg.exit_index}"] += 1
            # the intended per-probe read: stop once every active slot exited
            if not bool((alive & active_d).any().cpu()):
                break
        self.stage_calls["finalize"] += 1
        self._last_segments_run = segs_run
        self._last_depth_frac = layers_run / max(1, model.cfg.num_layers)
        return self._finalize(x, first_exit, active_d, tick)

    def _segment(self, seg, x, positions, alive, active_d, emb=None):
        """One depth segment over the arena's cache; returns the hidden
        state.  ``emb``: the step's token embeddings (Zamba2's sites read
        them)."""
        model, lm = self.model, self.cfg.long_mode
        if self.page_alloc is not None:
            # writes gate on alive & active (stale slots own no pages), but
            # the hidden passthrough keeps the plain alive mask: every
            # row's compute must match the reference's, because MoE expert
            # capacity couples batch rows (a changed garbage row could
            # evict a live row's token from an expert queue)
            wm = alive & active_d
            x, self.cache = model.decode_segment(
                self.params, self.cache, x, seg, positions, wm,
                long_mode=lm, paged=PagedKV(self._tbl_dev(), wm),
                passthrough=alive, emb=emb)
        else:
            x, self.cache = model.decode_segment(
                self.params, self.cache, x, seg, positions, alive,
                long_mode=lm, emb=emb)
        return x

    def _finalize(self, x, first_exit, active_d, tick):
        """The final norm and LM head, then ``_count_exits``."""
        logits = self.model.finalize_decode(self.params, x)
        return self._count_exits(logits, first_exit, active_d, tick)

    def _step_monolithic(self, tokens, positions, active_d, thr, tick):
        paged = (PagedKV(self._tbl_dev(), active_d)
                 if self.page_alloc is not None else None)
        logits, ee, self.cache = self.model.decode_step(
            self.params, self.cache, tokens, positions,
            long_mode=self.cfg.long_mode, paged=paged)
        if self._n_exits:
            idx = first_exit_index(ee, thr, self._vocab)
        else:
            idx = torch.zeros(tokens.shape[0], dtype=torch.int64,
                              device=self.device)
        self._last_segments_run = len(self._segments)
        self._last_depth_frac = 1.0
        return self._count_exits(logits, idx, active_d, tick)

    def step(self) -> bool:
        if self._win_q:
            raise RuntimeError("step(): async decode windows in flight - "
                               "sync() first")
        self._last_step_active = int(self.active.sum())
        if not self.active.any():
            return False
        thr = self._threshold()
        tick = self._step_tick()
        host = np.stack([self.current_tok.astype(np.int64), self.positions,
                         self.active.astype(np.int64)])
        dev = self._upload(host)                   # one upload per step
        tokens = dev[0][:, None]
        positions = dev[1].to(torch.int32)
        active_d = dev[2].bool()
        step = (self._step_segmented if self.cfg.segmented
                else self._step_monolithic)
        greedy, sampled = step(tokens, positions, active_d, thr, tick)
        t0 = time.perf_counter()
        nxt = (greedy if sampled is None else sampled).cpu().numpy()
        wait = time.perf_counter() - t0            # one readback per step
        self._wait_s += wait
        self.wait_ms_total += wait * 1e3
        self._step_idx += 1
        self._rng_tick += 1
        n_active = int(self.active.sum())
        self.tokens_served += n_active
        self._tokens_since_adapt += n_active
        self.depth_weighted_tokens += self._last_depth_frac * n_active
        self._depth_since_adapt += self._last_depth_frac * n_active
        for slot in np.nonzero(self.active)[0]:
            r = self.slot_req[slot]
            self.steps_taken[slot] += 1
            self.positions[slot] += 1
            if self.steps_taken[slot] >= r.max_new:
                self._finish(slot)      # the trailing sample is discarded
                continue
            tok = int(nxt[slot])
            r.out_tokens.append(tok)
            self.current_tok[slot] = tok
            if r.eos_id is not None and tok == r.eos_id:
                self._finish(slot)
        self._maybe_flush()
        return True

    # ------------------------------------------------------------------
    # async decode (cfg.async_decode): the double-buffered window pipeline
    # ------------------------------------------------------------------
    def _poll_async(self, prefill_budget: Optional[int] = None
                    ) -> StepReport:
        """One overlapped round: admission and prefill as usual, then, if
        a window is in flight, dispatch window N+1 from the device carry
        before blocking on window N's ring (the card computes N+1 while
        the host commits N), else dispatch a fresh window from host state.
        One ring readback per committed window."""
        t_poll = time.perf_counter()
        self._wait_s = self._flush_s = 0.0
        rep = self.prefill_poll(prefill_budget)
        done_before = len(self.completed)
        if self._win_q:
            if self._carry_valid:
                self._dispatch_window(from_carry=True)
                rep.decode_dispatched += 1
            win = self._win_q.popleft()
            ring = self._read_ring(win)
            with span("commit", win.seq):
                self._commit_window(ring, win.part, rep)
        elif self.active.any():
            self._dispatch_window(from_carry=False)
            rep.decode_dispatched += 1
        rep.completed += self.completed[done_before:]
        rep.tokens_in_flight = self.tokens_in_flight
        self.peak_tokens_in_flight = max(self.peak_tokens_in_flight,
                                         rep.tokens_in_flight)
        self._split_time(rep, t_poll)
        return rep

    def _read_ring(self, win: _InFlight) -> np.ndarray:
        """The one readback of a window: wait for its ring copy.  The
        window's device time (between its events, both passed now) adds
        to ``device_ms_total``."""
        with span("readback", win.seq):
            t0 = time.perf_counter()
            ring = win.ring.read()
            wait = time.perf_counter() - t0
        self._wait_s += wait
        self.wait_ms_total += wait * 1e3
        self.device_ms_total += win.ring.device_ms()
        return ring

    def _eos_host(self) -> np.ndarray:
        """Per-slot eos for the window (-1 = none: token ids are
        non-negative, so the device compare never fires)."""
        eos = np.full(self.cfg.n_slots, -1, np.int64)
        for slot in np.nonzero(self.active)[0]:
            r = self.slot_req[slot]
            if r.eos_id is not None:
                eos[slot] = r.eos_id
        return eos

    @property
    def tokens_in_flight(self) -> int:
        """Upper bound on tokens inside dispatched, unread windows (slots
        alive at dispatch x window length, per queued window)."""
        return sum(w.alive_hint * self.cfg.readback_interval
                   for w in self._win_q)

    def _dispatch_window(self, *, from_carry: bool):
        """Enqueue the next decode window (``_enqueue_window``) inside its
        ``dispatch`` span, which carries the window's sequence number."""
        self._win_seq += 1
        with span("dispatch", self._win_seq):
            self._enqueue_window(from_carry)

    def _enqueue_window(self, from_carry: bool):
        """Enqueue one decode window.  ``from_carry`` chains the previous
        window's device carry (cur, pos, alive, budget): nothing is
        uploaded, the chain and its slot mask stay the same.  A fresh
        dispatch writes host state into the carry and opens a chain whose
        mask snapshots ``active`` (slots admitted later join at the next
        fresh dispatch, never mid-chain).  The block table is rewritten
        only when it changed; the stream orders that write after every
        window already enqueued."""
        w = self._window
        if w is None:
            w = self._window = DecodeWindow(self)
        w.set_threshold(self._threshold())
        if self.page_alloc is not None:
            self._tbl_dev()
        if from_carry:
            if not (self._carry_valid and self._win_q):
                raise RuntimeError("no valid decode carry to chain from")
            part = self._win_q[-1].part
        else:
            budget = np.zeros(self.cfg.n_slots, np.int64)
            for slot in np.nonzero(self.active)[0]:
                budget[slot] = (self.slot_req[slot].max_new
                                - self.steps_taken[slot])
            host = (self.current_tok, self.positions, self.active, budget,
                    self._eos_host(), self._rng_tick, self._rng is not None)
            with span("carry_load"):
                w.load(*host)
            if w.needs_build():
                with span("capture"):
                    w.prepare()
                    w.load(*host)      # the warm-up froze every row
            part = self.active.copy()
        ring = w.run()
        self._carry_valid = True
        self._rng_tick += self.cfg.readback_interval
        self._win_q.append(_InFlight(ring, part,
                                     int((self.active & part).sum()),
                                     self._win_seq))

    def _commit_window(self, ring: np.ndarray, part: np.ndarray,
                       rep: StepReport):
        """Replay one window's token ring through the sync commit rules of
        ``step()`` (same order, the same max_new trailing-sample discard,
        the same eos handling), so host state after the replay equals R
        sync polls'.  ``part`` masks the replay to the window's chain:
        slots admitted while it was in flight have no ring tokens.

        A chain whose slots all finished leaves any queued successor
        window dead (no live row: no counts, no page writes): it is
        dropped, and the carry with it, without a readback."""
        R = self.cfg.readback_interval
        replayed = 0
        for j in range(R):
            mask = self.active & part
            if not mask.any():
                break
            n_active = int(mask.sum())
            self.tokens_served += n_active
            self._tokens_since_adapt += n_active
            self.depth_weighted_tokens += 1.0 * n_active
            self._depth_since_adapt += 1.0 * n_active
            rep.n_active = n_active
            for slot in np.nonzero(mask)[0]:
                r = self.slot_req[slot]
                self.steps_taken[slot] += 1
                self.positions[slot] += 1
                if self.steps_taken[slot] >= r.max_new:
                    self._finish(slot)  # trailing sample discarded; the
                    part[slot] = False  # slot leaves the chain for good
                    continue
                tok = int(ring[slot, j])
                r.out_tokens.append(tok)
                self.current_tok[slot] = tok
                if r.eos_id is not None and tok == r.eos_id:
                    self._finish(slot)
                    part[slot] = False
            self._step_idx += 1
            replayed += 1
        if replayed:
            self._last_segments_run = len(self._segments)
            self._last_depth_frac = 1.0
            rep.decode_stepped = True
            rep.decode_steps += replayed
            rep.decode_segments_run = self._last_segments_run
            rep.decode_depth_frac = self._last_depth_frac
        if not (self.active & part).any():
            self._win_q.clear()
            self._carry_valid = False
        self._maybe_flush()

    def sync(self) -> List[Request]:
        """Drain the pipeline: read back and commit every window in
        flight and invalidate the carry.  Returns the requests the drain
        completed (no later ``poll()`` reports them).  No-op on sync
        schedulers; ``export_slot``, ``release_slot`` and ``step()`` need
        it first, and ``reset_stats`` runs it."""
        n0 = len(self.completed)
        with span("sync"):
            while self._win_q:
                win = self._win_q.popleft()
                if not (self.active & win.part).any():
                    continue            # dead chain: no readback needed
                ring = self._read_ring(win)
                with span("commit", win.seq):
                    self._commit_window(ring, win.part, StepReport())
        self._carry_valid = False
        return self.completed[n0:]

    # ------------------------------------------------------------------
    # speculative decoding stages (serving/multipool.py: SpecPair): a draft
    # arena proposes a k-token window, a target arena verifies it.  Both
    # are k monolithic decode_step calls whose cache writes are gated by
    # ``act`` inside the step, so positions that end up rejected are never
    # written: no rollback pass, valid for paged and contiguous arenas.
    # ------------------------------------------------------------------
    def ensure_spec(self, k: int):
        """Fix the speculation window width ``k`` (a shape: tokens are
        [B, k]) for this arena."""
        if self.cfg.async_decode:
            raise ValueError("speculative pairs run propose/verify in "
                             "lockstep: async decode windows cannot overlap "
                             "them (SpecPair rejects async_decode)")
        if k < 2:
            raise ValueError(f"spec window k must be >= 2, got {k}")
        if self._spec_k == 0:
            self._spec_k = k
        if self._spec_k != k:
            raise ValueError(f"spec window is fixed per arena (have k="
                             f"{self._spec_k}, asked {k})")

    def _spec_step(self, tokens, positions, act):
        """One speculative position: the monolithic ``decode_step`` that
        target-only greedy runs, its cache writes gated by ``act`` (the
        paged write mask, or the contiguous rows' ``write_mask``).  Returns
        the greedy tokens [B]."""
        if self.page_alloc is not None:
            logits, _, self.cache = self.model.decode_step(
                self.params, self.cache, tokens, positions,
                long_mode=self.cfg.long_mode,
                paged=PagedKV(self._tbl_dev(), act))
        else:
            logits, _, self.cache = self.model.decode_step(
                self.params, self.cache, tokens, positions,
                long_mode=self.cfg.long_mode, write_mask=act)
        return torch.argmax(logits, dim=-1)

    def _spec_readback(self, t) -> np.ndarray:
        """A speculation stage's one readback; the wait counts in
        ``wait_ms_total``, as a decode step's readback does."""
        t0 = time.perf_counter()
        out = t.cpu().numpy()
        self.wait_ms_total += (time.perf_counter() - t0) * 1e3
        return out

    def spec_window_lens(self) -> np.ndarray:
        """Per-slot verify window ``min(k, max_new - steps_taken)`` (0 for
        idle slots): positions never pass ``prompt + max_new - 1``, so
        every speculated write stays inside the slot's admission-reserved
        pages."""
        win = np.zeros(self.cfg.n_slots, np.int32)
        for slot in np.nonzero(self.active)[0]:
            r = self.slot_req[slot]
            win[slot] = min(self._spec_k,
                            int(r.max_new - self.steps_taken[slot]))
        return win

    def spec_propose(self, win_len: np.ndarray) -> np.ndarray:
        """Draft side of a round: step j feeds the running token at
        ``pos + j`` while ``active & (j < win_len)`` and emits the next
        greedy draft; the k-th step feeds the last draft so its KV row is
        written (after a full accept the resynced draft would otherwise
        attend to a hole).  Positions and commit state stay untouched (the
        driver resyncs this arena from the target).  Returns [B, k]
        drafts: column j is the draft for window position j + 1."""
        if not self._spec_k:
            raise RuntimeError("ensure_spec(k) first")
        run = self.active & (win_len > 0)
        dev = self._upload(np.stack([
            self.current_tok.astype(np.int64), self.positions,
            run.astype(np.int64), win_len.astype(np.int64)]))
        return self._spec_readback(self._propose_window(
            dev[0][:, None], dev[1].to(torch.int32), dev[2].bool(), dev[3]))

    def _propose_window(self, cur, pos0, active_d, win):
        """The draft's k steps on the device: [B, k] greedy drafts."""
        drafts = []
        for j in range(self._spec_k):
            act = active_d & (j < win)
            greedy = self._spec_step(cur, pos0 + j, act)
            cur = torch.where(act[:, None], greedy[:, None], cur)
            drafts.append(greedy)
        return torch.stack(drafts, 1)

    def spec_verify(self, drafts: np.ndarray,
                    win_len: np.ndarray) -> np.ndarray:
        """Target side of a round: verify each slot's window
        ``[current_tok, d_1 .. d_{win-1}]`` and commit the longest accepted
        prefix plus one corrected (or bonus) token, with ``step()``'s
        commit rules (max_new discards the trailing sample; eos finishes).
        Step i runs while every earlier draft matched, ``act = active & ok
        & (i < win_len)``, all on the device; one readback brings the
        greedy tokens and each slot's count of steps that ran.  ``drafts``
        is [B, >= k-1].  Returns the per-slot committed counts.

        Committed tokens are full-depth greedy, so they equal target-only
        greedy decode; they count in the no-exit bucket on the host."""
        if not self._spec_k:
            raise RuntimeError("ensure_spec(k) first")
        k, b = self._spec_k, self.cfg.n_slots
        run = self.active & (win_len > 0)
        host = np.zeros((b, k + 3), np.int64)
        host[:, 0] = self.current_tok
        host[:, 1:k] = np.asarray(drafts)[:, :k - 1]
        host[:, k] = self.positions
        host[:, k + 1] = run
        host[:, k + 2] = win_len
        dev = self._upload(host)
        out = self._spec_readback(self._verify_window(
            dev[:, :k], dev[:, k].to(torch.int32), dev[:, k + 1].bool(),
            dev[:, k + 2]))
        committed = np.zeros(b, np.int64)
        for slot in np.nonzero(run)[0]:
            r = self.slot_req[slot]
            for j in range(int(out[slot, k])):
                tok = int(out[slot, j])
                self.steps_taken[slot] += 1
                self.positions[slot] += 1
                committed[slot] += 1
                self.tokens_served += 1
                self._tokens_since_adapt += 1
                self.depth_weighted_tokens += 1.0
                self._depth_since_adapt += 1.0
                self._host_exit_extra[self._n_exits] += 1
                if self.steps_taken[slot] >= r.max_new:
                    self._finish(slot)  # trailing sample discarded, as in
                    break               # step(); later verified ones too
                r.out_tokens.append(tok)
                self.current_tok[slot] = tok
                if r.eos_id is not None and tok == r.eos_id:
                    self._finish(slot)
                    break
        self._last_segments_run = len(self._segments)
        self._last_depth_frac = 1.0     # verify always runs full depth
        self.spec_rounds += 1
        self.spec_committed += int(committed.sum())
        self._step_idx += 1
        self._maybe_flush()
        return committed

    def _verify_window(self, tokens, pos0, active_d, win):
        """The target's k steps on the device: [B, k + 1], the greedy
        tokens and each row's count of steps that ran."""
        k = self._spec_k
        ok = torch.ones_like(active_d)
        gs, acts = [], []
        for i in range(k):
            act = active_d & ok & (i < win)
            greedy = self._spec_step(tokens[:, i:i + 1], pos0 + i, act)
            ok = ok & (greedy == tokens[:, min(i + 1, k - 1)])
            gs.append(greedy)
            acts.append(act)
        return torch.cat([torch.stack(gs, 1),
                          torch.stack(acts, 1).sum(1, keepdim=True)], 1)

    def spec_resync_from(self, slot: int, src, src_slot: int):
        """Align this (draft) arena's slot with the target's commit state
        after a verify: position, pending token and step count copy over.
        Stale draft rows past the accept point are overwritten before any
        read reaches them (reads are masked by position), which is why
        SpecPair takes only position-indexed caches as drafts."""
        self.positions[slot] = src.positions[src_slot]
        self.current_tok[slot] = src.current_tok[src_slot]
        self.steps_taken[slot] = src.steps_taken[src_slot]

    def _release_slot_pages(self, slot: int):
        """Drop the slot's block-table references; pages the prefix tree
        also holds stay resident for later prefix hits."""
        if self.page_alloc is None:
            return
        sentinel = self.page_alloc.n_pages
        for pg in self._tbl[slot]:
            if pg != sentinel:
                self.page_alloc.release(int(pg))
        self._tbl[slot] = sentinel
        self._tbl_dirty = True
        self._slot_digests[slot] = []

    def _finish(self, slot: int):
        r = self.slot_req[slot]
        r.done, r.t_done = True, time.time()
        self.completed.append(r)
        self.slot_req[slot] = None
        self.active[slot] = False
        self._release_slot_pages(slot)

    # ------------------------------------------------------------------
    # slot migration: export/import of one slot's serving state
    # ------------------------------------------------------------------
    @staticmethod
    def _gather_slot(cache, slot: int):
        """Slot ``slot``'s row of every cache leaf, as views: block leaves
        are stacked [n_layers, B, ...] (batch axis 1), shared-attention
        leaves are [B, ...] (batch axis 0)."""
        out = {"blocks": [tree_map(lambda a: a[:, slot], c)
                          for c in cache["blocks"]]}
        if "shared_attn" in cache:
            out["shared_attn"] = [tree_map(lambda a: a[slot], c)
                                  for c in cache["shared_attn"]]
        return out

    @staticmethod
    def _scatter_slot(cache, rows, slot: int):
        """Inverse of ``_gather_slot``, in place: each row, truncated on its
        time axis, is written into slot ``slot`` zero-padded back to the
        arena's shape (unwritten rows are zero in an unmigrated arena too,
        and reads are masked by position)."""
        def put(dst, r):
            if tuple(r.shape) != tuple(dst.shape):
                dst.zero_()
                dst = dst[tuple(slice(0, n) for n in r.shape)]
            dst.copy_(r)
        for c, r in zip(cache["blocks"], rows["blocks"]):
            tree_map(lambda a, rr: put(a[:, slot], rr), c, r)
        for c, r in zip(cache.get("shared_attn", []),
                        rows.get("shared_attn", [])):
            tree_map(lambda a, rr: put(a[slot], rr), c, r)
        return cache

    def _gather_slot_paged(self, cache, pages, slot: int):
        """Paged analogue of ``_gather_slot``: pool leaves [n_layers,
        n_pages, P, ...] gather the physical ``pages`` (a device index
        vector) into [n_layers, len(pages), P, ...] copies, shared-attention
        pools [n_pages, P, ...] into [len(pages), P, ...]; state leaves
        take the batch row ``slot`` (a view)."""
        out = {"blocks": [
            tree_map(lambda a: a.index_select(1, pages), c)
            if kind in PAGED_KINDS else tree_map(lambda a: a[:, slot], c)
            for kind, c in zip(self.model.scan_block_kinds(),
                               cache["blocks"])]}
        if "shared_attn" in cache:
            out["shared_attn"] = [tree_map(lambda a: a.index_select(0, pages),
                                           c) for c in cache["shared_attn"]]
        return out

    def _scatter_slot_paged(self, cache, rows, idxvec: np.ndarray,
                            slot: int):
        """Inverse of ``_gather_slot_paged``, in place: payload page row j
        lands on physical page ``idxvec[j]``, and state rows on batch row
        ``slot``.  Sentinel (``n_pages``) entries, the borrowed prefix
        pages and the unshipped tail, are dropped on the host before the
        copy, so no other page of the pool is written (the reference drops
        them inside its scatter)."""
        keep = idxvec[idxvec != self.page_alloc.n_pages]
        idx = self._upload(keep.astype(np.int64))
        n = keep.size
        for kind, c, r in zip(self.model.scan_block_kinds(),
                              cache["blocks"], rows["blocks"]):
            if kind not in PAGED_KINDS:
                tree_map(lambda a, rr: a[:, slot].copy_(rr), c, r)
            elif n:
                tree_map(lambda a, rr: a.index_copy_(
                    1, idx, rr[:, :n].to(a.dtype)), c, r)
        if n:
            for c, r in zip(cache.get("shared_attn", []),
                            rows.get("shared_attn", [])):
                tree_map(lambda a, rr: a.index_copy_(
                    0, idx, rr[:n].to(a.dtype)), c, r)
        return cache

    def _detect_row_layout(self):
        """Per-leaf layout of one exported slot row: its full shape and
        dtype, and which axis is the time axis, found by diffing the row
        shapes on the ``meta`` device at ``max_len`` vs ``max_len + 1``
        (a ``long_mode`` ring shorter than ``max_len`` has no time axis)
        (paged arenas: ``pages_per_slot`` vs one more gathered page, so the
        varying axis is the page axis).  A leaf whose shape does not depend
        on the context length gets -1 and always ships whole."""
        b, meta = self.cfg.n_slots, "meta"
        if self.page_alloc is not None:
            def rows(n):
                cache = self.model.init_decode_cache_paged(
                    b, self.page_alloc.n_pages, self.cfg.page_size,
                    device=meta)
                return tree_leaves(self._gather_slot_paged(
                    cache, torch.zeros(n, dtype=torch.long, device=meta), 0))
            flat, flat2 = rows(self._pps), rows(self._pps + 1)
        else:
            def rows(n):
                return tree_leaves(self._gather_slot(
                    self.model.init_decode_cache(
                        b, n, long_mode=self.cfg.long_mode, device=meta),
                    0))
            flat, flat2 = rows(self.cfg.max_len), rows(self.cfg.max_len + 1)
        axes = []
        for a, c in zip(flat, flat2):
            ax = next((i for i, (x, y) in enumerate(zip(a.shape, c.shape))
                       if x != y), -1)
            # the scales replace the last (feature) axis with 1, so a time
            # axis there would make them unsliceable
            if ax == a.ndim - 1:
                raise ValueError("time axis must not be the row axis")
            axes.append(ax)
        return [(tuple(a.shape), a.dtype) for a in flat], axes

    def prefix_keys(self, model: str = "") -> FrozenSet[bytes]:
        """Digest keys of every prefix page the radix tree holds: a
        migration source skips shipping the pages whose digests are here."""
        if self.prefix_cache is None:
            return frozenset()
        return self.prefix_cache.keys()

    def export_slot(self, slot: int, *, model: str = "",
                    compress: bool = False,
                    skip_keys: FrozenSet[bytes] = frozenset()
                    ) -> SlotSnapshot:
        """Snapshot one active slot out of the arena.

        Each leaf's time axis is cut to the prefix the request has written
        before it leaves the card, so ``payload_bytes`` measures the bytes
        a migration really ships.  ``compress=True`` routes every float
        leaf through the int8 row quantizer (``kops.compress_rows``; per-row
        fp32 scales ride along).  The slot itself is left untouched: pair
        with ``release_slot`` to evict, or discard the snapshot to abort.

        Paged arenas ship pages: ``[skip, used)`` with ``used =
        ceil(position / P)`` and ``skip`` the leading prompt pages whose
        digests are in ``skip_keys`` (the destination's ``prefix_keys()``).
        """
        if self._win_q:
            raise RuntimeError("export_slot: async decode windows in "
                               "flight - sync() first")
        r = self.slot_req[slot]
        if r is None or not self.active[slot]:
            raise ValueError(f"export_slot: slot {slot} is not active")
        position = int(self.positions[slot])
        paged = self.page_alloc is not None
        page_skip = page_used = 0
        page_digests: List[bytes] = []
        if paged:
            page_used = -(-position // self.cfg.page_size)
            page_digests = list(self._slot_digests[slot])
            while (page_skip < min(page_used, len(page_digests))
                   and page_digests[page_skip] in skip_keys):
                page_skip += 1
            pages = self._tbl[slot, page_skip:page_used].astype(np.int64)
            rows = self._gather_slot_paged(self.cache, self._upload(pages),
                                           slot)
        else:
            rows = self._gather_slot(self.cache, slot)
        payload: List[Any] = []
        scales: List[Optional[Any]] = []
        nbytes = 0
        for a, ax in zip(tree_leaves(rows), self._row_axes_flat):
            if ax >= 0 and not paged:       # paged rows hold only the cut
                a = a.narrow(ax, 0, min(position, a.shape[ax]))
            s = None
            if compress and a.is_floating_point():
                a, s = kops.compress_rows(a.contiguous())
            # the migration's intended d2h; a copy even on the CPU, where
            # the row is a view of the arena (a state row is reused by the
            # slot's next occupant)
            ah = a.to("cpu", copy=True)
            sh = None if s is None else s.cpu()
            payload.append(ah)
            scales.append(sh)
            nbytes += _nbytes(ah) + (0 if sh is None else _nbytes(sh))
        self.n_exported += 1
        return SlotSnapshot(
            req=r, position=position, current_tok=int(self.current_tok[slot]),
            steps_taken=int(self.steps_taken[slot]), compressed=compress,
            payload=payload, scales=scales, payload_bytes=int(nbytes),
            paged=paged,
            page_skip=page_skip, page_used=page_used,
            page_digests=page_digests, model=r.model)

    def slot_payload_bytes(self, slot: int, *, model: str = "") -> int:
        """Size of the raw payload ``export_slot(slot)`` would ship, from
        the row layout and the slot's position alone (no device work): what
        a driver feeds ``compression_decision`` before exporting.  Equals
        the exported snapshot's ``payload_bytes`` (no pages skipped)."""
        position = int(self.positions[slot])
        if self.page_alloc is not None:
            cut = -(-position // self.cfg.page_size)
        else:
            cut = position
        total = 0
        for (shape, dtype), ax in zip(self._row_struct_flat,
                                      self._row_axes_flat):
            shape = list(shape)
            if ax >= 0:
                shape[ax] = min(cut, shape[ax])
            total += int(np.prod(shape)) * dtype.itemsize
        return total

    def import_slot(self, snap: SlotSnapshot) -> int:
        """Restore an exported snapshot into a free slot of this arena and
        resume decoding mid-flight (no prefill replay).  Compressed leaves
        are dequantized on the card (``kops.decompress_rows``) into the
        arena leaf's dtype.  Returns the slot used.

        Paged imports rebuild the slot's block table first: pages the
        snapshot skipped are borrowed from this arena's prefix tree, the
        rest are freshly allocated, and the shipped pages are copied into
        the fresh ones."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("import_slot: no free slot in this arena")
        r = snap.req
        if r.done or snap.steps_taken >= r.max_new:
            raise ValueError("import_slot: request already finished")
        paged = self.page_alloc is not None
        if snap.paged != paged:
            raise ValueError("import_slot: snapshot/arena paging modes differ")
        slot = free[0]
        idxvec = None
        if paged:
            P, pps = self.cfg.page_size, self._pps
            n_pages = self.page_alloc.n_pages
            total = -(-(int(r.tokens.size) + r.max_new) // P)
            nskip, used = snap.page_skip, snap.page_used
            shared: List[int] = []
            if nskip:
                if self.prefix_cache is None:
                    raise ValueError("import_slot: skipped pages but no "
                                     "prefix cache here")
                shared = self.prefix_cache.match(snap.page_digests[:nskip],
                                                 r.tokens)
                if len(shared) != nskip:
                    for pg in shared:
                        self.page_alloc.release(pg)
                    raise RuntimeError("import_slot: prefix pages evicted "
                                       "mid-migration")
            if self.prefix_cache is not None:
                self.prefix_cache.evict_until(total - nskip)
            try:
                fresh = self.page_alloc.alloc(total - nskip)
            except MemoryError:
                for pg in shared:
                    self.page_alloc.release(pg)
                raise
            row = np.full(pps, n_pages, np.int32)
            row[:nskip] = shared
            row[nskip:total] = fresh
            # payload page j lands on physical page row[nskip + j]; entries
            # past the shipped range stay sentinel and are dropped
            idxvec = np.full(pps, n_pages, np.int32)
            idxvec[:used - nskip] = row[nskip:used]
            self._tbl[slot] = row
            self._tbl_dirty = True
            self._slot_digests[slot] = list(snap.page_digests)
        leaves = []
        for ah, sh, (_, dtype) in zip(snap.payload, snap.scales,
                                      self._row_struct_flat):
            a = ah.to(self.device)          # the migration's intended h2d
            if sh is not None:
                a = kops.decompress_rows(a, sh.to(self.device), dtype=dtype)
            leaves.append(a)
        it = iter(leaves)
        rows = tree_map(lambda _: next(it), self.cache)
        if paged:
            self._scatter_slot_paged(self.cache, rows, idxvec, slot)
            if self.prefix_cache is not None and snap.page_digests:
                # publish the imported prompt pages for later admissions
                n_full = len(snap.page_digests)
                self.prefix_cache.insert(
                    snap.page_digests, r.tokens,
                    [int(self._tbl[slot, i]) for i in range(n_full)])
        else:
            self._scatter_slot(self.cache, rows, slot)
        r.slot = slot
        self.slot_req[slot] = r
        self.positions[slot] = snap.position
        self.current_tok[slot] = snap.current_tok
        self.steps_taken[slot] = snap.steps_taken
        self.active[slot] = True
        self.n_imported += 1
        self._carry_valid = False      # a new live slot: fresh dispatch next
        return slot

    def free_slots(self, model: str = "") -> List[int]:
        """Slots with no request bound (staged admissions count as bound)."""
        return [i for i in range(self.cfg.n_slots)
                if self.slot_req[i] is None]

    def active_requests(self) -> List[tuple]:
        """``[(model, slot, request)]`` for every in-flight decode slot."""
        return [(r.model, i, r) for i, r in enumerate(self.slot_req)
                if r is not None and self.active[i]]

    def release_slot(self, slot: int, *, model: str = "") -> Request:
        """Evict a slot without completing its request (the migration
        path: the request continues elsewhere from its snapshot).  The
        cache rows are left stale; an admission or ``import_slot``
        overwrites them before the slot is read again."""
        if self._win_q:
            raise RuntimeError("release_slot: async decode windows in "
                               "flight - sync() first")
        r = self.slot_req[slot]
        if r is None:
            raise ValueError(f"release_slot: slot {slot} is empty")
        self.slot_req[slot] = None
        self.active[slot] = False
        self._release_slot_pages(slot)
        r.slot = -1
        return r

    def drain_queue(self) -> List[Request]:
        """Pop every not-yet-admitted request (tier drain on an outage)."""
        out = list(self.queue)
        self.queue.clear()
        return out

    def cancel_pending(self) -> List[Request]:
        """Abandon an in-flight chunked admission and return its requests
        (their prefill restarts wherever they are resubmitted)."""
        if self._pending is None:
            return []
        reqs = list(self._pending.reqs)
        for slot in self._pending.slots:
            self.slot_req[slot] = None
            self._release_slot_pages(slot)
        for r in reqs:
            r.slot = -1
        self._pending = None
        return reqs

    # ------------------------------------------------------------------
    # exit statistics
    # ------------------------------------------------------------------
    def _maybe_flush(self):
        """The controller's update, the one counter read inside a poll.
        With a controller and at least ``adaptive_every`` tokens served
        since its last update, it reads the counters exactly and steers
        from the measured depth fraction of those tokens (monolithic steps
        report 1.0: they never truncate).  Without one a poll reads no
        counters: nothing reads ``exit_counts`` between exact reads, and a
        blocking read in a window's commit would wait for the window
        dispatched after it."""
        if (self.controller is not None
                and self._tokens_since_adapt >= self.adaptive_every):
            self.flush_counters()
            self.controller.update_measured(
                self._depth_since_adapt / max(1, self._tokens_since_adapt))
            self._tokens_since_adapt = 0
            self._depth_since_adapt = 0.0

    def flush_counters(self) -> np.ndarray:
        """Read the cumulative device exit histogram back to the host, plus
        the host-side histogram of verify-committed tokens.  The read
        waits for every step enqueued before it; that wait counts in
        ``flush_wait_ms_total`` and ``flushes``, and a poll takes it out
        of its ``host_ms``."""
        with span("flush"):
            t0 = time.perf_counter()
            counts = self._counters.cpu()
            wait = time.perf_counter() - t0
        self._flush_s += wait
        self.flush_wait_ms_total += wait * 1e3
        self.flushes += 1
        self.exit_counts = (counts.numpy().astype(np.int64)
                            + self._host_exit_extra)
        return self.exit_counts

    def reset_stats(self):
        """Zero served-token accounting and exit counters (e.g. after a
        warm-up request, so reports cover only the real trace).  Drains the
        async windows in flight first: their tokens belong before the
        reset."""
        self.sync()
        self._counters.zero_()
        self.exit_counts = np.zeros(self._n_exits + 1, np.int64)
        self._host_exit_extra = np.zeros(self._n_exits + 1, np.int64)
        self.tokens_served = 0
        self._tokens_since_adapt = 0
        self.depth_weighted_tokens = 0.0
        self._depth_since_adapt = 0.0
        self.spec_rounds = 0
        self.spec_committed = 0
        for name in self.stage_calls:
            self.stage_calls[name] = 0
        self.host_ms_total = 0.0
        self.wait_ms_total = 0.0
        self.flush_wait_ms_total = 0.0
        self.flushes = 0
        self.device_ms_total = 0.0
        self.prefill_ms_total = 0.0
        self.prefill_tokens_total = 0
        self.state_resets = 0
        self.peak_tokens_in_flight = 0
        self.completed.clear()

    def measured_depth_fraction(self) -> float:
        """Layer-weighted fraction of the stack dispatched per token."""
        if not self.tokens_served:
            return 1.0
        return self.depth_weighted_tokens / self.tokens_served

    def exit_stats(self) -> Dict[str, float]:
        self.flush_counters()
        st = exit_stats_dict(self.exit_counts, self.tokens_served)
        st["measured_depth"] = self.measured_depth_fraction()
        return st

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Builds of the fixed-shape decode stages, each of which must stay
        at most 1 per scheduler: the async window's CUDA graph captures
        (its eager builds on the CPU), and the speculative ``propose`` and
        ``verify`` stages, fixed at one k by ``ensure_spec``.  Other eager
        stages have no entry."""
        sizes: Dict[str, int] = {}
        if self.cfg.async_decode:
            sizes["decode_window"] = (0 if self._window is None
                                      else self._window.captures)
        if self._spec_k:
            sizes["propose"] = sizes["verify"] = 1
        return sizes

    def _on_cache(self, cache, fn, *args):
        """``fn(*args)`` with the arena's cache swapped for ``cache`` and
        its exit counters for zeroed ones; both, and ``stage_calls``, are
        restored after."""
        saved = self.cache, self._counters, dict(self.stage_calls)
        self.cache = cache
        self._counters = torch.zeros_like(self._counters)
        try:
            return fn(*args)
        finally:
            self.cache, self._counters = saved[0], saved[1]
            self.stage_calls.update(saved[2])

    def audit_stages(self) -> Dict[str, StageSpec]:
        """The stages ``poll`` dispatches, by name: the prefill chunk,
        every ``segment*``, ``probe*`` and ``finalize`` (segmented), the
        monolithic ``decode``, the window step ``decode_window`` (async),
        and ``propose`` / ``verify`` (after ``ensure_spec``).  Each runs
        the arena's own method on example inputs: token 0 at position 0
        in every row, every row live, and a fresh cache from
        ``_init_cache`` in place of the arena's (paged stages read the
        arena's block table), so running a stage leaves an idle arena as
        it was."""
        cfg, b, dev = self.cfg, self.cfg.n_slots, self.device
        model, params = self.model, self.params
        thr = self._threshold()
        i64 = torch.int64

        def rows(dtype=i64, fill=0):
            return torch.full((b,), fill, dtype=dtype, device=dev)

        def hidden():
            return model.embed_decode_tokens(
                params, torch.zeros((b, 1), dtype=i64, device=dev))

        def pending():
            chunk = cfg.prefill_chunk
            lengths = np.full(b, chunk, np.int32)
            start = np.zeros(b, np.int32)
            cache = self._init_cache()
            return (cache, _PendingPrefill(
                reqs=[], slots=list(range(b)),
                tokens=np.zeros((b, chunk), np.int32), lengths=lengths,
                lengths_d=self._upload(lengths), admit=np.ones(b, bool),
                cache=None if self.page_alloc is not None else cache,
                last=torch.zeros((b, self._vocab), dtype=torch.float32,
                                 device=dev),
                n_chunks=1, start=start, start_d=self._upload(start)))

        def spec(name, fn, make_args):
            return StageSpec(name, fn, make_args, b)

        stages = {"prefill": spec(
            "prefill", lambda cache, p: self._on_cache(
                cache, self._prefill_chunk, p, 0, cfg.prefill_chunk),
            pending)}
        step_args = (lambda: (self._init_cache(), hidden(), rows(torch.int32),
                              rows(torch.bool, True), rows(torch.bool, True)))
        if cfg.segmented:
            for seg in self._segments:
                stages[f"segment{seg.index}"] = spec(
                    f"segment{seg.index}",
                    lambda cache, x, pos, alive, act, seg=seg:
                        self._on_cache(cache, self._segment, seg, x, pos,
                                       alive, act),
                    step_args)
                if seg.exit_index is not None:
                    e = seg.exit_index
                    stages[f"probe{e}"] = spec(
                        f"probe{e}",
                        lambda x, alive, first, e=e: self._probe(
                            e, x, alive, first, thr),
                        lambda: (hidden(), rows(torch.bool, True),
                                 rows(fill=self._n_exits)))
            stages["finalize"] = spec(
                "finalize", lambda x, first, act: self._on_cache(
                    self.cache, self._finalize, x, first, act, None),
                lambda: (hidden(), rows(fill=self._n_exits),
                         rows(torch.bool, True)))
        else:
            stages["decode"] = spec(
                "decode", lambda cache, tok, pos, act: self._on_cache(
                    cache, self._step_monolithic, tok, pos, act, thr, None),
                lambda: (self._init_cache(),
                         torch.zeros((b, 1), dtype=i64, device=dev),
                         rows(torch.int32), rows(torch.bool, True)))
        if cfg.async_decode:
            def window():
                w = DecodeWindow(self)
                w.set_threshold(thr)
                w.load(np.zeros(b), np.zeros(b), np.ones(b),
                       np.full(b, cfg.max_len), np.full(b, -1), 0, False)
                return self._init_cache(), w

            stages["decode_window"] = spec(
                "decode_window",
                lambda cache, w: self._on_cache(cache, w._step), window)
        if self._spec_k:
            k = self._spec_k
            stages["propose"] = spec(
                "propose", lambda cache, *a: self._on_cache(
                    cache, self._propose_window, *a),
                lambda: (self._init_cache(),
                         torch.zeros((b, 1), dtype=i64, device=dev),
                         rows(torch.int32), rows(torch.bool, True),
                         rows(fill=k)))
            stages["verify"] = spec(
                "verify", lambda cache, *a: self._on_cache(
                    cache, self._verify_window, *a),
                lambda: (self._init_cache(),
                         torch.zeros((b, k), dtype=i64, device=dev),
                         rows(torch.int32), rows(torch.bool, True),
                         rows(fill=k)))
        return stages
