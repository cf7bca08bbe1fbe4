"""Async decode windows: R monolithic decode steps with sampling, token
feedback and eos/max_new termination on the device, read back once.

The port of the reference's ``_make_decode_window`` (a jitted
``lax.scan`` of ``readback_interval`` steps).  PyTorch runs eagerly, so on
the card the scan becomes one CUDA graph of one step, captured once and
replayed R times; on the CPU the same step runs eagerly R times.

The step reads and writes only persistent buffers, so the graph's
pointers stay valid from window to window:

* ``state`` [5, B] int64: the carry ``cur``, ``pos``, ``alive``, ``budget``
  (``max_new - steps_taken``) and each slot's ``eos`` (-1 = none);
* ``scal`` [3] int64: the sampling tick, the ring column ``j`` and the
  greedy-or-sampled flag;
* ``thr`` [1] fp32: the exit threshold, rewritten before a dispatch only
  when it moved (an adaptive controller moves it without a recapture);
* ``ring`` [B, R] int64: token j of each slot;
* the scheduler's cache, block table (paged arenas), exit counters and
  sampling key.

The on-device commit is the reference's, line for line: a live row's
budget drops by one each step; a row whose budget reaches zero freezes
without taking the trailing token (``max_new`` discards it, as the sync
``step()`` does); otherwise the token feeds back as ``cur`` and a token
equal to the row's eos freezes the row.  Frozen rows keep computing
garbage like inactive slots under the sync monolithic step (private rows
in contiguous arenas; in paged ones no page write, no state-row store and
an all-sentinel table, as a released slot has), so greedy tokens stay
bit-identical to the sync path's, also where MoE capacity couples the
rows.

A window on the card is a timing event, R graph replays, a
``non_blocking`` copy of the ring into a pinned host buffer of its own,
and a second timing event; the host waits on that event only when it
commits the window, and then reads the device time between the two
(``RingHandle.device_ms``), which needs no further wait.
``kernels.ops.LAUNCHES`` counts Python calls, which a replay does not
make, so each window adds the launches one step made during capture
times R.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.early_exit import first_exit_index
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import PagedKV
from repro_torch.serving.spans import span

CUR, POS, ALIVE, BUDGET, EOS = range(5)     # rows of DecodeWindow.state
TICK, COL, SAMPLED = range(3)                # entries of DecodeWindow.scal
WARMUP_STEPS = 2        # side-stream steps before capture (lazy inits)


@dataclasses.dataclass
class RingHandle:
    """One dispatched window's token ring: a host buffer that the ring
    copy fills, the event recorded behind that copy and the one recorded
    before the window's first replay (both None on the CPU, where the
    copy has already happened)."""
    host: torch.Tensor                 # [B, R] int64 (pinned on the card)
    event: Optional[torch.cuda.Event] = None
    start: Optional[torch.cuda.Event] = None

    def read(self) -> np.ndarray:
        """The ring as numpy, after waiting on the window's event."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def device_ms(self) -> float:
        """Device milliseconds from the window's first replay to the end
        of its ring copy; call after ``read`` (0.0 on the CPU)."""
        if self.event is None:
            return 0.0
        return self.start.elapsed_time(self.event)


class DecodeWindow:
    """The decode window of one ``ContinuousBatchScheduler``
    (``async_decode``): ``load`` host state into the carry, ``prepare``
    the step (one capture), ``set_threshold``, then ``run`` one window."""

    def __init__(self, sched):
        self.sched = sched
        b, dev = sched.cfg.n_slots, sched.device
        self.R = sched.cfg.readback_interval
        self.on_card = dev.type == "cuda"
        self.state = torch.zeros((5, b), dtype=torch.int64, device=dev)
        self.scal = torch.zeros(3, dtype=torch.int64, device=dev)
        self.ring = torch.zeros((b, self.R), dtype=torch.int64, device=dev)
        self.thr = torch.zeros(1, dtype=torch.float32, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.threshold: Optional[float] = None   # host copy of ``thr``
        self.captures = 0                  # graph captures (CPU: builds)
        self.replays = 0                   # graph replays (CPU: eager steps)
        self.warmup_steps = 0              # side-stream steps run to capture
        self._warming = False              # a warm-up step writes no row
        self.per_replay: Dict[str, int] = {}   # launches one step makes

    @property
    def steps_run(self) -> int:
        """Decode steps this window object ran on the device."""
        return self.replays + self.warmup_steps

    # ------------------------------------------------------------------
    def load(self, cur, pos, alive, budget, eos, tick: int,
             use_sampled: bool):
        """A fresh dispatch: write host state into the carry (two writes
        through the scheduler's pinned staging)."""
        host = np.stack([np.asarray(cur, np.int64), np.asarray(pos, np.int64),
                         np.asarray(alive, np.int64),
                         np.asarray(budget, np.int64),
                         np.asarray(eos, np.int64)])
        self.sched._put(self.state, host)
        self.sched._put(self.scal, np.asarray([tick, 0, int(use_sampled)],
                                              np.int64))

    def set_threshold(self, threshold: float):
        """Write the exit threshold the step reads, if it moved; the
        stream orders the write after every window already enqueued."""
        if threshold != self.threshold:
            self.sched._put(self.thr, np.asarray([threshold], np.float32))
            self.threshold = threshold

    def needs_build(self) -> bool:
        return self.captures == 0

    def prepare(self):
        """Capture the step (on the card), once.  Call after ``load``: the
        warm-up steps run with every row frozen, so they write no cache row
        and count nothing.  The caller loads the carry again after.  A
        failed capture raises: there is no eager fallback on the card."""
        if self.on_card:
            self._capture()
        self.captures += 1

    def _capture(self):
        dev = self.sched.device
        self.state[ALIVE].zero_()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        self._warming = True
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step()
        finally:
            self._warming = False
        main.wait_stream(side)
        self.warmup_steps += WARMUP_STEPS
        before = dict(kops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step()
        # capture records launches without running them
        self.per_replay = {k: kops.LAUNCHES[k] - before[k] for k in before}
        kops.LAUNCHES.update(before)
        self.graph = graph

    def _step(self):
        """One monolithic decode step and its on-device commit.  A warm-up
        step (every row frozen) writes no row of a contiguous arena either:
        a state row, unlike a K/V row, would not be rewritten with the
        same values by the next real step."""
        s = self.sched
        st = self.state
        act = st[ALIVE] != 0
        paged = None
        write_mask = act if self._warming else None
        if s.page_alloc is not None:
            # a row frozen mid-window reads an all-sentinel table, as a
            # slot the sync step has finished (and released) does: its
            # garbage must match, because MoE capacity couples rows
            paged = PagedKV(torch.where(act[:, None], s._tbl_buf,
                                        s.page_alloc.n_pages), act)
        logits, ee, _ = s.model.decode_step(
            s.params, s.cache, st[CUR][:, None], st[POS].to(torch.int32),
            long_mode=s.cfg.long_mode, paged=paged, write_mask=write_mask)
        if s._n_exits:
            idx = first_exit_index(ee, self.thr, s._vocab)
        else:
            idx = torch.zeros(act.shape[0], dtype=torch.int64,
                              device=act.device)
        sampling = s.cfg.temperature > 0.0
        greedy, sampled = s._count_exits(
            logits, idx, act, tick=self.scal[TICK:TICK + 1] if sampling
            else None)
        tok = (torch.where(self.scal[SAMPLED] != 0, sampled, greedy)
               if sampling else greedy)
        self.ring.index_copy_(1, self.scal[COL:COL + 1], tok[:, None])
        a = act.to(torch.int64)
        st[POS] += a
        st[BUDGET] -= a
        spent = act & (st[BUDGET] <= 0)
        keep = act & ~spent
        st[CUR] = torch.where(keep, tok, st[CUR])
        st[ALIVE] = (keep & (tok != st[EOS])).to(torch.int64)
        self.scal[TICK] += 1
        self.scal[COL] = (self.scal[COL] + 1) % self.R

    def run(self) -> RingHandle:
        """Enqueue one window of R steps from the carry; returns its ring."""
        R = self.R
        if not self.on_card:
            with span("replay"):
                for _ in range(R):
                    self._step()
            self.replays += R
            with span("ring_copy"):
                return RingHandle(self.ring.clone())
        with span("replay"):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(R):
                self.graph.replay()
        self.replays += R
        for name, n in self.per_replay.items():
            kops.LAUNCHES[name] += n * R
        with span("ring_copy"):
            host = torch.empty(tuple(self.ring.shape), dtype=torch.int64,
                               pin_memory=True)
            host.copy_(self.ring, non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        return RingHandle(host, event, start)
