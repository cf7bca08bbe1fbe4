"""Reading a traced window: the benchmark's spans and the device's
operations, from ``torch.profiler`` (CUPTI).

The runners open spans (``span``: a ``record_function`` named
``bench.<what>``) around their calls into the program.  ``summarize``
turns one profiled window into what the per-layer metrics read: the
device's busy time (the union of every kernel, copy and set interval),
each operation's total time by name (two operations that overlap, as a
programmatic dependent launch waiting on the one before it does, both
count the overlap there), and the idle gaps, each named by
the innermost span that was open on the host when the gap began.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

SPAN = "bench."
WINDOW = "bench.traced"                   # the span around a traced window
TOP = 10                                  # entries of each breakdown list


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(SPAN + name):
        yield


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(prof) -> Dict[str, object]:
    """busy_s, window_s, kernel_s {name: seconds}, device_ops and
    idle_gaps (the breakdown's lists) of the window inside ``WINDOW``."""
    dev, spans, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span is mirrored on the device's timeline: not an operation
            if not e.name.startswith(SPAN):
                dev.append((e.name, tr.start, tr.end))
        elif e.name == WINDOW:
            window = (tr.start, tr.end)
        elif e.name.startswith(SPAN):
            spans.append((e.name[len(SPAN):], tr.start, tr.end))
    if window is None:
        raise RuntimeError("bench trace: no traced window span")
    lo, hi = window
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi]
    kernel_s: Dict[str, float] = defaultdict(float)
    for n, a, b in dev:
        kernel_s[n] += (b - a) * 1e-6
    busy = _union([(a, b) for _, a, b in dev])
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle[_open_span(spans, a)] += (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_s,
            "kernel_s": dict(kernel_s), "ops": dev,
            "device_ops": _top(kernel_s), "idle_gaps": _top(idle)}


def _open_span(spans, t: float) -> str:
    """The innermost (latest started) span open at time ``t``."""
    best, start = "between spans", None
    for name, a, b in spans:
        if a <= t < b and (start is None or a > start):
            best, start = name, a
    return best


def _top(d: Dict[str, float]) -> List[list]:
    return [[n[:120], s] for n, s in sorted(d.items(),
                                             key=lambda kv: -kv[1])[:TOP]]


def kernel_time(summary: Dict[str, object], *names: str) -> float:
    """Seconds in which a device operation whose name holds one of
    ``names`` ran: the union of their intervals, so that a kernel
    launched early behind another (programmatic dependent launch, as
    paged attention's combine behind its partial) and waiting on it is
    not counted twice."""
    spans = [(a, b) for n, a, b in summary["ops"]
             if any(k in n for k in names)]
    return sum(b - a for a, b in _union(spans)) * 1e-6
