"""Reading a ``torch.profiler`` trace of the port on the card: the device's
operations and the union of their intervals, the serving stack's spans
(``serving/spans.py``) with their total and self time, the device's idle
gaps, each named by the innermost span open on the host when it began,
each decode window's time from dispatch to commit, and the device time
of the kernels launched under each kind of the model's plan-step spans
(``models/common.py: step_span``).

Busy time is the union of the operations' intervals, never their sum: paged
attention's combine is launched early behind its partial (programmatic
dependent launch) and waits inside it, so a sum counts that overlap twice.
An interval the profiler mirrors onto the device's timeline for a user
annotation (``record_function``) is not an operation.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from repro_torch.models.common import SPAN_PREFIX
from repro_torch.serving.spans import PREFIX

Interval = Tuple[float, float]
BETWEEN = "between spans"


def device_ops(prof) -> List[Tuple[str, float, float]]:
    """(name, start_us, end_us) of every device operation (kernel, copy,
    set) of a finished profile."""
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.name.startswith(PREFIX):
            continue
        out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def serving_spans(prof) -> List[Tuple[str, float, float]]:
    """(name without the ``repro.serving.`` prefix, start_us, end_us) of
    every serving span on the host, ordered by start."""
    return sorted(((e.name[len(PREFIX):], e.time_range.start,
                    e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith(PREFIX)), key=lambda s: (s[1], -s[2]))


def plan_device_s(prof) -> Dict[str, float]:
    """Device seconds of the kernels launched inside each kind of plan-step
    span (``mamba``, ``site``, ``exit``, ``head``, ...), by kind: each
    span's ``device_time_total``, the kernels of the host operations
    nested in it (0 on the CPU)."""
    out: Dict[str, float] = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.name.startswith(SPAN_PREFIX):
            us = getattr(e, "device_time_total", None)
            if us is None:                     # older torch
                us = e.cuda_time_total
            out[e.name[len(SPAN_PREFIX):]] += us * 1e-6
    return dict(out)


def window_ms(prof) -> Dict[int, float]:
    """Each decode window's milliseconds from its ``dispatch`` span's
    start to its ``commit`` span's end, by sequence number: the two are
    joined by their ``seq``, so the trace must be taken with
    ``record_shapes=True``.  A window whose dispatch or commit lies
    outside the trace is left out."""
    start: Dict[int, float] = {}
    end: Dict[int, float] = {}
    for e in prof.events():
        seq = (getattr(e, "kwinputs", None) or {}).get("seq")
        if seq is None or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name == PREFIX + "dispatch":
            start[seq] = e.time_range.start
        elif e.name == PREFIX + "commit":
            end[seq] = e.time_range.end
    return {k: (end[k] - start[k]) * 1e-3 for k in sorted(start)
            if k in end}


def union(intervals) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(ops, lo: float, hi: float):
    """``ops`` cut to the window [lo, hi] (those outside dropped)."""
    return [(n, max(a, lo), min(b, hi)) for n, a, b in ops
            if b > lo and a < hi]


def busy_s(ops) -> float:
    return sum(b - a for a, b in union((a, b) for _, a, b in ops)) * 1e-6


def by_name(ops) -> Dict[str, Dict[str, float]]:
    """Each operation name's seconds (the union of its own intervals) and
    launches."""
    groups: Dict[str, List[Interval]] = defaultdict(list)
    for n, a, b in ops:
        groups[n].append((a, b))
    return {n: {"s": sum(b - a for a, b in union(iv)) * 1e-6,
                "launches": len(iv)} for n, iv in groups.items()}


def idle_gaps(ops, spans, lo: float, hi: float) -> Dict[str, float]:
    """Seconds of the window [lo, hi] in which no operation ran, by the
    innermost span open when each gap began (``BETWEEN`` where none)."""
    gaps, t = [], lo
    for a, b in union((a, b) for _, a, b in clip(ops, lo, hi)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        out[_open_at(spans, a)] += (b - a) * 1e-6
    return dict(out)


def _open_at(spans, t: float) -> str:
    """The innermost span open at ``t``: the latest started, and of two
    started together the one that ends first."""
    best, key = BETWEEN, None
    for name, a, b in spans:
        if a <= t < b and (key is None or (a, -b) > key):
            best, key = name, (a, -b)
    return best


def span_seconds(spans, lo: float, hi: float) -> Dict[str, Dict[str, float]]:
    """Each span name's total and self seconds inside [lo, hi] and its
    count.  Self time is the span less the union of the spans nested in
    it; ``spans`` come ordered by start, so a span's descendants follow
    it."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"total_s": 0.0, "self_s": 0.0, "count": 0})
    for i, (name, a, b) in enumerate(spans):
        ca, cb = max(a, lo), min(b, hi)
        if cb <= ca:
            continue
        kids = []
        for _, ka, kb in spans[i + 1:]:
            if ka >= b:
                break
            if kb <= b:
                kids.append((max(ka, ca), min(kb, cb)))
        inner = sum(y - x for x, y in union(k for k in kids if k[1] > k[0]))
        d = out[name]
        d["total_s"] += (cb - ca) * 1e-6
        d["self_s"] += (cb - ca - inner) * 1e-6
        d["count"] += 1
    return dict(out)
