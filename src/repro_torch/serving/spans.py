"""Named spans of the serving stack, read from a ``torch.profiler`` trace.

``span(name, seq)`` records ``repro.serving.<name>`` while a profiler
collects, and otherwise returns one shared null context: with no profiler
running a span costs one check.  The profiler keeps the spans in memory
with its other events and writes them out when the trace ends, on the same
clock as the device's CUPTI events, so an idle gap of the card can be set
against the host work that was open when it began.  Spans nest by time: an
inner span's parent is the span open around it.  ``seq`` (a decode
window's sequence number, on its ``dispatch``, ``readback`` and ``commit``)
is kept as the event's keyword input ``seq``, which a trace taken with
``record_shapes=True`` shows; ``launch/device_trace.window_ms`` joins a
window's spans by it.

A span is a function-scope record (``_RecordFunctionFast``), not a user
annotation (``torch.profiler.record_function``): the profiler mirrors every
user annotation onto the device's timeline as an interval spanning the
kernels launched inside it, which a reader of device operations would count
as device work.  Nothing inside a graph-captured step opens a span: a CUDA
graph replays its kernels without re-running the Python that launched
them.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

PREFIX = "repro.serving."
_NULL = contextlib.nullcontext()


def span(name: str, seq: Optional[int] = None):
    """A context that records ``repro.serving.<name>`` (with ``seq``)
    while a profiler collects."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    record = torch._C._profiler._RecordFunctionFast
    if seq is None:
        return record(PREFIX + name)
    return record(PREFIX + name, (), {"seq": seq})
