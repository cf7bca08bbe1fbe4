"""Host-staged collectives of the port's world of ranks (``launch.mesh``),
over ``gloo`` on either device.

Gloo's ``send`` / ``recv`` and ``all_gather`` take host tensors only, so
these wrappers copy to the host and back explicitly, on every device
alike.  A boundary that crosses a network goes through a host the same
way, so for staged execution the host-staged handoff is the transport,
not a fallback.  ``all_reduce`` and ``broadcast`` hand the tensor to
``torch.distributed`` as it is: gloo takes CUDA tensors for these two and
stages them through the host itself.

Inside ``count_collectives()`` every wrapper also records what it moved:
its kind under the reference's HLO names (``send`` / ``recv`` is
``collective-permute``), plus ``broadcast``, which the reference has no
op for (its psum of the last stage's logits against zeros); the bytes of
its output on this rank; and its call site.  Outside a counter the
wrappers make the same calls with the same tensors as without one.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

_LOG: Optional[List[Dict]] = None
_HERE = os.path.abspath(__file__)


@contextlib.contextmanager
def count_collectives() -> Iterator[List[Dict]]:
    """Record every collective of the block: yields a list that gets one
    ``{"kind", "bytes", "site"}`` a call (``bytes`` of the output on this
    rank; ``site`` the innermost ``repro_torch`` frame outside this
    module, as ``file:line function``)."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


def call_site(skip: Sequence[str] = ()) -> str:
    """The innermost frame of the ``repro_torch`` package that is not in
    this module or in ``skip`` (absolute file paths), as
    ``repro_torch/<file>:<line> <function>``."""
    skip = {_HERE, *skip}
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        at = path.rfind(os.sep + "repro_torch" + os.sep)
        if at >= 0 and os.path.abspath(path) not in skip:
            return f"{path[at + 1:]}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


def _record(kind: str, t: torch.Tensor) -> None:
    if _LOG is not None:
        _LOG.append({"kind": kind, "bytes": t.numel() * t.element_size(),
                     "site": call_site()})


def send(t: torch.Tensor, dst: int) -> None:
    """Send ``t`` to global rank ``dst`` (through the host)."""
    _record("collective-permute", t)
    dist.send(t.detach().to("cpu").contiguous(), dst=dst)


def recv(shape, dtype, src: int) -> torch.Tensor:
    """Receive a host tensor of ``shape`` / ``dtype`` from global rank
    ``src``."""
    host = torch.empty(shape, dtype=dtype)
    dist.recv(host, src=src)
    _record("collective-permute", host)
    return host


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place, in its dtype; returns ``t``."""
    _record("all-reduce", t)
    dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, group_src: int, group) -> torch.Tensor:
    """Overwrite ``t`` on every rank of ``group`` with the tensor of the
    group's rank ``group_src``, in place; returns ``t``."""
    _record("broadcast", t)
    dist.broadcast(t, group_src=group_src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in the group's rank
    order (through the host), back on ``t``'s device."""
    host = t.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    out = torch.cat(parts, dim).to(t.device)
    _record("all-gather", out)
    return out


def all_gather_axes(t: torch.Tensor, groups: Sequence, dim: int = 0):
    """Gather over several mesh axes given major first, as a spec entry
    (("pod", "data")) splits a dimension: the minor axis first."""
    for g in reversed(tuple(groups)):
        t = all_gather(t, g, dim)
    return t
