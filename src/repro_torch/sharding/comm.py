"""Host-staged collectives of the port's world of ranks (``launch.mesh``),
over ``gloo`` on either device.

Gloo's ``send`` / ``recv`` and ``all_gather`` take host tensors only, so
these wrappers copy to the host and back explicitly, on every device
alike.  A boundary that crosses a network goes through a host the same
way, so for staged execution the host-staged handoff is the transport,
not a fallback.  ``torch.distributed.all_reduce`` and ``broadcast`` are
called directly, with the tensor as it is: gloo takes CUDA tensors for
these two and stages them through the host itself.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def send(t: torch.Tensor, dst: int) -> None:
    """Send ``t`` to global rank ``dst`` (through the host)."""
    dist.send(t.detach().to("cpu").contiguous(), dst=dst)


def recv(shape, dtype, src: int) -> torch.Tensor:
    """Receive a host tensor of ``shape`` / ``dtype`` from global rank
    ``src``."""
    host = torch.empty(shape, dtype=dtype)
    dist.recv(host, src=src)
    return host


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in the group's rank
    order (through the host), back on ``t``'s device."""
    host = t.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim).to(t.device)


def all_gather_axes(t: torch.Tensor, groups: Sequence, dim: int = 0):
    """Gather over several mesh axes given major first, as a spec entry
    (("pod", "data")) splits a dimension: the minor axis first."""
    for g in reversed(tuple(groups)):
        t = all_gather(t, g, dim)
    return t
