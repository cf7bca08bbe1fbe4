"""Operation and byte counts of one eager step, the port's counterpart of
the reference's ``launch/hlo_cost.py`` (which reads a compiled XLA
program's HLO text; the port has no HLO, so it counts its own eager
program as it runs).

``analyze(fn, *args, **kw)`` runs ``fn`` once under a
``TorchDispatchMode``, on the tensors' device: "cpu", "meta" (the dry
run's stand-ins: nothing is allocated or computed) or "cuda".  It sees
every aten op below autograd, the backward's too.

Counting rules (the reference's, op by op):
- flops: 2 * M * N * K for the four products of
  ``analysis.costcheck.MATMUL_OPS`` (``aten.mm``, ``bmm``, ``addmm``,
  ``baddbmm``; an einsum or a matmul runs as one of them), plus each
  hand-written kernel's formula (``kernels.ops.count_costs``).
  Convolutions and elementwise work count 0, as the reference ignores
  elementwise and transcendental flops.
- bytes: every other op reads its tensor operands once and writes its
  outputs once; a tensor counts its distinct elements (an ``expand``ed
  operand its source).  Free: views (``view``, ``reshape`` that aliases,
  ``t`` / ``transpose`` / ``permute`` / ``expand`` / ``slice`` /
  ``select`` / ``(un)squeeze`` / ``as_strided`` / ``detach`` and every
  other op whose schema returns an alias), ``_unsafe_view``, and the
  factory ops that write no data (``empty`` and its kin).  An in-place
  write into part of a buffer (``copy_`` into a slice, ``index_copy_``,
  ``index_put_``) counts the source read and the written region, not the
  whole buffer: the reference's dynamic-update-slice rule.
- kernels: a wrapper's call counts its formulas only; its plain version
  runs hidden, so attention's [B, H, S, S] scores are never counted.
- collective: the output bytes of each collective of
  ``sharding.comm.count_collectives``, by kind.  A collective adds no
  HBM bytes of its own (the host copies of a host-staged one are aten
  ops, counted as such).

A Python loop over layers runs each layer, so every layer is counted
and no trip-count scaling is needed.  Each label in ``top`` is the op
(aten, kernel or collective) and its innermost ``repro_torch`` frame.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.costcheck import MATMUL_OPS
from repro_torch.kernels import ops as kops
from repro_torch.launch.roofline import COLLECTIVES
from repro_torch.sharding import comm

_SKIP = (os.path.abspath(__file__), os.path.abspath(kops.__file__))

_FREE = {"aten._unsafe_view", "aten.empty", "aten.empty_like",
         "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided",
         "aten.lift_fresh"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: a dimension of stride 0 (an
    ``expand``) reads its source once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    out, seen = [], set()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _product_flops(name: str, args) -> float:
    a, b = (args[1], args[2]) if name in ("aten.addmm",
                                          "aten.baddbmm") else args[:2]
    lead = math.prod(a.shape[:-2])
    return 2.0 * lead * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _region(self_t: torch.Tensor, indices) -> int:
    """Elements ``self_t[indices]`` selects (index_put_'s write)."""
    meta = torch.empty_strided(self_t.shape, self_t.stride(),
                               dtype=self_t.dtype, device="meta")
    idx = [None if i is None else torch.empty(i.shape, dtype=i.dtype,
                                              device="meta")
           for i in indices]
    return torch.ops.aten.index.Tensor(meta, idx).numel()


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    # label -> (bytes, collective bytes)
    top: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    # kernel -> {"calls", "flops", "bytes"}
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def note(self, label: str, nbytes: float, cbytes: float = 0.0) -> None:
        b, cb = self.top.get(label, (0.0, 0.0))
        self.top[label] = (b + nbytes, cb + cbytes)

    def top_bytes(self, k: int = 15):
        return sorted(self.top.items(), key=lambda kv: -kv[1][0])[:k]

    def top_collective(self, k: int = 15):
        return [t for t in sorted(self.top.items(),
                                  key=lambda kv: -kv[1][1])[:k]
                if t[1][1] > 0]

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.note(f"{name} (kernel)  {comm.call_site(_SKIP)}", nbytes)

    def add_op(self, func, args, kwargs, out) -> None:
        name = str(func.overloadpacket)
        if func.namespace == "c10d" or func.is_view or name in _FREE:
            return
        if name in MATMUL_OPS:
            self.flops += _product_flops(name, args)
        if name == "aten.copy_":              # dst region <- src
            nbytes = tensor_bytes(args[1]) + tensor_bytes(args[0])
        elif name == "aten.index_copy_":       # (self, dim, index, source)
            nbytes = tensor_bytes(args[2]) + 2 * tensor_bytes(args[3])
        elif name in ("aten.index_put_", "aten._index_put_impl_"):
            self_t, indices, values = args[0], args[1], args[2]
            accumulate = args[3] if len(args) > 3 else \
                kwargs.get("accumulate", False)
            region = _region(self_t, indices) * self_t.element_size()
            nbytes = (tensor_bytes(values)
                      + sum(tensor_bytes(i) for i in indices
                            if i is not None)
                      + region * (2 if accumulate else 1))
        else:
            nbytes = (sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
                      + sum(tensor_bytes(t) for t in _tensors(out)))
        self.bytes += nbytes
        if nbytes:
            self.note(f"{name}  {comm.call_site(_SKIP)}", nbytes)


class _Counting(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.add_op(func, args, kwargs, out)
        return out


def analyze(fn, *args, **kw) -> Cost:
    """Run ``fn(*args, **kw)`` once and count it (module docstring)."""
    cost = Cost()
    with comm.count_collectives() as log, \
            kops.count_costs(cost.add_kernel), _Counting(cost):
        fn(*args, **kw)
    for r in log:
        cost.collective[r["kind"]] += r["bytes"]
        cost.note(f"{r['kind']}  {r['site']}", 0.0, r["bytes"])
    return cost
