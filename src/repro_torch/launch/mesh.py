"""Meshes, and the port's world of ranks.

Production meshes stay abstract (no devices), so the partition rules run
on them anywhere:
  one card:   (data=1, model=1), the dry run's "one";
  single pod: (data=16, model=16) = 256 chips;
  multi pod:  (pod=2, data=16, model=16) = 512 chips; the "pod" axis
  carries data parallelism across pods AND the collaborative tier boundary
  of staged execution (``core.hierarchy.staged_forward``).

A live mesh is a ``torch.distributed`` world of processes, one rank each,
over the ``gloo`` backend: NCCL refuses two ranks on one card, and gloo
runs the same on the CPU and beside a card.  Gloo's ``all_reduce`` and
``broadcast`` take CUDA tensors (staged through the host inside gloo);
its ``send`` / ``recv`` and ``all_gather`` are given host tensors by the
callers.  ``run_world`` starts such a world:

    run_world(4, "repro_torch.launch.collab:run_jobs", jobs_path, out_dir)

spawns 4 processes, joins them through a ``file://`` rendezvous in a fresh
temporary directory, and calls the named function of an importable module
as ``fn(rank, world_size, *args)`` in each (a function of a test module is
not reliably importable in a spawned child).  A rank that raises or exits
non-zero stops the others and raises in the caller.
"""
from __future__ import annotations

import importlib
import os
import shutil
import tempfile
from typing import Any

from repro_torch.sharding.mesh_compat import AbstractMesh, make_abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


MESH_NAMES = ("one", "single", "multi")


def named_mesh(name: str) -> AbstractMesh:
    """The dry run's meshes by name: "one" (data 1 x model 1, one H100),
    "single" and "multi" (``make_production_mesh``)."""
    if name == "one":
        return make_abstract_mesh((1, 1), ("data", "model"))
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi")
    raise ValueError(f"unknown mesh {name!r}: one of {MESH_NAMES}")


def make_host_mesh(*, data: int = 1, model: int = 1, pod: int = 0):
    """A ``DeviceMesh`` over the initialized world with the reference's
    axis names: (pod, data, model) when ``pod`` is given, else (data,
    model).  Its product must be the world size.  The mesh's device type
    is "cpu": it only holds the process groups, which carry tensors of
    either device."""
    from torch.distributed.device_mesh import init_device_mesh
    if pod:
        return init_device_mesh("cpu", (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


def _rank_main(rank: int, world: int, entry: str, init_file: str,
               threads: int, args: tuple) -> None:
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    mod, _, name = entry.partition(":")
    fn = getattr(importlib.import_module(mod), name)
    fn(rank, world, *args)
    dist.barrier()
    dist.destroy_process_group()


def run_world(world: int, entry: str, *args: Any, threads: int = 1) -> None:
    """Run ``entry`` ("package.module:function") on ``world`` gloo ranks,
    ``torch`` pinned to ``threads`` intra-op threads in each (0 leaves the
    default).  Returns when every rank has returned."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        mp.spawn(_rank_main, args=(world, entry, os.path.join(tmp, "init"),
                                   threads, args),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
