"""Rank programs of the collaborative paths: staged execution across pods
(``core.hierarchy.staged_forward``), the expert-parallel MoE and a model
forward whose MoE layers run expert parallel.

    run_world(n, "repro_torch.launch.collab:run_jobs", jobs_path, out_dir)

Every rank loads the list of jobs that ``jobs_path`` holds (``torch.save``
of a list of dicts), builds each job's mesh over the world
(``launch.mesh.make_host_mesh``), runs the job, and writes what it got to
``out_dir/<name>.<rank>.pt``.  A job gives its weights either as a full
params tree (each rank keeps only its part: its stage's blocks, its
experts) or as a seed (each rank makes only its part, the draws of the
rest made and dropped, so the parts equal a full init's).  Keys:

  every job: "kind", "name", "mesh" (make_host_mesh's sizes), "device"
      ("cuda" unless the job asks for "cpu");
  "staged": "cfg", "stages", "batch", "params" or "seed", "runs" (a list
      of compress flags, run in order, after one untimed run of each
      flag when "warmup"), "save_logits", "forward" (a full-params rank 0
      also runs the one-process ``Model.forward``);
  "moe": "cfg", "x", "params" (a full layer) or "seed" with "w8a8",
      "warmup" (one untimed call first);
  "forward": "cfg", "params", "batch", "single" (rank 0 also runs the
      one-device forward);
  "profile" (``launch.profile_pair --staged``): "cfg", "stages", "seed",
      "batch", "runs" (compress flags): after an untimed warm-up run of
      each flag, each run once under ``launch.op_cost.analyze`` (this
      rank's flops, bytes, kernels, collectives by kind and the top
      labels) and once timed.

"staged" and "moe" jobs with "count" also record each run's collectives
(``sharding.comm.count_collectives``: kind, bytes, site) under
"collectives"; a "moe" job with "count" runs the layer a second time
without the counter and keeps that output as "y_uncounted".

A rank records its kernel launches (``kernels.ops.LAUNCHES``) and wall
time for each run, and on the card its peak device memory.  Nothing here
catches an error: a rank that raises fails the world.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import time

import torch
import torch.distributed as dist

from repro_torch.sharding import comm


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (bit-for-bit comparisons across
    processes without shipping the tensor)."""
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _counter(job):
    """The collective counter where the job asks to count, else nothing."""
    return (comm.count_collectives() if job.get("count")
            else contextlib.nullcontext())


def run_jobs(rank: int, world: int, jobs_path: str, out_dir: str) -> None:
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import resolve_device
    for job in torch.load(jobs_path, weights_only=False):
        dev = resolve_device(job.get("device", "cuda"))
        mesh = make_host_mesh(**job["mesh"])
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = _KINDS[job["kind"]](job, mesh, dev, kops)
        if dev.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["rank"] = rank
        out["coords"] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        torch.save(out, os.path.join(out_dir, f"{job['name']}.{rank}.pt"))


def _staged(job, mesh, dev, kops):
    from repro_torch.core.hierarchy import (stage_parts, stage_params,
                                            staged_forward)
    from repro_torch.kernels import ref
    from repro_torch.models import Model
    from repro_torch.models.common import tree_leaves
    model = Model(job["cfg"], device=dev)
    stages = job["stages"]
    pod = mesh.get_local_rank("pod")
    out = {"runs": []}
    t0 = time.perf_counter()
    if "params" in job:
        full = job["params"]
        params = stage_params(full, model, stages, pod)
    else:
        full = None
        params = model.init(job["seed"], keep=stage_parts(model, stages, pod))
    _sync(dev)
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(params) if t is not None)
    out["blocks"] = [i for i, b in enumerate(params["blocks"])
                     if b is not None]
    batch = job["batch"]
    runs = list(job["runs"])
    n_warm = len(set(runs)) if job.get("warmup") else 0
    runs = sorted(set(runs)) * bool(n_warm) + runs
    logits_of = {}
    for i, compress in enumerate(runs):
        handoffs = []
        kops.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        with _counter(job) as log:
            logits = staged_forward(model, params, batch, stages, mesh,
                                    compress_boundary=compress,
                                    handoffs=handoffs)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        if i < n_warm:
            continue
        rec = {"compress": compress, "wall_ms": wall,
               "launches": dict(kops.LAUNCHES), "digest": _digest(logits),
               "finite": bool(torch.isfinite(logits).all()),
               "shape": tuple(logits.shape), "handoffs": []}
        for h in handoffs:
            r = {k: h[k] for k in ("block", "src", "dst", "side", "bytes",
                                   "ms")}
            if "q" in h and h["side"] == "send":   # the kernels at the
                q, s = ref.quantize_rows_ref(h["x"])  # live boundary
                r["q_equal"] = bool(torch.equal(q, h["q"]))  # against
                r["scale_equal"] = bool(torch.equal(    # their plain
                    s.view(torch.int32), h["scale"].view(torch.int32)))
            elif "q" in h:                            # versions, bitwise
                x = ref.dequantize_rows_ref(h["q"], h["scale"], h["x"].dtype)
                r["x_equal"] = bool(torch.equal(
                    x.view(torch.int16), h["x"].view(torch.int16)))
            if job.get("save_logits"):
                r.update({k: h[k].cpu() for k in ("x", "q", "scale")
                          if k in h})
            rec["handoffs"].append(r)
        if job.get("save_logits"):
            rec["logits"] = logits.cpu()
        if job.get("count"):
            rec["collectives"] = log
        logits_of[compress] = logits
        out["runs"].append(rec)
    if True in logits_of and False in logits_of:
        out["compressed_vs_raw"] = float(
            (logits_of[True] - logits_of[False]).abs().max())
    del logits_of
    if job.get("forward") and full is not None and mesh.get_rank() == 0:
        out["forward"] = model.forward(
            full, {k: v.to(dev) for k, v in batch.items()}).logits.cpu()
    return out


def _moe(job, mesh, dev, kops):
    from repro_torch.models import ffn
    from repro_torch.models.common import tree_map
    cfg = job["cfg"]
    ctx = ffn.ShardCtx(mesh)
    t0 = time.perf_counter()
    if "params" in job:
        params = ffn.local_experts(
            tree_map(lambda t: t.to(dev), job["params"]), ctx)
    else:
        e_loc = cfg.moe.num_experts // ctx.model_size
        e0 = ctx.coord("model") * e_loc if ctx.model_axis else 0
        params = ffn.init_moe_layer(cfg, job["seed"], dev, (e0, e0 + e_loc),
                                    w8a8=job.get("w8a8", False))
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_local = params["wg_q" if "wg_q" in params else "wg"].shape[0]
    x = job["x"].to(dev)
    if job.get("warmup"):
        ffn.moe_ffn(params, x, cfg, ctx)
    kops.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    with _counter(job) as log:
        y, aux = ffn.moe_ffn(params, x, cfg, ctx)
    _sync(dev)
    out = {"y": y.cpu(), "aux": aux.cpu(), "init_s": init_s,
           "local_experts": n_local,
           "wall_ms": (time.perf_counter() - t0) * 1e3,
           "launches": dict(kops.LAUNCHES)}
    if job.get("count"):
        out["collectives"] = log
        out["y_uncounted"] = ffn.moe_ffn(params, x, cfg, ctx)[0].cpu()
    if ctx.model_axis:      # the combine's all_reduce alone, on its shape
        b, s, d = x.shape
        rows = (b // ctx.data_size if b % ctx.data_size == 0 else b) * s
        buf = torch.zeros((rows, d), dtype=x.dtype, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=ctx.group(ctx.model_axis))
        _sync(dev)
        out["combine_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def _forward(job, mesh, dev, kops):
    from repro_torch.models import Model, ffn
    from repro_torch.models.common import tree_map
    ctx = ffn.ShardCtx(mesh)
    model = Model(job["cfg"], device=dev, ctx=ctx)
    params = ffn.local_experts(tree_map(lambda t: t.to(dev), job["params"]),
                               ctx)
    batch = {k: v.to(dev) for k, v in job["batch"].items()}
    kops.reset_launches()
    out = model.forward(params, batch)
    res = {"logits": out.logits.cpu(), "aux": out.aux_loss.cpu(),
           "launches": dict(kops.LAUNCHES)}
    if job.get("single") and mesh.get_rank() == 0:
        one = Model(job["cfg"], device=dev).forward(
            tree_map(lambda t: t.to(dev), job["params"]), batch)
        res["single_logits"] = one.logits.cpu()
    return res


def _profile(job, mesh, dev, kops):
    from repro_torch.core.hierarchy import stage_parts, staged_forward
    from repro_torch.launch import op_cost
    from repro_torch.models import Model
    model = Model(job["cfg"], device=dev)
    stages = job["stages"]
    params = model.init(job["seed"], keep=stage_parts(
        model, stages, mesh.get_local_rank("pod")))
    batch = job["batch"]

    def run(compress):
        return staged_forward(model, params, batch, stages, mesh,
                              compress_boundary=compress)
    for compress in sorted(set(job["runs"])):       # warm-up, untimed
        run(compress)
    out = {"runs": []}
    for compress in job["runs"]:
        kops.reset_launches()
        cost = op_cost.analyze(run, compress)
        launches = dict(kops.LAUNCHES)
        _sync(dev)
        t0 = time.perf_counter()
        run(compress)
        _sync(dev)
        out["runs"].append({
            "compress": compress, "flops": cost.flops, "bytes": cost.bytes,
            "collective": cost.collective, "kernels": cost.kernels,
            "top_bytes": cost.top_bytes(10),
            "top_collective": cost.top_collective(10),
            "launches": launches,
            "wall_ms": (time.perf_counter() - t0) * 1e3})
    return out


_KINDS = {"staged": _staged, "moe": _moe, "forward": _forward,
          "profile": _profile}
