"""Profile one (arch, shape) step on the card: its counted operations and
bytes against what the card took, the counterpart of the reference's
``launch/profile_pair.py`` (which prints a compiled TPU program's counts).

    PYTHONPATH=src python -m repro_torch.launch.profile_pair granite-3-2b prefill_32k one --batch 8 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.profile_pair granite-3-2b prefill_32k one --batch 4 --seq 1024 --staged int8

The step is the dry run's (``dryrun.step_fn``) on real tensors made from
seed 0, at the shape's batch and length unless ``--batch`` / ``--seq``
cut them and at the arch's depth unless ``--layers`` does; every cut is
printed in the ``reduced`` list.  The mesh is "one": one card.

It runs the step once under ``op_cost.analyze`` and prints the
reference's three blocks (the totals, the top byte ops, the top
collective ops), then times the warm step by CUDA events, reads the
device's busy share from ``torch.profiler``, and prints

    bound = max(flops / PEAK_FLOPS, bytes / HBM_BW) and its share of the
            device time;
    mfu   = model_flops / (PEAK_FLOPS * device s), the model's useful
            FLOPs (``roofline.model_flops_for``) whatever runs them.

A share above 1.05 exits non-zero: the count would exceed what the card
did.  ``--staged raw|int8`` runs ``core.hierarchy.staged_forward`` on 2
gloo ranks (``launch.mesh.run_world`` over ``launch.collab``'s "profile"
job), its exit moved to the middle layer so the scan blocks split in
half; each rank's counts and collectives are printed.  Without a card it
exits non-zero: there is no CPU path.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import device_trace, op_cost
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS, model_flops_for

MAX_SHARE = 1.05
SEED = 0          # the weights' and the inputs' seed


def cut_config(cfg, layers: Optional[int], staged: bool, reduced: List):
    """``cfg`` at its published widths, cut to ``layers`` (exits past the
    cut dropped); for a staged run its exits moved to the middle layer."""
    if layers and layers != cfg.num_layers:
        reduced.append(f"layers {cfg.num_layers} -> {layers}")
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name}-{layers}l", num_layers=layers,
            exits=dataclasses.replace(cfg.exits, exit_layers=tuple(
                e for e in cfg.exits.exit_layers if e < layers)))
    if staged:
        mid = cfg.num_layers // 2
        reduced.append(f"exits {cfg.exits.exit_layers} -> ({mid},): the "
                       "scan blocks split in half over 2 pods")
        cfg = dataclasses.replace(cfg, exits=dataclasses.replace(
            cfg.exits, exit_layers=(mid,)))
    return cfg


def cut_shape(shape, batch: Optional[int], seq: Optional[int],
              reduced: List):
    if batch and batch != shape.global_batch:
        reduced.append(f"batch {shape.global_batch} -> {batch}")
        shape = dataclasses.replace(shape, global_batch=batch)
    if seq and seq != shape.seq_len:
        reduced.append(f"seq {shape.seq_len} -> {seq}")
        shape = dataclasses.replace(shape, seq_len=seq)
    return shape


def make_batch(cfg, b: int, s: int, gen, device) -> Dict[str, torch.Tensor]:
    """The dry run's batch keys (``dryrun.batch_shapes``) with values:
    tokens and labels uniform over the vocabulary, every position in the
    loss, patches and frames N(0, 0.5^2) in bf16."""
    def rnd(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device=device)
                ).bfloat16()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=device, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=device, dtype=torch.int32),
             "loss_mask": torch.ones((b, s), dtype=torch.float32,
                                     device=device)}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = rnd(b, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "audio_frames":
        batch["frames"] = rnd(b, cfg.encdec.encoder_seq_len, cfg.d_model)
    return batch


def step_args(model, cfg, shape, long_mode: bool, device):
    """Real arguments of the step a shape's kind runs (``dryrun.step_fn``):
    seeded params (and zero optimizer state), batch, or a zero decode
    cache with seeded tokens at the cache's last position."""
    from repro_torch.training.optimizer import init_optimizer
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = model.init(SEED)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return (params, init_optimizer(params),
                make_batch(cfg, b, s, gen, device))
    if shape.kind == "prefill":
        return params, make_batch(cfg, b, s, gen, device)
    cache = model.init_decode_cache(b, s, long_mode=long_mode)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                           device=device, dtype=torch.int32)
    pos = torch.tensor(model.cache_len_for(s, long_mode) - 1,
                       dtype=torch.int32, device=device)
    return params, cache, tokens, pos


def print_cost(cost, k: int = 20) -> None:
    print(f"flops={cost.flops:.3e} bytes={cost.bytes:.3e} "
          f"coll={ {k: f'{v:.2e}' for k, v in cost.collective.items()} }")
    print("\n== top byte ops ==")
    for label, (b, _) in cost.top_bytes(k):
        print(f"  {b:12.3e} B  {label[:150]}")
    print("\n== top collective ops ==")
    for label, (_, cb) in cost.top_collective(k):
        print(f"  {cb:12.3e} B  {label[:150]}")


def busy_share(fn, args) -> float:
    """Device time over the host wall time of one synchronized call, from
    ``torch.profiler``: the union of the device operations' intervals
    (``launch/device_trace.py``, as ``launch.profile_decode`` reads it), so
    overlapping kernels count once."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return device_trace.busy_s(device_trace.device_ops(prof)) / wall_s


def count_step(arch: str, shape_name: str, *, batch=None, seq=None,
               layers=None, device="cuda") -> Dict:
    """Build the (cut) step on ``device`` with seeded inputs and count one
    run of it: the step, its arguments, the ``op_cost.Cost`` and the
    kernel launches of the counted run."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.dryrun import step_fn
    from repro_torch.models import Model
    reduced: List[str] = []
    cfg = cut_config(get_config(arch), layers, False, reduced)
    shape = cut_shape(INPUT_SHAPES[shape_name], batch, seq, reduced)
    long_mode = shape_name == "long_500k"
    print(f"profile_pair {arch} {shape_name} one: {shape.kind}, batch "
          f"{shape.global_batch}, seq {shape.seq_len}; reduced {reduced}")
    model = Model(cfg, device=device)
    fn = step_fn(model, shape.kind, long_mode)
    args = step_args(model, cfg, shape, long_mode, device)
    kops.reset_launches()
    cost = op_cost.analyze(fn, *args)
    return {"cfg": cfg, "shape": shape, "reduced": reduced, "fn": fn,
            "args": args, "cost": cost, "launches": dict(kops.LAUNCHES)}


def profile_step(arch: str, shape_name: str, *, batch=None, seq=None,
                 layers=None, iters: int = 3) -> Dict:
    """Count, time and profile one step on the card (module docstring);
    returns what it printed."""
    torch.cuda.reset_peak_memory_stats()
    st = count_step(arch, shape_name, batch=batch, seq=seq, layers=layers)
    cfg, shape, fn, args, cost = (st[k] for k in ("cfg", "shape", "fn",
                                                  "args", "cost"))
    print_cost(cost)
    fn(*args)                                           # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3 / iters
    busy = busy_share(fn, args)
    model_flops = model_flops_for(cfg, shape, shape.kind)
    t_ops, t_bytes = cost.flops / PEAK_FLOPS, cost.bytes / HBM_BW
    res = {"arch": arch, "shape": shape_name, "mesh": "one",
           "kind": shape.kind, "batch": shape.global_batch,
           "seq": shape.seq_len, "layers": cfg.num_layers,
           "reduced": st["reduced"], "flops": cost.flops,
           "bytes": cost.bytes, "kernels": cost.kernels,
           "launches": st["launches"], "device_ms": device_s * 1e3,
           "busy": busy, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share": max(t_ops, t_bytes) / device_s,
           "model_flops": model_flops,
           "mfu": model_flops / (PEAK_FLOPS * device_s),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "top_bytes": cost.top_bytes(10)}
    print(f"\ndevice {res['device_ms']:.3f} ms a step (CUDA events, warm, "
          f"{iters} steps), busy {busy:.3f} (torch.profiler); bound "
          f"{res['bound_ms']:.3f} ms by {res['bound_by']}, share "
          f"{res['share']:.3f}; model flops {model_flops:.3e}, mfu "
          f"{res['mfu']:.4f}; kernel launches {res['launches']}")
    return res


def profile_staged(arch: str, shape_name: str, modes, *, batch=None,
                   seq=None, layers=None) -> Dict:
    """``staged_forward`` on 2 gloo ranks, each mode ("raw" / "int8") in
    turn in one world; returns each rank's counts and collectives."""
    from repro_torch.launch.mesh import run_world
    reduced: List[str] = []
    cfg = cut_config(get_config(arch), layers, True, reduced)
    shape = cut_shape(INPUT_SHAPES[shape_name], batch, seq, reduced)
    print(f"profile_pair {arch} {shape_name} one --staged "
          f"{'/'.join(modes)}: 2 ranks, batch {shape.global_batch}, seq "
          f"{shape.seq_len}; reduced {reduced}")
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size,
                           (shape.global_batch, shape.seq_len),
                           generator=gen)
    job = dict(kind="profile", name="profile", mesh=dict(pod=2),
               device="cuda", cfg=cfg, stages=[0, 1], seed=SEED,
               batch={"tokens": tokens},
               runs=[m == "int8" for m in modes])
    tmp = tempfile.mkdtemp(prefix="profile_pair_")
    try:
        path = os.path.join(tmp, "jobs.pt")
        torch.save([job], path)
        t0 = time.time()
        run_world(2, "repro_torch.launch.collab:run_jobs", path, tmp,
                  threads=0)
        world_s = time.time() - t0
        ranks = [torch.load(os.path.join(tmp, f"profile.{r}.pt"),
                            weights_only=False) for r in (0, 1)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"arch": arch, "shape": shape_name, "reduced": reduced,
           "world_s": world_s, "modes": list(modes), "ranks": []}
    for o in ranks:
        runs = []
        for mode, r in zip(modes, o["runs"]):
            print(f"\n== rank {o['rank']} (pod {o['coords']['pod']}), {mode} "
                  f"boundary: flops={r['flops']:.3e} bytes={r['bytes']:.3e} "
                  f"{r['wall_ms']:.1f} ms (host clock); launches "
                  f"{r['launches']}")
            for kind, b in r["collective"].items():
                if b:
                    print(f"  {kind}: {b:.0f} B")
            for label, (_, cb) in r["top_collective"]:
                print(f"  {cb:12.3e} B  {label[:150]}")
            runs.append(dict({k: r[k] for k in (
                "flops", "bytes", "collective", "kernels", "launches",
                "wall_ms")}, mode=mode))
        out["ranks"].append({"rank": o["rank"], "coords": o["coords"],
                             "peak_bytes": o.get("peak_bytes"),
                             "runs": runs})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("mesh", choices=["one"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--staged", choices=["raw", "int8"], default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_pair: no CUDA card (torch.cuda.is_available() is "
              "False); it measures the card and has no CPU path",
              file=sys.stderr)
        sys.exit(2)
    print(f"card: {torch.cuda.get_device_name(0)}")
    kw = dict(batch=args.batch, seq=args.seq, layers=args.layers)
    if args.staged:
        res = profile_staged(args.arch, args.shape, [args.staged], **kw)
    else:
        res = profile_step(args.arch, args.shape, **kw)
    if not args.staged and not (res["share"] <= MAX_SHARE
                                and math.isfinite(res["share"])):
        print(f"profile_pair: share {res['share']:.3f} above {MAX_SHARE}: "
              "the count exceeds what the card did", file=sys.stderr)
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
