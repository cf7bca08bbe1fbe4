"""Dry run: price every (arch x input-shape x mesh) step of the port
without a card, the counterpart of the reference's ``launch/dryrun.py``
(which lowers and compiles each step for placeholder TPU chips).

Every input is a "meta" tensor: the params (``Model.abstract_params``),
the optimizer state (``init_optimizer`` on them), the batch
(``batch_shapes``: tokens, labels, loss mask, patches, frames) and the
decode cache (``init_decode_cache(..., device="meta")``).  The step is
the port's own (``make_train_step``; ``Model.forward`` with every output
kept; ``make_serve_step(model, long_mode=)``), run once at full width and
depth under ``op_cost.analyze``: nothing is allocated and nothing is
computed, only counted.

What the result holds, and why each number means what it says:
- memory, exact: each argument's shard under ``ShardingRules(mesh,
  strategy)`` (``local_slice`` of every leaf at the first rank's
  coordinates), summed per device by part (params, optimizer state,
  batch, cache, decode inputs).  ``fits_80gb`` compares their sum with
  one H100's 80 GB: arguments only, since no compiler reports the
  port's temporaries.
- roofline per device: the counted flops and bytes divided by the
  mesh's chips.  The port has no partitioner, so this is the ideal
  partition of the one-device program.  ``useful_flops_ratio`` is the
  model FLOPs over the counted FLOPs.  The reference's train FLOPs
  include its rematerialization's recompute; the port does not
  rematerialize.  The port issues no tensor-parallel collectives, so
  the collective term is null: never a guess.
- a step that reads a value back to the host raises on meta; the
  combination is then "fail", with the site named.

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, \
    shape_applicable
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import MESH_NAMES, named_mesh
from repro_torch.launch.roofline import HBM_BYTES, Roofline, model_flops_for
from repro_torch.models import Model
from repro_torch.models.common import tree_leaves
from repro_torch.serving.engine import make_serve_step
from repro_torch.sharding.specs import ShardingRules, local_tree
from repro_torch.training import OptimizerConfig, TrainConfig, \
    make_train_step
from repro_torch.training.optimizer import init_optimizer

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# input_specs: meta stand-ins for every input of the step a shape runs
# ---------------------------------------------------------------------------

def batch_shapes(cfg, shape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
        "loss_mask": _meta((b, s), torch.float32),
    }
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = _meta((b, cfg.frontend_tokens, cfg.d_model),
                                      torch.bfloat16)
    if cfg.frontend == "audio_frames":
        batch["frames"] = _meta((b, cfg.encdec.encoder_seq_len, cfg.d_model),
                                torch.bfloat16)
    return batch


def step_fn(model, kind: str, long_mode: bool = False):
    """The step an input shape's kind runs: "train" ``make_train_step``
    (params, opt_state, batch); "prefill" ``Model.forward`` with every
    output kept (params, batch); "decode" ``make_serve_step`` (params,
    cache, tokens, pos).  Forward and decode run without autograd."""
    if kind == "train":
        return make_train_step(model, OptimizerConfig(),
                               TrainConfig(microbatches=1))
    if kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return model.forward(params, batch, long_mode=long_mode)
        return prefill
    serve = make_serve_step(model, long_mode=long_mode)

    def decode(params, cache, tokens, pos):
        with torch.no_grad():
            return serve(params, cache, tokens, pos)
    return decode


def input_specs(arch: str, shape_name: str, mesh,
                strategy: str = "tp", variant: str = "") -> Dict[str, Any]:
    """The step a shape runs, its meta arguments, and each argument part
    with its specs under ``ShardingRules(mesh, strategy)``:
    ``parts[name] = (tree, specs)``.

    variant "w8a8": a decode step's MoE experts in W8A8
    (``ffn.quantize_model_moe``), the reference's serving profile."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    long_mode = shape_name == "long_500k"
    model = Model(cfg, device=META)
    rules = ShardingRules(mesh, strategy=strategy)
    params = model.abstract_params()
    if "w8a8" in variant and shape.kind == "decode":
        from repro_torch.models.ffn import quantize_model_moe
        quantize_model_moe(params)
    parts = {"params": (params, rules.params_specs(params))}
    if shape.kind == "train":
        opt = init_optimizer(params)
        batch = batch_shapes(cfg, shape)
        parts["opt_state"] = (opt, rules.opt_specs(opt, params))
        parts["batch"] = (batch, rules.batch_specs(batch))
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        batch = batch_shapes(cfg, shape)
        parts["batch"] = (batch, rules.batch_specs(batch))
        args = (params, batch)
    else:
        b = shape.global_batch
        cache = model.init_decode_cache(b, shape.seq_len,
                                        long_mode=long_mode, device=META)
        tokens = _meta((b, 1), torch.int32)
        pos = _meta((), torch.int32)
        data = "data" if "data" in mesh.axis_names and \
            b % mesh.shape["data"] == 0 else None
        parts["cache"] = (cache, rules.cache_specs(cache))
        parts["inputs"] = ({"tokens": tokens, "pos": pos},
                           {"tokens": (data, None), "pos": ()})
        args = (params, cache, tokens, pos)
    return dict(model=model, cfg=cfg, shape=shape,
                fn=step_fn(model, shape.kind, long_mode), args=args,
                parts=parts, kind=shape.kind)


def argument_bytes(parts, mesh) -> Dict[str, int]:
    """Per-device bytes of each argument part: the first rank's shard of
    every leaf under its spec."""
    coords = {a: 0 for a in mesh.axis_names}
    return {name: sum(t.numel() * t.element_size() for t in tree_leaves(
                local_tree(tree, specs, mesh, coords)))
            for name, (tree, specs) in parts.items()}


# ---------------------------------------------------------------------------
# Dry-run one combination
# ---------------------------------------------------------------------------

def _fail_site(exc: BaseException) -> str:
    """The innermost ``repro_torch`` frame of a traceback, as
    ``file:line function``."""
    site = "?"
    for fr in traceback.extract_tb(exc.__traceback__):
        at = fr.filename.rfind(os.sep + "repro_torch" + os.sep)
        if at >= 0:
            site = f"{fr.filename[at + 1:]}:{fr.lineno} {fr.name}"
    return site


def dryrun_one(arch: str, shape_name: str, mesh_name: str,
               save: bool = True, strategy: str = "tp",
               variant: str = "",
               counts: Optional[Dict] = None) -> Dict[str, Any]:
    """Price one combination (module docstring).  ``counts``, a dict the
    caller keeps across calls, holds each step's count by (arch, shape,
    variant): the count does not depend on the mesh or the strategy, so
    ``--all`` runs each step once for its three meshes."""
    cfg = get_config(arch)
    if not shape_applicable(cfg, shape_name):
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped",
               "reason": "long_500k skipped: pure full-attention arch "
                         "(DESIGN.md §3)"}
        if save:
            _save(res)
        return res

    mesh = named_mesh(mesh_name)
    t0 = time.time()
    spec = input_specs(arch, shape_name, mesh, strategy=strategy,
                       variant=variant)
    args_b = argument_bytes(spec["parts"], mesh)
    per_device = sum(args_b.values())
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": spec["kind"], "chips": mesh.size, "strategy": strategy,
            "variant": variant,
            "argument_bytes_per_device": args_b,
            "argument_bytes": per_device,
            "fits_80gb": per_device <= HBM_BYTES}
    t_specs = time.time() - t0
    key = (arch, shape_name, variant)
    try:
        cost = counts[key] if counts and key in counts else \
            op_cost.analyze(spec["fn"], *spec["args"])
    except RuntimeError as e:       # a host readback: meta has no value
        res = dict(base, status="fail", site=_fail_site(e),
                   error=f"{type(e).__name__}: {str(e)[:400]}")
        if save:
            _save(res)
        return res
    if counts is not None:
        counts[key] = cost
    t_run = time.time() - t0 - t_specs
    chips = mesh.size
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops / chips, hlo_bytes=cost.bytes / chips,
        collective=None,
        model_flops=model_flops_for(cfg, spec["shape"], spec["kind"]))
    res = dict(base, status="ok", specs_s=round(t_specs, 2),
               run_s=round(t_run, 2),
               counted={"flops": cost.flops, "bytes": cost.bytes,
                        "kernels": cost.kernels},
               top_bytes=[[label, b] for label, (b, _) in
                          cost.top_bytes(15)],
               roofline=rl.to_dict())
    if save:
        _save(res)
    return res


def _path(arch: str, shape: str, mesh: str, tag: str = "") -> str:
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh}{tag}.json")


def _save(res):
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = ""
    if res.get("strategy", "tp") != "tp" or res.get("variant"):
        tag = "__" + "-".join(filter(None, [
            res.get("strategy") if res.get("strategy") != "tp" else "",
            res.get("variant", "")]))
    with open(_path(res["arch"], res["shape"], res["mesh"], tag), "w") as f:
        json.dump(res, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=MESH_NAMES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=["tp", "dp_zero"])
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for a in ARCHS:
            for s in INPUT_SHAPES:
                for m in MESH_NAMES:
                    combos.append((a, s, m))
    else:
        combos.append((args.arch, args.shape, args.mesh))

    counts: Dict = {}
    for a, s, m in combos:
        if args.skip_existing and os.path.exists(_path(a, s, m)):
            print(f"skip {a} {s} {m} (exists)")
            continue
        t0 = time.time()
        try:
            res = dryrun_one(a, s, m, strategy=args.strategy,
                             variant=args.variant, counts=counts)
        except Exception as e:        # record it and go on to the next
            res = {"arch": a, "shape": s, "mesh": m, "status": "fail",
                   "strategy": args.strategy, "variant": args.variant,
                   "site": _fail_site(e),
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            _save(res)
        status = res["status"]
        extra = ""
        if status == "ok":
            r = res["roofline"]
            extra = (f"args={res['argument_bytes'] / 1e9:.2f}GB/dev "
                     f"fits_80gb={res['fits_80gb']} "
                     f"flops={r['hlo_flops']:.3e} bytes={r['hlo_bytes']:.3e} "
                     f"bottleneck={r['bottleneck']}")
        elif status == "fail":
            extra = f"at {res['site']}: {res['error'][:160]}"
        print(f"[{time.time() - t0:7.1f}s] {a:26s} {s:12s} {m:6s} {status} "
              f"{extra}", flush=True)


if __name__ == "__main__":
    main()
