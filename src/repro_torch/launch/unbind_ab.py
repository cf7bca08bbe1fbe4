"""A full-width training step with the stacked layers taken by one unbind
against the design it replaced, on one card.

    python -m repro_torch.launch.unbind_ab [--arch granite-3-2b]
        [--batch 4] [--seq 1024] [--json PATH]

``blocks.run_scan_block`` takes a block's layers as the views of one
``torch.unbind`` of each stacked leaf.  The replaced design indexed every
leaf a layer at a time (``a[i]``): under autograd each ``SelectBackward``
fills a zero gradient of the whole stacked leaf and adds it to the
accumulator.  This times ``make_train_step`` both ways on one batch, in
the order unbind, a[i], a[i], unbind (the first of each a warm-up), by
CUDA events, with each step's peak device memory, and prints one line a
design.  The card is required.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import batch_for_model
from repro_torch.models import Model, blocks
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training import (OptimizerConfig, init_optimizer,
                                  make_train_step)


def _select_layers(tree):
    """The replaced design: every stacked leaf indexed a layer at a time."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], tree) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("unbind_ab needs the card")

    cfg = get_config(args.arch)
    model = Model(cfg, device="cuda")
    params = model.init(0)
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=10)
    step_fn = make_train_step(model, ocfg)
    opt = init_optimizer(params)
    batch = batch_for_model(cfg, InputShape("ab", args.seq, args.batch,
                                            "train"), 0, device="cuda")

    def timed_step():
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        e0.record()
        step_fn(params, opt, batch)
        e1.record()
        torch.cuda.synchronize()
        return {"host_ms": (time.time() - t0) * 1e3,
                "device_ms": e0.elapsed_time(e1),
                "peak_bytes": torch.cuda.max_memory_allocated()}

    unbind = blocks._unbind_layers
    runs = {"unbind": [], "select": []}
    for design in ("unbind", "select", "select", "unbind"):
        blocks._unbind_layers = unbind if design == "unbind" else \
            _select_layers
        runs[design].append(timed_step())
    blocks._unbind_layers = unbind

    stacked = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params["blocks"]))
    print(f"{cfg.name}, {cfg.num_layers} layers, {args.batch} x {args.seq}"
          f" tokens a step, {stacked / 1e9:.2f} GB of stacked block leaves")
    for design, label in (("unbind", "one unbind"), ("select", "a[i]")):
        r = runs[design]
        print(f"  {label}: device {[t['device_ms'] for t in r]} ms, host "
              f"{[t['host_ms'] for t in r]} ms, peak "
              f"{[t['peak_bytes'] / 1e9 for t in r]} GB")
    # the timed (non warm-up) step of each: the select's second, the
    # unbind's second
    sel, unb = runs["select"][1], runs["unbind"][1]
    print(f"  a[i] - unbind: device {sel['device_ms'] - unb['device_ms']} "
          f"ms, peak {(sel['peak_bytes'] - unb['peak_bytes']) / 1e9} GB")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "batch": args.batch,
                       "seq": args.seq, "stacked_bytes": stacked,
                       "runs": runs}, f, indent=1)
    return runs


if __name__ == "__main__":
    main()
