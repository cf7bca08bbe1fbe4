"""End-to-end training entry point of the port.

Runs a real training loop on one device, the card unless ``--device cpu``:

    python -m repro_torch.launch.train --arch granite-3-2b-smoke \\
        --device cpu --steps 100 --batch 8 --seq 128 --ckpt build/ckpt
    python -m repro_torch.launch.train --arch granite-3-2b --steps 5 \\
        --batch 4 --seq 1024

Batches come from the synthetic ``data.batch_for_model`` stream (step i
draws batch i), the params from ``Model.init(seed)``.  Each step's
failout draw (``--failout``) comes from a generator seeded by (seed,
step), so a run resumed from a checkpoint draws what the uninterrupted
run drew.  With ``--ckpt``, the newest checkpoint there is restored first,
one is written every ``ckpt_every`` steps and one at the end, in the
reference package's npz format.  ``examples/torch/train_100m.py`` calls
``train`` with a ~100M-parameter config.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import batch_for_model
from repro_torch.models import Model
from repro_torch.models.common import tree_leaves
from repro_torch.training import (OptimizerConfig, TrainConfig,
                                  init_optimizer, latest_checkpoint,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's random draws (failout)."""
    return torch.Generator().manual_seed(seed * (1 << 32) + step)


def train(arch: str, steps: int, batch: int, seq: int, *, lr: float = 3e-4,
          microbatches: int = 1, failout: float = 0.0, ckpt_dir: str = "",
          ckpt_every: int = 200, log_every: int = 10, seed: int = 0,
          config_override=None, device="cuda", history=None):
    """Trains ``steps`` steps of ``batch`` x ``seq`` tokens and returns
    (params, the last step's metrics as floats).  ``history``, a list,
    gets each step's metrics as floats and ``step_s``, the step's host
    time (batch included; reading the metrics waits for the device)."""
    cfg = config_override or get_config(arch)
    model = Model(cfg, device=device)
    params = model.init(seed)
    opt_state = init_optimizer(params)
    start = 0
    if ckpt_dir:
        last = latest_checkpoint(ckpt_dir)
        if last:
            state = restore_checkpoint(last, {"params": params,
                                              "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = int(opt_state["step"])
            print(f"restored step {start} from {last}")

    ocfg = OptimizerConfig(lr=lr, warmup_steps=max(10, steps // 20),
                           total_steps=steps)
    tcfg = TrainConfig(microbatches=microbatches, failout_prob=failout)
    step_fn = make_train_step(model, ocfg, tcfg)
    shape = InputShape("cli", seq, batch, "train")

    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={steps} "
          f"batch={batch} seq={seq} device={model.device}")
    t0 = time.time()
    metrics = {}
    for step in range(start, steps):
        t_step = time.time()
        b = batch_for_model(cfg, shape, step, device=model.device)
        params, opt_state, metrics = step_fn(params, opt_state, b,
                                             step_generator(seed, step))
        if history is not None:
            history.append({**{k: float(v) for k, v in metrics.items()},
                            "step_s": time.time() - t_step})
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            tput = (step - start + 1) * batch * seq / max(dt, 1e-9)
            print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"gnorm {m['grad_norm']:.2f} lr {m['lr']:.2e} "
                  f"tok/s {tput:,.0f}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, {"params": params, "opt": opt_state},
                            step + 1)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, {"params": params, "opt": opt_state},
                        steps)
    return params, {k: float(v) for k, v in metrics.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--failout", type=float, default=0.0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.arch, args.steps, args.batch, args.seq, lr=args.lr,
          microbatches=args.microbatches, failout=args.failout,
          ckpt_dir=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
