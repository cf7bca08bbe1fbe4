"""Quickstart on the PyTorch/CUDA port: train a tiny model, serve it, read
early-exit statistics.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import batch_for_model
from repro_torch.models import Model
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.training import (OptimizerConfig, TrainConfig,
                                  init_optimizer, make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("granite-3-2b-smoke")    # 2L reduced variant
    model = Model(cfg, device=args.device)
    params = model.init(0)
    opt = init_optimizer(params)
    step = make_train_step(
        model, OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=60),
        TrainConfig(exit_loss_weight=0.3))    # BranchyNet joint training

    shape = InputShape("quickstart", seq_len=64, global_batch=8, kind="train")
    print("training...")
    losses = []
    for i in range(60):
        batch = batch_for_model(cfg, shape, i, device=model.device)
        params, opt, metrics = step(params, opt, batch,
                                    torch.Generator().manual_seed(i))
        losses.append(float(metrics["loss"]))
        if i % 15 == 0 or i == 59:
            print(f"  step {i:3d}  loss {losses[-1]:.3f}  "
                  f"exit0_ce {float(metrics.get('exit0_ce', 0)):.3f}")

    print("serving...")
    engine = ServingEngine(model, params, ServeConfig(exit_threshold=0.8))
    prompts = torch.randint(0, cfg.vocab_size, (4, 8),
                            generator=torch.Generator().manual_seed(7))
    out = engine.generate(prompts, max_new=16)
    stats = engine.exit_stats()
    print(f"  generated {tuple(out.shape)}; early-exit stats: "
          f"{ {k: round(v, 3) for k, v in stats.items()} }")
    return {"losses": losses, "out": out, "exit_stats": stats}


if __name__ == "__main__":
    main()
