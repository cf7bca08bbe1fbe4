"""Failure-resilient distributed inference on the PyTorch/CUDA port
(deepFogGuard/ResiliNet, survey §5.2.3): train WITH failout, then show
inference survives dead stages.

    PYTHONPATH=src python examples/torch/resilient_inference.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.resilience import n_scan_blocks, resilient_forward
from repro_torch.data import batch_for_model
from repro_torch.models import Model
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.training import (OptimizerConfig, TrainConfig,
                                  init_optimizer, make_train_step)


def eval_ce(model, params, batch, alive):
    with torch.no_grad():
        logits, _ = resilient_forward(model, params, batch, alive)
        return float(softmax_cross_entropy(logits, batch["labels"],
                                           batch["loss_mask"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    cfg = get_config("granite-3-2b-smoke")
    shape = InputShape("r", 64, 8, "train")

    results = {}
    for failout_p, tag in ((0.0, "plain"), (0.25, "failout")):
        model = Model(cfg, device=args.device)
        params = model.init(0)
        opt = init_optimizer(params)
        step = make_train_step(
            model, OptimizerConfig(lr=1e-3, warmup_steps=5,
                                   total_steps=args.steps),
            TrainConfig(failout_prob=failout_p))
        for i in range(args.steps):
            b = batch_for_model(cfg, shape, i, device=model.device)
            params, opt, _ = step(params, opt, b,
                                  torch.Generator().manual_seed(i))
        nb = n_scan_blocks(model)
        test = batch_for_model(cfg, shape, 999, device=model.device)
        all_alive = torch.ones((nb,), dtype=torch.float32)
        one_dead = all_alive.clone()
        one_dead[0] = 0.0
        results[tag] = (eval_ce(model, params, test, all_alive),
                        eval_ce(model, params, test, one_dead))

    print("cross-entropy (lower=better):  all-alive | stage-0 dead")
    for tag, (full, dead) in results.items():
        print(f"  {tag:8s} {full:10.3f} | {dead:10.3f} "
              f"(degradation +{dead-full:.3f})")
    assert (results["failout"][1] - results["failout"][0]) < \
           (results["plain"][1] - results["plain"][0]) + 0.5, \
        "failout training should reduce failure degradation"
    print("-> failout training tolerates a dead stage better "
          "(ResiliNet, reproduced)")
    return results


if __name__ == "__main__":
    main()
