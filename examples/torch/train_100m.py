"""End-to-end example on the PyTorch/CUDA port: train a ~100M-parameter
decoder for a few hundred steps on the synthetic copy-structured corpus,
with BranchyNet exit heads and checkpointing.

    PYTHONPATH=src python examples/torch/train_100m.py --steps 300 \\
        [--device cpu]

Checkpoints go to ``--ckpt`` (default ``build/train_100m_ckpt`` under the
repository root); a run finds the newest one there and resumes from it.
"""
import argparse
import dataclasses
import os

from repro_torch.configs import get_config
from repro_torch.configs.base import ExitConfig
from repro_torch.launch.train import train

DEFAULT_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "build", "train_100m_ckpt")


def make_100m_config():
    base = get_config("granite-3-2b")
    cfg = dataclasses.replace(
        base,
        name="granite-100m",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=3072,
        vocab_size=16_384,
        exits=ExitConfig(exit_layers=(4, 8), entropy_threshold=0.5),
    )
    return cfg


def main(argv=None, history=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = make_100m_config()
    params, metrics = train(
        cfg.name, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=6e-4, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        config_override=cfg, log_every=20, device=args.device,
        history=history)
    print("final metrics:", {k: round(v, 4) for k, v in metrics.items()})
    return params, metrics


if __name__ == "__main__":
    main()
