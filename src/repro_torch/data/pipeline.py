"""Synthetic data pipeline: deterministic and stateless.

A batch is a pure function of (config, shape, step): every draw comes
from a CPU ``torch.Generator`` seeded with ``step``, so a batch is the
same on every device and after a restart.  Two sources, as in the
reference package's ``data/pipeline.py``:

- ``lm_batch``: a Zipf-distributed token stream with a copy structure
  (spans repeated at a fixed lag), so language-model training has real
  signal and the loss visibly drops in the examples;
- frontend stubs: ``patch_embeds`` (vlm) / ``frames`` (encdec), the
  precomputed modality embeddings the models take.

The tokens are drawn with ``torch.multinomial`` on the Zipf
probabilities, not by sampling a [B, S, V] broadcast of logits as the
reference does (0.8 GB at (4, 1024, 49,155)).  The bits differ from the
reference's, by design; parity tests hand both packages the reference's
batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    copy_lag: int = 32            # tokens repeat with this lag (learnable signal)
    copy_prob: float = 0.5
    zipf_a: float = 1.2


def zipf_probs(vocab: int, a: float):
    """Zipf(a) probabilities of the ranks 1..V, fp64 [V]."""
    w = torch.arange(1, vocab + 1, dtype=torch.float64) ** -a
    return w / w.sum()


def lm_batch(cfg: DataConfig, step: int, *, d_model: int = 0,
             frontend: str = "none", frontend_tokens: int = 0,
             device="cpu") -> Dict[str, torch.Tensor]:
    """One global batch: tokens / labels [B, S] int32, loss_mask [B, S]
    fp32 (0 at the last column, whose label wraps, and at patch
    positions), plus the stub embeddings; drawn on the CPU, then moved to
    ``device``."""
    gen = torch.Generator().manual_seed(step)
    b, s = cfg.global_batch, cfg.seq_len
    toks = torch.multinomial(zipf_probs(cfg.vocab_size, cfg.zipf_a), b * s,
                             replacement=True, generator=gen).reshape(b, s)
    # copy structure: with copy_prob, token[t] = token[t - lag]
    lag = min(cfg.copy_lag, s - 1)
    copy = torch.rand((b, s), generator=gen) < cfg.copy_prob
    idx = torch.arange(s)[None, :]
    toks = torch.where((idx >= lag) & copy, torch.roll(toks, lag, dims=1),
                       toks).to(torch.int32)
    mask = torch.ones((b, s), dtype=torch.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
             "loss_mask": mask}
    if frontend == "vision_patches" and frontend_tokens:
        batch["patch_embeds"] = (0.02 * torch.randn(
            (b, min(frontend_tokens, s), d_model),
            generator=gen)).to(torch.bfloat16)
        mask[:, :frontend_tokens] = 0.0
    if frontend == "audio_frames" and frontend_tokens:
        batch["frames"] = (0.02 * torch.randn(
            (b, frontend_tokens, d_model), generator=gen)).to(torch.bfloat16)
    return {k: v.to(device) for k, v in batch.items()}


def batch_for_model(model_cfg, shape, step: int,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """A batch matching a (ModelConfig, InputShape) pair."""
    dcfg = DataConfig(model_cfg.vocab_size, shape.seq_len, shape.global_batch)
    return lm_batch(dcfg, step, d_model=model_cfg.d_model,
                    frontend=model_cfg.frontend,
                    frontend_tokens=model_cfg.frontend_tokens, device=device)


def data_iterator(model_cfg, shape, start_step: int = 0,
                  device="cpu") -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_for_model(model_cfg, shape, step, device)
        step += 1
