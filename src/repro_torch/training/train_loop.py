"""Training step: BranchyNet joint exit loss + MoE aux + MTP + optional
ResiliNet failout, with microbatched gradient accumulation.

``make_train_step(model, opt_cfg, tcfg)`` returns ``train_step(params,
opt_state, batch, generator) -> (params, opt_state, metrics)``, the
reference package's step (``training/train_loop.py``) in eager PyTorch:
autograd takes the gradients (the attention's through the flash backward
kernel on the card) and ``apply_updates`` writes the params in place.
The params' floating leaves require grad only inside the step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.resilience import failout, n_scan_blocks, \
    resilient_forward
from repro_torch.models.common import softmax_cross_entropy, tree_leaves, \
    tree_map
from repro_torch.training.optimizer import OptimizerConfig, apply_updates


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    exit_loss_weight: float = 0.3      # BranchyNet joint training
    aux_loss_coef: float = 0.01        # MoE load balance
    mtp_loss_weight: float = 0.3       # DeepSeek-V3 MTP
    failout_prob: float = 0.0          # ResiliNet stage dropout (0 = off)
    microbatches: int = 1              # gradient accumulation


def compute_loss(model, params, batch, *, tcfg: TrainConfig,
                 generator: Optional[torch.Generator] = None,
                 long_mode: bool = False):
    """Scalar loss and a metrics dict: the final CE, plus
    ``exit_loss_weight`` x each exit's CE, ``aux_loss_coef`` x the MoE aux
    loss and ``mtp_loss_weight`` x the MTP CE (labels and mask rolled by
    -1).  With ``failout_prob`` > 0 and a generator, the forward is
    ``resilient_forward`` under a failout mask, with aux 0 and no MTP."""
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if tcfg.failout_prob > 0.0 and generator is not None:
        alive = failout(generator, n_scan_blocks(model),
                        1.0 - tcfg.failout_prob)
        logits, exit_logits = resilient_forward(model, params, batch, alive,
                                                long_mode=long_mode)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        mtp_logits = None
    else:
        out = model.forward(params, batch, long_mode=long_mode)
        logits, exit_logits, aux = out.logits, out.exit_logits, out.aux_loss
        mtp_logits = out.mtp_logits

    loss = softmax_cross_entropy(logits, labels, mask)
    metrics = {"ce": loss}
    for i, el in enumerate(exit_logits):
        ce = softmax_cross_entropy(el, labels, mask)
        metrics[f"exit{i}_ce"] = ce
        loss = loss + tcfg.exit_loss_weight * ce
    if aux is not None:
        loss = loss + tcfg.aux_loss_coef * aux
        metrics["aux"] = aux
    if mtp_logits is not None:
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_mask = mask
        if mask is not None:
            mtp_mask = mask * torch.roll(mask, -1, dims=1)
        ce = softmax_cross_entropy(mtp_logits, mtp_labels, mtp_mask)
        metrics["mtp_ce"] = ce
        loss = loss + tcfg.mtp_loss_weight * ce
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(model, opt_cfg: OptimizerConfig,
                    tcfg: TrainConfig = TrainConfig(),
                    long_mode: bool = False):
    """Returns train_step(params, opt_state, batch, generator=None) ->
    (params, opt_state, metrics).  ``generator`` feeds failout; with
    microbatches it draws each microbatch's mask in turn.  The metrics are
    the last microbatch's, with the mean ``loss``, and ``grad_norm`` and
    ``lr`` (0-dim tensors, detached)."""

    def grads_of(params, leaves, mb, generator):
        loss, metrics = compute_loss(model, params, mb, tcfg=tcfg,
                                     generator=generator,
                                     long_mode=long_mode)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(params, opt_state, batch, generator=None):
        leaves = [p for p in tree_leaves(params) if p.is_floating_point()]
        for p in leaves:
            p.requires_grad_(True)
        nmb = tcfg.microbatches
        if nmb <= 1:
            loss, metrics, grads = grads_of(params, leaves, batch, generator)
        else:
            b = batch["tokens"].shape[0]
            assert b % nmb == 0, (b, nmb)
            size = b // nmb
            grads = [None] * len(leaves)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(nmb):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                lmb, metrics, gs = grads_of(params, leaves, mb, generator)
                for j, g in enumerate(gs):
                    if g is not None:
                        g = g.float() / nmb
                        grads[j] = g if grads[j] is None else grads[j] + g
                loss = loss + lmb / nmb
            metrics["loss"] = loss
        for p in leaves:
            p.requires_grad_(False)
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}
        grad_tree = tree_map(lambda p: by_leaf.get(id(p)), params)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, grad_tree, opt_state)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
