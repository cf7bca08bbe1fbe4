"""Early-exit runtime helpers (the part of the reference's
``core/early_exit.py`` the serving path uses)."""
from __future__ import annotations

import math

import torch


def first_exit_index(exit_entropies, threshold: float, vocab: int):
    """exit_entropies [n_exits, B] -> per-item first exit (n_exits = stayed).
    Entropy is normalized by log(V) so one threshold spans vocab sizes."""
    n = exit_entropies.shape[0]
    hit = exit_entropies / math.log(float(vocab)) < threshold  # [n_exits, B]
    idx = torch.argmax(hit.to(torch.int32), dim=0)   # argmax takes no bool
    return torch.where(hit.any(dim=0), idx, torch.full_like(idx, n))


def exit_stats_dict(exit_counts, tokens_served) -> dict:
    """Serving-side exit statistics from a first-exit histogram
    ``exit_counts [n_exits + 1]`` (last entry = ran full depth)."""
    total = max(1, int(sum(int(c) for c in exit_counts)))
    st = {f"exit{i}_frac": float(c) / total
          for i, c in enumerate(exit_counts[:-1])}
    st["full_depth_frac"] = float(exit_counts[-1]) / total
    st["tokens"] = float(tokens_served)
    return st
