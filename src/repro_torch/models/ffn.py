"""Dense gated feed-forward layer (the MoE layer is not ported yet)."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, scaled_init


def init_ffn(gen, d: int, ff: int, act: str, device="cpu"):
    if act == "silu":
        return {
            "w_gate": scaled_init(gen, (d, ff), d, device=device),
            "w_up": scaled_init(gen, (d, ff), d, device=device),
            "w_down": scaled_init(gen, (ff, d), ff, device=device),
        }
    return {
        "w_in": scaled_init(gen, (d, ff), d, device=device),
        "w_down": scaled_init(gen, (ff, d), ff, device=device),
    }


def ffn_forward(params, x, act: str):
    fn = activation(act)
    w = {k: v.to(x.dtype) for k, v in params.items()}
    if "w_gate" in params:
        h = fn(torch.matmul(x, w["w_gate"])) * torch.matmul(x, w["w_up"])
    else:
        h = fn(torch.matmul(x, w["w_in"]))
    return torch.matmul(h, w["w_down"])
