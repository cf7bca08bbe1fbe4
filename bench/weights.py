"""The benchmark makes the model's weights itself, from the seed, on the
device and in the type they are served in; the program and the plain
reference both read these same tensors.

What is drawn, and how the program's tree of parameters is laid over
it, belongs to each kind of model: ``bench/models/<model>.py``, named by
the configuration file's ``model`` key.  This module holds what they
share: the seeded generator on the device, draws in a few large calls
(a call at most ``DRAW`` elements), and the check of a params tree
against the shapes and dtypes the program declares.
"""
from __future__ import annotations

import torch

DRAW = 1 << 30                            # elements a draw at most


def generator(seed: int, device) -> torch.Generator:
    """The device's generator under ``seed`` (any integer)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw(gen, shape, std, mean=0.0, dtype=torch.bfloat16, device=None):
    """A tensor of ``shape``, N(mean, std^2), drawn in place."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for a in range(0, flat.numel(), DRAW):
        b = min(a + DRAW, flat.numel())
        torch.randn(b - a, generator=gen, dtype=dtype, device=device,
                    out=flat[a:b])
    out.mul_(std)
    if mean:
        out.add_(mean)
    return out


def check(got, want, path="params"):
    """Raise unless ``got`` has the keys, entries, shapes and dtypes of
    ``want`` (the program's ``abstract_params()``), leaf by leaf."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"bench weights: {path} has keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f", the program declares {sorted(want)}")
        for k in want:
            check(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise ValueError(f"bench weights: {path} has {len(got)} entries, "
                             f"the program declares {len(want)}")
        for i, (g, t) in enumerate(zip(got, want)):
            check(g, t, f"{path}[{i}]")
    elif tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise ValueError(f"bench weights: {path} is {tuple(got.shape)} "
                         f"{got.dtype}, the program declares "
                         f"{tuple(want.shape)} {want.dtype}")
