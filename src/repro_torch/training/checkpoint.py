"""Checkpointing in the reference package's own npz format.

``<path>/ckpt_<step:08d>.npz`` holds every leaf of a tree under its flat
path (dict keys sorted, list and tuple entries by index, joined by "/"),
bf16 leaves stored as their uint16 bits, and a ``__meta__`` JSON of each
leaf's dtype name.  A checkpoint written by either package restores in
the other, bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _to_numpy(t):
    """(array to store, dtype name) of a tensor or number."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(path: str, tree, step: int) -> str:
    """Writes <path>/ckpt_<step>.npz.  Returns the file path."""
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    os.makedirs(path, exist_ok=True)
    store, meta = {}, {}
    for k, v in _flatten(tree).items():
        store[k], meta[k] = _to_numpy(v)
    np.savez(fn, __meta__=json.dumps(meta), **store)
    return fn


def latest_checkpoint(path: str):
    """The newest ckpt_*.npz under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    cks = sorted(f for f in os.listdir(path)
                 if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(path, cks[-1]) if cks else None


def restore_checkpoint(fn: str, example_tree):
    """The checkpoint in the structure of ``example_tree``, each leaf a
    tensor of the stored dtype on the device of the example's leaf."""
    with np.load(fn, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}

    def leaf(key, like):
        a = flat[key]
        if meta.get(key) == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        return t.to(dev)

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        return leaf(prefix.rstrip("/"), tree)

    return rebuild(example_tree)
