"""Reference params -> port params.

The reference's ``Model.init`` tree (dicts, lists, stacked ``[n_layers,
...]`` blocks), handed over as numpy arrays, maps leaf by leaf onto the
port's tree of the same layout: each stacked block stays stacked and the
port's decode walks its layer axis.  bfloat16 leaves (numpy's ml_dtypes
bfloat16) go through ``.view(np.uint16)`` -> ``torch.from_numpy`` ->
``.view(torch.bfloat16)``, which keeps every bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(tree, device="cpu"):
    """Numpy param tree of the reference package -> torch tensors on
    ``device``, same nesting."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _leaf(tree, device)
