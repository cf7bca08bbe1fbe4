"""Partition specs for params / optimizer state / batches / decode caches.

Rule-based: every leaf gets a spec from its tree path + shape.  A spec is
a tuple with one entry per dimension: ``None`` (replicated), an axis name,
or a tuple of axis names (the dimension split over their product, the
first axis major), which is what the reference's ``PartitionSpec`` holds.
The reference's scheme:

- "model" axis: tensor parallel — attention heads, FFN width, MoE experts,
  vocab.  When a head count is not divisible by the axis (GQA kv-heads), we
  fall back to sharding the contraction (d_model) dim.
- ("pod","data") axes: batch for activations; ZeRO-1 for optimizer moments
  (m/v additionally sharded over data on the first free divisible dim).
- decode caches: batch over "data"; the sequence dim over "model" when the
  kv-head dim cannot shard (context-parallel cache).

The rules read only ``mesh.axis_names`` and ``mesh.shape`` (an
``AbstractMesh``, or a ``DeviceMesh`` through ``abstract_of``).
``local_slice`` / ``local_tree`` cut a rank's shard of a leaf or a tree
from its spec and the rank's mesh coordinates.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from repro_torch.sharding.mesh_compat import abstract_of

Spec = Tuple[Any, ...]


def _is_leaf(x) -> bool:
    return hasattr(x, "shape")


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested dicts / lists / tuples whose leaves
    have a ``shape`` (tensors, meta tensors, numpy arrays); a path holds
    dict keys and sequence indices as strings, as the reference's
    ``_path_names`` gives them."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0 and n >= size


class ShardingRules:
    """strategy:
    - "tp" (baseline): model axis = tensor parallel (heads/ffn/experts/vocab)
    - "dp_zero": weights replicated over the model axis, batch sharded over
      (pod, data, model), optimizer moments ZeRO-sharded over ALL axes.
    """

    def __init__(self, mesh, strategy: str = "tp"):
        assert strategy in ("tp", "dp_zero"), strategy
        self.mesh = abstract_of(mesh)
        self.strategy = strategy
        self.axes = self.mesh.axis_names
        self.model = ("model" if "model" in self.axes and strategy == "tp"
                      else None)
        self.msize = self.mesh.shape["model"] if self.model else 1
        if strategy == "dp_zero":
            self.data_axes = tuple(a for a in ("pod", "data", "model")
                                   if a in self.axes)
        else:
            self.data_axes = tuple(a for a in ("pod", "data") if a in self.axes)
        self.dsize = math.prod(self.mesh.shape[a] for a in self.data_axes) or 1

    # ------------------------------------------------------------------
    @staticmethod
    def _spec(ndim: int, **placed) -> Spec:
        parts = [None] * ndim
        for dim, axis in placed.items():
            parts[int(dim)] = axis
        return tuple(parts)

    def param_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        name = path[-1] if path else ""
        nd = len(shape)
        m, ms = self.model, self.msize
        if m is None or nd == 0:
            return (None,) * nd
        in_exit = "exit_heads" in path
        stack = 1 if (path and path[0] == "blocks") or "layer" in path else 0

        def last_if_div(*dims):
            for d in dims:
                d = d % nd
                if _div(shape[d], ms):
                    return self._spec(nd, **{str(d): m})
            return (None,) * nd

        if name in ("embed", "lm_head"):
            return last_if_div(0, 1)
        if in_exit and name == "w":
            return last_if_div(nd - 1, 0)
        if name in ("w_gate", "w_up", "w_in", "w_h"):
            return last_if_div(nd - 1)
        if name == "w_down":
            return last_if_div(nd - 2)
        if name in ("wg", "wu", "wd",                   # MoE experts [*,E,.,.]
                    "wg_q", "wu_q", "wd_q", "wg_s", "wu_s", "wd_s"):
            return last_if_div(nd - 3)
        if name == "router":
            return (None,) * nd
        if name == "wq" and nd - stack == 3:            # attn q [*,D,Nq,H]
            return last_if_div(nd - 2, nd - 3)
        if name in ("wk", "wv") and nd - stack == 3:    # GQA kv: heads or D
            return last_if_div(nd - 2, nd - 3)
        if name == "wo" and nd - stack == 3:            # [*,Nq,H,D]
            return last_if_div(nd - 3, nd - 1)
        if name in ("wq_b", "wk_b", "wv_b"):            # MLA [*,R,Nq,h]
            return last_if_div(nd - 2)
        if name in ("wq_a", "wkv_a"):
            return last_if_div(nd - 1)
        if name == "in_proj":                           # mamba [*,D,X]
            return last_if_div(nd - 1)
        if name == "out_proj":
            return last_if_div(nd - 2)
        if name == "up":                                # xlstm [*,D,2Din]
            return last_if_div(nd - 1)
        if name == "down":
            return last_if_div(nd - 2)
        if name in ("wq", "wk", "wv", "wz", "wi", "wf", "wo") and nd - stack == 2:
            return last_if_div(nd - 1)                  # xlstm projections
        if name == "combine":
            return last_if_div(nd - 1)
        return (None,) * nd

    def opt_moment_spec(self, pspec: Spec, shape: Tuple[int, ...]) -> Spec:
        """ZeRO-1: add the data axes on the first free divisible dim."""
        if not self.data_axes:
            return pspec
        parts = list(pspec) + [None] * (len(shape) - len(pspec))
        for i, (p, n) in enumerate(zip(parts, shape)):
            if p is None and _div(n, self.dsize):
                parts[i] = (self.data_axes if len(self.data_axes) > 1
                            else self.data_axes[0])
                return tuple(parts)
        return pspec

    # ------------------------------------------------------------------
    def params_specs(self, params_shapes):
        return tree_map_with_path(
            lambda path, leaf: self.param_spec(path, tuple(leaf.shape)),
            params_shapes)

    def opt_specs(self, opt_shapes, params_shapes):
        """{"m", "v"}: each leaf's moment spec; "step": a scalar's.
        ``opt_shapes`` is not read (the reference's signature)."""
        mspec = tree_map_with_path(
            lambda path, leaf: self.opt_moment_spec(
                self.param_spec(path, tuple(leaf.shape)), tuple(leaf.shape)),
            params_shapes)
        return {"m": mspec, "v": mspec, "step": ()}

    def batch_specs(self, batch_shapes):
        """Shard batch over as many data axes as divisibility allows
        (dp_zero on 512 chips with batch 256 falls back to 32-way)."""
        candidates = []
        axes = list(self.data_axes)
        while axes:
            candidates.append(tuple(axes))
            axes = axes[:-1]

        def spec(path, leaf):
            nd = len(leaf.shape)
            b = leaf.shape[0] if nd else 1
            for cand in candidates:
                size = math.prod(self.mesh.shape[a] for a in cand)
                if _div(b, size):
                    ax = cand if len(cand) > 1 else cand[0]
                    return (ax,) + (None,) * (nd - 1)
            return (None,) * nd

        return tree_map_with_path(spec, batch_shapes)

    def cache_specs(self, cache_shapes):
        """Decode caches: dim0 = stacked layers, dim1 = batch, then per-kind.

        5D [n, B, S, nkv, hd]: shard kv-heads over model when divisible,
        else the SEQUENCE dim (context-parallel cache).
        4D [n, B, S, R] (MLA latent / k_rope): shard the SEQUENCE dim over
        model.
        3D/recurrent states: shard the widest trailing dim if divisible.
        """
        data = "data" if "data" in self.axes else None
        m, ms = self.model, self.msize

        def spec(names, leaf):
            shape = tuple(leaf.shape)
            nd = len(shape)
            parts = [None] * nd
            if "shared_attn" in names:
                # unstacked [B, S, nkv, hd] (zamba2 weight-shared block)
                if data and _div(shape[0], self.mesh.shape["data"]):
                    parts[0] = data
                if m is not None and nd == 4:
                    if _div(shape[2], ms):
                        parts[2] = m
                    elif _div(shape[1], ms) and shape[1] >= 1024:
                        parts[1] = m
                return tuple(parts)
            if nd >= 2 and data and _div(shape[1], self.mesh.shape["data"]):
                parts[1] = data
            if m is None:
                return tuple(parts)
            if nd == 5:
                if _div(shape[3], ms):
                    parts[3] = m
                elif _div(shape[2], ms) and shape[2] >= 1024:
                    parts[2] = m
            elif nd == 4:
                if _div(shape[2], ms) and shape[2] >= 1024:
                    parts[2] = m        # sequence (context-parallel)
                elif _div(shape[3], ms) and shape[3] >= 128:
                    parts[3] = m
            elif nd == 3 and _div(shape[2], ms) and shape[2] >= 128:
                parts[2] = m
            return tuple(parts)

        return tree_map_with_path(spec, cache_shapes)


# ---------------------------------------------------------------------------
# A rank's shard
# ---------------------------------------------------------------------------

def shard_of(entry, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of a spec entry's shard at ``coords``: the entry's
    axes read as one mixed-radix number, the first axis major."""
    mesh = abstract_of(mesh)
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return index, count


def local_slice(leaf, spec: Spec, mesh, coords: Dict[str, int]):
    """The shard of ``leaf`` (a tensor or an array) that the rank at
    ``coords`` holds under ``spec``: each placed dimension cut into equal
    parts, this rank's part kept.  A torch tensor comes back as a view when
    the cut leaves it contiguous, else as a contiguous copy."""
    index = []
    for dim, entry in enumerate(spec):
        if entry is None:
            index.append(slice(None))
            continue
        i, k = shard_of(entry, mesh, coords)
        n = leaf.shape[dim]
        if n % k:
            raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} does "
                             f"not split {k} ways ({entry})")
        index.append(slice(i * (n // k), (i + 1) * (n // k)))
    out = leaf[tuple(index)]
    return out.contiguous() if hasattr(out, "contiguous") else out


def local_tree(tree, specs, mesh, coords: Dict[str, int]):
    """``local_slice`` of every leaf of ``tree`` under the spec at the same
    path of ``specs``."""
    if isinstance(tree, dict):
        return {k: local_tree(v, specs[k], mesh, coords)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        return type(tree)(local_tree(v, s, mesh, coords)
                          for v, s in zip(tree, specs))
    return local_slice(tree, specs, mesh, coords)
