"""A device-free mesh: axis names and their sizes.

The reference builds a JAX ``AbstractMesh`` here, behind a shim over the
constructor's signature across JAX releases; the shim has no torch
meaning.  The port's ``AbstractMesh`` is what the partition rules read of
a mesh (``axis_names`` and ``shape``), so the rules run on a production
mesh of 256 or 512 chips without any device, and on a live
``torch.distributed.device_mesh.DeviceMesh`` through ``abstract_of``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple


class AbstractMesh:
    """A map from axis names to sizes, in axis order."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        assert len(sizes) == len(names), (sizes, names)
        assert len(set(names)) == len(names), names
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __eq__(self, other):
        return (isinstance(other, AbstractMesh)
                and self.axis_names == other.axis_names
                and self.shape == other.shape)

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(sizes: Sequence[int],
                       names: Sequence[str]) -> AbstractMesh:
    """AbstractMesh from parallel (sizes, names), e.g. ((16, 16), ("data",
    "model"))."""
    return AbstractMesh(sizes, names)


def abstract_of(mesh) -> AbstractMesh:
    """The abstract mesh of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.mesh.shape), mesh.mesh_dim_names)
