"""The port's partition rules (``repro_torch.sharding``) against the
reference's (``repro.sharding.specs``), on the abstract production meshes
(16, 16) and (2, 16, 16), under both strategies, for every registry arch
at full width and smoke.

The port's trees come from its own ``Model.abstract_params()`` ("meta"
tensors) and ``init_decode_cache(..., device="meta")``; the reference's
from ``jax.eval_shape``.  A reference ``PartitionSpec`` is read as the
port's spec tuple, padded with ``None`` to the leaf's rank (``P()`` and
``P(None, None)`` place a matrix alike).

Paths.  Parameters and optimizer moments: the two trees have the same
paths, leaf for leaf.  Batches: the same dicts.  Decode caches: the same
paths for every arch (the port's contiguous cache keeps the reference's
layout); the test asserts the path sets are equal, so a difference would
be listed by the failure.

Then every smoke leaf is cut into its ranks' local slices
(``local_slice``) and put back together over the mesh: every element is
covered, replicas agree, and the result is the leaf.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.sharding.mesh_compat import make_abstract_mesh as ref_mesh
from repro.sharding.specs import ShardingRules as RefRules
from repro.sharding.specs import _path_names
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.sharding.mesh_compat import AbstractMesh, make_abstract_mesh
from repro_torch.sharding.specs import (ShardingRules, local_slice,
                                        local_tree, shard_of)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
STRATEGIES = ("tp", "dp_zero")
NAMES = sorted(ARCHS) + sorted(a + "-smoke" for a in ARCHS)
BATCH, SEQ = 256, 32768


def _seq(cfg):
    return 448 if cfg.family == "encdec" else SEQ


def _flat_port(tree, specs, path=()):
    """{path: (shape, spec)} walking the leaf tree and the spec tree
    together (a spec is a tuple, so the leaf tree says where leaves are)."""
    if hasattr(tree, "shape"):
        return {path: (tuple(tree.shape), specs)}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_flat_port(v, specs[k], path + (str(k),)))
    return out


def _flat_ref(shapes, specs):
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    out = {}
    for (path, leaf), spec in zip(leaves, sp):
        nd = len(leaf.shape)
        out[_path_names(path)] = (tuple(leaf.shape),
                                  tuple(spec) + (None,) * (nd - len(spec)))
    return out


def _batch(cfg, jnp_shapes: bool):
    b = {"tokens": (BATCH, 128)}
    if cfg.frontend == "vision_patches":
        b["patch_embeds"] = (BATCH, 16, cfg.d_model)
    if cfg.family == "encdec":
        b["frames"] = (BATCH, cfg.encdec.encoder_seq_len, cfg.d_model)
    if jnp_shapes:
        return {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in b.items()}
    return {k: torch.empty(v, device="meta") for k, v in b.items()}


@pytest.fixture(scope="module")
def trees():
    """name -> (port params, port cache, reference params, reference cache)
    as shapes."""
    out = {}
    for name in NAMES:
        rm = RefModel(ref_config(name))
        tm = Model(get_config(name), device="cpu")
        seq = _seq(tm.cfg)
        out[name] = (tm.abstract_params(),
                     tm.init_decode_cache(BATCH, seq, device="meta"),
                     jax.eval_shape(rm.init, jax.random.PRNGKey(0)),
                     jax.eval_shape(lambda: rm.init_decode_cache(BATCH, seq)))
    return out


def test_registry_is_the_references():
    assert sorted(ARCHS) == sorted(REF_ARCHS)


def test_production_meshes():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert make_abstract_mesh((2, 16, 16), ("pod", "data", "model")) == multi
    with pytest.raises(AssertionError):
        AbstractMesh((2, 2), ("data", "data"))


@pytest.mark.parametrize("name", NAMES)
def test_specs_equal_the_references(trees, name):
    tp, tc, rp, rc = trees[name]
    cfg = get_config(name)
    for sizes, names in MESHES:
        for strategy in STRATEGIES:
            rules = ShardingRules(make_abstract_mesh(sizes, names), strategy)
            rrules = RefRules(ref_mesh(sizes, names), strategy)
            assert rules.data_axes == rrules.data_axes
            assert rules.dsize == rrules.dsize
            where = (name, sizes, strategy)
            got = _flat_port(tp, rules.params_specs(tp))
            want = _flat_ref(rp, rrules.params_specs(rp))
            assert got == want, where
            ospecs = rules.opt_specs(None, tp)
            rospecs = rrules.opt_specs(None, rp)
            for k in ("m", "v"):
                assert _flat_port(tp, ospecs[k]) == _flat_ref(
                    rp, rospecs[k]), (where, k)
            assert ospecs["step"] == tuple(rospecs["step"]) == ()
            got = _flat_port(tc, rules.cache_specs(tc))
            want = _flat_ref(rc, rrules.cache_specs(rc))
            assert sorted(got) == sorted(want), where   # the same paths
            assert got == want, where
            tb, rb = _batch(cfg, False), _batch(cfg, True)
            assert _flat_port(tb, rules.batch_specs(tb)) == _flat_ref(
                rb, rrules.batch_specs(rb)), where


def _assemble(leaf, spec, mesh):
    """Every rank's local slice put back at its offset; replicas must
    agree and every element must be written."""
    full = np.full(tuple(leaf.shape), np.nan, np.float32)
    seen = np.zeros(tuple(leaf.shape), bool)
    axes = mesh.axis_names
    for at in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        coords = dict(zip(axes, at))
        part = local_slice(leaf, spec, mesh, coords).float().numpy()
        index = []
        for dim, entry in enumerate(spec):
            if entry is None:
                index.append(slice(None))
            else:
                i, k = shard_of(entry, mesh, coords)
                n = leaf.shape[dim] // k
                index.append(slice(i * n, (i + 1) * n))
        index = tuple(index)
        old = full[index]
        done = seen[index]
        assert np.array_equal(old[done], part[done]), "replicas disagree"
        full[index] = part
        seen[index] = True
    assert seen.all()
    return full


@pytest.mark.parametrize("name", sorted(a + "-smoke" for a in ARCHS))
def test_local_slices_put_back_give_the_leaf(name):
    """Every smoke leaf and its moments' spec, cut over both production
    meshes under both strategies, every rank's slice put back.  The cuts
    are counted, so the test does walk sharded leaves."""
    params = Model(get_config(name), device="cpu").init(0)
    leaves = _flat_port(params, params)
    cut = 0
    for sizes, names in MESHES:
        mesh = make_abstract_mesh(sizes, names)
        for strategy in STRATEGIES:
            rules = ShardingRules(mesh, strategy)
            specs = rules.params_specs(params)
            moments = rules.opt_specs(None, params)["m"]
            for path, (_, spec) in _flat_port(params, specs).items():
                leaf = _get(params, path)
                for sp in (spec, _get(moments, path)):
                    if any(e is not None for e in sp):
                        cut += 1
                        got = _assemble(leaf, sp, mesh)
                        assert np.array_equal(got, leaf.float().numpy()), \
                            (name, path, sp)
    assert cut > len(leaves)


def _get(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def test_local_tree_cuts_each_leaf_by_its_spec():
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    tree = {"a": torch.arange(8.).reshape(4, 2),
            "b": [torch.arange(4.), (torch.arange(6.).reshape(2, 3),)]}
    specs = {"a": (("data", "model"), None),
             "b": [("model",), ((None, None),)]}
    got = local_tree(tree, specs, mesh, {"data": 1, "model": 0})
    assert torch.equal(got["a"], torch.tensor([[4., 5.]]))   # shard 2 of 4
    assert torch.equal(got["b"][0], torch.tensor([0., 1.]))
    assert torch.equal(got["b"][1][0], tree["b"][1][0])
    with pytest.raises(ValueError, match="split"):
        local_slice(torch.zeros(3), ("model",), mesh, {"model": 0})
