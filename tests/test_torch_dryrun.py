"""The port's dry run (``launch.dryrun``), its report (``launch.report``)
and the long-mode serve step it prices, against the reference.

* ``dryrun_one("granite-3-2b", "decode_32k", "single")`` is "ok" on 256
  chips with flops counted, on meta in seconds; a skipped combination
  gives the reference's reason.
* Per-device argument bytes, exactly, for every arch x input shape x
  {single, multi} x {tp, dp_zero}: the port's (its meta trees under its
  ``ShardingRules``, ``local_slice`` at the first rank) against the bytes
  of the reference's ``jax.eval_shape`` trees under its own rules
  (``repro.sharding.specs``), each leaf's dimensions cut by its
  ``PartitionSpec``.  The reference's trees are built here as its
  ``launch/dryrun.py`` builds them (that module is not imported: it sets
  ``XLA_FLAGS`` for 512 placeholder devices when imported).  Part by part:
  params, optimizer state, batch, decode cache and the decode step's
  tokens and position; the reference's train step also takes a
  ``uint32[2]`` key, which the port's (a ``torch.Generator`` for
  failout) does not.
* ``make_serve_step(model, long_mode=True)`` against the reference's
  long-mode step on granite-3-2b-smoke (ring caches of 64) past the ring,
  within the decode-logit tolerance (2e-2, ``PERF.md`` §2).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serving.engine import make_serve_step as ref_serve_step
from repro.sharding.mesh_compat import make_abstract_mesh as ref_mesh
from repro.sharding.specs import ShardingRules as RefRules
from repro.training.optimizer import init_optimizer as ref_init_optimizer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import named_mesh
from repro_torch.models import Model
from repro_torch.serving.engine import make_serve_step

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = ("tp", "dp_zero")
LOGIT_TOL = 2e-2


def _ref_batch(cfg, shape):
    """The reference dry run's ``batch_shapes``."""
    b, s = shape.global_batch, shape.seq_len
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds((b, s), jnp.int32),
             "labels": sds((b, s), jnp.int32),
             "loss_mask": sds((b, s), jnp.float32)}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = sds((b, cfg.frontend_tokens, cfg.d_model),
                                    jnp.bfloat16)
    if cfg.frontend == "audio_frames":
        batch["frames"] = sds((b, cfg.encdec.encoder_seq_len, cfg.d_model),
                              jnp.bfloat16)
    return batch


def _ref_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    total = 0
    for leaf, spec in zip(leaves, sp):
        dims = list(leaf.shape)
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            k = math.prod(mesh.shape[a] for a in axes)
            assert dims[i] % k == 0
            dims[i] //= k
        total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


def _ref_parts(rm, params, opt, shape_name, mesh, strategy):
    """Per-device bytes of each argument part of the reference's step."""
    cfg = rm.cfg
    shape = REF_SHAPES[shape_name]
    rules = RefRules(mesh, strategy)
    out = {"params": _ref_bytes(params, rules.params_specs(params), mesh)}
    if shape.kind in ("train", "prefill"):
        batch = _ref_batch(cfg, shape)
        out["batch"] = _ref_bytes(batch, rules.batch_specs(batch), mesh)
        if shape.kind == "train":
            out["opt_state"] = _ref_bytes(
                opt, rules.opt_specs(opt, params), mesh)
        return out
    long_mode = shape_name == "long_500k"
    clen = rm.cache_len_for(shape.seq_len, long_mode)
    cache = jax.eval_shape(lambda: rm.init_decode_cache(
        shape.global_batch, clen, long_mode=long_mode))
    out["cache"] = _ref_bytes(cache, rules.cache_specs(cache), mesh)
    data = ("data" if "data" in mesh.axis_names
            and shape.global_batch % mesh.shape["data"] == 0 else None)
    toks = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
    out["inputs"] = (_ref_bytes(toks, P(data, None), mesh) + 4)  # + pos
    return out


def test_dryrun_one_decode_is_ok_in_seconds():
    res = dryrun.dryrun_one("granite-3-2b", "decode_32k", "single",
                            save=False)
    assert res["status"] == "ok", res
    assert res["chips"] == 256 and res["kind"] == "decode"
    rl = res["roofline"]
    assert rl["hlo_flops"] > 0 and rl["hlo_bytes"] > 0
    assert rl["collective"] is None and rl["t_collective"] is None
    assert rl["bottleneck"] in ("compute", "memory")
    assert res["fits_80gb"] is True
    assert res["argument_bytes"] == sum(
        res["argument_bytes_per_device"].values())
    # the count is the whole program's, the roofline a device's share
    assert res["counted"]["flops"] == rl["hlo_flops"] * 256


def test_skipped_combination_gives_the_references_reason():
    res = dryrun.dryrun_one("whisper-base", "long_500k", "one", save=False)
    assert res == {"arch": "whisper-base", "shape": "long_500k",
                   "mesh": "one", "status": "skipped",
                   "reason": "long_500k skipped: pure full-attention arch "
                             "(DESIGN.md §3)"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_equal_the_references(arch):
    rm = RefModel(ref_config(arch))
    params = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(ref_init_optimizer, params)
    cfg = get_config(arch)
    n = 0
    for shape_name in REF_SHAPES:
        if not dryrun.shape_applicable(cfg, shape_name):
            continue
        for mesh_name, (sizes, names) in MESHES.items():
            mesh = named_mesh(mesh_name)
            for strategy in STRATEGIES:
                spec = dryrun.input_specs(arch, shape_name, mesh,
                                          strategy=strategy)
                got = dryrun.argument_bytes(spec["parts"], mesh)
                want = _ref_parts(rm, params, opt, shape_name,
                                  ref_mesh(sizes, names), strategy)
                assert got == want, (arch, shape_name, mesh_name, strategy)
                n += 1
    assert n >= 12


def test_one_card_mesh_holds_everything():
    res = dryrun.dryrun_one("granite-3-2b", "train_4k", "one", save=False)
    spec = dryrun.input_specs("granite-3-2b", "train_4k", named_mesh("one"))
    params = spec["parts"]["params"][0]
    whole = sum(t.numel() * t.element_size()
                for t in jax.tree_util.tree_leaves(
                    params, is_leaf=lambda x: hasattr(x, "shape")))
    assert res["chips"] == 1
    assert res["argument_bytes_per_device"]["params"] == whole
    # fp32 m and v: two fp32 copies of every parameter, and the step
    assert res["argument_bytes_per_device"]["opt_state"] == \
        8 * sum(t.numel() for t in jax.tree_util.tree_leaves(
            params, is_leaf=lambda x: hasattr(x, "shape"))) + 4


def test_report_renders_both_tables(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                 "--mesh", "single"])
    dryrun.main(["--arch", "granite-3-2b", "--shape", "prefill_32k",
                 "--mesh", "one"])
    dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                 "--mesh", "single"])
    results = report.load_all(str(tmp_path))
    assert sorted(results) == [
        ("granite-3-2b", "decode_32k", "single"),
        ("granite-3-2b", "prefill_32k", "one"),
        ("whisper-base", "long_500k", "single")]
    text = report.render(results)
    assert "3 (2 ok, 1 skipped, 0 failed)" in text
    assert "| granite-3-2b | decode_32k | single | 256 | ok |" in text
    assert "| granite-3-2b | prefill_32k | one | 1 | ok |" in text
    assert "SKIPPED: long_500k skipped" in text
    assert "memory-bound decode: batch more rows a step or shard the " \
           "cache" in text
    headers = [line for line in text.splitlines()
               if line.startswith("| arch |")]
    assert len(headers) == 3 and all(h.split(" | ")[-1] in (
        "fits_80gb |", "note |") for h in headers)
    assert all("fits_80gb" in h for h in headers)
    report.main(["--dir", str(tmp_path)])


def test_long_mode_serve_step_matches_the_reference():
    """granite-3-2b-smoke decodes 80 positions through ring caches of
    ``long_context_window`` 64, in both packages on the same weights;
    past the ring the long-mode step differs from the full-cache one,
    so the flag reaches ``decode_step``."""
    arch, b, steps = "granite-3-2b-smoke", 2, 80
    rm = RefModel(ref_config(arch))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    toks = np.random.RandomState(28).randint(0, 512, (b, steps)).astype(
        np.int32)
    rstep = jax.jit(ref_serve_step(rm, long_mode=True))
    rcache = rm.init_decode_cache(b, steps, long_mode=True)
    tstep = make_serve_step(tm, long_mode=True)
    tcache = tm.init_decode_cache(b, steps, long_mode=True)
    assert tcache["blocks"][0][0].shape[2] == 64
    full = make_serve_step(tm)
    fcache = tm.init_decode_cache(b, steps)
    worst = 0.0
    for t in range(steps):
        rl, _, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        with torch.no_grad():
            tok = torch.from_numpy(toks[:, t:t + 1])
            tl, _, tcache = tstep(tp, tcache, tok, t)
            fl, _, fcache = full(tp, fcache, tok, t)
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(rl)).max()))
        if t == steps - 1:
            assert float((tl - fl).abs().max()) > 10 * LOGIT_TOL
    assert worst < LOGIT_TOL, worst


def test_profile_pair_counts_the_dry_runs_step_on_real_tensors():
    """``profile_pair``'s counted run (``count_step``, the part without a
    card) builds the dry run's step on seeded tensors: on the CPU at 2 x
    32 it counts what ``tests/test_torch_op_cost.py`` holds equal to the
    reference's compiled forward and serve step."""
    from repro_torch.launch import profile_pair
    fwd = profile_pair.count_step("granite-3-2b-smoke", "prefill_32k",
                                  batch=2, seq=32, device="cpu")
    assert fwd["cost"].flops == 239075328.0
    assert fwd["reduced"] == ["batch 32 -> 2", "seq 32768 -> 32"]
    assert not any(fwd["launches"].values())     # CPU calls never count
    dec = profile_pair.count_step("granite-3-2b-smoke", "decode_32k",
                                  batch=2, seq=32, device="cpu")
    assert dec["cost"].flops == 7471104.0
    tr = profile_pair.count_step("granite-3-2b-smoke", "train_4k", batch=2,
                                 seq=32, layers=1, device="cpu")
    assert tr["cfg"].num_layers == 1 and tr["cfg"].exits.exit_layers == ()
    assert set(tr["cost"].kernels) == {"flash_attention",
                                       "flash_attention_bwd"}


def test_profile_pair_staged_cut_and_no_card():
    from repro_torch.launch import profile_pair
    reduced = []
    cfg = profile_pair.cut_config(get_config("granite-3-2b"), None, True,
                                  reduced)
    assert cfg.exits.exit_layers == (20,) and cfg.num_layers == 40
    assert reduced == ["exits (13, 26) -> (20,): the scan blocks split in "
                       "half over 2 pods"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: profile_pair would run on it")
    with pytest.raises(SystemExit) as e:
        profile_pair.main(["granite-3-2b", "prefill_32k", "one"])
    assert e.value.code != 0
