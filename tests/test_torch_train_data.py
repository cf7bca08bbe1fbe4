"""The port's synthetic data pipeline, ``core/cnn_zoo.py`` and
checkpoints: the pipeline's structure (its bits differ from the
reference's JAX draws by design), the CNN zoo field by field against the
reference, and the npz checkpoint format against the reference's in both
directions, bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import cnn_zoo as ref_zoo
from repro.models import Model as RefModel
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import cnn_zoo
from repro_torch.data import (DataConfig, batch_for_model, data_iterator,
                              lm_batch)
from repro_torch.data.pipeline import zipf_probs
from repro_torch.models import Model
from repro_torch.models.common import tree_leaves
from repro_torch.training import (init_optimizer, latest_checkpoint,
                                  restore_checkpoint, save_checkpoint)


def test_batches_are_deterministic_in_step():
    dcfg = DataConfig(vocab_size=100, seq_len=64, global_batch=4)
    b1, b2, b3 = lm_batch(dcfg, 3), lm_batch(dcfg, 3), lm_batch(dcfg, 4)
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    it = data_iterator(get_config("granite-3-2b-smoke"),
                       InputShape("t", 32, 2, "train"), start_step=5)
    want = batch_for_model(get_config("granite-3-2b-smoke"),
                           InputShape("t", 32, 2, "train"), 5)
    got = next(it)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_lm_batch_structure():
    """Copy structure at the lag, labels rolled by one, the last column
    masked, int32 tokens in the vocabulary."""
    dcfg = DataConfig(vocab_size=100, seq_len=64, global_batch=4)
    b = lm_batch(dcfg, 3)
    t = b["tokens"]
    assert t.dtype == b["labels"].dtype == torch.int32
    assert b["loss_mask"].dtype == torch.float32
    assert t.min() >= 0 and t.max() < 100
    lag = dcfg.copy_lag
    assert (t[:, lag:] == t[:, :-lag]).float().mean() > 0.3
    assert torch.equal(b["labels"][:, :-1], t[:, 1:])
    assert torch.equal(b["labels"][:, -1], t[:, 0])       # the roll wraps
    assert (b["loss_mask"][:, -1] == 0).all()
    assert (b["loss_mask"][:, :-1] == 1).all()
    short = lm_batch(DataConfig(100, 8, 2), 0)             # lag = S - 1
    assert short["tokens"].shape == (2, 8)


def test_zipf_head_frequency():
    """Token 0 comes at the Zipf(1.2) head probability; copying keeps the
    marginal."""
    dcfg = DataConfig(vocab_size=1000, seq_len=256, global_batch=32)
    t = lm_batch(dcfg, 0)["tokens"]
    p0 = float(zipf_probs(1000, 1.2)[0])
    n = t.numel()
    assert abs((t == 0).float().mean().item() - p0) < 4 * np.sqrt(
        p0 * (1 - p0) / n) * 2       # the copies halve the independent draws
    assert (t == 0).float().mean() > (t == 1).float().mean()


def test_frontend_stubs():
    """vlm: patch embeddings for the first Tf positions, which the loss
    skips; encdec: encoder frames of [B, Tenc, D]."""
    vcfg = get_config("qwen2-vl-2b-smoke")
    b = batch_for_model(vcfg, InputShape("t", 32, 2, "train"), 1)
    tf = min(vcfg.frontend_tokens, 32)
    assert b["patch_embeds"].shape == (2, tf, vcfg.d_model)
    assert b["patch_embeds"].dtype == torch.bfloat16
    assert (b["loss_mask"][:, :tf] == 0).all()
    assert (b["loss_mask"][:, tf:-1] == 1).all()
    assert 0.01 < b["patch_embeds"].float().std() < 0.03
    wcfg = get_config("whisper-base-smoke")
    w = batch_for_model(wcfg, InputShape("t", 16, 2, "train"), 1)
    assert w["frames"].shape == (2, wcfg.frontend_tokens, wcfg.d_model)
    assert w["frames"].dtype == torch.bfloat16
    assert "patch_embeds" not in w and "frames" not in b


@pytest.mark.parametrize("name", sorted(ref_zoo.CNN_ZOO))
def test_cnn_zoo_matches_reference(name):
    want, got = ref_zoo.CNN_ZOO[name](), cnn_zoo.CNN_ZOO[name]()
    assert set(cnn_zoo.CNN_ZOO) == set(ref_zoo.CNN_ZOO)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_flops == want.total_flops
    assert got.cut_points() == want.cut_points()


def _state(arch="xlstm-350m-smoke"):
    """The reference's params and optimizer state, and the port's from the
    same bits."""
    rp = RefModel(ref_config(arch)).init(jax.random.PRNGKey(0))
    ropt = ref_opt.init_optimizer(rp)
    ropt["m"] = jax.tree.map(lambda a: a + 0.5, ropt["m"])
    ropt["step"] = ropt["step"] + 7
    rstate = {"params": rp, "opt": ropt}
    tstate = params_from_jax(jax.tree.map(np.asarray, rstate))
    return rstate, tstate


def _bits(t):
    t = torch.as_tensor(t)
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return (t.dtype, tuple(t.shape),
            t.view(view[t.dtype]).tolist() if t.dtype in view else t.tolist())


def test_checkpoint_roundtrip(tmp_path):
    model = Model(get_config("xlstm-350m-smoke"), device="cpu")
    params = model.init(0)
    state = {"params": params, "opt": init_optimizer(params)}
    state["opt"]["step"] += 7
    fn = save_checkpoint(str(tmp_path), state, 7)
    assert fn.endswith("ckpt_00000007.npz")
    assert latest_checkpoint(str(tmp_path)) == fn
    assert latest_checkpoint(str(tmp_path / "none")) is None
    restored = restore_checkpoint(fn, state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert _bits(a) == _bits(b)
    assert int(restored["opt"]["step"]) == 7


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rstate, tstate = _state()
    fn = ref_ckpt.save_checkpoint(str(tmp_path), rstate, 3)
    got = restore_checkpoint(fn, tstate)
    for a, b in zip(tree_leaves(tstate), tree_leaves(got)):
        assert _bits(a) == _bits(b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rstate, tstate = _state()
    fn = save_checkpoint(str(tmp_path), tstate, 3)
    got = ref_ckpt.restore_checkpoint(fn, rstate)
    for a, b in zip(jax.tree.leaves(rstate), jax.tree.leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    with np.load(fn) as zp, np.load(ref_ckpt.save_checkpoint(
            str(tmp_path / "ref"), rstate, 3)) as zr:
        assert sorted(zp.files) == sorted(zr.files)
        assert str(zp["__meta__"]) == str(zr["__meta__"])
