"""The port's four examples (``examples/torch/``) and its training entry
point, run on the CPU.

``quickstart.py``, ``resilient_inference.py`` and
``collaborative_serving.py`` run at the reference examples' own counts
(60 training steps of 8 x 64; 2 x 80 steps; the same plans, requests
and pools).  ``train_100m.py`` builds its ~142M-parameter config as the
reference does but trains 3 steps of 2 x 32 tokens: its 300 steps of
8 x 256 take hours on one CPU thread (the card runs them in
``chip_smoke.py`` phase 14 (d)).
"""
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro_torch.configs import get_config
from repro_torch.launch import train as train_mod

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", "torch")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_then_serves():
    out = _example("quickstart").main(["--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 60 and all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0]
    assert tuple(out["out"].shape) == (4, 16)
    assert out["exit_stats"]["tokens"] == 64.0


def test_resilient_inference_assertion_holds():
    """main() asserts that failout training degrades less with a dead
    stage; the numbers behind it are returned."""
    res = _example("resilient_inference").main(["--device", "cpu"])
    plain, fo = res["plain"], res["failout"]
    assert fo[1] - fo[0] < plain[1] - plain[0] + 0.5
    assert all(np.isfinite(v) for pair in res.values() for v in pair)


def test_collaborative_serving_runs():
    out = _example("collaborative_serving").main(["--device", "cpu"])
    assert set(out["vgg16"]) == set(out["qwen2-vl-2b"]) == {
        "cloud-device", "edge-device", "cloud-edge-device", "device-device"}
    assert out["depth"][1.5] < out["depth"][0.0] == 1.0
    assert sum(out["cluster"]["route_counts"].values()) == 6
    assert out["pool_tokens"] == {"yi": 24, "xlstm": 24}
    assert out["compress_err"] < 0.05
    assert out["compress_ops_equal"]       # core.offload == the kernel pair
    assert out["compress_err"] < out["int4_err"] < 1.0


def test_train_100m_config_and_steps(tmp_path):
    mod = _example("train_100m")
    cfg = mod.make_100m_config()
    base = ref_config("granite-3-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                12, 768, 12, 4, 64, 3072, 16_384)
    assert cfg.exits.exit_layers == (4, 8)
    assert (cfg.attention, cfg.norm, cfg.act) == (
        base.attention, base.norm, base.act)
    hist = []
    params, metrics = mod.main(["--device", "cpu", "--steps", "3",
                                "--batch", "2", "--seq", "32", "--ckpt",
                                str(tmp_path)], history=hist)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert {"exit0_ce", "exit1_ce"} <= set(metrics)
    assert os.path.basename(os.listdir(tmp_path)[0]) == "ckpt_00000003.npz"


def test_train_resumes_from_a_checkpoint(tmp_path):
    """``launch.train`` restores the newest checkpoint and continues: the
    resumed steps equal the uninterrupted run's (the same batches, failout
    draws and optimizer state; the CPU is deterministic)."""
    kw = dict(lr=1e-3, failout=0.25, ckpt_every=2, device="cpu")
    full = []
    train_mod.train("granite-3-2b-smoke", 4, 2, 32,
                    ckpt_dir=str(tmp_path / "a"), history=full, **kw)
    assert sorted(os.listdir(tmp_path / "a")) == [
        "ckpt_00000002.npz", "ckpt_00000004.npz"]
    os.makedirs(tmp_path / "b")
    shutil.copy(tmp_path / "a" / "ckpt_00000002.npz", tmp_path / "b")
    resumed = []
    train_mod.train("granite-3-2b-smoke", 4, 2, 32,
                    ckpt_dir=str(tmp_path / "b"), history=resumed, **kw)
    assert len(resumed) == 2
    for got, want in zip(resumed, full[2:]):
        got.pop("step_s"), want.pop("step_s")
        assert got == want


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--arch", "granite-3-2b-smoke", "--steps", "1"])
    assert get_config("granite-3-2b-smoke").num_layers == 2
