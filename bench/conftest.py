"""Fixtures of the benchmark's CPU tests: a checkout-like root holding the
benchmark's own files plus small cells of its own, added as files alone,
and a runner that drives a cell through the harness on the CPU."""
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# the small configuration: granite-3-2b's file at small widths
SMALL = {"name": "small", "hidden_size": 128, "intermediate_size": 256,
         "num_hidden_layers": 4, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 512,
         "attention_multiplier": 32 ** -0.5, "exit_layers": [1, 2]}
DECODE = {"prompt_len": [3, 9], "waves": 2, "page_size": 4,
          "readback_interval": 3,
          "warm_windows": 2, "trace_polls": 2, "sample_sessions": 4}
SCORE = {"batch": 2, "seq_len": 32, "distinct_batches": 2,
         "trace_forwards": 2}
# limits at the small size, from seeds 5-8 on the CPU: sound runs read
# token_gap 0.0024-0.0081, exit_entropy_gap 0.00034-0.00098 and
# logit_err 0.042-0.057, the float8 control 0.018-0.070, 0.0047-0.0083
# and 0.64-0.83
LIMITS = {"small.decode": {"token_gap": 0.02, "exit_share_gap": 0.0,
                           "exit_entropy_gap": 0.003},
          "small.score": {"logit_err": 0.15}}


def make_root(dest: Path, config: dict = None) -> Path:
    """A root with the repository's benchmark files and two added cells,
    ``small.decode`` and ``small.score``: new files and new entries
    only."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    b = dest / "bench"
    cfg = json.loads((b / "configs/granite-3-2b.json").read_text())
    cfg.update(SMALL, **(config or {}))
    (b / "configs/small.json").write_text(json.dumps(cfg))
    dec = json.loads((b / "traffic/reason-decode.json").read_text())
    dec.update(DECODE)
    (b / "traffic/small-decode.json").write_text(json.dumps(dec))
    sco = json.loads((b / "traffic/score-2k.json").read_text())
    sco.update(SCORE)
    (b / "traffic/small-score.json").write_text(json.dumps(sco))
    (b / "workloads/small.decode.json").write_text(json.dumps(
        {"sessions": 4, "max_new": 12, "wave_steps": 3,
         "limits": LIMITS["small.decode"]}))
    (b / "workloads/small.score.json").write_text(json.dumps(
        {"limits": LIMITS["small.score"]}))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "small", "source": "test",
                            "file": "bench/configs/small.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"] += [
        {"name": "small.decode", "config": "small",
         "traffic": "small-decode", "chips": 1, "why": "CPU tests"},
        {"name": "small.score", "config": "small", "traffic": "small-score",
         "chips": 1, "why": "CPU tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            decode = any(".reason-decode" in w for w in m["workloads"])
            m["workloads"].append("small.decode" if decode
                                  else "small.score")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path)


def run_small(root: Path, name: str, seed: int = 5, trace: bool = False,
              control: bool = False) -> dict:
    """One CPU run of a small cell: a window long enough that every
    session runs to its ``max_new``, so the run is the same each time."""
    import torch
    from bench import harness
    cell = harness.load_cell(name, root)
    return harness.run_cell(cell, seed, 1.0 if name.endswith("score")
                            else 60.0, trace, torch.device("cpu"),
                            time.perf_counter(), control=control)
