"""On the card: each cell's command as `BENCHMARK.json` gives it, short, comes
out correct with every metric of its cell.  Skips without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483647", "--seconds", "2", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in SPEC[group]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        if name.split(".")[0].endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 105, (name, m)
