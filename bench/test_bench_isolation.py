"""The benchmark imports no JAX and no JAX package, its plain reference
nothing of the program, and a run refuses to report without a card or
with a JAX package loaded."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def _imports(path: Path):
    """Top-level names of every module ``path`` imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "typing", "torch"}


def test_loaded_forbidden_compares_whole_names():
    assert harness.loaded_forbidden(["repro_torch", "repro_torch.models",
                                     "reprox", "bench", "torch"]) == []
    assert harness.loaded_forbidden(["repro.models", "jaxlib.xla",
                                     "flax", "repro_torch"]) == [
        "flax", "jaxlib", "repro"]


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "granite-3-2b.score-2k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_result_without_a_card_or_the_program(tmp_path):
    out = _run(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
    for line in out.stdout.splitlines():
        json.loads(line)                      # never reached
