"""The benchmark's harness: finds a cell's files by name, builds its
inputs from the seed, hands them to the cell's runner and assembles the
result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``bench/``, found by the
name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model as it is run, with the names of
  its builder under ``models/`` and its plain reference under
  ``reference/``;
* ``traffic/<traffic>.json``: the mix's parameters, with the name of the
  runner under ``runners/`` that serves it;
* ``workloads/<cell>.json``: the cell's sizes and the limit of each
  number its correctness check compares;
* ``metrics/<metric>.py``: a reader ``read(record) -> float | None`` of
  one per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
BENCH = "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(root: Path, *parts: str) -> dict:
    return json.loads(Path(root, BENCH, *parts).read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell ``name`` reads: its entry, its
    configuration, traffic and cell files, and the metrics it reports."""
    root = Path(root)
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = json.loads((root / configs[entry["config"]]["file"]).read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return {"root": root, "name": name, "entry": entry, "config": cfg,
            "traffic": _json(root, "traffic", entry["traffic"] + ".json"),
            "cell": _json(root, "workloads", name + ".json"),
            "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": spec["run_seconds"]}


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(cell: dict):
    return _load_file(cell["root"] / BENCH / "runners"
                      / f"{cell['traffic']['runner']}.py",
                      "bench_runner_" + cell["traffic"]["runner"])


def reference(cell: dict):
    return _load_file(cell["root"] / BENCH / "reference"
                      / f"{cell['config']['reference']}.py",
                      "bench_reference_" + cell["config"]["reference"])


def metric_reader(cell: dict, name: str):
    return _load_file(cell["root"] / BENCH / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_"))


def builder(cell: dict):
    """The builder module of the cell's kind of model,
    ``models/<model>.py`` as the configuration file names it."""
    name = cell["config"]["model"]
    return _load_file(cell["root"] / BENCH / "models" / f"{name}.py",
                      "bench_model_" + name)


def build(cell: dict, seed: int, device):
    """The program's ``Model`` of the cell's configuration, the weights
    drawn from ``seed`` and the program's params tree over them."""
    from repro_torch.models.model import Model
    b = builder(cell)
    cfg = cell["config"]
    model = Model(b.model_config(cfg), device=device)
    w = b.make(cfg, seed, device)
    return model, w, b.port_params(model, w)


def loaded_forbidden(modules=None) -> list:
    """Top-level names of ``FORBIDDEN`` packages among ``modules`` (by
    default ``sys.modules``), compared whole (``repro_torch`` is not
    ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each compared number beside its limit; a number passes when it is
    at most its limit (an exact comparison has the limit 0)."""
    missing = set(limits) - set(checks)
    if missing:
        raise KeyError(f"checks {sorted(missing)} were not read")
    return {k: {"value": checks[k], "limit": limits[k]} for k in limits}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> dict:
    """One run of ``cell``: the runner's set-up, window, optional traced
    window and correctness readings, then the result line's fields."""
    rec = runner(cell).run(cell, seed=seed, seconds=seconds, trace=trace,
                           device=device, t_start=t_start, control=control)
    checks = judge(rec["checks"], cell["cell"]["limits"])
    correct = rec["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            val = metric_reader(cell, m["name"]).read(rec)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": rec["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": rec["device"]}
    if trace and rec.get("trace"):
        out["device"]["busy_s"] = rec["trace"]["busy_s"]
        out["device"]["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    if control:
        # the control put in the program's place, judged as the program is
        ctrl = judge(rec["control"], cell["cell"]["limits"])
        out["control"] = {k: c["value"] for k, c in ctrl.items()}
        out["control_correct"] = all(c["value"] <= c["limit"]
                                     for c in ctrl.values())
    out["phases"] = rec["phases"]
    out["checks"] = checks
    return out


def device_info(dev, chips: int) -> dict:
    """The result's ``device``: the card's name and count, and its power
    limit as ``nvidia-smi`` reads it (the rates assume 700 W)."""
    import subprocess
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        info["power_limit"] = q.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "unread"
    return info
