"""BENCHMARK.json against the benchmark's contract, and the harness
finding every file a cell names, also a cell added by files alone."""
import json
import re
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head_size|expan|experts_per_tok|num_experts_per")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    for w in SPEC["command"]:
        assert _text_ok(w) and not w.startswith("/") and ".." not in w


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_units_and_texts(group):
    entries = SPEC[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _text_ok(e[key]), (e["name"], key)


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"] \
                or m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"], w["name"]
        for m in SPEC["per_layer"]:
            assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
            if w["name"] in m.get("workloads", []):
                assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_named_file_exists():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        cfg = json.loads(path.read_text())
        assert (ROOT / "bench/reference" / f"{cfg['reference']}.py").is_file()
        assert (ROOT / "bench/models" / f"{cfg['model']}.py").is_file()
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert set(cell["cell"]["limits"])
        assert (ROOT / "bench/runners"
                / f"{cell['traffic']['runner']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert hasattr(harness.metric_reader({"root": ROOT}, m["name"]),
                       "read")


def test_a_cell_added_by_files_alone_is_found(small_root):
    cell = harness.load_cell("small.decode", small_root)
    assert cell["config"]["hidden_size"] == 128
    assert cell["traffic"]["page_size"] == 4
    assert {m["name"] for m in cell["end_to_end"]} == {
        "decode_tok_s", "itl_p95_ms", "setup_s"}
    assert "paged_gqa_roofline.decode" in {m["name"]
                                           for m in cell["per_layer"]}
    # the repository's own files were copied unchanged
    for path in (ROOT / "bench").rglob("*"):
        rel = path.relative_to(ROOT)
        if path.is_file() and "__pycache__" not in rel.parts \
                and not path.name.startswith("test_"):
            assert (small_root / rel).read_bytes() == path.read_bytes()
    with pytest.raises(KeyError):
        harness.load_cell("small.nothing", small_root)
