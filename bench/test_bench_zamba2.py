"""The Zamba2 hybrid's cell on the CPU, at small widths, added to a
checkout-like root by files alone (``bench/conftest.py``'s root plus a
configuration, a cell file and entries): sound runs are correct, runs
with a fault planted in what the hybrid adds to the program are not, the
float8 control fails, and the hybrid's cost functions count by hand.

The small configuration is the published file at small widths (as
``tests/test_torch_zamba2.py`` has it): D 64, Mamba2 8 heads of 16 in 2
groups, 2 shared blocks of 4 heads of 32 over the 128-wide concatenated
input, adapters of rank 8, sites before layers 2, 5 and 7 of 9, exits
after layers 2 and 6.
"""
import json
import math

import pytest
import torch

from bench import costs, harness, hybrid_costs
from bench.conftest import ROOT, make_root, run_small

CELL = "small-zamba2.decode"
SMALL = {"name": "small-zamba2", "hidden_size": 64,
         "attention_hidden_size": 128, "attention_head_dim": 32,
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "ffn_hidden_size": 128, "intermediate_size": 128,
         "adapter_rank": 8, "n_mamba_heads": 8, "mamba_headdim": 16,
         "mamba_d_state": 16, "chunk_size": 8, "num_hidden_layers": 9,
         "hybrid_layer_ids": [2, 5, 7], "vocab_size": 512,
         "exit_layers": [2, 6]}
# limits at the small size, from seeds 5-8 on the CPU: sound runs read
# token_gap 0.0072-0.0196 and exit_entropy_gap 0.0011-0.0020, the float8
# control 0.23-0.40 and 0.012-0.026
LIMITS = {"token_gap": 0.05, "exit_share_gap": 0.0,
          "exit_entropy_gap": 0.004}


@pytest.fixture
def zamba_root(tmp_path):
    """The conftest root (its small decode traffic among its files) plus
    the small hybrid's configuration, cell file and entries."""
    root = make_root(tmp_path)
    b = root / "bench"
    cfg = json.loads((b / "configs/zamba2-7b-instruct.json").read_text())
    cfg.update(SMALL)
    cfg["layers_block_type"] = [
        "hybrid" if i in SMALL["hybrid_layer_ids"] else "mamba"
        for i in range(SMALL["num_hidden_layers"])]
    (b / "configs/small-zamba2.json").write_text(json.dumps(cfg))
    (b / f"workloads/{CELL}.json").write_text(json.dumps(
        {"sessions": 4, "max_new": 12, "wave_steps": 3, "limits": LIMITS}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "small-zamba2", "source": "test",
                            "file": "bench/configs/small-zamba2.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": CELL, "config": "small-zamba2",
                              "traffic": "small-decode", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "zamba2-7b-instruct.reason-decode" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_the_cell_reports_its_metrics(zamba_root):
    cell = harness.load_cell(CELL, zamba_root)
    assert {m["name"] for m in cell["end_to_end"]} == {
        "decode_tok_s", "itl_p95_ms", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "host_ms_step.decode", "device_ms_step.decode", "device_idle.decode",
        "paged_gqa_roofline.hybrid-decode", "mfu.hybrid-decode"}
    # the published cell reads the same lists
    cell = harness.load_cell("zamba2-7b-instruct.reason-decode")
    assert {m["name"] for m in cell["per_layer"]} == {
        "host_ms_step.decode", "device_ms_step.decode", "device_idle.decode",
        "paged_gqa_roofline.hybrid-decode", "mfu.hybrid-decode"}


@pytest.mark.parametrize("seed", [5, 6])
def test_sound_runs_are_correct(zamba_root, seed):
    out = run_small(zamba_root, CELL, seed, trace=seed == 5)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    if seed == 5:
        # on the CPU: no kernels for the roofline and no peak for the mfu
        assert "paged_gqa_roofline.hybrid-decode" not in out["metrics"]
        assert "mfu.hybrid-decode" not in out["metrics"]
        assert "host_ms_step.decode" in out["metrics"]


def _one_block(monkeypatch):
    from repro_torch.models import blocks
    monkeypatch.setattr(blocks, "site_params",
                        lambda cfg, sp, k: (sp["blocks"][0], sp["sites"][k]))


def _no_adapter(monkeypatch):
    from repro_torch.models import ffn
    forward = ffn.ffn_forward
    monkeypatch.setattr(ffn, "ffn_forward",
                        lambda p, x, act, adapter=None: forward(p, x, act))


def _group_zero(monkeypatch):
    from repro_torch.models import ssm
    per_head = ssm._per_head

    def first(t, groups, heads):
        n = t.shape[-1] // groups
        return per_head(t[..., :n].repeat_interleave(groups, -1), groups,
                        heads)
    monkeypatch.setattr(ssm, "_per_head", first)


def _no_concat(monkeypatch):
    """The site reads the stream where it should read the embedding."""
    from repro_torch.models import blocks
    site_input = blocks._site_input
    monkeypatch.setattr(blocks, "_site_input",
                        lambda cfg, block, x, emb: site_input(
                            cfg, block, x, x))


def _zero_embedding(monkeypatch):
    """The embedding concat left out: the site's embedding half is zeros.
    (Read only because the builder weighs that half of the site's norm up
    to the stream's order; at a plain norm scale seed 5 read token_gap
    0.027 under the 0.05 limit.)"""
    from repro_torch.models import blocks
    site_input = blocks._site_input
    monkeypatch.setattr(blocks, "_site_input",
                        lambda cfg, block, x, emb: site_input(
                            cfg, block, x, torch.zeros_like(emb)))


@pytest.mark.parametrize("plant", [_one_block, _no_adapter, _group_zero,
                                   _no_concat, _zero_embedding],
                         ids=["one_shared_block", "adapter_dropped",
                              "group_zero_bc", "stream_for_embedding",
                              "embedding_left_out"])
def test_a_planted_fault_reads_not_correct(zamba_root, monkeypatch, plant):
    plant(monkeypatch)
    out = run_small(zamba_root, CELL)
    assert not out["correct"], out["checks"]
    assert out["checks"]["token_gap"]["value"] > \
        out["checks"]["token_gap"]["limit"]


def _dirty_state_rows(monkeypatch):
    """Every slot's recurrent state rows start as a previous occupant's
    would leave them (the paged arena's pools stay fresh)."""
    from repro_torch.models.model import Model
    init = Model.init_decode_cache_paged

    def dirty(self, *a, **kw):
        cache = init(self, *a, **kw)
        for c in cache["blocks"]:
            c[0].fill_(0.5)                   # the Mamba2 state [L, B, ...]
        return cache
    monkeypatch.setattr(Model, "init_decode_cache_paged", dirty)


def test_state_rows_not_reset_at_admission(zamba_root, monkeypatch):
    _dirty_state_rows(monkeypatch)
    out = run_small(zamba_root, CELL)
    assert out["correct"], out["checks"]      # admission zeroes them
    from repro_torch.serving.scheduler import ContinuousBatchScheduler
    monkeypatch.setattr(ContinuousBatchScheduler, "_reset_states",
                        lambda self, slots: None)
    out = run_small(zamba_root, CELL)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_fails_where_the_program_passes(zamba_root, seed):
    out = run_small(zamba_root, CELL, seed, control=True)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False, out["control"]
    number = "exit_entropy_gap"
    assert out["control"][number] > out["checks"][number]["limit"]
    assert out["control"][number] >= 3 * out["checks"][number]["value"]


def test_the_references_are_found_by_the_isolation_rule():
    """``test_bench_isolation.py`` holds every module under
    ``reference/`` to importing nothing of the program: the hybrid's is
    among them."""
    names = {p.stem for p in (ROOT / "bench" / "reference").glob("*.py")}
    assert "zamba2_hybrid" in names


def test_hybrid_costs_count_by_hand():
    cfg = json.loads((ROOT / "bench/configs/zamba2-7b-instruct.json")
                     .read_text())
    d, f, v = 3584, 14336, 32000
    mamba = d * (2 * 7168 + 2 * 2 * 64 + 112) + 7168 * d
    site = (7168 * 3 * 32 * 224 + 32 * 224 * d + 3 * d * f
            + 128 * (d + 2 * f) + d * d)
    assert hybrid_costs.matmul_params(cfg) == 81 * mamba + 13 * site \
        + 3 * d * v
    assert 11.2e9 < hybrid_costs.matmul_params(cfg) < 11.4e9
    assert hybrid_costs.attention_flops(cfg, 10) == 4 * 32 * 224 * 10 * 13
    assert hybrid_costs.decode_flops(cfg, 3, 10) == \
        2 * hybrid_costs.matmul_params(cfg) * 3 + 4 * 32 * 224 * 10 * 13
    # K and V rows of every context, q read and o written, at 13 sites
    ctx = [5, 17]
    assert hybrid_costs.paged_gqa_bytes(cfg, ctx) == 13 * (
        2 * 32 * 224 * 2 * 22 + 2 * 32 * 224 * 2 * 2)
    # one more token of context: 372,736 bytes of site KV
    assert hybrid_costs.paged_gqa_bytes(cfg, [6]) \
        - hybrid_costs.paged_gqa_bytes(cfg, [5]) == 372_736


@pytest.mark.parametrize("tokens,keys", [(1, 1), (4_032, 5_912_345),
                                         (31_000, 61_234_567)])
def test_mfu_inverts_the_runners_flops(tokens, keys):
    """The runner records ``costs.decode_flops(cfg, tokens, keys)`` with
    the keys it summed; the reader recovers them from it."""
    cfg = json.loads((ROOT / "bench/configs/zamba2-7b-instruct.json")
                     .read_text())
    flops = costs.decode_flops(cfg, tokens, keys)
    got = hybrid_costs.keys_from_flops(cfg, flops, tokens)
    assert math.isclose(got, keys, rel_tol=1e-9, abs_tol=1e-3)
    mfu = harness._load_file(ROOT / "bench/metrics/mfu.hybrid-decode.py",
                             "test_mfu_hybrid")
    rec = {"mode": "decode", "config": cfg, "flops": flops,
           "tokens": tokens, "window_s": 2.0,
           "peaks": costs.PEAKS["H100"]}
    want = 100 * hybrid_costs.decode_flops(cfg, tokens, keys) / (
        989e12 * 2.0)
    assert math.isclose(mfu.read(rec), want, rel_tol=1e-9)
