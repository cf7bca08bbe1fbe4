"""Zamba2's published hybrid (Zamba2-7B) in the port, on the CPU, against
the benchmark's plain float32 reference (``bench/reference/zamba2_hybrid.py``)
on the benchmark's own seeded weights (``bench/models/zamba2_hybrid.py``).

The small configuration is the published file at small widths: D 64,
Mamba2 8 heads of 16 in 2 groups (d_state 16, chunks of 8), 2 shared
blocks of 4 heads of 32 over the 128-wide concatenated input, adapters of
rank 8, sites before layers 2, 5 and 7 of 9 (irregular, and one at the
same boundary as the exit after layer 2), exits after layers 2 and 6.

Tolerances: the port runs in bf16 and the reference in fp32, so every
matmul input, activation and cache row the port rounds to bf16 (relative
2^-9) moves the logits; over 9 layers the final logits (|logit| < 1, a
tied embedding drawn at 0.02) moved by 0.04-0.05 and the exit logits
(|logit| ~ 4) by 0.04-0.15 on the seeds tried, against 0.3 and 0.5-1.5
for the reference's own float8 control.  The limits, 0.1 for the final
logits and 0.3 for the exits, leave room for seeds above those readings
and stay under the control's.
"""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402
from bench.models import zamba2_hybrid as zb  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,  # noqa
                                           Request, SchedulerConfig)

PUBLISHED = ROOT / "bench" / "configs" / "zamba2-7b-instruct.json"
SMALL = {"hidden_size": 64, "attention_hidden_size": 128,
         "attention_head_dim": 32, "num_attention_heads": 4,
         "num_key_value_heads": 4, "ffn_hidden_size": 128,
         "intermediate_size": 128, "adapter_rank": 8, "n_mamba_heads": 8,
         "mamba_headdim": 16, "mamba_d_state": 16, "chunk_size": 8,
         "num_hidden_layers": 9, "hybrid_layer_ids": [2, 5, 7],
         "vocab_size": 512, "exit_layers": [2, 6]}
FINAL_TOL = 0.1          # final logits, bf16 port vs fp32 reference
EXIT_TOL = 0.3           # exit logits (10x larger), same reason


def small_config() -> dict:
    cfg = json.loads(PUBLISHED.read_text())
    cfg.update(SMALL)
    cfg["layers_block_type"] = [
        "hybrid" if i in SMALL["hybrid_layer_ids"] else "mamba"
        for i in range(SMALL["num_hidden_layers"])]
    return cfg


def _reference():
    return harness._load_file(ROOT / "bench" / "reference"
                              / "zamba2_hybrid.py", "test_zamba2_reference")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    model = Model(zb.model_config(cfg), device="cpu")
    w = zb.make(cfg, 5, "cpu")
    return cfg, model, w, zb.port_params(model, w), _reference()


def test_plan_puts_sites_before_their_layers(small):
    _, model, _, _, _ = small
    assert model.plan == [
        ("scan", "mamba", 2, 0), ("exit", 0, 2), ("shared_attn", 0),
        ("scan", "mamba", 3, 2), ("shared_attn", 1), ("scan", "mamba", 1, 5),
        ("exit", 1, 6), ("scan", "mamba", 1, 6), ("shared_attn", 2),
        ("scan", "mamba", 2, 7)]
    # a site and the layer it feeds share a decode segment
    for seg in model.decode_segments:
        for a, b in zip(seg.steps, seg.steps[1:] + (None,)):
            if a[0] == "shared_attn":
                assert b is not None and b[0] == "scan"


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_matches_reference(small, seed):
    cfg, model, w, params, ref = small
    tok = torch.randint(0, cfg["vocab_size"], (1, 24),
                        generator=torch.Generator().manual_seed(seed))
    out = model.forward(params, {"tokens": tok})
    want = ref.forward(cfg, w, tok[0])
    assert (out.logits[0] - want["logits"]).abs().max() < FINAL_TOL
    assert len(out.exit_logits) == len(want["exit_logits"]) == 2
    for got, exp in zip(out.exit_logits, want["exit_logits"]):
        assert (got[0] - exp).abs().max() < EXIT_TOL


def _tap_logits(model, n_slots, max_len):
    """Record the final logits of every decode step the program runs, by
    slot and position (the prompt replay's eager steps and the windows'
    steps), where the row wrote its cache."""
    buf = torch.full((n_slots, max_len, model.cfg.vocab_size), math.nan)
    step = model.decode_step

    def tapped(params, cache, tokens, position, **kw):
        logits, ee, cache = step(params, cache, tokens, position, **kw)
        paged, wm = kw.get("paged"), kw.get("write_mask")
        act = paged.write_mask if paged is not None else wm
        pos = torch.as_tensor(position).long().expand(tokens.shape[0])
        for b in range(tokens.shape[0]):
            if act is None or bool(act[b]):
                buf[b, int(pos[b])] = logits[b]
        return logits, ee, cache
    model.decode_step = tapped
    return buf


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync", "windows"])
def test_scheduler_decode_matches_reference(small, async_decode):
    """Prompts replayed into the paged arena, then decoded through
    ``ContinuousBatchScheduler`` (three slots, one re-admitted, so a
    slot's state rows must be reset): every step's logits against the
    reference's full forward over the prompt and the served tokens."""
    cfg, _, w, _, ref = small
    model = Model(zb.model_config(cfg), device="cpu")
    params = zb.port_params(model, w)
    n, max_len = 3, 32
    buf = _tap_logits(model, n, max_len)
    sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
        n_slots=n, max_len=max_len, paged=True, page_size=4,
        prefill_chunk=4, segmented=False, async_decode=async_decode,
        readback_interval=3, exit_threshold=0.0), device="cpu")
    rs = np.random.RandomState(3)
    reqs = [Request(tokens=rs.randint(0, cfg["vocab_size"], m), max_new=k)
            for m, k in ((5, 9), (12, 6), (9, 10), (7, 8))]
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert sched.state_resets == len(reqs)
    # the last occupant of each slot: its steps are the last written there
    last = {}
    for r in reqs:
        last[r.slot] = r
    for slot, r in last.items():
        fed = np.concatenate([r.tokens, r.out_tokens[:-1]])
        want = ref.forward(cfg, w, torch.from_numpy(fed).long())["logits"]
        got = buf[slot, :len(fed)]
        assert not torch.isnan(got).any()
        assert (got - want).abs().max() < FINAL_TOL


def test_segmented_decode_equals_the_monolithic_step(small):
    """The depth-segmented step hands each site the token embeddings: its
    tokens equal the monolithic step's (no exits, so every segment runs)."""
    cfg, _, w, _, _ = small
    outs = []
    for segmented in (False, True):
        model = Model(zb.model_config(cfg), device="cpu")
        sched = ContinuousBatchScheduler(model, zb.port_params(model, w),
                                         SchedulerConfig(
            n_slots=2, max_len=32, paged=True, page_size=4, prefill_chunk=4,
            segmented=segmented, exit_threshold=0.0), device="cpu")
        reqs = [Request(tokens=(np.arange(6 + j) * 11 + j) % 500,
                        max_new=7) for j in range(2)]
        for r in reqs:
            sched.submit(r)
        sched.run()
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]


def test_layout_is_the_published_files():
    """At the published widths (on "meta": shapes only): 13 sites at the
    catalog's ids, two blocks alternating A/B, 112 Mamba2 heads in 2
    groups, 372,736 bytes of site KV a token, 7.36 B parameters."""
    cfg = json.loads(PUBLISHED.read_text())
    mc = zb.model_config(cfg)
    model = Model(mc, device="meta")
    ids = [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77]
    assert list(B.shared_attn_sites(mc)) == ids == [
        i for i, t in enumerate(cfg["layers_block_type"]) if t == "hybrid"]
    plan = model.plan
    for k, i in enumerate(ids):
        at = plan.index(("shared_attn", k))
        assert plan[at + 1][0] == "scan" and plan[at + 1][3] == i
    ap = model.abstract_params()
    sp = ap["shared_attn"]
    assert len(sp["blocks"]) == 2 and len(sp["sites"]) == 13
    for k in range(13):
        assert B.site_params(mc, sp, k)[0] is sp["blocks"][k % 2]
    assert tuple(sp["blocks"][0]["attn"]["wq"].shape) == (7168, 32, 224)
    assert tuple(sp["blocks"][0]["attn"]["wo"].shape) == (32, 224, 3584)
    assert tuple(sp["sites"][0]["adapter"]["b"].shape) == (128, 2 * 14336)
    d_in, heads, conv = ssm_mod._dims(mc)
    assert (d_in, heads, conv) == (7168, 112, 7168 + 2 * 2 * 64)
    cache = model.init_decode_cache_paged(1, 1, 16, device="meta")
    kv = sum(t.numel() * t.element_size() for pair in cache["shared_attn"]
             for t in pair) // 16
    assert kv == 372_736
    n = sum(t.numel() for t in _leaves(ap)) - sum(
        t.numel() for t in _leaves(ap["exit_heads"]))
    assert 7.3e9 < n < 7.4e9
    # the analytic count (the reference's formula) leaves out the Mamba2
    # biases, norms and constants: 0.9 M of 7.36 B
    assert abs(mc.param_count() - n) < 1e-3 * n


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
