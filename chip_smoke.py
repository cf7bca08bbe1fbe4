#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each fatal on failure:
  1. card and build: print the card's name and power limit, build every
     CUDA kernel of the port with nvcc from the sources in this checkout;
  2. each kernel against its plain PyTorch version at the main path's
     shapes, with its time, its plain version's time, one library call's
     time and its bound (CUDA events);
  3. a small-input reference: granite-3-2b-smoke decode on the card
     (kernels) against the same weights on the CPU (plain versions);
  4. the main path at full width: granite-3-2b (40 layers, random seeded
     weights) serving a Poisson trace through ``serve_poisson`` with the
     paged KV arena and depth-segmented decode; both kernels' launch counts
     must go up, and each kernel is held against its plain version again on
     inputs captured from that run;
  5. the tiered path at full width: granite-3-2b behind the cloud/edge/
     device cluster with an edge outage mid-trace, once through
     ``serve_tiered_poisson`` (contiguous arenas, handoff chosen per link)
     and once through ``TieredServingCluster`` with paged arenas and a
     forced int8 handoff; every request must complete, in-flight slots must
     migrate, and all four kernels must launch during the second run; the
     int8 kernels are held against their plain versions again on a leaf
     captured from a live export.
Prints the per-kernel JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when CUDA is unavailable or the port's sources are not beside this file.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense):
# HBM bytes/s and bf16 tensor-core FLOP/s
PEAKS = (3.35e12, 989e12)

PAGED_TOL = 1e-2   # bf16 output: both accumulate in fp32 and round once;
                   # one bf16 ulp of |out| < 2 is at most 2^-7 = 0.0078
ENT_TOL = 1e-3     # fp32 entropy (~log V = 10.8) from fp32 sums over
                   # D = 2048 products taken in another order
# the int8 kernels are held bit for bit: the same formula, one IEEE
# division and one rounding per element, and no sum whose order can differ
LOGIT_TOL = 3e-2   # logits are bf16 matmul results: cuBLAS and the CPU
                   # round a few bf16 ulps (2^-7 at |logit| ~ 1) apart


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_ms(torch, fn, args_list, iters=20):
    """Device time of one call, from CUDA events around ``iters`` calls
    queued behind a sleep kernel (so host enqueue time is not counted)."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    e0.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def paged_inputs(torch, gen, b, nq, nkv, hd, page, pps, max_pos, sets):
    """Ragged positions, shuffled page tables with sentinel tails; ``sets``
    independent pool copies so timed launches do not reuse L2."""
    dev = "cuda"
    pos = torch.randint(0, max_pos, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    n_pages = b * pps
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    tbl = perm.reshape(b, pps).clone()
    used = (pos.long() // page + 1)[:, None]
    cols = torch.arange(pps, device=dev)[None, :]
    tbl = torch.where(cols < used, tbl, torch.full_like(tbl, n_pages))
    out = []
    for _ in range(sets):
        q = torch.randn(b, 1, nq, hd, generator=gen, device=dev).bfloat16()
        pk = torch.randn(n_pages, page, nkv, hd, generator=gen,
                         device=dev).bfloat16()
        pv = torch.randn(n_pages, page, nkv, hd, generator=gen,
                         device=dev).bfloat16()
        out.append((q, pk, pv, tbl, pos))
    return out


def bound(nbytes, ops):
    """Least time in ms for the work, and what sets it."""
    t_bytes, t_ops = nbytes / PEAKS[0], ops / PEAKS[1]
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def paged_bound(args):
    q, pk, _, _, pos = args
    _, _, nq, hd = q.shape
    page, nkv = pk.shape[1], pk.shape[2]
    pages = int((pos.long() // page + 1).sum())
    tokens = int((pos.long() + 1).sum())
    nbytes = (2 * q.numel() * 2 + pages * page * nkv * hd * 2 * 2
              + pages * 4 + pos.numel() * 4)
    return bound(nbytes, 4 * nq * hd * tokens)


def exit_bound(x, w):
    t, d = x.shape
    v = w.shape[1]
    return bound(x.numel() * 2 + w.numel() * 2 + t * 4, 2 * t * d * v)


def sdpa_gathered(F, torch):
    """The library yardstick for paged attention: one
    scaled_dot_product_attention call on the gathered view, kv heads
    repeated to the query heads (the page gather and the repeat are done
    beforehand and not timed)."""
    def prep(q, pk, pv, tbl, pos):
        from repro_torch.models.attention import paged_view
        g = q.shape[2] // pk.shape[2]
        k = paged_view(pk, tbl).transpose(1, 2).repeat_interleave(g, dim=1)
        v = paged_view(pv, tbl).transpose(1, 2).repeat_interleave(g, dim=1)
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        return (q.transpose(1, 2), k, v, mask)

    def call(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return prep, call


def quant_bound(x):
    t, d = x.shape
    return bound(x.numel() * x.element_size() + t * d + 4 * t, 4 * t * d)


def dequant_bound(q, out_dtype_bytes):
    t, d = q.shape
    return bound(t * d + 4 * t + t * d * out_dtype_bytes, t * d)


def bits_equal(torch, a, b):
    """Bitwise equality of two tensors of one dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return bool(torch.equal(a, b))


def check_quant_pair(torch, ops, ref, x, out_dtype, label):
    """Both int8 kernels against their plain versions on ``x``; fails on
    any bit that differs.  Returns the max abs difference (0.0)."""
    q, s = ops.compress_rows(x)
    qr, sr = ref.quantize_rows_ref(x)
    y = ops.decompress_rows(q, s, dtype=out_dtype)
    yr = ref.dequantize_rows_ref(qr, sr, out_dtype)
    torch.cuda.synchronize()
    ok = (bits_equal(torch, q, qr) and bits_equal(torch, s, sr)
          and bits_equal(torch, y, yr))
    err = max((q.int() - qr.int()).abs().max().item() if q.numel() else 0,
              (s - sr).abs().max().item() if s.numel() else 0.0,
              (y.float() - yr.float()).abs().max().item() if y.numel()
              else 0.0)
    print(f"  {label} {tuple(x.shape)} {x.dtype} -> {out_dtype}: "
          f"{'bit-exact' if ok else 'MISMATCH'} (max abs diff {err:.3e})")
    if not ok:
        bad = (q != qr).nonzero()[:5].tolist()
        fail(f"int8 kernels disagree with their plain versions on {label}: "
             f"first differing q entries {bad}")
    return float(err)


def entropy_library(torch):
    def call(x, w):
        logp = torch.log_softmax(torch.matmul(x, w).float(), dim=-1)
        return -(logp.exp() * logp).sum(-1)
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description="chip smoke of the port")
    ap.add_argument("--json", default="",
                    help="also write the results to this file")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "kernels",
                                       "csrc", "paged_attention.cu")):
        fail(f"the port's sources are not under {SRC}")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import serve_poisson
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card and build -------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; bounds use H100 SXM peaks "
          f"{PEAKS[0] / 1e12:.2f} TB/s, {PEAKS[1] / 1e12:.0f} TFLOP/s bf16")
    t0 = time.time()
    logs = build.build_all()
    print(f"build: {time.time() - t0:.1f}s for {sorted(logs) or 'none'} "
          f"(nvcc, sm_90a)")
    for kname, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{kname}] {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}

    # ---- phase 2: kernels vs plain at main-path shapes ----------------
    # paged GQA: 16 slots, 32/8 heads of 64, pages of 16, pos up to 2047
    sets = paged_inputs(torch, gen, 16, 32, 8, 64, 16, 128, 2048, 4)
    a = sets[0]
    got = ops.paged_gqa_attention(*a)
    want = ref.paged_gqa_attention_ref(*a)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    print(f"paged_gqa_attention: max_abs_err {err:.3e} (tol {PAGED_TOL})")
    if not math.isfinite(err) or err > PAGED_TOL:
        fail(f"paged_gqa_attention disagrees with its plain version: {err}")
    prep, sdpa = sdpa_gathered(F, torch)
    lib_args = [prep(*s) for s in sets]
    lib_out = sdpa(*lib_args[0]).transpose(1, 2)
    lib_err = (lib_out.float() - want.float()).abs().max().item()
    bound_ms, by = paged_bound(a)
    results["paged_gqa_attention"] = {
        "max_abs_err": err,
        "ms": device_ms(torch, ops.paged_gqa_attention, sets),
        "plain_ms": device_ms(torch, ref.paged_gqa_attention_ref, sets),
        "library_ms": device_ms(torch, sdpa, lib_args),
        "bound_ms": bound_ms, "bound_by": by}
    print(f"  sdpa yardstick agrees to {lib_err:.3e}; "
          f"{json.dumps(results['paged_gqa_attention'])}")
    del sets, lib_args

    # exit head: T = 16 slots, D = 2048, V = 49155
    x = torch.randn(16, 2048, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(2048, 49155, generator=gen, device="cuda")
         / math.sqrt(2048)).bfloat16()
    got = ops.exit_head_entropy(x, w)
    want = ref.exit_head_entropy_ref(x, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"exit_head_entropy: max_abs_err {err:.3e} (tol {ENT_TOL}), "
          f"entropy ~{want.mean().item():.3f}")
    if not math.isfinite(err) or err > ENT_TOL:
        fail(f"exit_head_entropy disagrees with its plain version: {err}")
    lib = entropy_library(torch)
    bound_ms, by = exit_bound(x, w)
    results["exit_head_entropy"] = {
        "max_abs_err": err,
        "ms": device_ms(torch, ops.exit_head_entropy, [(x, w)]),
        "plain_ms": device_ms(torch, ref.exit_head_entropy_ref, [(x, w)]),
        "library_ms": device_ms(torch, lib, [(x, w)]),
        "bound_ms": bound_ms, "bound_by": by}
    print(f"  {json.dumps(results['exit_head_entropy'])}")
    del x, w

    # int8 handoff kernels: one full-width granite-3-2b slot leaf at 2048
    # tokens (40 layers x 128 pages x 16 tokens x 8 kv heads rows of 64),
    # one row per hidden state at [4096, 2048] fp32, a zero row, a ragged D
    print("int8 handoff kernels against their plain versions "
          "(tolerance: bit-exact)")
    leaf = torch.randn(40 * 128 * 16 * 8, 64, generator=gen,
                       device="cuda").bfloat16()
    hid = torch.randn(4096, 2048, generator=gen, device="cuda") \
        * torch.rand(4096, 1, generator=gen, device="cuda") * 8
    zero = torch.zeros(3, 64, device="cuda").bfloat16()
    zero[1] = torch.randn(64, generator=gen, device="cuda").bfloat16()
    ragged = torch.randn(777, 100, generator=gen, device="cuda")
    q_err = max(check_quant_pair(torch, ops, ref, leaf, torch.bfloat16,
                                 "slot leaf"),
                check_quant_pair(torch, ops, ref, hid, torch.float32,
                                 "hidden rows"),
                check_quant_pair(torch, ops, ref, zero, torch.bfloat16,
                                 "zero rows"),
                check_quant_pair(torch, ops, ref, ragged, torch.bfloat16,
                                 "D = 100"))
    qz, sz = ops.compress_rows(zero)
    if not (bool((qz[0] == 0).all()) and bool((qz[2] == 0).all())
            and sz[0].item() == sz[2].item() == torch.tensor(1e-8).item()):
        fail("a zero row must quantize to q = 0 with scale exactly 1e-8")
    q_leaf, s_leaf = ops.compress_rows(leaf)
    bound_ms, by = quant_bound(leaf)
    results["quantize_rows"] = {
        "max_abs_err": q_err,
        "ms": device_ms(torch, ops.compress_rows, [(leaf,)]),
        "plain_ms": device_ms(torch, ref.quantize_rows_ref, [(leaf,)]),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": by}
    print(f"  quantize_rows {json.dumps(results['quantize_rows'])}")

    def dequant(q, s):
        return ops.decompress_rows(q, s, dtype=torch.bfloat16)

    def dequant_plain(q, s):
        return ref.dequantize_rows_ref(q, s, torch.bfloat16)
    bound_ms, by = dequant_bound(q_leaf, 2)
    results["dequantize_rows"] = {
        "max_abs_err": q_err,
        "ms": device_ms(torch, dequant, [(q_leaf, s_leaf)]),
        "plain_ms": device_ms(torch, dequant_plain, [(q_leaf, s_leaf)]),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": by}
    print(f"  dequantize_rows {json.dumps(results['dequantize_rows'])}")
    print("  library_ms: none (no single PyTorch call computes either "
          "function)")
    del leaf, hid, q_leaf, s_leaf

    # ---- phase 3: small-input reference, card vs CPU ------------------
    check_smoke_vs_cpu(torch)

    # ---- phase 4: the main path at full width -------------------------
    captured = {}
    orig = {"paged_gqa_attention": ops.paged_gqa_attention,
            "exit_head_entropy": ops.exit_head_entropy}

    def capturing(kname, every):
        calls = [0]

        def wrapper(*a):
            calls[0] += 1
            if calls[0] % every == 0:
                # pools change in place later: copy them; weights do not
                captured[kname] = tuple(
                    t.clone() if t.numel() * t.element_size() < 2 ** 26
                    else t for t in a)
            return orig[kname](*a)
        return wrapper

    ops.paged_gqa_attention = capturing("paged_gqa_attention", 997)
    ops.exit_head_entropy = capturing("exit_head_entropy", 53)
    print("main path: granite-3-2b, 40 layers, random weights (seed 0), "
          "paged + segmented, 16 slots, 32 requests")
    print("  random weights give near-flat logits (normalized entropy ~1), "
          "so exits at threshold 0.5 will rarely fire; both probes still "
          "run on every decode step")
    ops.reset_launches()
    t0 = time.time()
    stats = serve_poisson(
        "granite-3-2b", rate=16.0, n_requests=32, slots=16,
        prompt_len=256, max_new=32, threshold=0.5, paged=True,
        page_size=16, segmented=True, prefix_share=0.25, prefix_len=128,
        seed=0, device="cuda", quiet=True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    wall = time.time() - t0
    ops.paged_gqa_attention = orig["paged_gqa_attention"]
    ops.exit_head_entropy = orig["exit_head_entropy"]
    print(f"  launches during the main path: {launches} ({wall:.1f}s "
          f"including model init and warm-up)")
    for kname in ("paged_gqa_attention", "exit_head_entropy"):
        if launches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the main path")
    outs = stats.pop("outputs")
    if len(outs) != 32 or any(len(o) != 32 for o in outs):
        fail("not every request produced max_new tokens")
    if any(not (0 <= t < 49155) for o in outs for t in o):
        fail("token out of vocabulary range")
    print(f"  tokens {stats['tokens']}, sustained "
          f"{stats['sustained_tok_s']:.2f} tok/s, p50 "
          f"{stats['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{stats['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{stats['makespan_s']:.2f} s, prefix_hit_tokens "
          f"{stats['prefix_hit_tokens']}, chunks skipped "
          f"{stats['prefill_chunks_skipped']}")
    print(f"  exit stats {stats['exit_stats']}; stage calls "
          f"{stats['stage_calls']}")
    if stats["prefix_hit_tokens"] <= 0:
        fail("the shared prefix never hit the prefix cache")

    main_launches = launches
    # each kernel again on inputs captured from the live run
    for kname, tol, plain in (
            ("paged_gqa_attention", PAGED_TOL, ref.paged_gqa_attention_ref),
            ("exit_head_entropy", ENT_TOL, ref.exit_head_entropy_ref)):
        if kname not in captured:
            fail(f"no live call of {kname} was captured")
        a = captured[kname]
        got = orig[kname](*a).float()
        want = plain(*a).float()
        err = (got - want).abs().max().item()
        shapes = [tuple(t.shape) for t in a]
        print(f"  live {kname} {shapes}: max_abs_err {err:.3e} (tol {tol})")
        if not torch.isfinite(got).all() or err > tol:
            fail(f"{kname} disagrees with its plain version on live inputs")
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                            err)

    # ---- phase 5: the tiered path at full width ----------------------
    tiered, tier_launches = run_tiered(torch, ops, ref, results)

    replaces = {
        "paged_gqa_attention": ("src/repro_torch/kernels/csrc/"
                                "paged_attention.cu",
                                "src/repro/kernels/paged_attention.py:82"),
        "exit_head_entropy": ("src/repro_torch/kernels/csrc/exit_head.cu",
                              "src/repro/kernels/exit_head.py:55"),
        "quantize_rows": ("src/repro_torch/kernels/csrc/feature_compress.cu",
                          "src/repro/kernels/feature_compress.py:34"),
        "dequantize_rows": ("src/repro_torch/kernels/csrc/"
                            "feature_compress.cu",
                            "src/repro/kernels/feature_compress.py:60"),
    }
    # launches: each kernel's count on the path that carries it (phase 4
    # for attention and the exit probe, phase 5's int8 run for the handoff)
    path_launches = dict(main_launches)
    path_launches["quantize_rows"] = tier_launches["quantize_rows"]
    path_launches["dequantize_rows"] = tier_launches["dequantize_rows"]
    kernels = []
    for kname, r in results.items():
        source, repl = replaces[kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": repl, "launches": path_launches[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card_line, "kernels": kernels,
                       "serve": stats, "tiered": tiered}, f, indent=1)
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


TIER_TRACE = dict(rate=100.0, n_requests=8, base_slots=2, prompt_len=12,
                  max_new=8, seed=0)


def run_tiered(torch, ops, ref, results):
    """Phase 5: granite-3-2b at full width behind the tiered cluster with
    an edge outage, twice (see the module docstring).  Returns the two
    runs' summaries and the launch counts of the int8 run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import Scenario
    from repro_torch.launch.serve import poisson_trace, serve_tiered_poisson
    from repro_torch.models import Model
    from repro_torch.serving.cluster import ClusterConfig, TieredServingCluster
    cfg = get_config("granite-3-2b")
    model = Model(cfg, device="cuda")
    params = model.init(0)
    tr = TIER_TRACE
    print(f"tiered path: granite-3-2b, 40 layers, random weights (seed 0), "
          f"{tr['n_requests']} requests, prompts {tr['prompt_len'] // 4}-"
          f"{tr['prompt_len']} tokens, max_new {tr['max_new']}, cloud pool "
          f"{tr['base_slots']} slots; latencies below are modelled by the "
          f"planners' tier profiles (virtual clocks), not measured")
    summaries = {}

    def summarize(label, st, wall, launches):
        mig = st["migration"]
        tok_s = st["tokens"] / wall
        print(f"  {label}: routes {st['route_counts']} splits "
              f"{st['splits']}, dead {st.get('dead_tiers')}, migration "
              f"{json.dumps(mig)}")
        print(f"    bytes moved {mig['bytes_moved']:.0f} of raw "
              f"{mig['bytes_raw']:.0f}; measured wall {wall:.2f} s, "
              f"{st['tokens']} tokens, {tok_s:.2f} tok/s (host clock); "
              f"modelled virtual p50 {st['p50_latency_s'] * 1e3:.1f} ms, "
              f"p95 {st['p95_latency_s'] * 1e3:.1f} ms; launches {launches}")
        if st["completed"] != tr["n_requests"]:
            fail(f"{label}: {st['completed']} of {tr['n_requests']} "
                 f"requests completed")
        if st.get("dead_tiers") != ["edge"]:
            fail(f"{label}: dead tiers {st.get('dead_tiers')}, not ['edge']")
        if mig["outage_migrations"] < 1:
            fail(f"{label}: no slot migrated off the dead tier")
        if any(len(o) != tr["max_new"] for o in st["outputs"]) or any(
                not (0 <= t < cfg.vocab_size) for o in st["outputs"]
                for t in o):
            fail(f"{label}: a request's tokens are missing or out of range")
        summaries[label] = {"wall_s": wall, "tokens": st["tokens"],
                            "tok_s": tok_s, "route_counts":
                            st["route_counts"], "migration": mig,
                            "virtual_p50_s": st["p50_latency_s"],
                            "virtual_p95_s": st["p95_latency_s"],
                            "launches": launches}

    # run 1: the normal entry point (contiguous arenas, handoff per link)
    ops.reset_launches()
    t0 = time.time()
    st = serve_tiered_poisson("granite-3-2b", scenario="tier-outage",
                              params=params, device="cuda", quiet=True,
                              **tr)
    torch.cuda.synchronize()
    summarize("run 1 serve_tiered_poisson (contiguous, kv_handoff auto)",
              st, time.time() - t0, dict(ops.LAUNCHES))

    # run 2: paged arenas and a forced int8 handoff, on the same trace
    rs = np.random.RandomState(tr["seed"])
    arrivals, lengths = poisson_trace(rs, tr["rate"], tr["n_requests"],
                                      tr["prompt_len"])
    prompts = [rs.randint(0, cfg.vocab_size, int(n)) for n in lengths]
    max_len = tr["prompt_len"] + tr["max_new"]
    max_len += (-max_len) % 16
    captured = {}
    orig = {"compress_rows": ops.compress_rows,
            "decompress_rows": ops.decompress_rows}

    def capture(kname):
        def wrapper(*a, **kw):
            if kname not in captured and a[0].numel():
                captured[kname] = (tuple(t.clone() for t in a), kw)
            return orig[kname](*a, **kw)
        return wrapper
    ops.compress_rows = capture("compress_rows")
    ops.decompress_rows = capture("decompress_rows")
    cluster = TieredServingCluster(
        model, params, Scenario.tier_outage("edge", at=0.03),
        plan_cfg=cfg,
        cfg=ClusterConfig(base_slots=tr["base_slots"], max_len=max_len,
                          prefill_chunk=tr["prompt_len"], kv_handoff="int8",
                          paged=True,
                          page_size=16))
    crs = [cluster.submit(p, max_new=tr["max_new"], arrival=float(a))
           for p, a in zip(prompts, arrivals)]
    ops.reset_launches()
    t0 = time.time()
    cluster.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    ops.compress_rows = orig["compress_rows"]
    ops.decompress_rows = orig["decompress_rows"]
    st = cluster.stats()
    st["outputs"] = [list(cr.req.out_tokens) for cr in crs]
    st["tokens"] = sum(len(o) for o in st["outputs"])
    summarize("run 2 TieredServingCluster (paged, kv_handoff int8)", st,
              wall, launches)
    if st["migration"]["compressed"] < 1:
        fail("run 2: no handoff went through the int8 kernels")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"kernel {kname} was not launched on the tiered path")
    if "compress_rows" not in captured:
        fail("no live export was captured")
    (x,), _ = captured["compress_rows"]
    err = check_quant_pair(torch, ops, ref, x, x.dtype, "live export leaf")
    for kname in ("quantize_rows", "dequantize_rows"):
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                            err)
    del model, params, cluster
    return summaries, launches


def check_smoke_vs_cpu(torch):
    """granite-3-2b-smoke paged decode: the card (kernels, cuBLAS) against
    the CPU (plain versions) on the same weights and inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.attention import PagedKV
    from repro_torch.models.common import tree_map
    cfg = get_config("granite-3-2b-smoke")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    p_cpu = cpu.init(0)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    b, page, pps = 4, 16, 4
    n_pages = b * pps
    g = torch.Generator().manual_seed(1)
    tbl = torch.randperm(n_pages, generator=g).to(torch.int32).reshape(b, pps)
    c_cpu = cpu.init_decode_cache_paged(b, n_pages, page)
    c_gpu = gpu.init_decode_cache_paged(b, n_pages, page)
    pos = torch.tensor([0, 5, 17, 40], dtype=torch.int32)
    worst = worst_ent = 0.0
    for _ in range(8):
        toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
        mask = torch.ones(b, dtype=torch.bool)
        lc, _, _ = cpu.decode_step(p_cpu, c_cpu, toks, pos,
                                   paged=PagedKV(tbl, mask))
        lg, _, _ = gpu.decode_step(p_gpu, c_gpu, toks.cuda(), pos.cuda(),
                                   paged=PagedKV(tbl.cuda(), mask.cuda()))
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        x = cpu.embed_decode_tokens(p_cpu, toks)
        ec = cpu.exit_probe_entropy(p_cpu, 0, x)
        eg = gpu.exit_probe_entropy(p_gpu, 0, x.cuda())
        worst_ent = max(worst_ent, (eg.cpu() - ec).abs().max().item())
        pos = pos + 1
    print(f"smoke reference (card vs CPU, 8 paged decode steps): logits "
          f"max_abs_err {worst:.3e} (tol {LOGIT_TOL}), probe entropy "
          f"{worst_ent:.3e} (tol {ENT_TOL})")
    if worst > LOGIT_TOL or worst_ent > ENT_TOL:
        fail("the card disagrees with the CPU on granite-3-2b-smoke")


if __name__ == "__main__":
    main()
