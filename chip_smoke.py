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
     inputs captured from that run.
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
    for kname, n in launches.items():
        if n <= 0:
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

    replaces = {
        "paged_gqa_attention": ("src/repro_torch/kernels/csrc/"
                                "paged_attention.cu",
                                "src/repro/kernels/paged_attention.py:82"),
        "exit_head_entropy": ("src/repro_torch/kernels/csrc/exit_head.cu",
                              "src/repro/kernels/exit_head.py:55"),
    }
    kernels = []
    for kname, r in results.items():
        source, repl = replaces[kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": repl, "launches": launches[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card_line, "kernels": kernels,
                       "serve": stats}, f, indent=1)
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


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
