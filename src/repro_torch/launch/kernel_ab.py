"""A redesigned kernel against an earlier version of it, in one process on
one card.

    python -m repro_torch.launch.kernel_ab --parent DIR [--kernels exit_head
        flash_attention] [--json PATH]

``DIR`` is a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``).  Each named kernel's
CUDA source under ``DIR/src/repro_torch/kernels/csrc/`` is compiled with
the current build flags and called through its C entry point as that
commit declared it; the current kernel is called through ``kernels.ops``.
Both are checked against the plain version on the same inputs, then timed
with CUDA events in turns over three rounds (the order reversed every
other round), with the library call beside them, at the main path's
shapes:

  exit_head        x [16, 2048] / W [2048, 49155] (granite-3-2b) and
                   x [16, 7168] / W [7168, 129280] (deepseek-v3);
  flash_attention  q [8, 2048, 32, 64], k/v [8, 2048, 8, 64], causal.

Prints each timing's median and spread (max - min over the rounds).  The
card is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ops, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points as the sources before the exit head's instance flag
# declare them
PARENT_SIGNATURES = {
    "exit_head": {
        "repro_exit_head_block_v": ([], _I),
        "repro_exit_head_entropy": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    },
    "flash_attention": {
        "repro_flash_attention": (
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    },
}


def parent_library(parent: Path, name: str) -> ctypes.CDLL:
    src = parent / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    out = build.BUILD_DIR / "parent" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_ab: the parent's {name} did not build\n"
                           + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in PARENT_SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def parent_exit_head(lib):
    def call(x, w):
        t, d = x.shape
        v = w.shape[1]
        n_tiles = -(-v // lib.repro_exit_head_block_v())
        part = torch.empty(3 * t * n_tiles, dtype=torch.float32,
                           device=x.device)
        out = torch.empty(t, dtype=torch.float32, device=x.device)
        build.check(lib.repro_exit_head_entropy(
            x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(), t,
            d, v, torch.cuda.current_stream().cuda_stream), "parent exit")
        return out
    return call


def parent_flash(lib):
    def call(q, k, v):
        b, sq, nq, hd = q.shape
        out = torch.empty_like(q)
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], nq, k.shape[2], hd, 1, 0, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream), "parent flash")
        return out
    return call


def device_ms(fn, args, iters=20):
    """Device time of one call: CUDA events around ``iters`` calls queued
    behind a sleep kernel, so host enqueue time is not counted."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    e0.record()
    for _ in range(iters):
        fn(*args)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def interleaved(fns, args, rounds, iters):
    """Time each of ``fns`` (name -> callable) ``rounds`` times, the order
    reversed every other round; returns name -> {median, spread, all}."""
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(device_ms(fns[n], args, iters))
    return {n: {"median_ms": statistics.median(t),
                "spread_ms": max(t) - min(t), "ms": t}
            for n, t in times.items()}


def entropy_library(x, w):
    logp = torch.log_softmax(torch.matmul(x, w).float(), dim=-1)
    return -(logp.exp() * logp).sum(-1)


def sdpa(q, k, v):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def run(parent: Path, kernels, rounds: int = 3):
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    if "exit_head" in kernels:
        old = parent_exit_head(parent_library(parent, "exit_head"))
        for label, d, v in (("granite", 2048, 49155),
                            ("deepseek", 7168, 129280)):
            x = torch.randn(16, d, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(d, v, generator=gen, device="cuda")
                 / math.sqrt(d)).bfloat16()
            want = ref.exit_head_entropy_ref(x, w)
            errs = {n: (f(x, w) - want).abs().max().item() for n, f in
                    (("parent", old), ("current", ops.exit_head_entropy))}
            r = interleaved({"library": entropy_library, "parent": old,
                             "current": ops.exit_head_entropy},
                            (x, w), rounds, 10)
            r["max_abs_err"] = errs
            results[f"exit_head_{label}"] = r
            print(f"exit_head {label} x {tuple(x.shape)} w {tuple(w.shape)}: "
                  f"{json.dumps(r)}", flush=True)
            del x, w
    if "flash_attention" in kernels:
        old = parent_flash(parent_library(parent, "flash_attention"))
        q, k, v = (torch.randn(8, 2048, n, 64, generator=gen, device="cuda")
                   .bfloat16() for n in (32, 8, 8))
        want = ref.flash_attention_ref(q, k, v).float()

        def err(f):
            diff = (f(q, k, v).float() - want).abs()
            return (diff / want.abs().clamp(min=1)).max().item()
        errs = {"parent": err(old), "current": err(
            lambda *a: ops.flash_attention(*a, causal=True))}
        r = interleaved({"library": sdpa, "parent": old,
                         "current": lambda *a: ops.flash_attention(
                             *a, causal=True)}, (q, k, v), rounds, 20)
        r["max_err_of_max1_plain"] = errs
        results["flash_attention"] = r
        print(f"flash_attention q {tuple(q.shape)} k {tuple(k.shape)}: "
              f"{json.dumps(r)}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--kernels", nargs="+",
                    default=["exit_head", "flash_attention"],
                    choices=["exit_head", "flash_attention"])
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, log in build.build_all(args.kernels).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    results = run(args.parent, args.kernels)
    results["card"] = smi.stdout.strip()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
