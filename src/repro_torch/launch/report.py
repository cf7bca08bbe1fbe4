"""Dry-run and roofline tables from the dry run's results
(``experiments/dryrun_torch/*.json``, or ``--dir``), the counterpart of
the reference's ``launch/report.py``: the same columns (``run_s``, the
meta run's seconds, where the reference has its compile time), plus each
combination's per-device argument size and ``fits_80gb`` (arguments
only), and advice that names the port's own levers.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

from repro_torch.configs import ARCHS
from repro_torch.launch.dryrun import OUT_DIR

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESH_ORDER = ["one", "single", "multi"]


def load_all(directory: str = OUT_DIR):
    out = {}
    for fn in glob.glob(os.path.join(directory, "*.json")):
        if len(os.path.basename(fn)[:-5].split("__")) > 3:
            continue              # strategy / variant runs: not tabled
        with open(fn) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def _fmt_t(x):
    if x is None:
        return "—"
    if x >= 1.0:
        return f"{x:7.2f}s "
    if x >= 1e-3:
        return f"{x*1e3:6.1f}ms"
    return f"{x*1e6:6.0f}µs"


def _advice(r):
    rl = r["roofline"]
    bn = rl["bottleneck"]
    kind = r.get("kind")
    if not r.get("fits_80gb", True):
        lead = ("arguments exceed one card's 80 GB: shard them over more "
                "cards; ")
    else:
        lead = ""
    if bn == "collective":
        coll = rl["collective"] or {}
        top = max(coll, key=coll.get) if coll else ""
        return lead + (f"dominant collective is {top}: keep the "
                       f"{'gradient exchange' if kind == 'train' else 'activations'} "
                       f"on one rank or cut its bytes (int8 boundary)")
    if bn == "memory":
        if kind == "decode":
            return lead + ("memory-bound decode: batch more rows a step or "
                           "shard the cache")
        return lead + ("memory-bound: fuse the fp32 upcasts and elementwise "
                       "passes (norms, RoPE, the optimizer) into fewer "
                       "kernels")
    return lead + ("compute-bound: raise the tensor-core share of the "
                   "products (bf16 GEMMs at aligned widths, the flash "
                   "kernel's tiles)")


def roofline_table(results, mesh="single"):
    lines = []
    lines.append("| arch | shape | kind | t_compute | t_memory | t_collective | bottleneck | MODEL_FLOPS | MODEL/HLO | fits_80gb | note |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for arch in sorted(ARCHS):
        for shape in SHAPE_ORDER:
            r = results.get((arch, shape, mesh))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | "
                             f"— | — | SKIPPED: {r['reason']} |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | {r.get('kind', '—')} | "
                             f"— | — | — | — | — | — | — | FAIL at "
                             f"{r.get('site', '?')} |")
                continue
            rl = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | {r['kind']} | {_fmt_t(rl['t_compute'])} "
                f"| {_fmt_t(rl['t_memory'])} | {_fmt_t(rl['t_collective'])} "
                f"| **{rl['bottleneck']}** | {rl['model_flops']:.2e} "
                f"| {rl['useful_flops_ratio']:.2f} | {r['fits_80gb']} "
                f"| {_advice(r)} |")
    return "\n".join(lines)


def dryrun_table(results):
    lines = []
    lines.append("| arch | shape | mesh | chips | status | run_s | per-dev flops | per-dev bytes | per-dev collective B | per-dev args GB | fits_80gb |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for arch in sorted(ARCHS):
        for shape in SHAPE_ORDER:
            for mesh in MESH_ORDER:
                r = results.get((arch, shape, mesh))
                if r is None:
                    continue
                if r["status"] != "ok":
                    lines.append(f"| {arch} | {shape} | {mesh} | — | "
                                 f"{r['status']} | — | — | — | — | — | — |")
                    continue
                rl = r["roofline"]
                cb = rl["collective_bytes"]
                lines.append(
                    f"| {arch} | {shape} | {mesh} | {r['chips']} | ok "
                    f"| {r['run_s']:.1f} | {rl['hlo_flops']:.2e} "
                    f"| {rl['hlo_bytes']:.2e} "
                    f"| {'—' if cb is None else f'{cb:.2e}'} "
                    f"| {r['argument_bytes'] / 1e9:.2f} | {r['fits_80gb']} |")
    return "\n".join(lines)


def summary_stats(results):
    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_fail = len(results) - n_ok - n_skip
    bn = defaultdict(int)
    for r in results.values():
        if r["status"] == "ok" and r["mesh"] == "single":
            bn[r["roofline"]["bottleneck"]] += 1
    return n_ok, n_skip, n_fail, dict(bn)


def render(results) -> str:
    n_ok, n_skip, n_fail, bn = summary_stats(results)
    fails = sorted(f"{a} {s} {m} at {r.get('site', '?')}"
                   for (a, s, m), r in results.items()
                   if r["status"] not in ("ok", "skipped"))
    out = ["## §Dry-run (the port, counted on meta)\n",
           f"- combos: {len(results)} ({n_ok} ok, {n_skip} skipped, "
           f"{n_fail} failed{': ' + '; '.join(fails) if fails else ''})",
           f"- single-pod bottleneck mix: {bn}\n",
           dryrun_table(results)]
    for mesh, title in (("one", "one H100"),
                        ("single", "single pod, 16x16 = 256 chips")):
        out += [f"\n## §Roofline ({title}; per device, against one "
                "H100's peaks)\n", roofline_table(results, mesh)]
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    print(render(load_all(args.dir)))


if __name__ == "__main__":
    main()
