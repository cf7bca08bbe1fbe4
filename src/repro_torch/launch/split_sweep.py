"""What the paged decode kernels' split size costs, on one card.

    python -m repro_torch.launch.split_sweep [--json PATH]

The wrappers split a page table by ``plan()`` in ``kernels/paged_mla.py``
and ``kernels/paged_attention.py``, from shapes only (never ``pos``).  For
each paged kernel this calls its C entry point with several pages-per-split
values, the plan's among them, and times them in turns
(``kernel_ab.interleaved``, three rounds, four pool copies), on three
kinds of table at deepseek-v3's and granite-3-2b's widths with 16
sequences:

  long     128-page tables, positions below 2048 (phase 2 of chip_smoke.py);
  serving  GQA 18-page tables below 288 (phase 4), MLA 9-page tables
           below 144 (phase 6);
  one page the serving tables with every position 0: one page a
           sequence, the fixed cost of a call.

Each setting is checked against the plain version first.  Prints one line
per kernel and table: the plan's split, then (ms, pages a split) from the
fastest.  The card is required.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build, paged_attention, paged_mla, ref
from repro_torch.launch import kernel_ab as ab

MLA_SCALE = 1.0 / math.sqrt(128 + 64)      # deepseek-v3's nope + rope


def gqa_with_split(split_pages):
    lib = build.library("paged_attention")

    def call(q, pk, pv, tbl, pos):
        b, _, nq, hd = q.shape
        n_pages, page, nkv, _ = pk.shape
        pps = tbl.shape[1]
        s = -(-pps // split_pages)
        out = torch.empty_like(q)
        part = torch.empty((b, s, nq, hd), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((b, s, nq, 2), dtype=torch.float32, device=q.device)
        build.check(lib.repro_paged_gqa_attention(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), tbl.data_ptr(),
            pos.data_ptr(), out.data_ptr(), part.data_ptr(), ml.data_ptr(),
            b, nkv, nq // nkv, hd, page, n_pages, pps, split_pages,
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream),
            "paged_gqa_attention launch")
        return out
    return call


def mla_with_split(split_pages):
    lib = build.library("paged_mla")

    def call(ql, qr, pc, pk, tbl, pos):
        b, _, n, r = ql.shape
        pps = tbl.shape[1]
        s = -(-pps // split_pages)
        out = torch.empty((b, 1, n, r), dtype=torch.float32,
                          device=ql.device)
        part = torch.empty((b, s, n, r), dtype=torch.float32,
                           device=ql.device)
        ml = torch.empty((b, s, n, 2), dtype=torch.float32, device=ql.device)
        build.check(lib.repro_paged_mla_attention(
            ql.data_ptr(), qr.data_ptr(), pc.data_ptr(), pk.data_ptr(),
            tbl.data_ptr(), pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            ml.data_ptr(), b, n, r, qr.shape[3], pc.shape[1], pc.shape[0],
            pps, split_pages, MLA_SCALE,
            torch.cuda.current_stream().cuda_stream),
            "paged_mla_attention launch")
        return out
    return call


def _one_page_each(sets):
    """The same inputs with every position 0 (the table's first page)."""
    return [(*a[:-1], torch.zeros_like(a[-1])) for a in sets]


def run(rounds: int = 3):
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = paged_mla.sm_count("cuda")
    results = {}
    kinds = {
        "paged_attention": (
            lambda pps, max_pos: ab.paged_inputs(gen, 16, 32, 8, 64, 16, pps,
                                                 max_pos, 4),
            lambda pps: paged_attention.plan(16, 8, pps, sms, 64),
            gqa_with_split,
            lambda a: ref.paged_gqa_attention_ref(*a).float(), 1e-2,
            {"long": (128, 2048, (4, 8, 12, 15, 16, 32, 128)),
             "serving": (18, 288, (1, 2, 3, 4, 6, 9, 18))}),
        "paged_mla": (
            lambda pps, max_pos: ab.mla_inputs(gen, 16, 128, 512, 64, 16,
                                               pps, max_pos, 4),
            lambda pps: paged_mla.plan(16, 128, pps, sms),
            mla_with_split,
            lambda a: ref.paged_mla_attention_ref(*a, scale=MLA_SCALE), 1e-3,
            {"long": (128, 2048, (8, 16, 22, 26, 32, 64, 128)),
             "serving": (9, 144, (2, 4, 6, 10))}),
    }
    for name, (inputs, plan, with_split, plain, tol, tables) in kinds.items():
        for label, (pps, max_pos, splits) in tables.items():
            sets = inputs(pps, max_pos)
            runs = [(label, sets)]
            if label == "serving":
                runs.append(("one page", _one_page_each(sets)))
            for tag, args in runs:
                chosen = plan(pps)["split_pages"]
                fns = {sp: with_split(sp)
                       for sp in sorted({*splits, chosen})}
                want = plain(args[0])
                for sp, fn in fns.items():
                    err = (fn(*args[0]).float() - want).abs().max().item()
                    if not err <= tol:
                        raise SystemExit(f"split_sweep: {name} with "
                                         f"{sp} pages a split is off by "
                                         f"{err}")
                r = ab.interleaved(fns, args, rounds, 20)
                ranked = sorted((v["median_ms"], sp) for sp, v in r.items())
                results[f"{name} {tag}"] = {
                    "pps": pps, "max_pos": max_pos, "plan": chosen,
                    "median_ms": {str(sp): v["median_ms"]
                                  for sp, v in r.items()},
                    "spread_ms": {str(sp): v["spread_ms"]
                                  for sp, v in r.items()}}
                print(f"{name} {tag} ({pps}-page tables): plan {chosen}; "
                      f"{[(round(ms, 5), sp) for ms, sp in ranked]}",
                      flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("split_sweep: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.build_all(["paged_attention", "paged_mla"])
    results = run()
    results["card"] = smi.stdout.strip()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
