"""The control of each cell's correctness check, and the readings its
limits are set from.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 \
        [--seconds S]

Runs the cell as ``run.py`` does, once a seed in one process (the
window at ``--seconds``, by default the benchmark's ``run_seconds``),
and then beside the program's readings the control's: the plain
reference in float8 (e4m3) put in the program's place, on the same
prompts and served tokens (a decode cell: the reference's gap of the
token float8 puts first, and float8's exit entropies; a scoring cell: float8's logits against
float32's), judged against the cell's limits as the program is:
``control_correct`` has to come out false.  One JSON line a seed.
The benchmark's own runs never run the control.
"""
import argparse
import gc
import json
import sys
import time

from run import ROOT, _setup_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    _setup_paths()
    import torch
    from bench import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("bench control: no CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or cell["run_seconds"]
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, seconds, False,
                               torch.device("cuda", 0), time.perf_counter(),
                               control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: c["value"] for k, c in out["checks"].items()},
            "control": out["control"], "correct": out["correct"],
            "control_correct": out["control_correct"],
            "metrics": {k: m["value"] for k, m in out["metrics"].items()},
            "phases": out.get("phases")}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
