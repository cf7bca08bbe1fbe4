"""CLI for the port's analyzer: ``python -m repro_torch.analysis``.

Two layers, one gate:

1. **AST lint** over ``src/repro_torch/`` (or the given paths): host syncs
   in the serving poll hot loop (SYN rules), same-class helpers followed
   one level deep.
2. **Cost cross-check** (default run only, skip with ``--no-cost``):
   builds the audit stack (``costcheck.build_audit_stack``: a tiered
   cluster with the speculative bridge and a paged prefix-cache
   scheduler, granite-3-2b-smoke, on the card unless ``--device cpu``),
   runs every arena's decode stages once under the FLOP counter, and
   compares FLOPs per token with the analytic router costs; drift outside
   ``costcheck.TOLERANCE`` is CST001.

All findings gate on the committed baseline
(``analysis_baseline_torch.json`` at the repo root): the exit code is
non-zero only for violations NOT in the baseline.  ``--update-baseline``
accepts the current state; ``--explain RULEID`` prints a rule's
description, a minimal violating snippet and its fix.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.report import (load_baseline, new_findings,
                                         save_baseline, sort_findings,
                                         to_json)
from repro_torch.analysis.rules import RULES

BASELINE = "analysis_baseline_torch.json"


def find_repo_root(start: Optional[str] = None) -> str:
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(cur, ".git")) \
                or os.path.isfile(os.path.join(cur, "ROADMAP.md")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start or os.getcwd())
        cur = parent


def explain_rule(rule_id: str) -> str:
    """Human-readable registry entry for ``--explain``: description plus
    the minimal violating snippet and its fix."""
    rule = RULES.get(rule_id.upper())
    if rule is None:
        known = ", ".join(sorted(RULES))
        raise KeyError(f"unknown rule id {rule_id!r} (known: {known})")
    lines = [f"{rule.id} [{rule.severity}] {rule.name}", "",
             rule.description]
    if rule.example:
        lines += ["", "violates:"]
        lines += ["    " + ln for ln in rule.example.splitlines()]
    if rule.fix:
        lines += ["", f"fix: {rule.fix}"]
    return "\n".join(lines)


def _family_counts(findings) -> str:
    counts = {}
    for f in findings:
        fam = f.rule[:3]
        counts[fam] = counts.get(fam, 0) + 1
    return ", ".join(f"{k}={v}" for k, v in sorted(counts.items())) \
        or "none"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant analyzer of the port: host syncs in "
                    "the serving poll hot loop, cost-graph cross-check")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: <repo>/src/"
                         "repro_torch; giving explicit paths skips the "
                         "cost layer)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline json (default: <repo>/{BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current findings as the new baseline")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable findings json")
    ap.add_argument("--no-gate", action="store_true",
                    help="report only; always exit 0")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost cross-check (the lint alone; much "
                         "faster)")
    ap.add_argument("--device", default="cuda",
                    help="device of the cost check's audit stack (default: "
                         "the card; 'cpu' runs it on the host)")
    ap.add_argument("--explain", metavar="RULEID", default=None,
                    help="print one rule's registry entry, a minimal "
                         "violating snippet, and its fix, then exit")
    args = ap.parse_args(argv)

    if args.explain:
        try:
            print(explain_rule(args.explain))
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2
        return 0

    root = find_repo_root()
    paths = list(args.paths) or [os.path.join(root, "src", "repro_torch")]
    baseline_path = args.baseline or os.path.join(root, BASELINE)

    findings = lint_paths(paths, repo_root=root)
    run_cost = not args.no_cost and not args.paths
    ratios = {}
    if run_cost:
        from repro_torch.analysis.costcheck import (build_audit_stack,
                                                    check_cost_graphs)
        cst_findings, ratios = check_cost_graphs(
            build_audit_stack(args.device))
        findings = findings + cst_findings

    if args.as_json:
        print(to_json(findings))
    if args.update_baseline:
        save_baseline(baseline_path, findings)
        print(f"baseline updated: {len(findings)} finding(s) -> "
              f"{os.path.relpath(baseline_path, root)}")
        return 0

    fresh = new_findings(findings, load_baseline(baseline_path))
    known = len(findings) - len(fresh)
    if not args.as_json:
        for f in sort_findings(fresh):
            print(f.render())
    n_err = sum(1 for f in fresh if f.severity == "error")
    if run_cost:
        rs = [v["ratio"] for v in ratios.values()]
        band = (f"cost ratios {min(rs):.3f}-{max(rs):.3f} over "
                f"{len(rs)} arena(s)") if rs else "no arenas costed"
        print(f"cost check: {band}", file=sys.stderr)
    print(f"analysis: {len(findings)} finding(s), {known} baselined, "
          f"{len(fresh)} new ({n_err} error(s)) "
          f"[families: {_family_counts(findings)}]", file=sys.stderr)
    if args.no_gate:
        return 0
    return 1 if fresh else 0


if __name__ == "__main__":
    raise SystemExit(main())
