"""Static and runtime invariant analyzer for the port's serving stack.

* :mod:`repro_torch.analysis.lint`: AST pass over ``src/repro_torch/``:
  host syncs in the serving poll hot loop (SYN rules), following
  same-class helpers one level deep (:mod:`.callgraph`).
* :mod:`repro_torch.analysis.costcheck`: the registered decode stages'
  matmul FLOPs against the analytic router costs, gated on a committed
  tolerance band (CST001).
* :mod:`repro_torch.analysis.guards`: runtime guards that tests and
  ``chip_smoke.py`` attach to live schedulers: ``no_recompile``,
  ``guard_polling``, ``guard_sync_budget`` and ``SlotAudit``.
* :mod:`repro_torch.analysis.report`: findings, rendering and the
  committed baseline ``analysis_baseline_torch.json`` (the gate trips on
  NEW findings only).

Run it: ``python -m repro_torch.analysis`` (``--explain RULEID`` for a
rule, ``--no-cost`` for the lint alone).
"""
from repro_torch.analysis.callgraph import CallGraph, map_tainted_params
from repro_torch.analysis.costcheck import (TOLERANCE, build_audit_stack,
                                            check_cost_graphs,
                                            decode_flops_per_token,
                                            stage_flops)
from repro_torch.analysis.guards import (GuardError, SlotAudit,
                                         guard_polling, guard_sync_budget,
                                         no_recompile)
from repro_torch.analysis.lint import lint_file, lint_paths, lint_source
from repro_torch.analysis.report import (Finding, load_baseline,
                                         new_findings, save_baseline,
                                         sort_findings, to_json)
from repro_torch.analysis.rules import RULES, Rule

__all__ = [
    "CallGraph", "Finding", "GuardError", "RULES", "Rule", "SlotAudit",
    "TOLERANCE", "build_audit_stack", "check_cost_graphs",
    "decode_flops_per_token", "guard_polling", "guard_sync_budget",
    "lint_file", "lint_paths", "lint_source", "load_baseline",
    "map_tainted_params", "new_findings", "no_recompile", "save_baseline",
    "sort_findings", "stage_flops", "to_json",
]
