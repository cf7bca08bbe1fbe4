"""Cost-graph honesty: the registered decode stages' FLOPs against the
analytic router costs.

Every admission decision the cluster makes is priced from
``core.paradigms.analytic_step_cost`` (itself ``core.cost_model.
build_cost_graph``).  Those numbers are asserted, not measured: nothing
stops ``_layer_flops`` drifting away from what the stages compute when an
architecture or a stage changes.  This module closes the loop: it runs
each arena's registered decode stages (``audit_stages()``) once on their
example inputs, counts their matmul FLOPs, reduces the decode path to
FLOPs *per token*, and compares against the analytic per-token cost of
the same model at the same context length.  The ratio

    measured_decode_flops_per_token / analytic_flops_per_token

must stay inside the committed ``TOLERANCE`` band or ``CST001`` fires
through the ordinary finding gate.

Counting is matmul-only, as the reference's: ``aten.mm``, ``bmm``,
``addmm`` and ``baddbmm`` (``einsum`` runs as ``bmm``) under
``torch.utils.flop_counter.FlopCounterMode``, plus each hand-written
kernel's formula, which its wrapper adds under ``kernels.ops.
count_flops()`` (a kernel launched through ctypes is opaque to the
dispatcher; on the CPU the wrapper hides its plain version's products so
they count once).  So a stage counts the same on the CPU and on the card.
Element-wise work is ignored on both sides of the ratio.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.report import Finding
from repro_torch.analysis.rules import RULES
from repro_torch.kernels import ops as kops

# measured/analytic per-token decode FLOPs must stay inside this band.
# The analytic graph prices a full-context forward (attention over the
# whole arena, no early exit, no paging overhead); the stages add exit
# probes (the monolithic step's full exit logits) and the LM head and run
# attention over the fixed arena, so the honest ratio sits near 1 but not
# at it: 1.195 (segmented) and 1.390 (monolithic) on the audit stack at
# max_len 32.  Widen ONLY with a written justification here.
TOLERANCE: Tuple[float, float] = (0.5, 2.0)

# the aten products counted (the reference's dot_general)
MATMUL_OPS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")


def stage_flops(spec: Any) -> Dict[str, float]:
    """Matmul FLOPs of one call of a registered stage on its example
    inputs: ``{"aten": ..., "kernels": ..., "total": ...}``."""
    args = spec.make_args()
    with torch.no_grad(), kops.count_flops() as kernels, \
            FlopCounterMode(display=False) as fc:
        spec.fn(*args)
    counts = fc.get_flop_counts().get("Global", {})
    aten = float(sum(v for op, v in counts.items()
                     if str(op) in MATMUL_OPS))
    k = float(sum(kernels.values()))
    return {"aten": aten, "kernels": k, "total": aten + k}


# ---------------------------------------------------------------------------
# decode-path reduction
# ---------------------------------------------------------------------------
def decode_flops_per_token(registry: Dict[str, Any]
                           ) -> Dict[str, Dict[str, float]]:
    """Per-arena decode-path cost of one registry.

    Stage names may carry a ``model/`` prefix (multipool flattening); each
    prefix is one arena.  An arena's decode path is either the monolithic
    ``decode`` stage or every ``segment*`` stage plus ``finalize`` (a
    full-depth step: what threshold-0 serving dispatches; the probes are
    not on it).  Returns ``arena -> {"flops_per_token",
    "kernel_flops_per_token"}``."""
    arenas: Dict[str, Dict[str, str]] = {}
    for name in registry:
        arena, _, stage = name.rpartition("/")
        arenas.setdefault(arena, {})[stage] = name
    out: Dict[str, Dict[str, float]] = {}
    for arena, stages in sorted(arenas.items()):
        if "decode" in stages:
            names = [stages["decode"]]
        elif any(s.startswith("segment") for s in stages):
            names = [stages[s] for s in sorted(stages)
                     if s.startswith("segment")]
            if "finalize" in stages:
                names.append(stages["finalize"])
        else:
            continue
        batch = registry[names[0]].batch
        counts = [stage_flops(registry[n]) for n in names]
        out[arena] = {
            "flops_per_token": sum(c["total"] for c in counts) / batch,
            "kernel_flops_per_token": sum(c["kernels"] for c in counts)
            / batch}
    return out


def flatten_registries(stack: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``prefix -> flat stage registry`` over an audit stack (name ->
    object with ``audit_stages()``; names starting with ``_`` skipped)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, obj in stack.items():
        if name.startswith("_"):
            continue
        stages = obj.audit_stages()
        if stages and all(isinstance(v, dict) for v in stages.values()):
            for sub, reg in stages.items():      # cluster: tier -> registry
                out[f"{name}/{sub}"] = reg
        else:
            out[name] = stages
    return out


def check_cost_graphs(stack: Dict[str, Any]
                      ) -> Tuple[List[Finding], Dict[str, Dict[str, float]]]:
    """Cross-check every arena's decode cost in the audit stack against
    the analytic per-token cost the router prices with, for the model
    under ``stack["_model"]``.  Returns ``(findings, ratios)``, ratios
    mapping ``"<registry>[/<arena>]"`` to measured/analytic/ratio."""
    from repro_torch.core import paradigms

    lo, hi = TOLERANCE
    model = stack["_model"]
    findings: List[Finding] = []
    ratios: Dict[str, Dict[str, float]] = {}
    max_lens = {name: obj.cfg.max_len for name, obj in stack.items()
                if not name.startswith("_")}
    for prefix, registry in sorted(flatten_registries(stack).items()):
        max_len = max_lens[prefix.split("/", 1)[0]]
        analytic = paradigms.analytic_step_cost(
            model.cfg, 1, max_len).flops_per_token
        for arena, m in decode_flops_per_token(registry).items():
            key = f"{prefix}/{arena}" if arena else prefix
            ratio = m["flops_per_token"] / analytic if analytic else math.inf
            ratios[key] = {"measured_flops_per_token": m["flops_per_token"],
                           "kernel_flops_per_token":
                               m["kernel_flops_per_token"],
                           "analytic_flops_per_token": analytic,
                           "ratio": ratio}
            if not (lo <= ratio <= hi):
                r = RULES["CST001"]
                findings.append(Finding(
                    rule="CST001", path=f"<cost:{key}>", line=0, col=0,
                    severity=r.severity,
                    message=(f"decode path of '{key}' runs "
                             f"{m['flops_per_token']:.3e} FLOPs/token but "
                             f"the router prices {analytic:.3e} "
                             f"(ratio {ratio:.2f}, tolerance "
                             f"[{lo}, {hi}]): the analytic cost graph is "
                             "no longer honest"),
                    snippet=f"{key}:cost-drift"))
    return findings, ratios


def build_audit_stack(device="cuda") -> Dict[str, Any]:
    """The reference's audit stack on the port, granite-3-2b-smoke:

    * a ``TieredServingCluster`` (the default scenario's device, edge and
      cloud tiers) over a draft/target ``ModelGroup`` with the
      speculative bridge forced into existence: the tier arenas, the
      multipool flattening and both bridge arenas;
    * a standalone paged + prefix-cache ``ContinuousBatchScheduler``,
      2 slots, ``max_len`` 32: the paged stage variants.

    The models live on ``device``: the card unless the caller asks for
    the CPU (``Model`` raises where there is no card).  Returns ``name ->
    object exposing audit_stages()`` plus the model under ``"_model"``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (ClusterConfig, ContinuousBatchScheduler,
                                     ModelGroup, SchedulerConfig,
                                     TieredServingCluster)

    cfg = get_config("granite-3-2b-smoke")
    model = Model(cfg, device=device)
    params = model.init(0)
    cluster = TieredServingCluster(
        ModelGroup([("draft", model, params), ("target", model, params)]),
        plan_cfg={"draft": get_config("granite-3-2b"),
                  "target": get_config("deepseek-v3-671b")},
        cfg=ClusterConfig(base_slots=2, max_len=32, prefill_chunk=8,
                          spec_draft="draft", spec_k=4))
    cluster._spec_pair("target")       # force the lazy spec bridge to build
    paged = ContinuousBatchScheduler(
        model, params,
        SchedulerConfig(n_slots=2, max_len=32, prefill_chunk=8,
                        paged=True, page_size=16, prefix_cache=True),
        device=device)
    return {"cluster": cluster, "paged": paged, "_model": model}
