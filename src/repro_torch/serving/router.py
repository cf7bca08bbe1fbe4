"""Admission router: per-request tier selection from the paradigm planners
(a copy of the reference package's ``serving/router.py``).

The survey's paradigms (§2.3) are offline plans; serving needs them *at
admission time*, per request.  ``AdmissionRouter`` closes that gap: given a
request's prompt length, decode budget, and deadline, plus the current
queueing pressure at each tier's slot pool, it calls
``core.paradigms.admission_decision`` — Neurosurgeon's cloud-device split,
Edgent's deadline-driven edge plan, DDNN's 3-tier placement, device-local
execution, and prefill/decode disaggregation splits all compete on the
scenario's measured cost profiles — and returns the winning
``AdmissionDecision``.

Multi-model serving routes per **(model, request)**: construct the router
with a ``{model_name: plan_cfg}`` dict and pass ``model=`` to ``route`` —
each model gets its own cost graphs (and KV footprint), so a heavy model's
request lands on the cloud pool while a light model's stays on device
within the same trace.  A single plan config keeps the old single-model
behaviour.

Cost graphs are cached per (model, prompt-length bucket) so routing is
O(planner) only on the first request of each bucket; every later request in
the bucket is a dictionary lookup plus a handful of float comparisons.
Nothing here touches a tensor: routing is host arithmetic only.

The ``decisions`` log is a bounded deque (``decision_log`` entries): a
long-lived router on a cluster reused across many batches must not grow
without bound, and ``TieredServingCluster.clear_completed()`` additionally
empties it.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Tuple, Union

from repro_torch.core.cost_model import (CostGraph, build_cost_graph,
                                   kv_cache_bytes_per_token)
from repro_torch.core.paradigms import (TIERS, AdmissionDecision, Scenario,
                                  admission_decision)


class AdmissionRouter:
    """Route one request to a serving tier (or a prefill/decode split).

    ``plan_cfg`` is the model config the cost graphs are built from — for a
    smoke-model runtime this is typically the *full-size* variant, so tier
    economics reflect the real model while execution stays cheap (the same
    planner/runtime split the rest of the repo uses).  Pass a
    ``{name: config}`` dict to plan per model for a multi-model pool.
    """

    def __init__(self, plan_cfg: Union[object, Dict[str, object]],
                 scenario: Optional[Scenario] = None, *,
                 bucket: int = 16, allow_split: bool = True,
                 decision_log: int = 256,
                 stream_tokens: bool = False, spec_k: int = 0,
                 spec_draft: str = "", spec_draft_frac: float = 0.1):
        if isinstance(plan_cfg, dict):
            assert plan_cfg, "empty plan_cfg dict"
            self.plan_cfgs: Dict[str, object] = dict(plan_cfg)
        else:
            self.plan_cfgs = {"": plan_cfg}
        self._default_model = next(iter(self.plan_cfgs))
        # single-model compatibility attribute (the default entry's config)
        self.plan_cfg = self.plan_cfgs[self._default_model]
        self.scenario = scenario or Scenario.default()
        self.bucket = max(1, bucket)
        self.allow_split = allow_split
        # speculative cross-tier candidate: opt-in interactive-token
        # pricing + device-draft/cloud-verify.  spec_accept is refreshed by
        # the cluster from MEASURED acceptance lengths, so routing tracks
        # how agreeable the live draft/target pair actually is.  When
        # spec_draft names a planned model, the draft's per-token compute
        # is priced from ITS OWN cost graph instead of the flat
        # spec_draft_frac fallback.
        self.stream_tokens = stream_tokens
        self.spec_k = spec_k
        self.spec_draft = spec_draft
        self.spec_draft_frac = spec_draft_frac
        self.spec_accept = 0.0
        self._kv_tok = {n: kv_cache_bytes_per_token(c)
                        for n, c in self.plan_cfgs.items()}
        self._graphs: Dict[Tuple[str, int], CostGraph] = {}
        self.route_counts: Dict[str, int] = {t: 0 for t in TIERS}
        self.route_counts_by_model: Dict[str, Dict[str, int]] = {
            n: {t: 0 for t in TIERS} for n in self.plan_cfgs}
        self.split_count = 0
        # bounded: a long-lived cluster reuses its router across batches
        self.decisions: Deque[AdmissionDecision] = deque(maxlen=decision_log)

    def _resolve(self, model: Optional[str]) -> str:
        if not model:
            return self._default_model
        assert model in self.plan_cfgs, \
            f"unknown model {model!r} (router plans {list(self.plan_cfgs)})"
        return model

    def _graph(self, model: str, total_tokens: int) -> CostGraph:
        b = -(-max(1, total_tokens) // self.bucket) * self.bucket
        if (model, b) not in self._graphs:
            self._graphs[(model, b)] = build_cost_graph(
                self.plan_cfgs[model], 1, b)
        return self._graphs[(model, b)]

    def route(self, prompt_len: int, max_new: int, *,
              deadline: Optional[float] = None,
              queue_cost: Optional[Dict[str, float]] = None,
              model: Optional[str] = None,
              exclude=None) -> AdmissionDecision:
        """``exclude`` names tiers no candidate may touch (prefill or decode
        side) — the cluster passes its dead-tier set after an outage."""
        model = self._resolve(model)
        graph = self._graph(model, prompt_len + max_new)
        frac = self.spec_draft_frac
        if (self.spec_k >= 2 and self.spec_draft
                and self.spec_draft != model
                and self.spec_draft in self.plan_cfgs):
            gd = self._graph(self.spec_draft, prompt_len + max_new)
            frac = min(1.0, gd.total_flops / graph.total_flops)
        d = admission_decision(
            graph, self.scenario,
            deadline=deadline, queue_cost=queue_cost,
            prefill_tokens=prompt_len, decode_tokens=max_new,
            kv_bytes_per_token=self._kv_tok[model],
            allow_split=self.allow_split,
            exclude=frozenset(exclude) if exclude else None,
            stream_tokens=self.stream_tokens, spec_k=self.spec_k,
            spec_accept=self.spec_accept,
            spec_draft_frac=frac)
        self.route_counts[d.tier] += 1
        self.route_counts_by_model[model][d.tier] += 1
        self.split_count += int(d.is_split)
        self.decisions.append(d)
        return d
