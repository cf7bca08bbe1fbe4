"""Serving engine: batched decode with early-exit accounting.

``make_serve_step(model, long_mode=)`` is the decode-shape step function: (params,
cache, tokens [B, 1], position [] or [B]) -> (logits [B, V], exit
entropies [n_exits, B], cache).

``ServingEngine`` is the batch front-end over the continuous-batching
scheduler (``serving/scheduler.py``): chunked batched prefill, greedy or
temperature sampling, and SPINN-style exit statistics (the fraction of
tokens that exited at each head under the entropy threshold, the number
the edge-device paradigm planner consumes).  ``enable_adaptive`` steers
that threshold online (``serving/adaptive.py``).

Given a ``scenario`` (and optionally a full-size ``plan_cfg``), the engine
instead submits every row through a ``TieredServingCluster``: the
admission router spreads the batch over cloud/edge/device pools and
``engine.route_counts`` reports where rows landed.  Split-routed rows
really execute in two arenas (prefill-tier pool -> exported slot snapshot
-> decode-tier pool); the engine pins the handoff to the raw encoding so
outputs stay identical either way: tiers differ in virtual cost, not in
arithmetic.

Constructed with a ``ModelGroup`` instead of one model, the engine serves
heterogeneous models through one multiplexed pool:
``generate_multi({name: prompts})`` decodes every model's batch in the
same poll loop (or routes per (model, row) across the tiered cluster when
a scenario is set), with per-model exit counters and outputs bit-identical
to dedicated single-model engines.

An encoder-decoder model (whisper) takes ``frames=`` [B, Tenc, D], one
row a request; ``prime_whisper_cross_cache`` fills a decode cache's
cross-attention rows from them.

The port of the reference's ``serving/engine.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.early_exit import exit_stats_dict
from repro_torch.models.attention import _proj
from repro_torch.serving.adaptive import AdaptiveExitController
from repro_torch.serving.cluster import ClusterConfig, TieredServingCluster
from repro_torch.serving.multipool import ModelGroup, MultiModelScheduler
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig)


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0          # 0 = greedy
    exit_threshold: float = 0.5
    long_mode: bool = False           # ring caches at long_context_window
    # cross-tier speculative decoding (ModelGroup engines with a scenario):
    # spec_draft names the group entry drafting on the device tier while
    # the routed model verifies on the cloud tier; empty disables
    spec_draft: str = ""
    spec_k: int = 4
    # decode windows (scheduler ``async_decode``): monolithic steps,
    # ``readback_interval`` of them a token readback; greedy outputs stay
    # bit-identical to the synchronous path
    async_decode: bool = False
    readback_interval: int = 8


def make_serve_step(model, *, long_mode: bool = False):
    """The decode-shape step function (what the dry run prices);
    ``long_mode`` decodes over the ring caches of ``long_context_window``,
    as the reference's long_500k step does."""

    def serve_step(params, cache, tokens, position):
        return model.decode_step(params, cache, tokens, position,
                                 long_mode=long_mode)

    return serve_step


def prime_whisper_cross_cache(model, params, cache, frames):
    """Fill every decoder layer's cross-attention k/v from the encoder
    output of ``frames`` [B, Tenc, D], in place: ``cache["blocks"][bi]``
    of a decx block holds {"cross": (k, v), "self": (k, v)} stacked over
    its layers [n, B, Tenc, Nkv, H].  Returns ``cache``."""
    enc_out = model.encode(params, frames)
    for kind, blk, bp in zip(model.scan_block_kinds(), cache["blocks"],
                             params["blocks"]):
        if kind != "decx":
            continue
        ck, cv = blk["cross"]
        wk, wv = bp["cross_attn"]["wk"], bp["cross_attn"]["wv"]
        for i in range(ck.shape[0]):
            ck[i].copy_(_proj(enc_out, wk[i]).to(torch.bfloat16))
            cv[i].copy_(_proj(enc_out, wv[i]).to(torch.bfloat16))
    return cache


def _host(a) -> np.ndarray:
    """A prompt batch (numpy or a torch tensor) as a host array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _stack(reqs) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(r.out_tokens, np.int32)
                                      for r in reqs]))


class ServingEngine:
    """Batch-generation front-end over the continuous-batching scheduler.

    ``generate`` submits each prompt row as a request to a
    ``ContinuousBatchScheduler`` sized to the batch: the prompt runs
    through the scheduler's chunked prefill, decode runs as fixed-shape
    pool steps, and exit statistics accumulate in device counters that
    the scheduler flushes periodically.  Optional adaptive threshold
    control (survey §7.3) is driven from those flushed counters.
    """

    # schedulers cached per pool shape; the oldest beyond this many is
    # evicted so a long-lived engine serving many shapes does not pin
    # device caches
    _MAX_CACHED_SCHEDS = 4

    def __init__(self, model, params=None, scfg: ServeConfig = None,
                 scenario=None, plan_cfg=None):
        if isinstance(model, ModelGroup):
            self.group: Optional[ModelGroup] = model
            self.model = model[model.default].model
            self.params = model[model.default].params
            self.exit_counts_by_model = {
                e.name: np.zeros(e.model.n_exits + 1, np.int64)
                for e in model}
            self.tokens_served_by_model = {e.name: 0 for e in model}
        else:
            self.group = None
            self.model = model
            self.params = params
            self.exit_counts_by_model = {}
            self.tokens_served_by_model = {}
        self.scfg = ServeConfig() if scfg is None else scfg
        self.scenario = scenario           # set -> route through tier pools
        self.plan_cfg = plan_cfg           # config or {name: config} (group)
        self.exit_counts = np.zeros(self.model.n_exits + 1, np.int64)
        self.tokens_served = 0
        self.depth_weighted_tokens = 0.0   # measured truncated depth x tokens
        self.controller: Optional[AdaptiveExitController] = None
        self._adaptive_every = 64
        self._scheds: Dict[Tuple, Any] = {}
        self._cluster: Optional[TieredServingCluster] = None
        self.route_counts: Dict[str, int] = {}

    def enable_adaptive(self, target_depth_fraction: float,
                        update_every: int = 64):
        """Steer the exit threshold so E[depth] / full <= target."""
        self.controller = AdaptiveExitController(
            target_depth_fraction, self.scfg.exit_threshold)
        self._adaptive_every = update_every

    def _cached(self, key, make):
        """The scheduler cached under ``key`` (an LRU of pool shapes)."""
        if key in self._scheds:
            self._scheds[key] = self._scheds.pop(key)   # refresh on a hit
        else:
            while len(self._scheds) >= self._MAX_CACHED_SCHEDS:
                self._scheds.pop(next(iter(self._scheds)))
            self._scheds[key] = make()
        return self._scheds[key]

    def _scheduler(self, n_slots: int, max_len: int):
        """Schedulers are cached by pool shape, so repeated generate()
        calls with the same (batch, seq) reuse their arena and buffers."""
        s = self.scfg
        sched = self._cached((n_slots, max_len), lambda: (
            ContinuousBatchScheduler(
                self.model, self.params,
                SchedulerConfig(n_slots=n_slots, max_len=max_len,
                                exit_threshold=s.exit_threshold,
                                temperature=s.temperature,
                                long_mode=s.long_mode,
                                segmented=not s.async_decode,
                                async_decode=s.async_decode,
                                readback_interval=s.readback_interval),
                device=self.model.device)))
        sched.params = self.params     # pick up any engine params update
        return sched

    def generate(self, prompt_tokens, *, max_new: int = 32, frames=None,
                 rng=None, deadline=None):
        """prompt_tokens [B, S0] -> generated [B, max_new] int32 (a CPU
        tensor).  ``frames`` [B, Tenc, D] are an encdec model's encoder
        inputs (required there).  ``rng`` (a ``torch.Generator``) samples
        when the temperature is above 0.

        With a ``scenario`` configured, rows are routed per request across
        the cloud/edge/device pools (``deadline`` feeds the router);
        otherwise one local pool serves the whole batch."""
        if self.group is not None:
            raise ValueError("multi-model engine: use generate_multi("
                             "{model: prompts}, ...)")
        toks = _host(prompt_tokens)
        b, s0 = toks.shape
        if self.model.cfg.family == "encdec" and frames is None:
            raise ValueError("whisper needs encoder frames")
        if self.scenario is not None:
            return self._generate_tiered(toks, max_new, frames, rng,
                                         deadline)
        sched = self._scheduler(b, s0 + max_new)
        sched.controller = self.controller
        sched.adaptive_every = self._adaptive_every
        before = self._snapshot_pools({0: sched})
        reqs = [Request(tokens=toks[i], max_new=max_new,
                        frames=None if frames is None else frames[i])
                for i in range(b)]
        for r in reqs:
            sched.submit(r)
        sched.run(rng=rng)
        self._absorb_pool_deltas({0: sched}, before)
        sched.completed.clear()        # requests are returned, not retained
        return _stack(reqs)

    # --- shared tiered/multi bookkeeping -------------------------------
    @staticmethod
    def _snapshot_pools(pools: Dict[Any, Any]) -> Dict[Any, Tuple]:
        """Per-pool (exit counters, tokens served, depth) before a batch."""
        return {k: (p.flush_counters().copy(), p.tokens_served,
                    p.depth_weighted_tokens) for k, p in pools.items()}

    def _absorb_pool_deltas(self, pools, before, model_of=None):
        """Fold each pool's exit/token/depth deltas into the engine's
        accumulators.  ``model_of(key)`` selects the per-model sinks (group
        engines); None targets the single-model aggregate counters."""
        for k, p in pools.items():
            counts0, tokens0, depth0 = before[k]
            delta = p.flush_counters() - counts0
            if model_of is None:
                self.exit_counts += delta
            else:
                m = model_of(k)
                self.exit_counts_by_model[m] += delta
                self.tokens_served_by_model[m] += p.tokens_served - tokens0
            self.tokens_served += p.tokens_served - tokens0
            self.depth_weighted_tokens += p.depth_weighted_tokens - depth0

    def _ensure_cluster(self, need: int) -> TieredServingCluster:
        """Lazily (re)build the tiered cluster once the needed context
        outgrows it, with the same growth rule for single-model and group
        engines.

        The engine pins ``kv_handoff="raw"``: a split-routed row really
        prefills in one tier's arena and decodes in another's (migrated
        through export/import), and the raw payload keeps the engine's
        contract that tiered outputs are bit-identical to the single-pool
        path."""
        s = self.scfg
        if self._cluster is None or self._cluster.cfg.max_len < need:
            max_len = max(s.max_len, 1 << (need - 1).bit_length())
            target = self.group if self.group is not None else self.model
            self._cluster = TieredServingCluster(
                target, None if self.group is not None else self.params,
                scenario=self.scenario, plan_cfg=self.plan_cfg,
                cfg=ClusterConfig(max_len=max_len,
                                  exit_threshold=s.exit_threshold,
                                  temperature=s.temperature,
                                  long_mode=s.long_mode,
                                  kv_handoff="raw",
                                  spec_draft=s.spec_draft, spec_k=s.spec_k,
                                  async_decode=s.async_decode,
                                  readback_interval=s.readback_interval))
        return self._cluster

    def _finish_cluster_batch(self, cl, routes_before):
        """This batch's placement (per-call delta, stable across cluster
        rebuilds); requests are returned, not retained by the cluster."""
        self.route_counts = {t: c - routes_before.get(t, 0)
                             for t, c in cl.router.route_counts.items()}
        cl.clear_completed()

    def _generate_tiered(self, toks, max_new, frames, rng, deadline):
        """Batch generation through the tiered cluster: one routed request
        per row, exit counters aggregated over all tier pools."""
        b, s0 = toks.shape
        cl = self._ensure_cluster(s0 + max_new)
        pools = {n: tr.sched for n, tr in cl.tiers.items()}
        before = self._snapshot_pools(pools)
        routes_before = dict(cl.router.route_counts)
        for tr in cl.tiers.values():
            tr.sched.params = self.params
            tr.sched.set_rng(rng)
            tr.sched.controller = self.controller
            tr.sched.adaptive_every = self._adaptive_every
        now = cl.virtual_now()
        crs = [cl.submit(toks[i], max_new=max_new, deadline=deadline,
                         arrival=now,
                         frames=None if frames is None else frames[i])
               for i in range(b)]
        cl.run()
        self._absorb_pool_deltas(pools, before)
        self._finish_cluster_batch(cl, routes_before)
        return _stack([cr.req for cr in crs])

    # ------------------------------------------------------------------
    # multi-model entry points (ModelGroup engines)
    # ------------------------------------------------------------------
    def generate_multi(self, prompts_by_model: Dict[str, Any], *,
                       max_new: int = 32, rng=None, deadline=None
                       ) -> Dict[str, torch.Tensor]:
        """``{model_name: prompts [B, S0]}`` -> ``{model_name: [B,
        max_new]}``.

        Every model's requests share ONE multiplexed pool (or, with a
        ``scenario``, one multi-model tiered cluster): heterogeneous
        models decode in the same poll loop instead of serving model by
        model.  Per-model outputs are bit-identical to a dedicated
        single-model engine fed the same prompts."""
        if self.group is None:
            raise ValueError("generate_multi needs a ModelGroup engine")
        batches = {m: _host(p) for m, p in prompts_by_model.items()}
        for m in batches:
            if m not in self.group:
                raise ValueError(f"unknown model {m!r}")
        if self.scenario is not None:
            return self._generate_multi_tiered(batches, max_new, rng,
                                               deadline)
        need = max(p.shape[1] for p in batches.values()) + max_new
        slots = {m: p.shape[0] for m, p in batches.items()}
        s = self.scfg
        sched = self._cached(
            ("multi", need, tuple(sorted(slots.items()))),
            lambda: MultiModelScheduler(
                self.group,
                SchedulerConfig(n_slots=max(slots.values()), max_len=need,
                                exit_threshold=s.exit_threshold,
                                temperature=s.temperature,
                                long_mode=s.long_mode),
                slots_per_model=slots))
        before = self._snapshot_pools(sched.pools)
        reqs = {m: [Request(tokens=p[i], max_new=max_new, model=m)
                    for i in range(p.shape[0])]
                for m, p in batches.items()}
        for rs in reqs.values():
            for r in rs:
                sched.submit(r)
        sched.run(rng=rng)
        self._absorb_pool_deltas(sched.pools, before, model_of=lambda m: m)
        for pool in sched.pools.values():
            pool.completed.clear()
        sched.completed.clear()
        return {m: _stack(rs) for m, rs in reqs.items()}

    @staticmethod
    def _cluster_pools(cl) -> Dict[Any, Any]:
        """Every per-model pool the cluster can serve from: the tier pools
        plus any speculative SpecPair arenas (keyed apart: a pair's target
        pool counts tokens the tier pools never saw)."""
        pools = {(n, m): pool for n, tr in cl.tiers.items()
                 for m, pool in tr.sched.pools.items()}
        for sm, pair in cl._spec_pairs.items():
            for pm, pool in pair.pools.items():
                pools[("spec:" + sm, pm)] = pool
        return pools

    def _generate_multi_tiered(self, batches, max_new, rng, deadline):
        """Multi-model batches through one tiered cluster: per-(model, row)
        routing over per-model cost graphs."""
        need = max(p.shape[1] for p in batches.values()) + max_new
        cl = self._ensure_cluster(need)
        pools = self._cluster_pools(cl)
        before = self._snapshot_pools(pools)
        routes_before = dict(cl.router.route_counts)
        for tr in cl.tiers.values():
            tr.sched.set_rng(rng)
        now = cl.virtual_now()
        crs = {m: [cl.submit(p[i], max_new=max_new, deadline=deadline,
                             arrival=now, model=m)
                   for i in range(p.shape[0])]
               for m, p in batches.items()}
        cl.run()
        # spec pairs built lazily during the run start from zero counters
        pools = self._cluster_pools(cl)
        for k, p in pools.items():
            if k not in before:
                before[k] = (np.zeros_like(p.flush_counters()), 0, 0.0)
        self._absorb_pool_deltas(pools, before, model_of=lambda k: k[1])
        self._finish_cluster_batch(cl, routes_before)
        return {m: _stack([cr.req for cr in rs]) for m, rs in crs.items()}

    def measured_depth_fraction(self) -> float:
        """Layer-weighted fraction of the stack dispatched per served
        token, over every pool this engine drove (1.0 = full depth)."""
        if not self.tokens_served:
            return 1.0
        return self.depth_weighted_tokens / self.tokens_served

    def exit_stats(self) -> Dict[str, Any]:
        """Exit-fraction statistics.  Single-model engines return one flat
        dict; ``ModelGroup`` engines return ``{model_name: stats}`` (the
        counters are per model by construction)."""
        if self.group is not None:
            out: Dict[str, Any] = {
                m: exit_stats_dict(counts, self.tokens_served_by_model[m])
                for m, counts in self.exit_counts_by_model.items()}
            out["measured_depth"] = self.measured_depth_fraction()
            return out
        st = exit_stats_dict(self.exit_counts, self.tokens_served)
        st["measured_depth"] = self.measured_depth_fraction()
        return st
