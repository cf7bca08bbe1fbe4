"""Serving through the port: one batch through ``ServingEngine``, or
open-loop Poisson serving through one continuous-batching pool or the
tiered cloud/edge/device cluster.

    python -m repro_torch.launch.serve --arch granite-3-2b-smoke \\
        --device cpu --batch 4 --prompt-len 16 --max-new 32
    python -m repro_torch.launch.serve --mode poisson --arch granite-3-2b \\
        --paged --requests 32 --slots 16 --prompt-len 256 --max-new 32
    python -m repro_torch.launch.serve --mode poisson \\
        --arch granite-3-2b-smoke --device cpu --tiered \\
        --scenario tier-outage --requests 8 --slots 2 --prompt-len 12 \\
        --max-new 8
    python -m repro_torch.launch.serve --mode poisson --arch granite-3-2b \\
        --paged --async-decode --readback-interval 8 --requests 32 \\
        --slots 16
    python -m repro_torch.launch.serve --mode poisson --device cpu --paged \\
        --models granite-3-2b-smoke,yi-6b-smoke --requests 8 --slots 2
    python -m repro_torch.launch.serve --mode poisson --device cpu --tiered \\
        --scenario high-rtt-access --models granite-3-2b-smoke,yi-6b-smoke \\
        --spec-draft granite-3-2b-smoke --spec-k 4 --threshold 0 \\
        --requests 4 --prompt-len 12 --max-new 8

An encoder-decoder arch (``whisper-base``, ``whisper-base-smoke``) gets
each request's encoder frames drawn from the same seeded generator, ``0.02
N(0, 1)`` of shape [encoder_seq_len, d_model] (the stub front end the
reference feeds); it serves on contiguous arenas only (no ``--paged``).
``qwen2-vl-2b`` serves text through M-RoPE, whose decode positions are
plain RoPE's.

``--long`` serves with ring-buffer KV caches at the model's
``long_context_window`` (contiguous arenas only); ``--prefill-chunk`` is
the prompt tokens a prefill round replays (Poisson modes).

``--mode batch`` (the default) generates ``--max-new`` tokens for
``--batch`` prompts of ``--prompt-len`` tokens (seeded) through
``ServingEngine`` and prints tok/s (host clock) and the exit statistics.

``--mode poisson``: requests arrive at Poisson times (seeded), prompts are uniform in
``[prompt_len // 4, prompt_len]`` tokens.  Single pool: ``prefix_share``
of them begin with one common ``prefix_len``-token prefix (so the paged
arena's prefix cache can hit); reports p50/p95 request latency and
sustained tok/s on the host clock, around work that ends with the
per-step token readback, and p50/p95 time to first token (arrival to the
first token appended, ``Request.t_first``).  ``--async-decode`` decodes
in windows of ``--readback-interval`` monolithic steps (a CUDA graph on
the card) with one token readback a window.  Tiered (``--tiered``): the
admission router places each request on a tier pool; latencies are on
the tiers' virtual clocks (modelled by the planners' tier profiles, not
measured), and the wall time of the whole run is on the host clock.

``--models a,b,...`` serves requests for several architectures, assigned
round-robin, through one ``MultiModelScheduler`` (one arena per model
behind one queue and one poll); with ``--tiered`` they are routed per
(model, request) across the cloud/edge/device pools, each model planned as
its arch without ``-smoke``.  ``--spec-draft`` (with ``--tiered``) names
the entry that drafts ``--spec-k`` tokens a round on the device tier while
the cloud verifies: requests the router sends speculative run through a
``SpecPair`` bridge.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, resolve_config
from repro_torch.core import Scenario
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterConfig, TieredServingCluster
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.multipool import ModelGroup, MultiModelScheduler
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig)
from repro_torch.serving.traces import poisson_trace

SCENARIOS = {"default": Scenario.default,
             "degraded-wan": Scenario.degraded_wan,
             "neurosurgeon-era": Scenario.neurosurgeon_era,
             "high-rtt-access": Scenario.high_rtt_access,
             "tier-outage": Scenario.tier_outage}


def draw_frames(rs, cfg, *lead):
    """An encdec request's encoder frames, ``0.02 N(0, 1)`` fp32 [*lead,
    Tenc, D] from the seeded ``rs`` (None for other families)."""
    if cfg.family != "encdec":
        return None
    return 0.02 * rs.randn(*lead, cfg.encdec.encoder_seq_len,
                           cfg.d_model).astype(np.float32)


def _drive_open_loop(sched, reqs, arrivals):
    """Submit each request at its arrival offset and poll until every
    request completes.  Returns (t0, makespan_seconds, polls)."""
    t0 = time.time()
    i = polls = 0
    while len(sched.completed) < len(reqs):
        now = time.time() - t0
        while i < len(reqs) and arrivals[i] <= now:
            sched.submit(reqs[i])
            i += 1
        if sched.has_work:
            sched.tick()
            polls += 1
        elif i < len(reqs):
            time.sleep(min(0.002, max(0.0, arrivals[i] - now)))
    return t0, time.time() - t0, polls


def _pctl(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) \
        else float("nan")


def serve(arch, batch: int, prompt_len: int, max_new: int, *,
          threshold: float = 0.5, long_mode: bool = False,
          async_decode: bool = False, readback_interval: int = 8,
          seed: int = 0, params=None, device="cuda", quiet: bool = False):
    """One closed batch through ``ServingEngine`` (the quickstart path):
    ``batch`` prompts of ``prompt_len`` tokens drawn from a seeded numpy
    ``RandomState`` (then, for an encdec arch, the batch's frames),
    ``max_new`` tokens each.  Returns (tokens [batch, max_new] int32, the
    engine's exit statistics)."""
    cfg = resolve_config(arch)
    model = Model(cfg, device=device)
    if params is None:
        params = model.init(seed)
    eng = ServingEngine(model, params,
                        ServeConfig(exit_threshold=threshold,
                                    long_mode=long_mode,
                                    async_decode=async_decode,
                                    readback_interval=readback_interval))
    rs = np.random.RandomState(seed)
    prompts = rs.randint(0, cfg.vocab_size,
                         (batch, prompt_len)).astype(np.int32)
    frames = draw_frames(rs, cfg, batch)
    t0 = time.time()
    out = eng.generate(prompts, max_new=max_new, frames=frames)
    dt = time.time() - t0
    stats = eng.exit_stats()
    if not quiet:
        print(f"arch={cfg.name} generated {tuple(out.shape)} in {dt:.2f}s "
              f"({batch * max_new / dt:.1f} tok/s) device={model.device}")
        print("exit stats:", {k: round(v, 3) for k, v in stats.items()})
    return out, stats


def serve_poisson(arch, *, rate: float = 4.0, n_requests: int = 32,
                  slots: int = 8, prompt_len: int = 16, max_new: int = 32,
                  threshold: float = 0.5, prefill_chunk: int = 16,
                  long_mode: bool = False, paged: bool = False,
                  page_size: int = 16,
                  segmented: bool = True, prefix_share: float = 0.0,
                  prefix_len: int = 0, async_decode: bool = False,
                  readback_interval: int = 8, seed: int = 0, params=None,
                  device="cuda", quiet: bool = False):
    """Serve a seeded Poisson trace; returns a stats dict (latency and
    time-to-first-token percentiles, sustained tok/s, the polls' split of
    host work, readback wait and counter-flush wait, the counter flushes,
    the prompt tokens prefill replayed, the slots whose recurrent state
    rows admission zeroed, the decode windows' device time,
    exit statistics,
    prefix-cache hits, decode-window builds).  ``arch`` is an arch name or
    a ``ModelConfig``.  ``params`` default to ``Model(arch).init(seed)``
    on ``device``.  ``async_decode`` runs the window pipeline (and the
    monolithic step: ``segmented`` is then ignored)."""
    cfg = resolve_config(arch)
    model = Model(cfg, device=device)
    if params is None:
        params = model.init(seed)
    max_len = prompt_len + max_new
    if paged:                          # page-pool arenas need whole pages
        max_len += (-max_len) % page_size
    sched = ContinuousBatchScheduler(
        model, params,
        SchedulerConfig(n_slots=slots, max_len=max_len,
                        prefill_chunk=min(prefill_chunk, max(1, prompt_len)),
                        exit_threshold=threshold, long_mode=long_mode,
                        paged=paged, page_size=page_size,
                        segmented=segmented and not async_decode,
                        async_decode=async_decode,
                        readback_interval=readback_interval),
        device=device)

    rs = np.random.RandomState(seed)
    arrivals, lengths = poisson_trace(rs, rate, n_requests, prompt_len)
    prefix = rs.randint(0, cfg.vocab_size, prefix_len)
    shared = set(rs.choice(n_requests, int(round(prefix_share * n_requests)),
                           replace=False).tolist())
    reqs = []
    for j, n in enumerate(lengths):
        toks = rs.randint(0, cfg.vocab_size, int(n))
        if j in shared:
            k = min(int(n), prefix_len)
            toks[:k] = prefix[:k]
        reqs.append(Request(tokens=toks, max_new=max_new))
    for r in reqs:
        r.frames = draw_frames(rs, cfg)

    # warm up outside the timed trace (one admission + one step)
    sched.submit(Request(tokens=rs.randint(0, cfg.vocab_size,
                                           int(lengths[0])), max_new=1,
                         frames=reqs[0].frames))
    sched.run()
    sched.reset_stats()
    steps0 = sched._step_idx

    t0, makespan, _ = _drive_open_loop(sched, reqs, arrivals)
    lat = np.asarray([r.t_done - (t0 + arrivals[j])
                      for j, r in enumerate(reqs)])
    ttft = np.asarray([r.t_first - (t0 + arrivals[j])
                       for j, r in enumerate(reqs)])
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    stats = {
        "requests": n_requests,
        "slots": slots,
        "rate_req_s": rate,
        "makespan_s": makespan,
        "p50_latency_s": float(np.percentile(lat, 50)),
        "p95_latency_s": float(np.percentile(lat, 95)),
        "p50_ttft_s": float(np.percentile(ttft, 50)),
        "p95_ttft_s": float(np.percentile(ttft, 95)),
        "sustained_tok_s": total_tokens / makespan,
        "tokens": total_tokens,
        "async_decode": async_decode,
        "host_ms": sched.host_ms_total,
        "wait_ms": sched.wait_ms_total,
        "flush_wait_ms": sched.flush_wait_ms_total,
        "flushes": sched.flushes,
        "device_ms": sched.device_ms_total,
        "prefill_ms": sched.prefill_ms_total,
        "prefill_tokens": sched.prefill_tokens_total,
        "state_resets": sched.state_resets,
        "decode_steps": sched._step_idx - steps0,
        "peak_tokens_in_flight": sched.peak_tokens_in_flight,
        "jit_cache_sizes": sched.jit_cache_sizes(),
        "stage_calls": dict(sched.stage_calls),
        "exit_stats": sched.exit_stats(),
        "outputs": [list(r.out_tokens) for r in reqs],
    }
    if paged:
        stats["prefix_hit_tokens"] = sched.prefix_hit_tokens
        stats["prefill_chunks_skipped"] = sched.prefill_chunks_skipped
    if not quiet:
        print(f"arch={cfg.name} poisson rate={rate}/s requests={n_requests} "
              f"slots={slots}" + (" paged" if paged else "")
              + (f" async(r={readback_interval})" if async_decode else "")
              + f" device={model.device}")
        print(f"  p50={stats['p50_latency_s']*1e3:.0f}ms "
              f"p95={stats['p95_latency_s']*1e3:.0f}ms "
              f"ttft p50={stats['p50_ttft_s']*1e3:.0f}ms "
              f"p95={stats['p95_ttft_s']*1e3:.0f}ms "
              f"sustained={stats['sustained_tok_s']:.1f} tok/s "
              f"makespan={makespan:.2f}s")
        print(f"  host={stats['host_ms']:.0f}ms "
              f"wait={stats['wait_ms']:.0f}ms "
              f"device={stats['device_ms']:.0f}ms "
              f"flush_wait={stats['flush_wait_ms']:.0f}ms in "
              f"{stats['flushes']} flushes; prefill "
              f"{stats['prefill_ms']:.0f}ms for {stats['prefill_tokens']} "
              f"prompt tokens; {stats['state_resets']} state resets; "
              f"peak-in-flight="
              f"{stats['peak_tokens_in_flight']} tokens; decode-window "
              f"builds (must stay 1): {stats['jit_cache_sizes']}")
    return stats


def _print_migration(stats):
    """Migration and resilience lines of the tiered driver."""
    mig = stats.get("migration", {})
    if mig.get("split_handoffs") or mig.get("outage_migrations") \
            or mig.get("requeued"):
        print(f"  migration: splits={mig['split_handoffs']} "
              f"outage={mig['outage_migrations']} "
              f"requeued={mig['requeued']} "
              f"moved={mig['bytes_moved'] / 1024:.0f}KiB "
              f"(raw {mig['bytes_raw'] / 1024:.0f}KiB, "
              f"{mig['compressed']} int8) "
              f"modelled transfer={mig['transfer_s'] * 1e3:.1f}ms")
    res = stats.get("resilience")
    if res is not None:
        print(f"  resilience: dead={stats.get('dead_tiers', [])} "
              f"survive_prob={res['survive_prob']:.2f} "
              f"acc_with_drain={res['expected_accuracy_with_skip']:.2f} "
              f"vs_collapse={res['expected_accuracy_without_skip']:.2f} "
              f"(gain {res['gain']:+.2f})")


def serve_tiered_poisson(arch, *, rate: float = 4.0,
                         n_requests: int = 32, base_slots: int = 8,
                         prompt_len: int = 16, max_new: int = 32,
                         threshold: float = 0.5, prefill_chunk: int = 16,
                         scenario: str = "default", plan_arch: str = "",
                         deadline: float = 0.0, long_mode: bool = False,
                         async_decode: bool = False,
                         readback_interval: int = 8, seed: int = 0,
                         params=None, device="cuda", quiet: bool = False):
    """Poisson trace through the tiered cluster: the admission router sends
    each arrival to a cloud/edge/device pool (or a prefill/decode split)
    with the paradigm planners.  Arrivals and the reported latencies live
    on the tiers' virtual clocks (modelled), token generation is real
    execution on ``device``, and ``wall_s`` is the host-clock time of
    ``run()``.  ``arch`` is an arch name or a ``ModelConfig``.  ``params``
    default to ``Model(arch).init(seed)``; the plan config defaults to
    ``arch`` without ``-smoke`` (a ``ModelConfig`` plans itself).  Returns
    the cluster's stats dict plus ``wall_s``, ``tokens`` and each
    request's outputs.  ``async_decode`` gives every tier pool the window
    pipeline."""
    cfg = resolve_config(arch)
    model = Model(cfg, device=device)
    if params is None:
        params = model.init(seed)
    if plan_arch:
        plan_cfg = get_config(plan_arch)
    elif isinstance(arch, str) and arch.endswith("-smoke"):
        plan_cfg = get_config(arch[:-len("-smoke")])
    else:
        plan_cfg = cfg
    cluster = TieredServingCluster(
        model, params, SCENARIOS[scenario](), plan_cfg=plan_cfg,
        cfg=ClusterConfig(base_slots=base_slots,
                          max_len=prompt_len + max_new,
                          prefill_chunk=min(prefill_chunk,
                                            max(1, prompt_len)),
                          exit_threshold=threshold, long_mode=long_mode,
                          async_decode=async_decode,
                          readback_interval=readback_interval))
    rs = np.random.RandomState(seed)
    arrivals, lengths = poisson_trace(rs, rate, n_requests, prompt_len)
    crs = [cluster.submit(rs.randint(0, cfg.vocab_size, int(n)),
                          max_new=max_new, arrival=float(arr),
                          deadline=deadline or None,
                          frames=draw_frames(rs, cfg))
           for arr, n in zip(arrivals, lengths)]
    t0 = time.time()
    cluster.run()
    wall = time.time() - t0
    stats = cluster.stats()
    stats["wall_s"] = wall
    stats["async_decode"] = async_decode
    stats["tokens"] = sum(len(cr.req.out_tokens) for cr in crs)
    stats["outputs"] = [list(cr.req.out_tokens) for cr in crs]
    if not quiet:
        print(f"arch={cfg.name} tiered poisson scenario={scenario} "
              f"rate={rate}/s requests={n_requests} (plan={plan_cfg.name}) "
              + (f"async(r={readback_interval}) " if async_decode else "")
              + f"device={model.device}")
        print(f"  routed: {stats['route_counts']} splits={stats['splits']} "
              f"deadline-hit={stats['deadline_hit_rate']:.2f}")
        print(f"  modelled virtual p50={stats['p50_latency_s']*1e3:.0f}ms "
              f"p95={stats['p95_latency_s']*1e3:.0f}ms; measured wall "
              f"{wall:.2f}s, {stats['tokens'] / wall:.2f} tok/s")
        for name, ts in stats["tiers"].items():
            print(f"  {name:6s} slots={ts['n_slots']} "
                  f"routed={ts['routed']:3d} util={ts['utilization']:.2f} "
                  f"occupancy={ts['slot_occupancy']:.2f} "
                  f"depth={ts['measured_depth']:.2f} "
                  f"p95={ts['p95_latency_s']*1e3:.0f}ms"
                  + (" DEAD" if ts.get("dead") else ""))
        _print_migration(stats)
    return stats


def _build_group(archs, seed: int, device="cuda") -> ModelGroup:
    """One (model, params) entry per arch name, named by it; entry i's
    params are ``Model.init(seed + i)`` on ``device``."""
    entries = []
    for i, arch in enumerate(archs):
        model = Model(get_config(arch), device=device)
        entries.append((arch, model, model.init(seed + i)))
    return ModelGroup(entries)


def _plan_name(arch: str) -> str:
    return arch[:-len("-smoke")] if arch.endswith("-smoke") else arch


def serve_multi_poisson(archs, *, rate: float = 4.0, n_requests: int = 32,
                        slots: int = 4, prompt_len: int = 16,
                        max_new: int = 32, threshold: float = 0.5,
                        prefill_chunk: int = 16, long_mode: bool = False,
                        max_prefill_chunks: int = 0, paged: bool = False,
                        page_size: int = 16, segmented: bool = True,
                        async_decode: bool = False,
                        readback_interval: int = 8, seed: int = 0,
                        group: ModelGroup = None, device="cuda",
                        quiet: bool = False):
    """Open-loop Poisson trace through one multi-model pool: requests are
    assigned round-robin across ``archs`` and one ``MultiModelScheduler``
    serves every model's arena in the same poll loop, ``slots`` slots
    each.  ``max_prefill_chunks`` is the pool-wide prefill budget a poll
    (0 = unbounded).  ``group`` defaults to ``_build_group(archs, seed,
    device)`` (its entries must be named by ``archs``).  Returns a stats
    dict with per-model tokens, tok/s and latencies, the host and
    readback split per poll, stage builds, and each request's model,
    prompt and outputs."""
    if group is None:
        group = _build_group(archs, seed, device)
    max_len = prompt_len + max_new
    if paged:                          # page-pool arenas need whole pages
        max_len += (-max_len) % page_size
    sched = MultiModelScheduler(group, SchedulerConfig(
        n_slots=slots, max_len=max_len,
        prefill_chunk=min(prefill_chunk, max(1, prompt_len)),
        exit_threshold=threshold, long_mode=long_mode,
        max_prefill_chunks_per_step=max_prefill_chunks, paged=paged,
        page_size=page_size, segmented=segmented and not async_decode,
        async_decode=async_decode, readback_interval=readback_interval))

    rs = np.random.RandomState(seed)
    arrivals, lengths = poisson_trace(rs, rate, n_requests, prompt_len)
    cfgs = {e.name: e.model.cfg for e in group}
    reqs = []
    for i, n in enumerate(lengths):
        arch = archs[i % len(archs)]
        reqs.append(Request(tokens=rs.randint(0, cfgs[arch].vocab_size,
                                              int(n)),
                            max_new=max_new, model=arch,
                            frames=draw_frames(rs, cfgs[arch])))

    # warm up each arena outside the timed trace
    for arch in archs:
        sched.submit(Request(tokens=rs.randint(0, cfgs[arch].vocab_size,
                                               int(lengths[0])),
                             max_new=1, model=arch,
                             frames=draw_frames(rs, cfgs[arch])))
    sched.run()
    sched.reset_stats()

    t0, makespan, polls = _drive_open_loop(sched, reqs, arrivals)
    lat = [r.t_done - (t0 + arrivals[j]) for j, r in enumerate(reqs)]
    ttft = [r.t_first - (t0 + arrivals[j]) for j, r in enumerate(reqs)]
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    per_model = {}
    for arch in archs:
        ml = [lat[j] for j, r in enumerate(reqs) if r.model == arch]
        tokens = sum(len(r.out_tokens) for r in reqs if r.model == arch)
        per_model[arch] = {
            "requests": len(ml),
            "tokens": tokens,
            "tok_s": tokens / makespan,
            "p50_latency_s": _pctl(ml, 50),
            "p95_latency_s": _pctl(ml, 95),
        }
    stats = {
        "requests": n_requests,
        "models": per_model,
        "slots": slots,
        "rate_req_s": rate,
        "makespan_s": makespan,
        "p50_latency_s": _pctl(lat, 50),
        "p95_latency_s": _pctl(lat, 95),
        "p50_ttft_s": _pctl(ttft, 50),
        "p95_ttft_s": _pctl(ttft, 95),
        "sustained_tok_s": total_tokens / makespan,
        "tokens": total_tokens,
        "async_decode": async_decode,
        "polls": polls,
        "host_ms": sched.host_ms_total,
        "wait_ms": sched.wait_ms_total,
        "flush_wait_ms": sched.flush_wait_ms_total,
        "device_ms": sched.device_ms_total,
        "host_ms_per_poll": sched.host_ms_total / max(1, polls),
        "peak_tokens_in_flight": sched.peak_tokens_in_flight,
        "jit_cache_sizes": sched.jit_cache_sizes(),
        "exit_stats": sched.exit_stats(),
        "request_models": [r.model for r in reqs],
        "prompts": [r.tokens.tolist() for r in reqs],
        "outputs": [list(r.out_tokens) for r in reqs],
    }
    if not quiet:
        print(f"multi-model poisson models={','.join(archs)} rate={rate}/s "
              f"requests={n_requests} slots={slots}/model"
              + (" paged" if paged else "")
              + (f" async(r={readback_interval})" if async_decode else ""))
        print(f"  p50={stats['p50_latency_s']*1e3:.0f}ms "
              f"p95={stats['p95_latency_s']*1e3:.0f}ms "
              f"ttft p50={stats['p50_ttft_s']*1e3:.0f}ms "
              f"p95={stats['p95_ttft_s']*1e3:.0f}ms "
              f"sustained={stats['sustained_tok_s']:.1f} tok/s "
              f"makespan={makespan:.2f}s host/poll="
              f"{stats['host_ms_per_poll']:.1f}ms")
        for arch, ms in per_model.items():
            print(f"  {arch:24s} requests={ms['requests']:3d} "
                  f"tokens={ms['tokens']:4d} tok/s={ms['tok_s']:.1f} "
                  f"p95={ms['p95_latency_s']*1e3:.0f}ms")
        print(f"  stage builds (each must stay <= 1): "
              f"{stats['jit_cache_sizes']}")
    return stats


def serve_multi_tiered_poisson(archs, *, rate: float = 4.0,
                               n_requests: int = 32, base_slots: int = 8,
                               prompt_len: int = 16, max_new: int = 32,
                               threshold: float = 0.5,
                               prefill_chunk: int = 16,
                               long_mode: bool = False,
                               scenario: str = "default",
                               deadline: float = 0.0, spec_draft: str = "",
                               spec_k: int = 4, paged: bool = False,
                               async_decode: bool = False,
                               readback_interval: int = 8, seed: int = 0,
                               device="cuda", quiet: bool = False):
    """Multi-model Poisson trace through the tiered cluster: each request
    is routed per (model, request) with that model's cost graphs (plan
    config: the arch without ``-smoke``), so heavy and light models can
    land on different tiers within one trace.

    ``spec_draft`` names the entry that drafts on the device tier: the
    router then also prices the speculative candidate (k drafted tokens a
    round, one batched verify on the cloud, one uplink of k token ids and
    one downlink of the accepted count a round instead of a round trip a
    token), and requests routed speculative run through a ``SpecPair``
    bridge.  Returns the cluster's stats plus ``wall_s`` (host clock),
    ``tokens`` and each request's outputs."""
    group = _build_group(archs, seed, device)
    max_len = prompt_len + max_new
    if paged:
        max_len += (-max_len) % 16
    cluster = TieredServingCluster(
        group, scenario=SCENARIOS[scenario](),
        plan_cfg={arch: get_config(_plan_name(arch)) for arch in archs},
        cfg=ClusterConfig(base_slots=base_slots, max_len=max_len,
                          prefill_chunk=min(prefill_chunk,
                                            max(1, prompt_len)),
                          exit_threshold=threshold, long_mode=long_mode,
                          spec_draft=spec_draft, spec_k=spec_k, paged=paged,
                          async_decode=async_decode,
                          readback_interval=readback_interval))
    rs = np.random.RandomState(seed)
    arrivals, lengths = poisson_trace(rs, rate, n_requests, prompt_len)
    crs = []
    for i, (arr, n) in enumerate(zip(arrivals, lengths)):
        arch = archs[i % len(archs)]
        crs.append(cluster.submit(
            rs.randint(0, group[arch].model.cfg.vocab_size, int(n)),
            max_new=max_new, arrival=float(arr), deadline=deadline or None,
            model=arch))
    t0 = time.time()
    cluster.run()
    wall = time.time() - t0
    stats = cluster.stats()
    stats["wall_s"] = wall
    stats["tokens"] = sum(len(cr.req.out_tokens) for cr in crs)
    stats["outputs"] = [list(cr.req.out_tokens) for cr in crs]
    if not quiet:
        print(f"multi-model tiered poisson models={','.join(archs)} "
              f"scenario={scenario} rate={rate}/s requests={n_requests} "
              f"device={group[archs[0]].model.device}")
        print(f"  routed: {stats['route_counts']} splits={stats['splits']} "
              f"deadline-hit={stats['deadline_hit_rate']:.2f}")
        print(f"  modelled virtual p50={stats['p50_latency_s']*1e3:.0f}ms "
              f"p95={stats['p95_latency_s']*1e3:.0f}ms; measured wall "
              f"{wall:.2f}s, {stats['tokens'] / wall:.2f} tok/s")
        for arch, ms in stats["models"].items():
            print(f"  {arch:24s} routed={ms['routed']:3d} "
                  f"{ms['route_counts']} tokens={ms['tokens']}")
        for name, ts in stats["tiers"].items():
            print(f"  {name:6s} slots={ts['n_slots']} "
                  f"routed={ts['routed']:3d} util={ts['utilization']:.2f} "
                  f"p95={ts['p95_latency_s']*1e3:.0f}ms"
                  + (" DEAD" if ts.get("dead") else ""))
        sp = stats.get("speculative")
        if sp is not None:
            print(f"  speculative: draft={sp['draft']} k={sp['k']} "
                  f"rounds={sp['rounds']} "
                  f"acceptance={sp['acceptance_len']:.2f} "
                  f"requests={sp['requests_completed']} "
                  f"modelled p50={sp['p50_latency_s']*1e3:.0f}ms "
                  f"tokens/round={sp['mean_speedup_x']:.2f}")
        _print_migration(stats)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b-smoke")
    ap.add_argument("--mode", default="batch", choices=["batch", "poisson"])
    ap.add_argument("--batch", type=int, default=4,
                    help="[batch] prompts in the batch")
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="[poisson] prompt tokens a prefill round replays")
    ap.add_argument("--long", action="store_true",
                    help="ring-buffer KV caches at the model's "
                         "long_context_window (contiguous arenas)")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--monolithic", action="store_true",
                    help="one decode_step per token instead of segments")
    ap.add_argument("--async-decode", action="store_true",
                    help="decode windows (monolithic steps, a CUDA graph "
                         "on the card) with one token readback every "
                         "--readback-interval steps")
    ap.add_argument("--readback-interval", type=int, default=8,
                    help="[async] decode steps per token readback")
    ap.add_argument("--prefix-share", type=float, default=0.0)
    ap.add_argument("--prefix-len", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiered", action="store_true",
                    help="route through the cloud/edge/device cluster "
                         "(--slots is the cloud pool's size)")
    ap.add_argument("--scenario", default="default", choices=sorted(SCENARIOS))
    ap.add_argument("--plan-arch", default="")
    ap.add_argument("--deadline", type=float, default=0.0)
    ap.add_argument("--models", default="",
                    help="comma-separated archs served by one multi-model "
                         "pool (overrides --arch; --slots is per model)")
    ap.add_argument("--spec-draft", default="",
                    help="[--tiered --models] the entry that drafts on the "
                         "device tier for cross-tier speculative decoding")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="[--spec-draft] draft tokens a round")
    args = ap.parse_args(argv)
    if args.mode == "batch":
        if args.models or args.tiered:
            ap.error("--models and --tiered need --mode poisson")
        serve(args.arch, args.batch, args.prompt_len, args.max_new,
              threshold=args.threshold, long_mode=args.long,
              async_decode=args.async_decode,
              readback_interval=args.readback_interval, seed=args.seed,
              device=args.device)
        return
    if args.spec_draft and not (args.tiered and args.models):
        ap.error("--spec-draft needs --tiered and --models")
    if args.models:
        archs = [a.strip() for a in args.models.split(",") if a.strip()]
        if args.spec_draft and args.spec_draft not in archs:
            ap.error("--spec-draft must name a --models entry")
        common = dict(rate=args.rate, n_requests=args.requests,
                      prompt_len=args.prompt_len, max_new=args.max_new,
                      threshold=args.threshold, paged=args.paged,
                      prefill_chunk=args.prefill_chunk, long_mode=args.long,
                      async_decode=args.async_decode,
                      readback_interval=args.readback_interval,
                      seed=args.seed, device=args.device)
        if args.tiered:
            serve_multi_tiered_poisson(
                archs, base_slots=args.slots, scenario=args.scenario,
                deadline=args.deadline, spec_draft=args.spec_draft,
                spec_k=args.spec_k, **common)
        else:
            serve_multi_poisson(archs, slots=args.slots,
                                segmented=not args.monolithic, **common)
        return
    if args.tiered:
        serve_tiered_poisson(
            args.arch, rate=args.rate, n_requests=args.requests,
            base_slots=args.slots, prompt_len=args.prompt_len,
            max_new=args.max_new, threshold=args.threshold,
            prefill_chunk=args.prefill_chunk, long_mode=args.long,
            scenario=args.scenario, plan_arch=args.plan_arch,
            deadline=args.deadline, async_decode=args.async_decode,
            readback_interval=args.readback_interval, seed=args.seed,
            device=args.device)
        return
    serve_poisson(args.arch, rate=args.rate, n_requests=args.requests,
                  slots=args.slots, prompt_len=args.prompt_len,
                  max_new=args.max_new, threshold=args.threshold,
                  prefill_chunk=args.prefill_chunk, long_mode=args.long,
                  paged=args.paged, segmented=not args.monolithic,
                  prefix_share=args.prefix_share, prefix_len=args.prefix_len,
                  async_decode=args.async_decode,
                  readback_interval=args.readback_interval,
                  seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
