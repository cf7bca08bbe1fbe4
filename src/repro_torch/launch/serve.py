"""Open-loop Poisson serving through the port: one continuous-batching
pool, or the tiered cloud/edge/device cluster.

    python -m repro_torch.launch.serve --arch granite-3-2b --paged \\
        --requests 32 --slots 16 --prompt-len 256 --max-new 32
    python -m repro_torch.launch.serve --arch granite-3-2b-smoke \\
        --device cpu --tiered --scenario tier-outage --requests 8 \\
        --slots 2 --prompt-len 12 --max-new 8
    python -m repro_torch.launch.serve --arch granite-3-2b --paged \\
        --async-decode --readback-interval 8 --requests 32 --slots 16

Requests arrive at Poisson times (seeded), prompts are uniform in
``[prompt_len // 4, prompt_len]`` tokens.  Single pool: ``prefix_share``
of them begin with one common ``prefix_len``-token prefix (so the paged
arena's prefix cache can hit); reports p50/p95 request latency and
sustained tok/s on the host clock, around work that ends with the
per-step token readback.  ``--async-decode`` decodes in windows of
``--readback-interval`` monolithic steps (a CUDA graph on the card) with
one token readback a window.  Tiered (``--tiered``): the admission router
places each request on a tier pool; latencies are on the tiers' virtual
clocks (modelled by the planners' tier profiles, not measured), and the
wall time of the whole run is on the host clock.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, resolve_config
from repro_torch.core import Scenario
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterConfig, TieredServingCluster
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig)

SCENARIOS = {"default": Scenario.default,
             "degraded-wan": Scenario.degraded_wan,
             "neurosurgeon-era": Scenario.neurosurgeon_era,
             "high-rtt-access": Scenario.high_rtt_access,
             "tier-outage": Scenario.tier_outage}


def poisson_trace(rs: np.random.RandomState, rate: float, n_requests: int,
                  prompt_len: int):
    """Homogeneous Poisson arrivals and uniform prompt lengths in
    ``[max(1, prompt_len // 4), prompt_len]`` (the reference's draw order:
    all gaps first, then all lengths)."""
    arrivals = np.cumsum(rs.exponential(1.0 / rate, n_requests))
    lengths = rs.randint(max(1, prompt_len // 4), prompt_len + 1, n_requests)
    return arrivals, lengths


def _drive_open_loop(sched, reqs, arrivals):
    """Submit each request at its arrival offset and poll until every
    request completes.  Returns (t0, makespan_seconds)."""
    t0 = time.time()
    i = 0
    while len(sched.completed) < len(reqs):
        now = time.time() - t0
        while i < len(reqs) and arrivals[i] <= now:
            sched.submit(reqs[i])
            i += 1
        if sched.has_work:
            sched.tick()
        elif i < len(reqs):
            time.sleep(min(0.002, max(0.0, arrivals[i] - now)))
    return t0, time.time() - t0


def serve_poisson(arch, *, rate: float = 4.0, n_requests: int = 32,
                  slots: int = 8, prompt_len: int = 16, max_new: int = 32,
                  threshold: float = 0.5, prefill_chunk: int = 16,
                  paged: bool = False, page_size: int = 16,
                  segmented: bool = True, prefix_share: float = 0.0,
                  prefix_len: int = 0, async_decode: bool = False,
                  readback_interval: int = 8, seed: int = 0, params=None,
                  device="cuda", quiet: bool = False):
    """Serve a seeded Poisson trace; returns a stats dict (latency
    percentiles, sustained tok/s, host/device split, exit statistics,
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
                        exit_threshold=threshold, paged=paged,
                        page_size=page_size,
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

    # warm up outside the timed trace (one admission + one step)
    sched.submit(Request(tokens=rs.randint(0, cfg.vocab_size,
                                           int(lengths[0])), max_new=1))
    sched.run()
    sched.reset_stats()
    steps0 = sched._step_idx

    t0, makespan = _drive_open_loop(sched, reqs, arrivals)
    lat = np.asarray([r.t_done - (t0 + arrivals[j])
                      for j, r in enumerate(reqs)])
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    stats = {
        "requests": n_requests,
        "slots": slots,
        "rate_req_s": rate,
        "makespan_s": makespan,
        "p50_latency_s": float(np.percentile(lat, 50)),
        "p95_latency_s": float(np.percentile(lat, 95)),
        "sustained_tok_s": total_tokens / makespan,
        "tokens": total_tokens,
        "async_decode": async_decode,
        "host_ms": sched.host_ms_total,
        "device_ms": sched.device_ms_total,
        "prefill_ms": sched.prefill_ms_total,
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
              f"sustained={stats['sustained_tok_s']:.1f} tok/s "
              f"makespan={makespan:.2f}s")
        print(f"  host={stats['host_ms']:.0f}ms "
              f"device={stats['device_ms']:.0f}ms peak-in-flight="
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
                         deadline: float = 0.0, async_decode: bool = False,
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
                          exit_threshold=threshold,
                          async_decode=async_decode,
                          readback_interval=readback_interval))
    rs = np.random.RandomState(seed)
    arrivals, lengths = poisson_trace(rs, rate, n_requests, prompt_len)
    crs = [cluster.submit(rs.randint(0, cfg.vocab_size, int(n)),
                          max_new=max_new, arrival=float(arr),
                          deadline=deadline or None)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b-smoke")
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--threshold", type=float, default=0.5)
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
    args = ap.parse_args(argv)
    if args.tiered:
        serve_tiered_poisson(
            args.arch, rate=args.rate, n_requests=args.requests,
            base_slots=args.slots, prompt_len=args.prompt_len,
            max_new=args.max_new, threshold=args.threshold,
            scenario=args.scenario, plan_arch=args.plan_arch,
            deadline=args.deadline, async_decode=args.async_decode,
            readback_interval=args.readback_interval, seed=args.seed,
            device=args.device)
        return
    serve_poisson(args.arch, rate=args.rate, n_requests=args.requests,
                  slots=args.slots, prompt_len=args.prompt_len,
                  max_new=args.max_new, threshold=args.threshold,
                  paged=args.paged, segmented=not args.monolithic,
                  prefix_share=args.prefix_share, prefix_len=args.prefix_len,
                  async_decode=args.async_decode,
                  readback_interval=args.readback_interval,
                  seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
