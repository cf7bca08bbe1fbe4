"""The survey, end to end, on the PyTorch/CUDA port: plan all four
collaborative-inference paradigms for a workload, then execute the
edge-device paradigm's ingredients for real — early-exit serving + int8
boundary compression.

    PYTHONPATH=src python examples/torch/collaborative_serving.py \\
        [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Scenario, build_cost_graph, plan_all
from repro_torch.core.cnn_zoo import CNN_ZOO
from repro_torch.core.offload import (compress_boundary, compression_decision,
                                      decompress_boundary)
from repro_torch.kernels import ops as kops
from repro_torch.models import Model
from repro_torch.serving import (ClusterConfig, ContinuousBatchScheduler,
                                 ModelGroup, MultiModelScheduler, Request,
                                 SchedulerConfig, ServeConfig, ServingEngine,
                                 TieredServingCluster)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    out = {}

    # ---- 1. plan the four paradigms (survey §3-§6) on a vision workload
    sc = Scenario.default()
    g = CNN_ZOO["vgg16"]()
    print("paradigm plans for vgg16 @ default scenario:")
    out["vgg16"] = plan_all(g, sc, deadline=0.1)
    for name, p in out["vgg16"].items():
        print(f"  {name:18s} latency={p.latency*1e3:8.2f}ms "
              f"energy={p.energy:7.3f}J acc={p.accuracy:.3f} "
              f"comm={p.comm_bytes/1e6:8.2f}MB")

    # ...and on an assigned-zoo transformer (token inputs: cloud-only wins
    # on comm, exits still pay — the survey's scenario-dependence)
    g2 = build_cost_graph(get_config("qwen2-vl-2b"), batch=1, seq_len=1024)
    print("\nparadigm plans for qwen2-vl-2b (vision-language workload):")
    out["qwen2-vl-2b"] = plan_all(g2, sc, deadline=0.5)
    for name, p in out["qwen2-vl-2b"].items():
        print(f"  {name:18s} latency={p.latency*1e3:8.2f}ms "
              f"acc={p.accuracy:.3f}")

    # ---- 2. run the edge-device paradigm's runtime pieces: requests with
    # mixed prompt lengths flow through the continuous-batching scheduler
    # (slot pool + chunked prefill + device-side exit counters)
    cfg = get_config("yi-6b-smoke")
    model = Model(cfg, device=dev)
    params = model.init(0)
    sched = ContinuousBatchScheduler(
        model, params, SchedulerConfig(n_slots=2, max_len=32,
                                       exit_threshold=0.9, prefill_chunk=8),
        device=dev)
    rs = np.random.RandomState(1)
    for length in (5, 8, 12, 7, 3, 10):
        sched.submit(Request(tokens=rs.randint(0, cfg.vocab_size, length),
                             max_new=12))
    sched.run()
    print(f"\ncontinuous batching (yi-6b-smoke): {sched.n_admitted} requests "
          f"through {sched.cfg.n_slots} slots, "
          f"stage builds {sched.jit_cache_sizes()}")
    out["sched_exit_stats"] = sched.exit_stats()
    print("early-exit serving stats:",
          {k: round(v, 3) for k, v in out["sched_exit_stats"].items()})

    # Decode is depth-segmented: after each fused entropy probe the
    # scheduler stops dispatching segments once every active slot has
    # exited, so a looser threshold removes layers from the step (the
    # depth fraction below); the tiered cluster charges its virtual clocks
    # with that truncated cost.
    out["depth"] = {}
    for thr in (0.0, 1.5):
        s2 = ContinuousBatchScheduler(
            model, params, SchedulerConfig(n_slots=2, max_len=32,
                                           exit_threshold=thr), device=dev)
        for length in (6, 9):
            s2.submit(Request(tokens=rs.randint(0, cfg.vocab_size, length),
                              max_new=12))
        s2.run()
        out["depth"][thr] = s2.measured_depth_fraction()
        print(f"  threshold {thr:3.1f}: measured depth fraction "
              f"{out['depth'][thr]:.2f} (stage dispatches {s2.stage_calls})")

    # ...the batch front-end (ServingEngine) rides on the same scheduler
    engine = ServingEngine(model, params, ServeConfig(exit_threshold=0.9))
    prompts = torch.randint(0, cfg.vocab_size, (4, 8),
                            generator=torch.Generator().manual_seed(1))
    engine.generate(prompts, max_new=12)
    out["engine_exit_stats"] = engine.exit_stats()
    print("engine batch stats:",
          {k: round(v, 3) for k, v in out["engine_exit_stats"].items()})

    # ---- 3. the paradigms AS the runtime: the tiered cluster routes each
    # request to a cloud/edge/device scheduler pool at admission time
    # (planning against the full-size model, executing the smoke one)
    cluster = TieredServingCluster(
        model, params, sc, plan_cfg=get_config("yi-6b"),
        cfg=ClusterConfig(base_slots=2, max_len=280, prefill_chunk=16))
    t = 0.0
    for i in range(6):
        short = i % 3 != 2
        cluster.submit(
            rs.randint(0, cfg.vocab_size, 8 if short else 256),
            max_new=8, deadline=0.05 if short else None, arrival=t)
        t += 0.05
    cluster.run()
    cst = out["cluster"] = cluster.stats()
    print(f"\ntiered serving: routed {cst['route_counts']} "
          f"(p50 {cst['p50_latency_s']*1e3:.0f}ms virtual, "
          f"deadline hit {cst['deadline_hit_rate']:.2f})")
    for tname, ts in cst["tiers"].items():
        if ts["routed"]:
            print(f"  {tname:6s} slots={ts['n_slots']} "
                  f"routed={ts['routed']} util={ts['utilization']:.2f}")

    # ---- 4. a multi-tenant edge node: ONE pool multiplexing two
    # heterogeneous models (survey §6.3 dynamic task allocation).  Each
    # model owns its own cache arena behind one queue; outputs are
    # bit-identical to dedicated per-model schedulers.
    cfg_b = get_config("xlstm-350m-smoke")
    model_b = Model(cfg_b, device=dev)
    group = ModelGroup([("yi", model, params),
                        ("xlstm", model_b, model_b.init(3))])
    pool = MultiModelScheduler(group, SchedulerConfig(n_slots=2, max_len=32))
    for i in range(6):
        name = ("yi", "xlstm")[i % 2]
        vocab = (cfg if name == "yi" else cfg_b).vocab_size
        pool.submit(Request(tokens=rs.randint(0, vocab, 4 + i), max_new=8,
                            model=name))
    pool.run()
    out["pool_tokens"] = {n: p.tokens_served for n, p in pool.pools.items()}
    print(f"\nmulti-model pool: {len(pool.completed)} requests over "
          f"{list(pool.pools)} arenas, per-model tokens {out['pool_tokens']}")

    # ---- 5. boundary feature compression (the partition-crossing tensor)
    x = torch.randn((64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2)).to(device=model.device,
                                        dtype=torch.bfloat16)
    q, s = kops.compress_rows(x)           # int8 kernel on the card
    x2 = kops.decompress_rows(q, s)
    err = float((x2.float() - x.float()).abs().max())
    # the runtime ops of core.offload: the same int8 pair, and int4 (in
    # int8) on the same rows
    q8, s8 = compress_boundary(x)
    same = bool(torch.equal(q8, q) and torch.equal(s8, s))
    q4, s4 = compress_boundary(x, bits=4)
    err4 = float((decompress_boundary(q4, s4).float() - x.float())
                 .abs().max())
    dec = compression_decision(float(x.numel() * 2), sc.device, sc.dev_edge)
    out.update(compress_err=err, compress_ops_equal=same, int4_err=err4)
    print(f"\nboundary compression: 2 bytes -> 1 byte/el, max abs err "
          f"{err:.4f} (int4: {err4:.4f}; runtime op == kernel pair: "
          f"{same}), planner says compress={dec.compress} "
          f"(speedup {dec.speedup:.2f}x)")
    return out


if __name__ == "__main__":
    main()
