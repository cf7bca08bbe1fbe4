"""Where a decode step's time goes, on the card.

    python -m repro_torch.launch.profile_decode [--arch granite-3-2b]
        [--slots 16] [--prompt-len 128] [--steps 8] [--json PATH]
        [--async-decode [--readback-interval 8]]

Fills every slot of a paged, segmented scheduler with a prompt (an
encoder-decoder model: a contiguous one, each request with seeded encoder
frames, as ``launch/serve.py`` draws them), then
profiles ``--steps`` decode polls with ``torch.profiler`` (CPU and CUDA
activity).  With ``--async-decode`` the scheduler is monolithic and
decodes in windows (one CUDA graph replayed R times a window): the
profile covers ``ceil(steps / R)`` polls, each dispatching one window and
committing the one before, and a final ``sync()``.  Reports the host wall
time per step, the device time per step (the union of every device
operation's interval, ``launch/device_trace.py``: overlapping kernels
count once), the device busy share (that time / wall time), CUDA kernel
launches per step, graph replays, the kernels that take the most device
time and each of the port's own kernels (``kernels/csrc``) with its time
(the union of its own intervals) and launches per step, the idle ms per
step by the serving span open when each gap began, each serving span's
total and self ms per step, and with ``--async-decode`` each window's ms
from its dispatch to its commit (the spans joined by the window's
sequence number), the time its tokens wait before the host has them,
and, on the eager (segmented) step, the device ms a step of the kernels
launched under each kind of plan step (``plan_ms_per_step``: a hybrid's
``mamba`` scans, shared-block ``site`` s, ``exit`` probes and the final
``head``; the model's ``repro.model.<kind>`` spans), which a captured
window does not record.
Weights are random (seeded) unless the caller passes ``params``; ``arch``
is an arch name or a ``ModelConfig``; the card is required.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import resolve_config
from repro_torch.launch import device_trace
from repro_torch.launch.serve import draw_frames
from repro_torch.models.model import Model
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig)

# the __global__ functions of kernels/csrc/*.cu
PORT_KERNELS = ("paged_gqa_partial", "paged_gqa_combine", "paged_mla_partial",
                "paged_mla_combine", "exit_head_partial", "exit_head_finish",
                "flash_fwd_kernel", "quantize_rows_kernel",
                "dequantize_rows_kernel", "w8a8_expert_kernel")


def profile_decode(arch="granite-3-2b", slots: int = 16,
                   prompt_len: int = 128, steps: int = 8, seed: int = 0,
                   params=None, async_decode: bool = False,
                   readback_interval: int = 8):
    model = Model(resolve_config(arch), device="cuda")
    if params is None:
        params = model.init(seed)
    R = readback_interval if async_decode else 1
    windows = -(-steps // R)
    steps = windows * R
    warm = 2 * R
    max_new = warm + steps + R + 2
    max_len = prompt_len + max_new
    max_len += (-max_len) % 16
    paged = model.cfg.family != "encdec"
    sched = ContinuousBatchScheduler(
        model, params, SchedulerConfig(n_slots=slots, max_len=max_len,
                                       paged=paged,
                                       segmented=not async_decode,
                                       async_decode=async_decode,
                                       readback_interval=R),
        device="cuda")
    rs = np.random.RandomState(seed)
    for _ in range(slots):
        sched.submit(Request(tokens=rs.randint(0, model.cfg.vocab_size,
                                               prompt_len), max_new=max_new,
                             frames=draw_frames(rs, model.cfg)))
    t0 = time.perf_counter()
    sched.prefill_poll()                      # every slot admitted at once
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    for _ in range(warm // R):
        sched.poll()                          # async: the capture
    sched.sync()
    torch.cuda.synchronize()
    replays0 = sched._window.replays if async_decode else 0
    steps0 = sched._step_idx
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # record_shapes keeps the spans' sequence numbers (window_ms)
    with torch.profiler.profile(activities=acts,
                                record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(windows):
            sched.poll()                      # ends in the token readback
        sched.sync()                          # async: the last window's
        wall_s = time.perf_counter() - t0
    if sched._step_idx - steps0 != steps:
        raise RuntimeError(f"profiled {sched._step_idx - steps0} decode "
                           f"steps, expected {steps}")
    ops = device_trace.device_ops(prof)
    spans = device_trace.serving_spans(prof)
    # the window: the profiled polls and the final sync
    lo = min(a for n, a, _ in spans if n in ("poll", "sync"))
    hi = max(b for n, _, b in spans if n in ("poll", "sync"))
    dev_s = device_trace.busy_s(ops)
    kernels = sorted(device_trace.by_name(ops).items(),
                     key=lambda kv: -kv[1]["s"])
    port = [kv for kv in kernels if any(k in kv[0] for k in PORT_KERNELS)]
    ms = 1e3 / steps
    win_ms = list(device_trace.window_ms(prof).values())
    return {
        "arch": model.cfg.name, "slots": slots, "prompt_len": prompt_len,
        "paged": paged,
        "steps": steps, "async_decode": async_decode,
        "readback_interval": R,
        "graph_replays": (sched._window.replays - replays0
                          if async_decode else 0),
        "prefill_s_per_token_step": prefill_s / prompt_len,
        "wall_ms_per_step": wall_s / steps * 1e3,
        "device_ms_per_step": dev_s * ms,
        "device_busy_share": dev_s / wall_s if wall_s else 0.0,
        "cuda_kernels_per_step": len(ops) / steps,
        "top_kernels": [_per_step(kv, steps) for kv in kernels[:8]],
        "port_kernels": [_per_step(kv, steps) for kv in port],
        "idle_ms_per_step": {
            n: s * ms for n, s in sorted(
                device_trace.idle_gaps(ops, spans, lo, hi).items(),
                key=lambda kv: -kv[1])},
        "span_ms_per_step": {
            n: {"total": d["total_s"] * ms, "self": d["self_s"] * ms,
                "count": d["count"]}
            for n, d in device_trace.span_seconds(spans, lo, hi).items()},
        "plan_ms_per_step": {
            n: d * 1e3 / steps for n, d in sorted(
                device_trace.plan_device_s(prof).items(),
                key=lambda kv: -kv[1])},
        "window_ms": {"windows": len(win_ms),
                      "mean": float(np.mean(win_ms)) if win_ms else 0.0,
                      "max": max(win_ms, default=0.0)},
    }


def _per_step(kv, steps):
    name, d = kv
    return {"name": name[:80], "ms_per_step": d["s"] / steps * 1e3,
            "calls_per_step": d["launches"] / steps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--json", default="")
    ap.add_argument("--async-decode", action="store_true")
    ap.add_argument("--readback-interval", type=int, default=8)
    args = ap.parse_args(argv)
    out = profile_decode(args.arch, args.slots, args.prompt_len, args.steps,
                         async_decode=args.async_decode,
                         readback_interval=args.readback_interval)
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
