"""Runner of long-generation decode: a full batch of sessions, admitted in
waves during set-up so that the window sees contexts spread over the
arena, then a window that only decodes, through
``ContinuousBatchScheduler`` with the paged arena and CUDA-graph decode
windows (``async_decode``), greedy.

Set-up: the weights and prompts from the seed; the traffic's ``waves``
admissions of ``sessions / waves`` sessions each, every wave's prompts
replayed into the paged cache (the admission's prefill) and the sessions
so far decoded ``wave_steps`` steps through the windows before the next
wave comes, so the window starts with waves ``wave_steps`` apart in
context; then ``warm_windows`` polls.  The first window captures the
step's graph.  The memory peak is reset after set-up: the result's
``memory_peak_bytes`` is the window's.
The window: ``poll()`` until ``seconds`` have passed; each poll
dispatches a window and commits the one before it.  A traced run then
profiles ``trace_polls`` more polls of the running pipeline, after one
poll that lets the profiler settle, draining nothing.

Correctness, once the windows have closed and the program's state is
freed: a sample of sessions drawn from the seed, the longest among them,
is run through the plain reference over its prompt and every token it
was served.  ``token_gap`` is the widest gap by which a served token's
reference logit lies below the reference's best at that position;
``exit_entropy_gap`` the widest gap, over log(V), between the exit
heads' entropies that the program's step computed (tapped off its
output, ``ExitTap``) and the reference's, at every position the sample
was served; ``exit_share_gap`` compares the share of tokens whose exit
heads fired in the program's counters with the share the reference's
exit entropies give on the sample.
"""
from __future__ import annotations

import math
import gc
import time

import numpy as np
import torch

from bench import costs, harness, traffic
from bench import trace as btrace


def _wrap(obj, attr: str, name: str) -> None:
    """Open span ``name`` around ``obj.attr`` (skipped if it is gone)."""
    fn = getattr(obj, attr, None)
    if fn is None:
        return

    def spanned(*a, **kw):
        with btrace.span(name):
            return fn(*a, **kw)
    setattr(obj, attr, spanned)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ExitTap:
    """Keeps the exit entropies of every decode step the program runs,
    by slot and position: ``model.decode_step`` is wrapped so that each
    call (the prompt replay's eager steps, and the step a window's graph
    captures) also writes its ``exit_entropies`` output [n_exits, B]
    into ``buf`` [n_exits, B, max_len] at the rows it writes, on the
    device and with no readback."""

    def __init__(self, model, n_slots: int, max_len: int, dev):
        self.buf = torch.full((model.n_exits, n_slots, max_len), math.nan,
                              dtype=torch.float32, device=dev)
        self.rows = torch.arange(n_slots, device=dev)
        step = model.decode_step

        def tapped(params, cache, tokens, position, **kw):
            logits, ee, cache = step(params, cache, tokens, position, **kw)
            paged, wm = kw.get("paged"), kw.get("write_mask")
            act = paged.write_mask if paged is not None else wm
            self.record(ee, position, act)
            return logits, ee, cache
        model.decode_step = tapped

    def record(self, ee, position, act):
        if not ee.shape[0]:
            return
        pos = torch.as_tensor(position, device=ee.device).long()
        pos = pos.expand(ee.shape[1]).clamp(0, self.buf.shape[2] - 1)
        old = self.buf[:, self.rows, pos]
        new = ee if act is None else torch.where(act[None], ee, old)
        self.buf[:, self.rows, pos] = new


def run(cell, *, seed, seconds, trace, device, t_start, control=False):
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               Request, SchedulerConfig)
    cfg, tr, cc = cell["config"], cell["traffic"], cell["cell"]
    dev = torch.device(device)
    model, w, params = harness.build(cell, seed, dev)
    n, max_new = cc["sessions"], cc["max_new"]
    waves = tr["waves"]
    lo, hi = tr["prompt_len"]
    prompts = traffic.session_prompts(seed, n, lo, hi, cfg["vocab_size"],
                                      waves)
    page = tr["page_size"]
    max_len = -(-(hi + max_new) // page) * page
    R = tr["readback_interval"]
    tap = ExitTap(model, n, max_len, dev)
    sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
        n_slots=n, max_len=max_len, paged=True, page_size=page,
        segmented=False, async_decode=True, readback_interval=R,
        exit_threshold=cfg["exit_entropy_threshold"]), device=dev)
    reqs = [Request(tokens=p, max_new=max_new) for p in prompts]
    per = n // waves
    for j in range(waves):
        for r in reqs[j * per:(j + 1) * per]:
            sched.submit(r)
        with btrace.span("prompt_replay"):
            sched.prefill_poll()
        if j + 1 < waves:
            newest = reqs[j * per]
            while len(newest.out_tokens) < cc["wave_steps"]:
                sched.poll()
    for _ in range(tr["warm_windows"]):
        sched.poll()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_last = np.full(n, time.perf_counter())
    n_out = np.array([len(r.out_tokens) for r in reqs])
    setup_s = time.perf_counter() - t_start

    # the measured window
    host0 = sched.host_ms_total
    samples, steps, tokens, ctx_sum = [], 0, 0, 0
    got = np.zeros(n, bool)
    t0 = time.perf_counter()
    t = t0
    while t - t0 < seconds and sched.has_work:
        rep = sched.poll()
        t = time.perf_counter()
        steps += rep.decode_steps
        now = np.array([len(r.out_tokens) for r in reqs])
        for i in np.nonzero(now > n_out)[0]:
            k = int(now[i] - n_out[i])
            samples.append(np.full(k, (t - t_last[i]) / k))
            m = len(prompts[i])
            # out token j came from the step at position m + j - 1, whose
            # attention read m + j keys
            ctx_sum += k * m + (int(n_out[i]) + int(now[i]) - 1) * k // 2
            t_last[i] = t
        tokens += int((now - n_out).sum())
        got |= now > n_out
        n_out = now
    wall = t - t0
    # a session still open that was served nothing in the whole window
    starved = sum(1 for i, r in enumerate(reqs) if not r.done and not got[i])
    host_ms = sched.host_ms_total - host0
    info = harness.device_info(dev, cell["entry"]["chips"])
    itl = np.concatenate(samples) if samples else np.zeros(1)
    rec = {
        "mode": "decode", "config": cfg,
        "e2e": {"decode_tok_s": tokens / wall,
                "itl_p95_ms": float(np.percentile(itl, 95)) * 1e3,
                "setup_s": setup_s},
        "window_s": wall, "tokens": tokens, "steps": steps,
        "host_ms": host_ms,
        "flops": costs.decode_flops(cfg, tokens, ctx_sum),
        "peaks": costs.peaks(info["kind"]),
        "attempted": n, "failed": starved, "device": info, "trace": None}
    # the contexts the window ended at, shortest and longest
    ends = [int(sched.positions.min()), int(sched.positions.max())]

    t1 = time.perf_counter()
    if trace:
        rec["trace"] = _traced(sched, tr["trace_polls"], dev)
    t2 = time.perf_counter()
    sched.sync()
    counts = sched.flush_counters()
    served = [list(r.out_tokens) for r in reqs]
    entropies = tap.buf
    del sched, params, model, tap
    gc.collect()                   # the window and its scheduler hold a cycle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.update(_check(cell, w, prompts, served, counts, entropies, seed, dev,
                      control))
    rec["phases"] = {"setup_s": setup_s, "window_s": wall,
                     "trace_s": t2 - t1,
                     "check_s": time.perf_counter() - t2,
                     "window_end_contexts": ends}
    return rec


def _traced(sched, polls: int, dev) -> dict:
    """Profile ``polls`` polls of the running pipeline, after one that
    lets the profiler settle; nothing is drained, so the traced window
    holds the same overlap of host and device as the measured one.  The
    steps counted are those the traced polls committed."""
    for attr, name in (("_dispatch_window", "dispatch"),
                       ("_read_ring", "readback"),
                       ("_commit_window", "commit")):
        _wrap(sched, attr, name)
    with btrace.profiler() as prof:
        sched.poll()
        active = sched.active.copy()
        pos0 = sched.positions.copy()
        t0 = time.perf_counter()
        with btrace.span("traced"):
            for _ in range(polls):
                with btrace.span("poll"):
                    sched.poll()
        host_window = time.perf_counter() - t0
    out = btrace.summarize(prof)
    adv = (sched.positions - pos0)[active]
    out["steps"] = int(adv.max()) if adv.size else 0
    out["contexts"] = [int(p) + 1 + s for p, d in zip(pos0[active], adv)
                       for s in range(int(d))]
    out["host_window_s"] = host_window
    return out


def _check(cell, w, prompts, served, counts, entropies, seed, dev,
           control):
    """The correctness readings over the seed's sample of sessions."""
    cfg, tr = cell["config"], cell["traffic"]
    ref = harness.reference(cell)
    longest = int(np.argmax([len(s) for s in served]))
    sample = traffic.sample(seed, len(served), tr["sample_sessions"],
                            longest)
    thr = cfg["exit_entropy_threshold"]
    log_v = math.log(cfg["vocab_size"])
    gap = ent_gap = 0.0
    ref_exits = ref_tokens = 0
    ctrl = {"token_gap": 0.0, "exit_entropy_gap": 0.0}
    ctrl_exits = 0
    old = ref.no_tf32()
    try:
        for i in sample:
            m, s = len(prompts[i]), len(served[i])
            fed = np.concatenate([prompts[i], served[i][:-1]]).astype(
                np.int64)
            toks = torch.from_numpy(fed).to(dev)
            got = torch.tensor(served[i], dtype=torch.int64, device=dev)
            res = ref.forward(cfg, w, toks, first=m - 1)
            lg = res["logits"]
            best = lg.max(-1).values
            gap = max(gap, float((best - lg.gather(1, got[:, None])[:, 0])
                                 .max()))
            # the step at position m - 1 + j served token j
            prog = entropies[:, i, m - 1:m - 1 + s]
            ref_ent = torch.stack([ref.entropy(e) for e in
                                   res["exit_logits"]])
            if ref_ent.numel():
                # NaN where the program never ran a position: fails
                d = float((prog - ref_ent).abs().max()) / log_v
                ent_gap = max(ent_gap, d) if d == d else math.inf
            ref_exits += int((ref_ent / log_v < thr).any(0).sum())
            ref_tokens += s
            if control:
                low = ref.forward(cfg, w, toks, first=m - 1, lowp=True)
                pick = low["logits"].argmax(-1)
                ctrl["token_gap"] = max(ctrl["token_gap"], float(
                    (best - lg.gather(1, pick[:, None])[:, 0]).max()))
                low_ent = torch.stack([ref.entropy(e) for e in
                                       low["exit_logits"]])
                if low_ent.numel():
                    ctrl["exit_entropy_gap"] = max(
                        ctrl["exit_entropy_gap"],
                        float((low_ent - ref_ent).abs().max()) / log_v)
                ctrl_exits += int((low_ent / log_v < thr).any(0).sum())
                del low, low_ent
            del res, lg, ref_ent
    finally:
        ref.restore_tf32(old)
    counts = np.asarray(counts, np.int64)
    prog_share = float(counts[:-1].sum()) / max(1, int(counts.sum()))
    ref_share = ref_exits / max(1, ref_tokens)
    out = {"checks": {"token_gap": gap, "exit_entropy_gap": ent_gap,
                      "exit_share_gap": abs(prog_share - ref_share)},
           "checked_tokens": ref_tokens}
    if control:
        ctrl["exit_share_gap"] = abs(ctrl_exits / max(1, ref_tokens)
                                     - ref_share)
        out["control"] = ctrl
    return out
