"""Runner of prompt scoring: back-to-back batches of tokens through
``Model.forward`` (the final head and every exit head's logits over
every position), with no cache, window or paged arena.

Set-up: the weights and ``distinct_batches`` token batches from the
seed, and one forward of each (the kernels' first launches).  The
window: forwards over the batches in turn, at most one waiting behind
the one that runs, until ``seconds`` have passed; the window closes when
the last forward has finished.  A traced run then profiles
``trace_forwards`` more, queued the same way, draining nothing.

Correctness: the last forward of the window over the batch the seed
picks keeps its outputs; once the window has closed, the plain
reference recomputes each of its rows, and ``logit_err`` is the largest
absolute difference between the program's and the reference's logits,
over the final head and every exit head.
"""
from __future__ import annotations

import gc
import time

import torch

from bench import costs, harness, traffic
from bench import trace as btrace


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _event(dev):
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def run(cell, *, seed, seconds, trace, device, t_start, control=False):
    cfg, tr = cell["config"], cell["traffic"]
    dev = torch.device(device)
    model, w, params = harness.build(cell, seed, dev)
    bsz, seq, nb = tr["batch"], tr["seq_len"], tr["distinct_batches"]
    batches = [{"tokens": torch.from_numpy(b).to(dev)}
               for b in traffic.score_batches(seed, nb, bsz, seq,
                                              cfg["vocab_size"])]
    keep = int(traffic.rng(seed, 5).integers(nb))
    with torch.no_grad():
        for b in batches:
            model.forward(params, b)
        _sync(dev)
        setup_s = time.perf_counter() - t_start

        kept, prev, i = None, None, 0
        t0 = time.perf_counter()
        while True:
            out = model.forward(params, batches[i % nb])
            if i % nb == keep:
                kept = out
            del out
            ev = _event(dev)
            if prev is not None:
                prev.synchronize()
            prev = ev
            i += 1
            if time.perf_counter() - t0 >= seconds and kept is not None:
                break
        _sync(dev)
        wall = time.perf_counter() - t0
    info = harness.device_info(dev, cell["entry"]["chips"])
    tokens = i * bsz * seq
    rec = {"mode": "score", "config": cfg,
           "e2e": {"forward_tok_s": tokens / wall, "setup_s": setup_s},
           "window_s": wall, "tokens": tokens, "forwards": i,
           "flops": i * costs.forward_flops(cfg, bsz, seq),
           "peaks": costs.peaks(info["kind"]),
           "attempted": i, "failed": 0, "device": info, "trace": None}
    t1 = time.perf_counter()
    if trace:
        with torch.no_grad():
            rec["trace"] = _traced(model, params, batches,
                                   tr["trace_forwards"], dev)
        rec["trace"]["batch"], rec["trace"]["seq"] = bsz, seq
    t2 = time.perf_counter()
    del params, model
    heads = [kept.logits] + list(kept.exit_logits)
    del kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.update(_check(cell, w, batches[keep]["tokens"], heads, dev,
                      control))
    rec["phases"] = {"setup_s": setup_s, "window_s": wall,
                     "trace_s": t2 - t1,
                     "check_s": time.perf_counter() - t2}
    return rec


def _traced(model, params, batches, n: int, dev) -> dict:
    """Profile ``n`` forwards queued as the window queues them, one
    waiting behind the one that runs, after one that lets the profiler
    settle; nothing is drained, so the traced window holds the same
    overlap of host and device as the measured one."""
    with btrace.profiler() as prof:
        model.forward(params, batches[0])
        prev = _event(dev)
        t0 = time.perf_counter()
        with btrace.span("traced"):
            for i in range(n):
                with btrace.span("forward"):
                    model.forward(params, batches[(i + 1) % len(batches)])
                ev = _event(dev)
                with btrace.span("wait"):
                    if prev is not None:
                        prev.synchronize()
                prev = ev
        host_window = time.perf_counter() - t0
        _sync(dev)
    out = btrace.summarize(prof)
    out["forwards"] = n
    out["host_window_s"] = host_window
    return out


def _check(cell, w, tokens, heads, dev, control):
    """The largest logit difference against the reference, row by row."""
    cfg = cell["config"]
    ref = harness.reference(cell)
    err = ctrl = 0.0
    old = ref.no_tf32()
    try:
        for r in range(tokens.shape[0]):
            res = ref.forward(cfg, w, tokens[r])
            want = [res["logits"]] + res["exit_logits"]
            err = max(err, max(float((h[r] - x).abs().max())
                               for h, x in zip(heads, want)))
            if control:
                low = ref.forward(cfg, w, tokens[r], lowp=True)
                got = [low["logits"]] + low["exit_logits"]
                ctrl = max(ctrl, max(float((g - x).abs().max())
                                     for g, x in zip(got, want)))
            del res, want
    finally:
        ref.restore_tf32(old)
    out = {"checks": {"logit_err": err}}
    if control:
        out["control"] = {"logit_err": ctrl}
    return out
