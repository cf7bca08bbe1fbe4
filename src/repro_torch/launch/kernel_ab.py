"""A redesigned kernel against an earlier version of it, in one process on
one card.

    python -m repro_torch.launch.kernel_ab --parent DIR [--kernels exit_head
        flash_attention flash_attention_bwd paged_attention paged_mla
        feature_compress] [--json PATH]
    python -m repro_torch.launch.kernel_ab --parent DIR --second-thread
        [--json PATH]

``DIR`` is a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``).  Each named kernel's
CUDA source under ``DIR/src/repro_torch/kernels/csrc/`` is compiled with
the current build flags and called through its C entry point as that
commit declared it (the exit head and the paged kernels, whose C interface
is the current one, through the current wrapper with the parent's library
swapped in); the current kernel is called through ``kernels.ops``.
Both are checked against the plain version on the same inputs, then timed
with CUDA events in turns over three rounds (the order reversed every
other round), with the library call beside them, at the main path's
shapes:

  exit_head        x [16, 2048] / W [2048, 49155] (granite-3-2b) and
                   x [16, 7168] / W [7168, 129280] (deepseek-v3);
  flash_attention  q [8, 2048, 32, 64], k/v [8, 2048, 8, 64], causal, and
                   the head dim 128 rows of chip_smoke.py's phase 2:
                   starcoder2-3b [1, 8192, 24, 128] / 2 heads, window
                   4096; qwen2-vl-2b [2, 2048, 12, 128] / 2; llama4
                   [2, 2048, 40, 128] / 8 (the current kernel also with its
                   log-sum-exp output);
  flash_attention_bwd  the backward at chip_smoke.py's four shapes: granite
                   q [4, 1024, 32, 64] / k, v 8 heads, causal, and with
                   window 256; whisper's cross q [16, 448, 8, 64] / k, v
                   [16, 1500, 8, 64], no mask; qwen2-vl q [2, 2048, 12,
                   128] / 2 heads, causal (the parent given the current
                   forward's o; the library call SDPA's backward alone);
  paged_attention  q [16, 1, 32, 64], pools [2048, 16, 8, 64], positions
                   below 2048 (granite-3-2b decode), and at serving's
                   lengths: 18-page tables, positions below 288 (phase 4
                   of chip_smoke.py); four pool copies each;
  paged_mla        q_lat [16, 1, 128, 512], q_rope [16, 1, 128, 64], pools
                   [2048, 16, 512] / [2048, 16, 64], positions below 2048
                   (deepseek-v3 decode), and 9-page tables, positions below
                   144 (phase 6); four pool copies each;
  feature_compress quantize_rows and dequantize_rows (to bf16) on the
                   granite-3-2b slot leaf [655360, 64] bf16 and the
                   deepseek-v3 c_kv slot leaf [124928, 512] bf16, two
                   copies each (so every call reads from HBM); no library
                   call computes either, so only the two versions.

The paged kernels' library call is one scaled_dot_product_attention on
the gathered view (gathered beforehand, not timed).  Prints each timing's
median and spread (max - min over the rounds).

``--second-thread`` times nothing: it launches paged GQA, paged MLA and
both exit-head instances at chip_smoke.py phase 15 (e)'s shapes
(``serving_calls``) once on the main thread and then from a new host
thread, first through the parent's libraries and then through the current
ones, and reports for each launch whether the second thread's was refused
and, where it ran, whether its bits equal the main thread's.

The card is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, exit_head, ops, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# the C entry points as the earlier sources declare them; the exit head
# and the paged kernels: as the current ones (the parent is called through
# the current wrapper with its library swapped in, ``swapped``)
PARENT_SIGNATURES = {
    "exit_head": build.SIGNATURES["exit_head"],
    "paged_attention": build.SIGNATURES["paged_attention"],
    "paged_mla": build.SIGNATURES["paged_mla"],
    "flash_attention": {
        "repro_flash_attention": (
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    },
    # as the sources before the forward wrote its log-sum-exp declare it:
    # fp32 scratch for the log-sum-exp and D, which the kernels made
    "flash_attention_bwd": {
        "repro_flash_attention_bwd": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _I, _I, _F, _P], _I),
    },
    # as the sources before the host plan picked an instance declare them
    "feature_compress": {
        "repro_quantize_rows": ([_P, _I, _P, _P, _L, _I, _P], _I),
        "repro_dequantize_rows": ([_P, _P, _P, _I, _L, _I, _P], _I),
    },
}


def parent_library(parent: Path, name: str) -> ctypes.CDLL:
    src = parent / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    out = build.BUILD_DIR / "parent" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_ab: the parent's {name} did not build\n"
                           + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in PARENT_SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def swapped(name, lib, fn):
    """``fn``, a current wrapper, launching the parent's library ``lib`` of
    kernel ``name`` in place of the current one (a parent whose C
    interface is the current one)."""
    def call(*a, **kw):
        cur = build.library(name)
        build._LIBS[name] = lib
        try:
            return fn(*a, **kw)
        finally:
            build._LIBS[name] = cur
    return call


def parent_flash(lib, window=0):
    def call(q, k, v):
        b, sq, nq, hd = q.shape
        out = torch.empty_like(q)
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], nq, k.shape[2], hd, 1, window, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream), "parent flash")
        return out
    return call


FLASH_SHAPES = {   # (B, S, Nq, Nkv, H, window), causal
    "": (8, 2048, 32, 8, 64, 0),
    " starcoder2-3b": (1, 8192, 24, 2, 128, 4096),
    " qwen2-vl-2b": (2, 2048, 12, 2, 128, 0),
    " llama4-maverick": (2, 2048, 40, 8, 128, 0),
}


def parent_flash_bwd(lib, causal, window):
    def call(q, k, v, o, do, lse):   # (the parent recomputes lse)
        b, sq, nq, hd = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        scratch = torch.empty((2, b, nq, sq), dtype=torch.float32,
                              device=q.device)
        build.check(lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(), b, sq, k.shape[1],
            nq, k.shape[2], hd, int(causal), int(window),
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream),
            "parent flash bwd")
        return dq, dk, dv
    return call


BWD_SHAPES = {     # (B, Sq, Skv, Nq, Nkv, H, causal, window), as chip_smoke
    "granite": (4, 1024, 1024, 32, 8, 64, True, 0),
    "granite window 256": (4, 1024, 1024, 32, 8, 64, True, 256),
    "whisper cross": (16, 448, 1500, 8, 8, 64, False, 0),
    "qwen2-vl H 128": (2, 2048, 2048, 12, 2, 128, True, 0),
}


def sdpa_bwd(q, k, v, do, causal, window):
    """SDPA's backward alone on the BHSD views (the forward's graph
    retained); a window goes in as a boolean mask."""
    from repro_torch.models.attention import make_mask
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    mask = None
    if window:
        mask = make_mask(q.shape[1], k.shape[1], causal=causal,
                         window=window, device=q.device)
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
        enable_gqa=True)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),
                                   retain_graph=True)
    return call


def parent_int8(lib):
    """The earlier quantize and dequantize (to bf16) kernels."""
    def quant(x):
        t, d = x.shape
        q = torch.empty((t, d), dtype=torch.int8, device=x.device)
        s = torch.empty((t, 1), dtype=torch.float32, device=x.device)
        build.check(lib.repro_quantize_rows(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            s.data_ptr(), t, d, torch.cuda.current_stream().cuda_stream),
            "parent quantize")
        return q, s

    def dequant(q, s):
        t, d = q.shape
        out = torch.empty((t, d), dtype=torch.bfloat16, device=q.device)
        build.check(lib.repro_dequantize_rows(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), 1, t, d,
            torch.cuda.current_stream().cuda_stream), "parent dequantize")
        return out
    return quant, dequant


def _bits_equal(a, b):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    a = a.view(view[a.dtype]) if a.dtype in view else a
    b = b.view(view[b.dtype]) if b.dtype in view else b
    return bool(torch.equal(a, b))


def _table(gen, b, page, pps, max_pos):
    """Ragged positions below ``max_pos`` and a shuffled page table whose
    entries past each sequence's last page are the sentinel n_pages."""
    pos = torch.randint(0, max_pos, (b,), generator=gen, device="cuda",
                        dtype=torch.int32)
    n_pages = b * pps
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    tbl = perm.to(torch.int32).reshape(b, pps).clone()
    cols = torch.arange(pps, device="cuda")[None, :]
    tbl = torch.where(cols < (pos.long() // page + 1)[:, None], tbl,
                      torch.full_like(tbl, n_pages))
    return tbl, pos


def paged_inputs(gen, b, nq, nkv, hd, page, pps, max_pos, sets):
    """Paged-GQA inputs: ``sets`` independent q and pool copies (so timed
    launches do not reuse L2) over one ragged table."""
    tbl, pos = _table(gen, b, page, pps, max_pos)
    out = []
    for _ in range(sets):
        q = torch.randn(b, 1, nq, hd, generator=gen, device="cuda").bfloat16()
        pk, pv = (torch.randn(b * pps, page, nkv, hd, generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        out.append((q, pk, pv, tbl, pos))
    return out


def mla_inputs(gen, b, n, r, hr, page, pps, max_pos, sets):
    """Paged-MLA inputs like ``paged_inputs``."""
    tbl, pos = _table(gen, b, page, pps, max_pos)
    out = []
    for _ in range(sets):
        ql = torch.randn(b, 1, n, r, generator=gen, device="cuda").bfloat16()
        qr = torch.randn(b, 1, n, hr, generator=gen, device="cuda").bfloat16()
        pc = torch.randn(b * pps, page, r, generator=gen,
                         device="cuda").bfloat16()
        pk = torch.randn(b * pps, page, hr, generator=gen,
                         device="cuda").bfloat16()
        out.append((ql, qr, pc, pk, tbl, pos))
    return out


def sdpa_gathered():
    """The library yardstick for paged GQA: one
    scaled_dot_product_attention call on the gathered view, kv heads
    repeated to the query heads.  ``prep`` gathers (not timed)."""
    def prep(q, pk, pv, tbl, pos):
        from repro_torch.models.attention import paged_view
        g = q.shape[2] // pk.shape[2]
        k = paged_view(pk, tbl).transpose(1, 2).repeat_interleave(g, dim=1)
        v = paged_view(pv, tbl).transpose(1, 2).repeat_interleave(g, dim=1)
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        return (q.transpose(1, 2), k, v, mask)

    def call(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return prep, call


def sdpa_mla_gathered(scale):
    """The library yardstick for paged MLA: one
    scaled_dot_product_attention call on the gathered latent view, the N
    heads as N queries of one head (MLA is multi-query in latent space):
    q [B, 1, N, R+Hr], k [B, 1, S, R+Hr], v = c_kv [B, 1, S, R].  ``prep``
    gathers and concatenates (not timed)."""
    def prep(ql, qr, pc, pk, tbl, pos):
        from repro_torch.models.attention import paged_view
        ckv = paged_view(pc, tbl)
        k = torch.cat([ckv, paged_view(pk, tbl)], dim=-1)[:, None]
        q = torch.cat([ql, qr], dim=-1)
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        return (q, k, ckv[:, None], mask)

    def call(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)
    return prep, call


def device_ms(fn, args_list, iters=20):
    """Device time of one call: CUDA events around ``iters`` calls, cycling
    through ``args_list``, queued behind a sleep kernel so host enqueue
    time is not counted."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    e0.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def interleaved(fns, args_list, rounds, iters):
    """Time each of ``fns`` (name -> callable) ``rounds`` times, the order
    reversed every other round; returns name -> {median, spread, all}.
    ``args_list`` maps a name to its argument tuples, or is one list for
    all."""
    names = list(fns)
    if not isinstance(args_list, dict):
        args_list = {n: args_list for n in names}
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(device_ms(fns[n], args_list[n], iters))
    return {n: {"median_ms": statistics.median(t),
                "spread_ms": max(t) - min(t), "ms": t}
            for n, t in times.items()}


def entropy_library(x, w):
    logp = torch.log_softmax(torch.matmul(x, w).float(), dim=-1)
    return -(logp.exp() * logp).sum(-1)


def sdpa(q, k, v):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def run(parent: Path, kernels, rounds: int = 3):
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    if "exit_head" in kernels:
        old = swapped("exit_head", parent_library(parent, "exit_head"),
                      ops.exit_head_entropy)
        for label, d, v in (("granite", 2048, 49155),
                            ("deepseek", 7168, 129280)):
            x = torch.randn(16, d, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(d, v, generator=gen, device="cuda")
                 / math.sqrt(d)).bfloat16()
            want = ref.exit_head_entropy_ref(x, w)
            errs = {n: (f(x, w) - want).abs().max().item() for n, f in
                    (("parent", old), ("current", ops.exit_head_entropy))}
            r = interleaved({"library": entropy_library, "parent": old,
                             "current": ops.exit_head_entropy},
                            [(x, w)], rounds, 10)
            r["max_abs_err"] = errs
            results[f"exit_head_{label}"] = r
            print(f"exit_head {label} x {tuple(x.shape)} w {tuple(w.shape)}: "
                  f"{json.dumps(r)}", flush=True)
            del x, w
    if "flash_attention" in kernels:
        lib_fwd = parent_library(parent, "flash_attention")
        for label, (b, s, nq, nkv, hd, window) in FLASH_SHAPES.items():
            old = parent_flash(lib_fwd, window)
            q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
                       .bfloat16() for n in (nq, nkv, nkv))

            def cur(*a, window=window):
                return ops.flash_attention(*a, causal=True, window=window)

            def cur_lse(*a, window=window):
                return ops.flash_attention_with_lse(*a, causal=True,
                                                    window=window)

            def lib(q, k, v, window=window):
                if not window:
                    return sdpa(q, k, v)
                from repro_torch.models.attention import make_mask
                mask = make_mask(q.shape[1], k.shape[1], causal=True,
                                 window=window, device=q.device)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True).transpose(1, 2)
            want = ref.flash_attention_ref(q, k, v, window=window).float()

            def err(f):
                diff = (f(q, k, v).float() - want).abs()
                return (diff / want.abs().clamp(min=1)).max().item()
            errs = {"parent": err(old), "current": err(cur)}
            r = interleaved({"library": lib, "parent": old, "current": cur,
                             "current_lse": cur_lse}, [(q, k, v)], rounds,
                            20)
            r["max_err_of_max1_plain"] = errs
            results["flash_attention" + label] = r
            print(f"flash_attention{label} q {tuple(q.shape)} k "
                  f"{tuple(k.shape)} window {window}: {json.dumps(r)}",
                  flush=True)
            del q, k, v, want
    if "flash_attention_bwd" in kernels:
        lib_bwd = parent_library(parent, "flash_attention_bwd")
        for label, shape in BWD_SHAPES.items():
            b, sq, skv, nq, nkv, hd, causal, window = shape
            q, do = (torch.randn(b, sq, nq, hd, generator=gen, device="cuda")
                     .bfloat16() for _ in range(2))
            k, v = (torch.randn(b, skv, nkv, hd, generator=gen, device="cuda")
                    .bfloat16() for _ in range(2))
            o, lse = ops.flash_attention_with_lse(q, k, v, causal=causal,
                                                  window=window)
            args = [(q, k, v, o, do, lse)]
            old = parent_flash_bwd(lib_bwd, causal, window)

            def cur(*a, causal=causal, window=window):
                return ops.flash_attention_bwd(*a, causal=causal,
                                               window=window)
            want = ref.flash_attention_bwd_ref(*args[0], causal=causal,
                                               window=window)
            errs = {n: max(((a.float() - w.float()).abs()
                            / w.float().abs().clamp(min=1)).max().item()
                           for a, w in zip(f(*args[0]), want))
                    for n, f in (("parent", old), ("current", cur))}
            r = interleaved({"library": sdpa_bwd(q, k, v, do, causal,
                                                 window),
                             "parent": old, "current": cur},
                            {"library": [()], "parent": args,
                             "current": args}, rounds, 20)
            r["max_err_of_max1_plain"] = errs
            results[f"flash_attention_bwd {label}"] = r
            print(f"flash_attention_bwd {label} q {tuple(q.shape)} k "
                  f"{tuple(k.shape)}: {json.dumps(r)}", flush=True)
            del q, k, v, o, do, lse, args, want
    if "paged_attention" in kernels:
        old = swapped("paged_attention",
                      parent_library(parent, "paged_attention"),
                      ops.paged_gqa_attention)
        prep, lib = sdpa_gathered()
        for label, pps, max_pos in (("", 128, 2048), ("_serving", 18, 288)):
            sets = paged_inputs(gen, 16, 32, 8, 64, 16, pps, max_pos, 4)
            want = ref.paged_gqa_attention_ref(*sets[0]).float()
            errs = {n: (f(*sets[0]).float() - want).abs().max().item()
                    for n, f in (("parent", old),
                                 ("current", ops.paged_gqa_attention))}
            r = interleaved({"library": lib, "parent": old,
                             "current": ops.paged_gqa_attention},
                            {"library": [prep(*a) for a in sets],
                             "parent": sets, "current": sets}, rounds, 20)
            r["max_abs_err"] = errs
            results["paged_attention" + label] = r
            print(f"paged_attention q {tuple(sets[0][0].shape)} pools "
                  f"{tuple(sets[0][1].shape)} positions < {max_pos}: "
                  f"{json.dumps(r)}", flush=True)
            del sets
    if "paged_mla" in kernels:
        scale = 1.0 / math.sqrt(128 + 64)
        def cur(*a):
            return ops.paged_mla_attention(*a, scale=scale)
        old = swapped("paged_mla", parent_library(parent, "paged_mla"), cur)
        prep, lib = sdpa_mla_gathered(scale)
        for label, pps, max_pos in (("", 128, 2048), ("_serving", 9, 144)):
            sets = mla_inputs(gen, 16, 128, 512, 64, 16, pps, max_pos, 4)
            want = ref.paged_mla_attention_ref(*sets[0], scale=scale)
            errs = {n: (f(*sets[0]) - want).abs().max().item()
                    for n, f in (("parent", old), ("current", cur))}
            r = interleaved({"library": lib, "parent": old, "current": cur},
                            {"library": [prep(*a) for a in sets],
                             "parent": sets, "current": sets}, rounds, 20)
            r["max_abs_err"] = errs
            results["paged_mla" + label] = r
            print(f"paged_mla q_lat {tuple(sets[0][0].shape)} pools "
                  f"{tuple(sets[0][2].shape)} positions < {max_pos}: "
                  f"{json.dumps(r)}", flush=True)
            del sets
    if "feature_compress" in kernels:
        old_q, old_d = parent_int8(parent_library(parent, "feature_compress"))

        def cur_d(q, s):
            return ops.decompress_rows(q, s, dtype=torch.bfloat16)
        for label, rows, d in (("granite", 655360, 64),
                               ("deepseek_c_kv", 124928, 512)):
            xs = [torch.randn(rows, d, generator=gen, device="cuda")
                  .bfloat16() for _ in range(2)]
            qs = [ops.compress_rows(x) for x in xs]
            qr, sr = ref.quantize_rows_ref(xs[0])
            yr = ref.dequantize_rows_ref(qr, sr, torch.bfloat16)
            exact = {}
            for n, fq, fd in (("parent", old_q, old_d),
                              ("current", ops.compress_rows, cur_d)):
                q, s = fq(xs[0])
                exact[n] = (_bits_equal(q, qr) and _bits_equal(s, sr)
                            and _bits_equal(fd(qr, sr), yr))
            for kname, fns, args in (
                    ("quantize_rows", {"parent": old_q,
                                       "current": ops.compress_rows},
                     [(x,) for x in xs]),
                    ("dequantize_rows", {"parent": old_d, "current": cur_d},
                     qs)):
                r = interleaved(fns, args, rounds, 20)
                r["bit_exact"] = exact
                results[f"{kname}_{label}"] = r
                print(f"{kname} {label} [{rows}, {d}] bf16: "
                      f"{json.dumps(r)}", flush=True)
            del xs, qs
    return results


def serving_calls(gen, wrap=lambda name, fn: fn):
    """Phase 15 (e)'s launches: paged GQA at serving's 18-page tables
    (positions below 288), paged MLA at 9 pages (below 144), and the exit
    head's two instances at x [16, 2048] (granite's vocab 49155, odd pitch;
    32000, aligned).  ``name -> () -> output``; ``wrap(kernel, fn)`` may
    swap another library in (``swapped``)."""
    (pa,) = paged_inputs(gen, 16, 32, 8, 64, 16, 18, 288, 1)
    (ma,) = mla_inputs(gen, 16, 128, 512, 64, 16, 9, 144, 1)
    x = torch.randn(16, 2048, generator=gen, device="cuda").bfloat16()
    heads = {}
    for v in (49155, 32000):
        w = (torch.randn(2048, v, generator=gen, device="cuda")
             / math.sqrt(2048)).bfloat16()
        heads[exit_head.plan(16, 2048, v, w.data_ptr())["instance"]] = w
    if sorted(heads) != ["aligned", "odd_pitch"]:
        raise RuntimeError(f"exit head instances {sorted(heads)}")
    scale = 1.0 / math.sqrt(192)
    gqa = wrap("paged_attention", ops.paged_gqa_attention)
    mla = wrap("paged_mla", ops.paged_mla_attention)
    ent = wrap("exit_head", ops.exit_head_entropy)
    return {"paged_gqa_attention": lambda: gqa(*pa),
            "paged_mla_attention": lambda: mla(*ma, scale=scale),
            "exit_head_entropy odd_pitch": lambda: ent(x, heads["odd_pitch"]),
            "exit_head_entropy aligned": lambda: ent(x, heads["aligned"])}


def launch_in_thread(calls):
    """Each call once, in order, on a new host thread.  Returns
    ``(outputs, errors)``: a refused launch is in ``errors`` by name, and
    the thread goes on to the next call."""
    outs, errors = {}, {}

    def work():
        for k, fn in calls.items():
            try:
                outs[k] = fn()
                torch.cuda.synchronize()
            except Exception as exc:     # reported to the caller
                errors[k] = repr(exc)
    worker = threading.Thread(target=work)
    worker.start()
    worker.join()
    return outs, errors


def second_thread(parent: Path):
    """The parent's and the current serving kernels, each launched on the
    main thread and then from a second host thread (``--second-thread``)."""
    libs = {n: parent_library(parent, n)
            for n in ("paged_attention", "paged_mla", "exit_head")}
    results = {}
    for label, wrap in (("parent", lambda n, fn: swapped(n, libs[n], fn)),
                        ("current", lambda n, fn: fn)):
        calls = serving_calls(torch.Generator(device="cuda").manual_seed(15),
                              wrap)
        main_out = {k: fn() for k, fn in calls.items()}
        torch.cuda.synchronize()
        outs, errors = launch_in_thread(calls)
        results[label] = {
            k: {"refused": errors.get(k),
                "bits_equal": (bool(torch.equal(outs[k], main_out[k]))
                               if k in outs else None)}
            for k in calls}
        print(f"{label}: {json.dumps(results[label])}", flush=True)
    return results


KERNELS = ["exit_head", "flash_attention", "flash_attention_bwd",
           "paged_attention", "paged_mla", "feature_compress"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--kernels", nargs="+", default=KERNELS,
                    choices=KERNELS)
    ap.add_argument("--json", default="")
    ap.add_argument("--second-thread", action="store_true",
                    help="launch the serving kernels from a second host "
                         "thread, parent and current, instead of timing")
    args = ap.parse_args(argv)
    if args.second_thread:
        args.kernels = ["exit_head", "paged_attention", "paged_mla"]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, log in build.build_all(args.kernels).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    results = (second_thread(args.parent) if args.second_thread
               else run(args.parent, args.kernels))
    results["card"] = smi.stdout.strip()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
