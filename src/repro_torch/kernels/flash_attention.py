"""Flash attention kernels: launches of ``csrc/flash_attention.cu`` (the
forward) and ``csrc/flash_attention_bwd.cu`` (its gradient).

Replaces the Pallas TPU kernel ``repro/kernels/attention.py``
(``_flash_kernel``).  One block per (128-row query tile, query head,
sequence): a producer warp feeds q and a ring of 128-key k/v tiles through
TMA and mbarriers, two consumer warpgroups of 64 rows each run both
products on ``wgmma`` and take turns (ping-pong) so one's products overlap
the other's softmax; GQA by index, no padding.  The tensor maps are made
in the C entry point (``cuTensorMapEncodeTiled`` through the runtime's
entry-point query, so no link against libcuda).  On request the forward
also writes each row's log-sum-exp (fp32 [B, Nq, Sq], natural log) for
the backward.  The design notes are in the CUDA source; the plain
versions are ``kernels.ref.flash_attention_ref`` and
``kernels.ref.flash_attention_lse_ref``.

The backward replaces no Pallas kernel (the reference differentiates its
jnp ``_sdpa``).  It has the forward's Hopper shape (TMA rings, ``wgmma``,
a producer and two consumer warpgroups) and takes the forward's
log-sum-exp, so no kernel recomputes the row statistics: a pre-pass takes
D = rowsum(dO * O) from ``o``; kernel dq per (128-row query tile, query
head, sequence) accumulates dQ; kernel dkv per (128-key tile, kv head,
share of its G query heads, sequence) accumulates dK and dV, and where
the shares are more than one a last kernel sums their fp32 partials in a
fixed order.  No atomics.  Its plain version is
``kernels.ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128)          # the template instances of the kernel
BWD_KEY_TILE = 128             # keys a block of the dK/dV kernel
BWD_STAT_PAD = 128             # the backward's row statistics' padding


def attention_cuda(q, k, v, causal: bool, window: int, with_lse=False):
    """q [B, Sq, Nq, H], k/v [B, Skv, Nkv, H] bf16 on the card ->
    [B, Sq, Nq, H] bf16, and with ``with_lse`` also the rows' fp32
    log-sum-exp [B, Nq, Sq].  Launches on the current stream; raises if
    the launch is refused."""
    lib = build.library("flash_attention")
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, skv, nq, nkv, hd,
        int(causal), int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention launch")
    return (out, lse) if with_lse else out


def bwd_splits(b: int, skv: int, nkv: int, group: int, sms: int) -> int:
    """How many blocks share a kv head's G query heads in the dK/dV
    kernel: the least divisor of G that gives at least one block an SM,
    else G.  Shapes only."""
    blocks = -(-skv // BWD_KEY_TILE) * nkv * b
    for d in range(1, group + 1):
        if group % d == 0 and blocks * d >= sms:
            return d
    return group


def attention_bwd_cuda(q, k, v, o, do, lse, causal: bool, window: int):
    """dq, dk, dv of the forward above: q/o/do [B, Sq, Nq, H], k/v
    [B, Skv, Nkv, H] bf16 and the forward's log-sum-exp ``lse`` fp32
    [B, Nq, Sq] on the card -> bf16 in their shapes.  The kernels launch
    on the current stream; scratch: the rows' statistics (fp32, padded)
    and, where G is split, fp32 partial dK and dV."""
    lib = build.library("flash_attention_bwd")
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = bwd_splits(b, skv, nkv, nq // nkv, sms)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    sp = -(-sq // BWD_STAT_PAD) * BWD_STAT_PAD
    stats = torch.empty((2, b, nq, sp), dtype=torch.float32, device=q.device)
    part = (torch.empty((splits, 2, *k.shape), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), None if part is None else part.data_ptr(), b, sq,
        skv, nq, nkv, hd, int(causal), int(window), 1.0 / math.sqrt(hd),
        splits, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd launch")
    return dq, dk, dv
