"""Flash attention kernels: launches of ``csrc/flash_attention.cu`` (the
forward) and ``csrc/flash_attention_bwd.cu`` (its gradient).

Replaces the Pallas TPU kernel ``repro/kernels/attention.py``
(``_flash_kernel``).  One block per (128-row query tile, query head,
sequence): a producer warp feeds q and a ring of 128-key k/v tiles through
TMA and mbarriers, two consumer warpgroups of 64 rows each run both
products on ``wgmma`` and take turns (ping-pong) so one's products overlap
the other's softmax; GQA by index, no padding.  The tensor maps are made
in the C entry point (``cuTensorMapEncodeTiled`` through the runtime's
entry-point query, so no link against libcuda).  The design notes are
in the CUDA source; the plain version is
``kernels.ref.flash_attention_ref``.

The backward replaces no Pallas kernel (the reference differentiates its
jnp ``_sdpa``): kernel A per (64-row query tile, query head, sequence)
recomputes each row's log-sum-exp, takes D = rowsum(dO * O), writes both
to fp32 scratch and accumulates dQ; kernel B per (64-key tile, kv head,
sequence) walks the G query heads and the query tiles that see its keys
and accumulates dK and dV.  No atomics.  Its plain version is
``kernels.ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128)          # the template instances of the kernel


def attention_cuda(q, k, v, causal: bool, window: int):
    """q [B, Sq, Nq, H], k/v [B, Skv, Nkv, H] bf16 on the card ->
    [B, Sq, Nq, H] bf16.  Launches on the current stream; raises if the
    launch is refused."""
    lib = build.library("flash_attention")
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        nq, nkv, hd, int(causal), int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention launch")
    return out


def attention_bwd_cuda(q, k, v, o, do, causal: bool, window: int):
    """dq, dk, dv of the forward above: q/o/do [B, Sq, Nq, H], k/v
    [B, Skv, Nkv, H] bf16 on the card -> bf16 in their shapes.  The two
    kernels launch on the current stream, A before B, with a fp32
    log-sum-exp and D [B, Nq, Sq] between them."""
    lib = build.library("flash_attention_bwd")
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lse = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
    dd = torch.empty_like(lse)
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), b, sq, skv, nq, nkv, hd, int(causal), int(window),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd launch")
    return dq, dk, dv
