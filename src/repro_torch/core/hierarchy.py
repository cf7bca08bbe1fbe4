"""Hierarchical (cloud-edge-device) distributed DNN — DDNN [65] + the
staged execution of a partitioned model.

Planner side: `ddnn_placement` maps plan segments to a 3-tier hierarchy and
computes the communication-cost reduction that local (device-tier) exits buy
— the survey's Table 5 "communication cost reduction: 20x" claim.

Runtime side: `staged_forward` executes a partitioned model across the
mesh's "pod" axis of a world of ranks (``launch.mesh``): pod p computes
only the scan blocks it owns (real divergence: the other pods do not run
them), and the boundary activation goes from its owner to the next stage
over a host-staged ``send`` / ``recv``, optionally int8-compressed by the
kernel pair ``kernels.ops.compress_rows`` / ``decompress_rows``.  This is
the executable form of the survey's Fig. 3/6: the split a cloud-edge
deployment makes, its boundary crossing a network.

A copy of the reference package's ``core/hierarchy.py``; its
``collective_permute`` is the send/recv pair, and its ``psum`` of the last
stage's logits against zeros is a broadcast from the last stage.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import (CostGraph, DeviceProfile, LinkProfile,
                                         compute_time)
from repro_torch.kernels import ops as kops
from repro_torch.models import blocks as B
from repro_torch.models.common import apply_norm, unembed
from repro_torch.models.ffn import ShardCtx
from repro_torch.sharding import comm
from repro_torch.sharding.specs import local_slice


@dataclass(frozen=True)
class Tier:
    name: str                     # device | edge | cloud
    profile: DeviceProfile
    uplink: Optional[LinkProfile]  # link towards the next tier up


@dataclass(frozen=True)
class DDNNPlacement:
    tier_of_segment: Tuple[str, ...]
    local_exit_fraction: float    # fraction resolved at the device tier
    latency: float
    comm_bytes: float
    comm_bytes_cloud_only: float

    @property
    def comm_reduction(self) -> float:
        return self.comm_bytes_cloud_only / max(self.comm_bytes, 1e-9)


def ddnn_placement(graph: CostGraph, tiers: Sequence[Tier],
                   exit_probs: Sequence[float],
                   aggregate_factor: float = 64.0) -> DDNNPlacement:
    """Place segments greedily across tiers (device -> edge -> cloud) so each
    tier takes segments until its compute share balances its uplink cost;
    exits at tier boundaries resolve a fraction of inputs locally (DDNN's
    local/edge/cloud exits).

    `aggregate_factor`: DDNN ships the exit head's AGGREGATED feature across
    tier boundaries (max-pooled summaries, [65] "local aggregation"), not the
    raw activation map — tier-crossing bytes are out_bytes/aggregate_factor.
    This aggregation is what buys the paper's ~20x communication-cost
    reduction."""
    n = len(graph.segments)
    n_tiers = len(tiers)
    # boundaries: device gets segments up to the first exit, edge up to the
    # second, cloud the rest (DDNN's structure: one exit per tier boundary)
    exit_segs = [i for i, s in enumerate(graph.segments) if s.has_exit_after]
    b1 = exit_segs[0] + 1 if exit_segs else max(1, n // 3)
    b2 = exit_segs[1] + 1 if len(exit_segs) > 1 else max(b1 + 1, 2 * n // 3)
    tier_of = tuple(
        ("device" if i < b1 else ("edge" if i < b2 else "cloud"))
        for i in range(n))

    p_exit_dev = exit_probs[0] if exit_probs else 0.0
    p_exit_edge = exit_probs[1] if len(exit_probs) > 1 else 0.0
    dev, edge, cloud = tiers[0], tiers[min(1, n_tiers - 1)], tiers[-1]

    lat = 0.0
    comm = 0.0
    alive = 1.0
    for i, seg in enumerate(graph.segments):
        tier = {"device": dev, "edge": edge, "cloud": cloud}[tier_of[i]]
        lat += alive * compute_time(seg.flops, tier.profile)
        if i + 1 < n and tier_of[i] != tier_of[i + 1]:
            if tier_of[i] == "device":
                alive *= (1.0 - p_exit_dev)
                link = dev.uplink
            else:
                alive *= (1.0 - p_exit_edge)
                link = edge.uplink
            shipped = seg.out_bytes / aggregate_factor
            comm += alive * shipped
            lat += alive * link.tx_time(shipped)
    cloud_only = graph.input_bytes          # raw input straight to cloud
    return DDNNPlacement(tier_of, p_exit_dev, lat, comm, cloud_only)


# ---------------------------------------------------------------------------
# Staged execution across the pod axis (runtime)
# ---------------------------------------------------------------------------

def _quantize_int8(x):
    """Per-row symmetric int8 quantization of the boundary activation:
    (q int8, scale fp32 [..., 1]), scale = max(amax * fl(1/127), 1e-8) (the
    reference's formula as ``jax.jit`` compiles it), on the card the
    quantize kernel."""
    return kops.compress_rows(x.contiguous())


def _dequantize_int8(q, scale, dtype):
    return kops.decompress_rows(q, scale, dtype)


def _check_stages(stages: Sequence[int], n_blocks: int) -> List[int]:
    stages = list(stages)
    assert len(stages) == n_blocks, (stages, n_blocks)
    assert all(b <= a for b, a in zip(stages, stages[1:])) or \
           all(a <= b for a, b in zip(stages, stages[1:])), "stages must be monotone"
    return stages


def _shared_attn_owner(stages: Sequence[int], bi: int) -> int:
    """The pod that runs a shared-attention site reached after ``bi`` scan
    blocks: the reference's rule as it is."""
    return stages[min(bi, len(stages) - 1) - 1] if bi else stages[0]


def stage_parts(model, stage_of_block: Sequence[int], pod: int):
    """``Model.init``'s ``keep`` for pod ``pod``: the scan blocks it owns,
    the embedding where it embeds (the first stage) or reads the tied head
    (the last), the final norm and head on the last stage, the shared
    attention where one of its sites runs, and the encoder everywhere
    (every pod encodes); no exit head (staged execution runs none)."""
    stages = _check_stages(stage_of_block, sum(
        1 for s in model.plan if s[0] == "scan"))
    first, last = stages[0], stages[-1]
    shared, bi = set(), 0
    for step in model.plan:
        if step[0] == "scan":
            bi += 1
        elif step[0] == "shared_attn":
            shared.add(_shared_attn_owner(stages, bi))
    tied = model.cfg.tie_embeddings

    def keep(part) -> bool:
        if isinstance(part, tuple):
            return stages[part[1]] == pod
        if part == "embed":
            return pod == first or (tied and pod == last)
        if part in ("final_norm", "lm_head"):
            return pod == last
        if part == "shared_attn":
            return pod in shared
        return part in ("encoder", "enc_norm")
    return keep


def stage_params(params, model, stage_of_block: Sequence[int], pod: int):
    """The part of a full params tree that pod ``pod`` holds
    (``stage_parts``): the same tensors, the rest left out."""
    keep = stage_parts(model, stage_of_block, pod)
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "blocks":
            out[k] = [b if keep(("blocks", i)) else None
                      for i, b in enumerate(v)]
        elif keep(k):
            out[k] = v
    return out


def staged_forward(model, params, batch, stage_of_block: Sequence[int],
                   mesh, *, compress_boundary: bool = False,
                   long_mode: bool = False,
                   handoffs: Optional[list] = None):
    """Run the model partitioned across the `pod` axis of ``mesh`` (a
    ``DeviceMesh`` of the world, ``launch.mesh.make_host_mesh``); every
    rank calls it with the same arguments.

    stage_of_block[i] = pod index owning scan-block i (monotone, either
    way).  ``params`` needs only what this rank's pod uses
    (``stage_params``).  ``batch`` is the global batch; a rank takes its
    rows over "data" (M-RoPE positions [3, B, S] on dim 1), and every pod
    encodes an encdec batch's frames.  Rank p of the pod group runs only
    the scan blocks it owns; at an ownership change the boundary goes
    from owner to next (int8 and scales with ``compress_boundary``).
    Exit heads are skipped.  The head runs on the last stage and its
    logits go to every pod; the data shards are gathered, so every rank
    returns the global fp32 logits [B, S, V].

    ``handoffs``: a list that gets one record a boundary this rank sends
    or receives: the block it follows, the pods, the bytes, and the ms of
    its side (the sender: quantize, copy to the host and send; the
    receiver: copy to the device and dequantize); also the activation
    shipped or landed (``x``) and, compressed, ``q`` and ``scale``; and
    one record ("side" "head") of the logits' broadcast from the last
    stage.  Recording synchronizes the card around each timed part."""
    cfg = model.cfg
    names = tuple(mesh.mesh_dim_names)
    assert "pod" in names, "staged execution needs a pod axis"
    stages = _check_stages(stage_of_block, sum(
        1 for s in model.plan if s[0] == "scan"))
    ctx = ShardCtx(mesh)
    coords = ctx.coords
    my_pod = coords["pod"]
    dev = model.device

    def rank_of(pod: int) -> int:
        at = dict(coords, pod=pod)
        return int(mesh.mesh[tuple(at[a] for a in names)])

    bsz, seq = batch["tokens"].shape
    tf = model.frontend_tokens_of(batch)
    positions = model.positions_for(bsz, seq, tf)
    window = model._window(long_mode)
    dax = "data" if "data" in names else None

    def rows(t, dim=0):                     # this rank's shard over "data"
        spec = tuple(dax if i == dim else None for i in range(t.ndim))
        return local_slice(t, spec, mesh, coords).to(dev)
    local = {k: rows(v) for k, v in batch.items()}
    positions = rows(positions, 1 if positions.ndim == 3 else 0)
    enc_out = (model.encode(params, local["frames"])
               if cfg.family == "encdec" else None)

    # the live activation: on the first stage's pod, then wherever the
    # last handoff took it (None elsewhere, where the reference's
    # ppermute leaves zeros that nothing reads)
    x = model.embed_inputs(params, local) if my_pod == stages[0] else None
    bi = 0
    for step in model.plan:
        if step[0] == "scan":
            owner = stages[bi]
            if my_pod == owner:
                x, _ = B.run_scan_block(cfg, step[1], params["blocks"][bi], x,
                                        positions, window, enc_out)
            nxt = stages[bi + 1] if bi + 1 < len(stages) else owner
            if nxt != owner:
                if my_pod == owner:
                    _send_boundary(x, rank_of(nxt), compress_boundary,
                                   handoffs, bi, owner, nxt)
                    x = None
                elif my_pod == nxt:
                    x = _recv_boundary(local["tokens"].shape + (cfg.d_model,),
                                       rank_of(owner), dev, compress_boundary,
                                       handoffs, bi, owner, nxt)
                else:
                    x = None
            bi += 1
        elif step[0] == "shared_attn":
            # the reference runs the site on its owner whatever that pod
            # holds; where a handoff has just left zeros there, nothing
            # reads the result, so the port skips it
            if my_pod == _shared_attn_owner(stages, bi) and x is not None:
                x = B.run_shared_attn(cfg, params["shared_attn"], x,
                                      positions, window)
        # exits are accounted by the planner; staged runtime skips heads
    last = stages[-1]
    b_loc = local["tokens"].shape[0]
    if my_pod == last:
        h = apply_norm(cfg.norm, x, params["final_norm"])
        logits = unembed(h, params["lm_head"] if "lm_head" in params
                         else params["embed"])
    else:
        logits = torch.empty((b_loc, seq, cfg.vocab_size),
                             dtype=torch.float32, device=dev)
    if handoffs is not None:
        _sync(dev)
        t0 = time.perf_counter()
    comm.broadcast(logits, last, ctx.group("pod"))
    if handoffs is not None:
        _sync(dev)
        handoffs.append({"block": bi - 1, "src": last, "dst": None,
                         "side": "head", "bytes": logits.numel() * 4,
                         "ms": (time.perf_counter() - t0) * 1e3})
    if dax and ctx.shape[dax] > 1:
        logits = comm.all_gather(logits, ctx.group(dax))
    return logits


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


# the activation's dtype: the embedding table's (every rank >= 2 leaf is
# made bf16), which the reference's x0 has on every pod
ACT_DTYPE = torch.bfloat16


def _send_boundary(x, dst, compress, handoffs, bi, owner, nxt):
    assert x.dtype == ACT_DTYPE, x.dtype
    if handoffs is not None:
        _sync(x.device)
    t0 = time.perf_counter()
    if compress:
        q, s = _quantize_int8(x)
        comm.send(q, dst)
        comm.send(s, dst)
        nbytes = q.numel() * q.element_size() + s.numel() * s.element_size()
    else:
        comm.send(x, dst)
        nbytes = x.numel() * x.element_size()
    if handoffs is not None:
        rec = {"block": bi, "src": owner, "dst": nxt, "side": "send",
               "bytes": nbytes, "ms": (time.perf_counter() - t0) * 1e3,
               "x": x}
        if compress:
            rec.update(q=q, scale=s)
        handoffs.append(rec)


def _recv_boundary(shape, src, dev, compress, handoffs, bi, owner, nxt):
    if compress:
        q = comm.recv(shape, torch.int8, src)
        s = comm.recv(shape[:-1] + (1,), torch.float32, src)
        t0 = time.perf_counter()
        nbytes = q.numel() + 4 * s.numel()
        q, s = q.to(dev), s.to(dev)
        x = _dequantize_int8(q, s, ACT_DTYPE)
    else:
        host = comm.recv(shape, ACT_DTYPE, src)
        t0 = time.perf_counter()
        x = host.to(dev)
        nbytes = host.numel() * host.element_size()
    if handoffs is not None:
        _sync(dev)
        rec = {"block": bi, "src": owner, "dst": nxt, "side": "recv",
               "bytes": nbytes, "ms": (time.perf_counter() - t0) * 1e3,
               "x": x}
        if compress:
            rec.update(q=q, scale=s)
        handoffs.append(rec)
    return x
