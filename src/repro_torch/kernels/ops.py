"""Public wrappers of the port's kernels.

Dispatch goes by the device of the tensors, never by what is installed:
a CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel, or raises — there is no fallback.
Each wrapper checks device, dtype, shape and contiguity before it launches,
and adds one to ``LAUNCHES[<kernel>]`` for every kernel launch (CPU calls
never count).

Inside ``count_flops()`` each wrapper also adds its kernel's matmul FLOPs,
from the formula of its own arguments (``*_flops`` below), on either
device.  The cost check (``repro_torch.analysis.costcheck``) counts the
rest of a stage with ``FlopCounterMode``, which cannot see a kernel
launched through ctypes; so inside ``count_flops()`` a wrapper hides its
call, kernel or plain version, from the dispatch modes, and a stage
counts the same on both devices.  Each formula equals what
``FlopCounterMode`` counts of the plain version (2 x M x N x K a
product); the int8 kernels do no product and add nothing.

Inside ``count_costs(sink)`` (``launch.op_cost``) every wrapper, the int8
pair too, calls ``sink(kernel, flops, bytes)`` once a call, from its
``*_flops`` and ``*_bytes`` formulas, and runs hidden from the dispatch
modes, so the plain version's intermediates (attention's [B, H, S, S]
scores) are never counted.  A byte formula counts each input read once
and each output written once, from shapes alone; a paged kernel reads
every page of its table, as its FLOP formula counts them.

On the "meta" device (the dry run's stand-ins) a wrapper takes the plain
version, which allocates and computes nothing there.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels import exit_head as _exit
from repro_torch.kernels import feature_compress as _fc
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _pattn
from repro_torch.kernels import paged_mla as _pmla
from repro_torch.kernels import ref
from repro_torch.kernels import w8a8_expert as _w8a8

LAUNCHES = {"paged_gqa_attention": 0, "paged_mla_attention": 0,
            "exit_head_entropy": 0, "quantize_rows": 0,
            "dequantize_rows": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "w8a8_expert_matmul": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_FLOPS: Optional[Dict[str, float]] = None
_SINK: Optional[Callable[[str, float, float], None]] = None


@contextlib.contextmanager
def count_flops() -> Iterator[Dict[str, float]]:
    """Count the kernels' matmul FLOPs in the block: yields
    ``{kernel: flops}``, filled by every wrapper call from its formula."""
    global _FLOPS
    outer, _FLOPS = _FLOPS, {}
    try:
        yield _FLOPS
    finally:
        _FLOPS = outer


@contextlib.contextmanager
def count_costs(sink: Callable[[str, float, float], None]) -> Iterator[None]:
    """Inside the block every kernel wrapper calls ``sink(kernel, flops,
    bytes)`` once a call, from its formulas."""
    global _SINK
    outer, _SINK = _SINK, sink
    try:
        yield
    finally:
        _SINK = outer


def _counts(name: str, nbytes, flops=None):
    """Decorate kernel ``name``'s wrapper: inside ``count_flops`` each call
    adds ``flops(*args, **kw)`` (kernels that do a product), inside
    ``count_costs`` it passes both formulas to the sink; counted calls run
    hidden from the dispatch modes (``FlopCounterMode``, ``op_cost``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            add = _FLOPS is not None and flops is not None
            if not add and _SINK is None:
                return fn(*args, **kw)
            f = float(flops(*args, **kw)) if flops is not None else 0.0
            if add:
                _FLOPS[name] = _FLOPS.get(name, 0.0) + f
            if _SINK is not None:
                _SINK(name, f, float(nbytes(*args, **kw)))
            with _disable_current_modes():
                return fn(*args, **kw)
        return call
    return wrap


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def exit_head_flops(x, w) -> float:
    """x [..., D] @ w [D, V]."""
    return 2.0 * x.numel() * w.shape[1]


def exit_head_bytes(x, w) -> float:
    """x and w read, one fp32 entropy a row written."""
    return _nbytes(x, w) + 4 * (x.numel() // x.shape[-1])


def flash_attention_flops(q, k, *_, **__) -> float:
    """S = Q K^T and O = P V over every (query, key) pair, masked or not:
    q [B, Sq, Nq, H], k [B, Skv, Nkv, H]."""
    b, sq, nq, hd = q.shape
    return 4.0 * b * sq * nq * k.shape[1] * hd


def flash_attention_bytes(q, k, v, causal=True, window=0, with_lse=False
                          ) -> float:
    """q, k and v read, the output (and, with ``with_lse``, the fp32
    log-sum-exp [B, Nq, Sq]) written."""
    b, sq, nq, _ = q.shape
    return 2 * _nbytes(q) + _nbytes(k, v) + (4 * b * nq * sq if with_lse
                                              else 0)


def flash_attention_bwd_flops(q, k, *_, **__) -> float:
    """The backward's five products: S again, dV, dP, dQ and dK."""
    return 2.5 * flash_attention_flops(q, k)


def flash_attention_bwd_bytes(q, k, v, o, do, lse, **_) -> float:
    """q, k, v, o, dO and the log-sum-exp read; dq, dk and dv written."""
    return _nbytes(q, k, v, o, do, lse) + _nbytes(q, k, v)


def paged_gqa_flops(q, pool_k, pool_v, tbl, pos, **_) -> float:
    """Q K^T and P V over the whole table (pps pages of P tokens a row)."""
    b, _, nq, hd = q.shape
    return 4.0 * b * nq * tbl.shape[1] * pool_k.shape[1] * hd


def paged_gqa_bytes(q, pool_k, pool_v, tbl, pos, **_) -> float:
    """q, the table and positions read, every page of the table of both
    pools read (pps pages of P tokens a row), the output written."""
    b = q.shape[0]
    pages = b * tbl.shape[1]
    page_bytes = pool_k[0].numel() * pool_k.element_size()
    return 2 * _nbytes(q) + _nbytes(tbl, pos) + 2 * pages * page_bytes


def paged_mla_flops(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos,
                    **_) -> float:
    """The latent and rope scores and the latent context over the whole
    table."""
    b, _, n, r = q_lat.shape
    t = tbl.shape[1] * pool_ckv.shape[1]
    return 2.0 * b * n * t * (2 * r + q_rope.shape[3])


def paged_mla_bytes(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos,
                    **_) -> float:
    """The queries, the table and positions read, every page of the table
    of both latent pools read, the fp32 latent context written."""
    pages = q_lat.shape[0] * tbl.shape[1]
    page_bytes = (pool_ckv[0].numel() * pool_ckv.element_size()
                  + pool_krope[0].numel() * pool_krope.element_size())
    return (_nbytes(q_lat, q_rope, tbl, pos) + pages * page_bytes
            + 4 * q_lat.numel())


def quantize_rows_bytes(x) -> float:
    """x read; the int8 rows and one fp32 scale a row written."""
    return _nbytes(x) + x.numel() + 4 * (x.numel() // x.shape[-1])


def dequantize_rows_bytes(q, scale, dtype=torch.bfloat16) -> float:
    """q and the scales read, the rows written in ``dtype``."""
    return _nbytes(q, scale) + q.numel() * dtype.itemsize


def w8a8_expert_flops(aq, a_scale, wq, w_scale) -> float:
    """aq [E, C, K] @ wq [E, K, N], every capacity row."""
    e, c, k = aq.shape
    return 2.0 * e * c * k * wq.shape[2]


def w8a8_expert_bytes(aq, a_scale, wq, w_scale) -> float:
    """Every operand read, the fp32 [E, C, N] product written."""
    e, c, _ = aq.shape
    return _nbytes(aq, a_scale, wq, w_scale) + 4 * e * c * wq.shape[2]


def _on_card(*tensors) -> bool:
    """True when every tensor is on a CUDA device, False when every one is
    on the CPU or every one on "meta"; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("repro_torch kernels: tensors on different cards")
        return True
    raise ValueError(f"repro_torch kernels: unsupported devices {kinds}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"repro_torch kernels: {msg}")


@_counts("exit_head_entropy", exit_head_bytes, exit_head_flops)
def exit_head_entropy(x, w):
    """x [..., D], w [D, V] -> entropy of softmax(x @ w) [...] fp32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not _on_card(x2, w):
        return ref.exit_head_entropy_ref(x2, w).reshape(lead)
    _require(x2.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
             f"exit_head_entropy takes bf16, got {x2.dtype} / {w.dtype}")
    _require(w.ndim == 2 and w.shape[0] == x2.shape[1],
             f"exit_head_entropy shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _require(x2.is_contiguous() and w.is_contiguous(),
             "exit_head_entropy takes contiguous x and w")
    _require(x2.shape[0] > 0, "exit_head_entropy on zero rows")
    out = _exit.entropy_cuda(x2, w)
    LAUNCHES["exit_head_entropy"] += 1
    return out.reshape(lead)


def _check_flash(q, k, v, window, what):
    """The flash kernels' conditions on q [B, Sq, Nq, H] and k/v
    [B, Skv, Nkv, H] on the card; raises on anything else."""
    _require(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape,
             f"{what} q {tuple(q.shape)} k {tuple(k.shape)} "
             f"v {tuple(v.shape)}")
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    _require(k.shape[0] == b and k.shape[3] == hd and nq % nkv == 0,
             f"{what} k/v {tuple(k.shape)} for q {tuple(q.shape)}")
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
             f"{what} takes bf16, got {q.dtype} / {k.dtype} / {v.dtype}")
    _require(hd in _flash.HEAD_DIMS,
             f"{what} has no instance for head_dim={hd}")
    _require(sq > 0 and skv > 0 and 0 < b < 65536 and nq < 65536,
             f"{what} shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    _require(window >= 0, f"{what} window {window}")
    _require(all(t.is_contiguous() for t in (q, k, v)),
             f"{what} takes contiguous q, k and v")
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
             f"{what} q, k and v must be 16-byte aligned")


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int = 0):
    """``flash_attention``'s forward without autograd, also returning each
    row's log-sum-exp: (out [B, Sq, Nq, H], lse fp32 [B, Nq, Sq], natural
    log).  One forward launch on the card (counted as
    ``flash_attention``), the plain versions on the CPU."""
    return _flash_forward(q, k, v, causal, window, with_lse=True)


@_counts("flash_attention", flash_attention_bytes, flash_attention_flops)
def _flash_forward(q, k, v, causal, window, with_lse=False):
    if not _on_card(q, k, v):
        out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        if not with_lse:
            return out
        return out, ref.flash_attention_lse_ref(q, k, causal=causal,
                                                window=window)
    _check_flash(q, k, v, window, "flash_attention")
    res = _flash.attention_cuda(q, k, v, causal, window, with_lse)
    LAUNCHES["flash_attention"] += 1
    return res


@_counts("flash_attention_bwd", flash_attention_bwd_bytes,
         flash_attention_bwd_flops)
def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention`` at output ``o`` for
    the output gradient ``do`` (both [B, Sq, Nq, H]) and the forward's
    log-sum-exp ``lse`` (fp32 [B, Nq, Sq]): the hand-written backward
    kernels on the card, ``ref.flash_attention_bwd_ref`` on the CPU.  D =
    rowsum(do * o) is taken from ``o``.  ``do`` may be any layout (it is
    made contiguous)."""
    do = do.contiguous()
    if not _on_card(q, k, v, o, do, lse):
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                           causal=causal, window=window)
    _check_flash(q, k, v, window, "flash_attention_bwd")
    _require(o.shape == q.shape and do.shape == q.shape
             and o.dtype == do.dtype == torch.bfloat16,
             f"flash_attention_bwd o {tuple(o.shape)} {o.dtype} / do "
             f"{tuple(do.shape)} {do.dtype} for q {tuple(q.shape)}")
    _require(o.is_contiguous() and o.data_ptr() % 16 == 0
             and do.data_ptr() % 16 == 0,
             "flash_attention_bwd o and do must be contiguous and 16-byte "
             "aligned")
    b, sq, nq, _ = q.shape
    _require(lse.shape == (b, nq, sq) and lse.dtype == torch.float32
             and lse.is_contiguous(),
             f"flash_attention_bwd lse {tuple(lse.shape)} {lse.dtype} for q "
             f"{tuple(q.shape)}: contiguous fp32 [B, Nq, Sq]")
    _require(causal or window == 0,
             "flash_attention_bwd takes a window only with the causal mask")
    grads = _flash.attention_bwd_cuda(q, k, v, o, do, lse, causal, window)
    LAUNCHES["flash_attention_bwd"] += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.  The
    forward writes the rows' log-sum-exp only when a gradient will be
    taken (``with_lse``), and saves it with q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, with_lse):
        ctx.causal, ctx.window = causal, window
        if not with_lse:
            return _flash_forward(q, k, v, causal, window)
        out, lse = _flash_forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Full-sequence GQA attention in the BSHD layout: q [B, Sq, Nq, H],
    k/v [B, Skv, Nkv, H] (query head n*G + g reads kv head n), causal
    and/or sliding-window masked -> [B, Sq, Nq, H] in q's dtype.  No head
    repeat and no transpose copy: the kernel reads the layout as it is.
    Differentiable: a ``torch.autograd.Function`` whose backward is
    ``flash_attention_bwd`` (the backward kernels on the card); the
    forward writes the log-sum-exp the backward takes only when grad mode
    is on and an input requires grad."""
    with_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, window, with_lse)


@_counts("paged_gqa_attention", paged_gqa_bytes, paged_gqa_flops)
def paged_gqa_attention(q, pool_k, pool_v, tbl, pos, scale=None):
    """Paged GQA decode attention: q [B, 1, Nq, H], pools
    [n_pages, P, Nkv, H], tbl [B, pps] int32 (sentinel entries allowed —
    clipped, and always masked by ``pos``), pos [B] int32 -> [B, 1, Nq, H].
    ``scale`` multiplies the scores (None: 1/sqrt(H))."""
    if not _on_card(q, pool_k, pool_v, tbl, pos):
        return ref.paged_gqa_attention_ref(q, pool_k, pool_v, tbl, pos,
                                           scale)
    _require(q.ndim == 4 and q.shape[1] == 1,
             f"paged_gqa_attention decodes one token, q {tuple(q.shape)}")
    b, _, nq, hd = q.shape
    _require(pool_k.ndim == 4 and pool_k.shape == pool_v.shape
             and pool_k.shape[3] == hd and nq % pool_k.shape[2] == 0,
             f"paged_gqa_attention pools {tuple(pool_k.shape)} / "
             f"{tuple(pool_v.shape)} for q {tuple(q.shape)}")
    _require(q.dtype == pool_k.dtype == pool_v.dtype == torch.bfloat16,
             "paged_gqa_attention takes bf16 q and pools")
    _require(tbl.dtype == torch.int32 and pos.dtype == torch.int32,
             "paged_gqa_attention takes int32 tbl and pos")
    _require(tbl.ndim == 2 and tbl.shape[0] == b and pos.shape == (b,),
             f"paged_gqa_attention tbl {tuple(tbl.shape)} pos "
             f"{tuple(pos.shape)} for batch {b}")
    _require(all(t.is_contiguous() for t in (q, pool_k, pool_v, tbl, pos)),
             "paged_gqa_attention takes contiguous tensors")
    _require(pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0,
             "paged_gqa_attention pools must be 16-byte aligned")
    page, nkv = pool_k.shape[1], pool_k.shape[2]
    _require(_pattn.supported(page, hd, nq // nkv),
             f"paged_gqa_attention has no instance for page={page}, "
             f"head_dim={hd}, group={nq // nkv}")
    out = _pattn.attention_cuda(q, pool_k, pool_v, tbl, pos, scale)
    LAUNCHES["paged_gqa_attention"] += 1
    return out


@_counts("paged_mla_attention", paged_mla_bytes, paged_mla_flops)
def paged_mla_attention(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos, *,
                        scale: float):
    """Paged MLA decode attention with matrix absorption: q_lat
    [B, 1, N, R] (W_kb already absorbed), q_rope [B, 1, N, Hr], pools
    [n_pages, P, R] / [n_pages, P, Hr], tbl [B, pps] int32 (sentinel
    entries allowed: clipped, and always masked by ``pos``), pos [B] int32
    -> latent context [B, 1, N, R] fp32 (the caller applies W_vb)."""
    args = (q_lat, q_rope, pool_ckv, pool_krope, tbl, pos)
    if not _on_card(*args):
        return ref.paged_mla_attention_ref(*args, scale=scale)
    _require(q_lat.ndim == 4 and q_lat.shape[1] == 1,
             f"paged_mla_attention decodes one token, q_lat "
             f"{tuple(q_lat.shape)}")
    b, _, n, r = q_lat.shape
    _require(q_rope.ndim == 4 and q_rope.shape[:3] == q_lat.shape[:3],
             f"paged_mla_attention q_rope {tuple(q_rope.shape)} for q_lat "
             f"{tuple(q_lat.shape)}")
    hr = q_rope.shape[3]
    _require(pool_ckv.ndim == 3 and pool_krope.ndim == 3
             and pool_ckv.shape[:2] == pool_krope.shape[:2]
             and pool_ckv.shape[2] == r and pool_krope.shape[2] == hr,
             f"paged_mla_attention pools {tuple(pool_ckv.shape)} / "
             f"{tuple(pool_krope.shape)} for q_lat {tuple(q_lat.shape)}, "
             f"q_rope {tuple(q_rope.shape)}")
    _require(all(t.dtype == torch.bfloat16 for t in args[:4]),
             "paged_mla_attention takes bf16 queries and pools")
    _require(tbl.dtype == torch.int32 and pos.dtype == torch.int32,
             "paged_mla_attention takes int32 tbl and pos")
    _require(tbl.ndim == 2 and tbl.shape[0] == b and pos.shape == (b,)
             and b > 0,
             f"paged_mla_attention tbl {tuple(tbl.shape)} pos "
             f"{tuple(pos.shape)} for batch {b}")
    _require(all(t.is_contiguous() for t in args),
             "paged_mla_attention takes contiguous tensors")
    _require(all(t.data_ptr() % 16 == 0 for t in args[:4]),
             "paged_mla_attention queries and pools must be 16-byte "
             "aligned")
    page = pool_ckv.shape[1]
    _require(_pmla.supported(n, r, hr, page),
             f"paged_mla_attention has no instance for heads={n}, "
             f"rank={r}, rope_dim={hr}, page={page}")
    out = _pmla.attention_cuda(*args, scale)
    LAUNCHES["paged_mla_attention"] += 1
    return out


@_counts("quantize_rows", quantize_rows_bytes)
def compress_rows(x):
    """x [..., D] fp32/bf16 -> (q int8 [..., D], scale fp32 [..., 1]), per
    row: scale = max(amax * fl(1/127), 1e-8), q = round_half_even(x /
    scale) clipped to +-127.  Zero rows launch nothing."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if not _on_card(x2):
        q, s = ref.quantize_rows_ref(x2)
        return q.reshape(*lead, d), s.reshape(*lead, 1)
    _require(x2.dtype in (torch.float32, torch.bfloat16),
             f"compress_rows takes fp32 or bf16, got {x2.dtype}")
    _require(d > 0, "compress_rows on rows of width 0")
    _require(x.is_contiguous(), "compress_rows takes contiguous rows")
    if x2.shape[0] == 0:
        return (torch.empty((*lead, d), dtype=torch.int8, device=x.device),
                torch.empty((*lead, 1), dtype=torch.float32, device=x.device))
    q, s = _fc.quantize_cuda(x2)
    LAUNCHES["quantize_rows"] += 1
    return q.reshape(*lead, d), s.reshape(*lead, 1)


@_counts("dequantize_rows", dequantize_rows_bytes)
def decompress_rows(q, scale, dtype=torch.bfloat16):
    """(q int8 [..., D], scale fp32 [..., 1]) -> x [..., D] ``dtype``:
    float(q) * scale rounded once to ``dtype``.  Zero rows launch nothing."""
    lead, d = q.shape[:-1], q.shape[-1]
    q2 = q.reshape(-1, d)
    s2 = scale.reshape(-1, 1)
    if not _on_card(q2, s2):
        return ref.dequantize_rows_ref(q2, s2, dtype).reshape(*lead, d)
    _require(q2.dtype == torch.int8 and s2.dtype == torch.float32,
             f"decompress_rows takes int8 q and fp32 scales, got "
             f"{q2.dtype} / {s2.dtype}")
    _require(dtype in (torch.float32, torch.bfloat16),
             f"decompress_rows writes fp32 or bf16, not {dtype}")
    _require(tuple(scale.shape) == (*lead, 1) and d > 0,
             f"decompress_rows q {tuple(q.shape)} scale {tuple(scale.shape)}")
    _require(q.is_contiguous() and scale.is_contiguous(),
             "decompress_rows takes contiguous q and scales")
    if q2.shape[0] == 0:
        return torch.empty((*lead, d), dtype=dtype, device=q.device)
    out = _fc.dequantize_cuda(q2, s2, dtype)
    LAUNCHES["dequantize_rows"] += 1
    return out.reshape(*lead, d)


@_counts("w8a8_expert_matmul", w8a8_expert_bytes, w8a8_expert_flops)
def w8a8_expert_matmul(aq, a_scale, wq, w_scale):
    """W8A8 grouped expert GEMM: aq [E, C, K] int8 with a_scale [E, C, 1]
    fp32, wq [E, K, N] int8 with w_scale [E, 1, N] fp32 -> fp32 [E, C, N]
    = float(s32 sum over K) * a_scale * w_scale, every capacity row
    computed."""
    args = (aq, a_scale, wq, w_scale)
    if not _on_card(*args):
        return ref.w8a8_expert_matmul_ref(*args)
    _require(aq.ndim == 3 and wq.ndim == 3,
             f"w8a8_expert_matmul aq {tuple(aq.shape)} wq {tuple(wq.shape)}")
    e, c, k = aq.shape
    n = wq.shape[2]
    _require(wq.shape[:2] == (e, k) and a_scale.shape == (e, c, 1)
             and w_scale.shape == (e, 1, n),
             f"w8a8_expert_matmul aq {tuple(aq.shape)} a_scale "
             f"{tuple(a_scale.shape)} wq {tuple(wq.shape)} w_scale "
             f"{tuple(w_scale.shape)}")
    _require(aq.dtype == wq.dtype == torch.int8
             and a_scale.dtype == w_scale.dtype == torch.float32,
             f"w8a8_expert_matmul takes int8 aq / wq and fp32 scales, got "
             f"{aq.dtype} / {wq.dtype} / {a_scale.dtype} / {w_scale.dtype}")
    _require(0 < e < 65536 and 0 < c and -(-c // _w8a8.BLOCK_C) < 65536,
             f"w8a8_expert_matmul grid for E {e}, C {c}")
    _require(_w8a8.supported(k, n),
             f"w8a8_expert_matmul has no instance for K={k}, N={n} (K a "
             f"multiple of {_w8a8.K_STEP} up to {_w8a8.MAX_K}, N of 4)")
    _require(all(t.is_contiguous() for t in args),
             "w8a8_expert_matmul takes contiguous tensors")
    _require(aq.data_ptr() % 16 == 0 and wq.data_ptr() % 4 == 0,
             "w8a8_expert_matmul: aq must be 16-byte and wq 4-byte aligned")
    out = _w8a8.matmul_cuda(*args)
    LAUNCHES["w8a8_expert_matmul"] += 1
    return out
