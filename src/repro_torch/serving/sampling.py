"""Sampled decode: Gumbel-max draws from a counter-based hash.

The reference samples with ``jax.random.categorical(fold_in(key, tick),
logits / T)``, which is Gumbel-max on threefry bits.  The port keeps the
semantics, not the bits: a draw is ``argmax(logits / T - log(-log u))``
with every uniform ``u`` a hash of (key, tick, row, vocab index).  Nothing
here holds generator state, so a decode step that a CUDA graph replays
reads its tick from a device tensor the graph increments, and the sync
step and a decode window draw the same noise at the same tick.

The hash is the 32-bit ``lowbias32`` finalizer (C. Wellons), computed in
int64 tensor ops whose products stay below 2^49, so the CPU and the card
give the same bits without relying on integer overflow.  A tick is taken
below 2^32 in full and above it through one more xor.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    as two 16-bit halves so that no product leaves int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash32(x):
    """lowbias32 on int64 values in [0, 2^32): a bijection of 32 bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def draw_key(gen: torch.Generator) -> Tuple[int, int]:
    """One 64-bit key from ``gen``, as two 32-bit halves."""
    k = torch.randint(0, 2 ** 32, (2,), generator=gen, dtype=torch.int64,
                      device=gen.device).tolist()
    return int(k[0]), int(k[1])


def counter_rows(rows, vocab: int):
    """Hashed counters of ``rows`` [n] int64 (batch rows): [n, vocab] int64,
    hash32(row * vocab + v).  Depends on shapes only, so a caller keeps it."""
    c = rows[:, None] * vocab + torch.arange(vocab, dtype=torch.int64,
                                             device=rows.device)
    return hash32(c & _M32)


def gumbel(key, tick, counters):
    """Gumbel noise [n, V] fp32: ``key`` int64 [2] (the two halves),
    ``tick`` int64 [] or [n], ``counters`` from ``counter_rows``."""
    tick = tick.reshape(-1, 1)
    s = hash32(hash32(hash32(tick & _M32) ^ key[0])
               ^ key[1] ^ ((tick >> 32) & _M32))
    bits = hash32(counters ^ s)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample(logits, temperature: float, key, tick, counters):
    """Gumbel-max draw of ``softmax(logits / temperature)`` per row:
    logits [n, V] fp32 -> int64 [n]."""
    return torch.argmax(logits / temperature + gumbel(key, tick, counters),
                        dim=-1)


def sample_rows(logits, temperature: float, key, ticks):
    """``sample`` of ad-hoc rows, each at its own tick (``ticks`` [n]
    int64) and all with row 0's counters, as the reference draws a first
    token from its row alone."""
    rows = torch.zeros(logits.shape[0], dtype=torch.int64,
                       device=logits.device)
    return sample(logits, temperature, key, ticks,
                  counter_rows(rows, logits.shape[-1]))
