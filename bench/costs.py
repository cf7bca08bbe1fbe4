"""The benchmark's yardstick: the card's peaks and the work a step needs.

Every count here comes from shapes and the configuration file alone, so
it does not depend on what implements a step: a later change that
removes a copy or a kernel leaves these numbers as they are.

* Model FLOPs a token: 2 x the matmul parameters the token runs through
  (every layer's q, k, v, o and gated FFN, plus the vocabulary
  projections of the final head and of each exit head, which the
  monolithic decode step and ``Model.forward`` both compute; the
  embedding gather is no matmul), plus attention's score and context
  products, 4 x heads x head_dim x context a layer.
* Paged attention's bytes: the K/V rows each decoded row's context
  needs (read once), its q read and its output written, a layer.
* Flash attention's forward: the causal (query, key) pairs' two
  products, and q, k, v read and o written once.
"""
from __future__ import annotations

from typing import Iterable, Optional

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
BF16 = 2                                  # bytes an element


def peaks(device_name: str) -> Optional[dict]:
    """The peaks of the card named ``device_name``, None if unknown."""
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    return None


def shape(cfg: dict) -> dict:
    """The sizes the counts read from a configuration file."""
    d = cfg["hidden_size"]
    nq = cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "D": d, "Nq": nq,
            "Nkv": cfg["num_key_value_heads"],
            "H": cfg.get("head_dim") or d // nq,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "exits": len(cfg.get("exit_layers", ()))}


def matmul_params(cfg: dict) -> int:
    """Matmul parameters one token runs through: every layer's
    projections and FFN, and the final and exit heads' vocabularies."""
    s = shape(cfg)
    attn = s["D"] * s["H"] * (2 * s["Nq"] + 2 * s["Nkv"])
    ffn = 3 * s["D"] * s["F"]
    return s["L"] * (attn + ffn) + (1 + s["exits"]) * s["D"] * s["V"]


def attention_flops(cfg: dict, pairs: float) -> float:
    """Score and context products over ``pairs`` (query, key) pairs,
    every layer."""
    s = shape(cfg)
    return 4.0 * s["Nq"] * s["H"] * pairs * s["L"]


def decode_flops(cfg: dict, tokens: int, keys: int) -> float:
    """Model FLOPs of decoding ``tokens`` tokens whose attention reads
    ``keys`` keys in all (each token's context, itself included)."""
    return 2.0 * matmul_params(cfg) * tokens + attention_flops(cfg, keys)


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def forward_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of a causal forward over [batch, seq] tokens."""
    return (2.0 * matmul_params(cfg) * batch * seq
            + attention_flops(cfg, batch * causal_pairs(seq)))


def paged_gqa_bytes(cfg: dict, contexts: Iterable[int]) -> float:
    """Bytes the paged decode attention needs, all layers, for one row a
    context: its K and V rows, its q read and its output written."""
    s = shape(cfg)
    ctx = [int(c) for c in contexts]
    kv = 2 * s["Nkv"] * s["H"] * BF16 * sum(ctx)
    qo = 2 * s["Nq"] * s["H"] * BF16 * len(ctx)
    return float(s["L"] * (kv + qo))


def flash_fwd_flops(cfg: dict, batch: int, seq: int) -> float:
    """The causal flash forward's products, all layers, one forward."""
    return attention_flops(cfg, batch * causal_pairs(seq))


def flash_fwd_bytes(cfg: dict, batch: int, seq: int) -> float:
    """q, k and v read and o written once, all layers, one forward."""
    s = shape(cfg)
    return float(s["L"] * batch * seq * s["H"] * BF16
                 * (2 * s["Nq"] + 2 * s["Nkv"]))


def roofline_s(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_s"])
