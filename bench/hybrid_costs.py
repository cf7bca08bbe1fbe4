"""The yardstick of Zamba2's published hybrid (``configs/zamba2-*``):
the work a decode step needs, from shapes and the configuration file
alone, as ``costs.py`` counts it for a dense GQA decoder.

* Model FLOPs a token: 2 x the matmul parameters the token runs through:
  every layer's Mamba2 in and out projections, at each site the shared
  block's q, k, v (from the 2 x hidden concatenated input), o and gated
  FFN, the site's adapter and linear, and the vocabulary projections of
  the final head and of each exit head; plus the sites' attention, 4 x
  heads x head_dim x context a site.  The SSM's own arithmetic (a few
  operations an element of the state) and the conv are no matmul.
* The sites' paged attention bytes: the K/V rows each decoded row's
  context needs (read once), its q read and its output written, a site.

``costs.decode_flops`` (what the decode runner records, ``rec["flops"]``)
counts every layer of a configuration file as a dense GQA layer; it is
linear in the keys, so ``keys_from_flops`` recovers the window's keys
from it.
"""
from __future__ import annotations

from typing import Iterable

from bench import costs

BF16 = costs.BF16


def shape(cfg: dict) -> dict:
    """The sizes the counts read from a Zamba2 configuration file."""
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    return {"L": cfg["num_hidden_layers"], "D": d, "d_in": d_in,
            "X": 2 * d_in + 2 * cfg["mamba_ngroups"] * cfg["mamba_d_state"]
            + cfg["n_mamba_heads"],
            "A": cfg["attention_hidden_size"],
            "Nq": cfg["num_attention_heads"],
            "Nkv": cfg["num_key_value_heads"],
            "Hd": cfg["attention_head_dim"], "F": cfg["ffn_hidden_size"],
            "r": cfg["adapter_rank"], "V": cfg["vocab_size"],
            "sites": len(cfg["hybrid_layer_ids"]),
            "exits": len(cfg.get("exit_layers", ()))}


def matmul_params(cfg: dict) -> int:
    """Matmul parameters one token runs through."""
    s = shape(cfg)
    mamba = s["D"] * s["X"] + s["d_in"] * s["D"]
    attn = (s["A"] * (s["Nq"] + 2 * s["Nkv"]) + s["Nq"] * s["D"]) * s["Hd"]
    site = (attn + 3 * s["D"] * s["F"] + s["r"] * (s["D"] + 2 * s["F"])
            + s["D"] * s["D"])
    return (s["L"] * mamba + s["sites"] * site
            + (1 + s["exits"]) * s["D"] * s["V"])


def attention_flops(cfg: dict, keys: float) -> float:
    """The sites' score and context products over ``keys`` (query, key)
    pairs, every site."""
    s = shape(cfg)
    return 4.0 * s["Nq"] * s["Hd"] * keys * s["sites"]


def decode_flops(cfg: dict, tokens: int, keys: float) -> float:
    """Model FLOPs of decoding ``tokens`` tokens whose attention reads
    ``keys`` keys in all (each token's context, itself included)."""
    return 2.0 * matmul_params(cfg) * tokens + attention_flops(cfg, keys)


def paged_gqa_bytes(cfg: dict, contexts: Iterable[int]) -> float:
    """Bytes the sites' paged decode attention needs, all sites, for one
    row a context: its K and V rows, its q read and its output written."""
    s = shape(cfg)
    ctx = [int(c) for c in contexts]
    kv = 2 * s["Nkv"] * s["Hd"] * BF16 * sum(ctx)
    qo = 2 * s["Nq"] * s["Hd"] * BF16 * len(ctx)
    return float(s["sites"] * (kv + qo))


def keys_from_flops(cfg: dict, flops: float, tokens: int) -> float:
    """The keys ``costs.decode_flops(cfg, tokens, keys)`` was given."""
    return ((flops - 2.0 * costs.matmul_params(cfg) * tokens)
            / costs.attention_flops(cfg, 1))
