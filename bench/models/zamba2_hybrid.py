"""Builder of Zamba2's published hybrid (Zamba2-7B): Mamba2 layers with
grouped B/C, and weight-shared attention + FFN blocks at irregular sites,
named ``"model": "zamba2_hybrid"`` in a configuration file.

The three functions of a builder (see ``dense_gqa.py``):
``model_config(cfg)``, ``make(cfg, seed, device)`` and
``port_params(model, w)``.

Draws: the embedding N(0, 0.02) (tied: it is also the vocabulary head);
every projection N(0, 1/fan_in); norm scales 1 + N(0, 0.1), so a norm
that drops its scale does not pass unseen.  A site's input norm scales
its embedding half by a further 1 / 0.02: the embedding is drawn at 0.02
against a stream of order 1, so at a plain scale it would be about 1 %
of the site's normed input, and a site that dropped it would read
correct; so scaled it enters the site at the stream's order.  The Mamba2 constants are
drawn where a trained model keeps them, so the recurrent state carries
over many tokens: ``a_log`` N(1, 0.5) (A = -exp(a_log), about -0.4 to
-7), ``dt_bias`` N(-4, 1) (dt = softplus(. + dt_bias), about 0.02),
``d_skip`` 1 + N(0, 0.1), ``conv_b`` N(0, 0.1).  Mamba2 leaves are
stacked over the 81 layers, one draw a stacked tensor; the shared
blocks and the per-site adapters and linears are drawn one by one.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench.weights import check, draw, generator

EMBED_STD = 0.02                   # the embedding's (and tied head's) draw

# the port's stacked Mamba2 layer leaves, by (group, leaf) -> benchmark name
LAYER_LEAVES = {("ln", "scale"): "ln", ("mamba", "in_proj"): "in_proj",
                ("mamba", "conv_w"): "conv_w", ("mamba", "conv_b"): "conv_b",
                ("mamba", "a_log"): "a_log", ("mamba", "d_skip"): "d_skip",
                ("mamba", "dt_bias"): "dt_bias", ("mamba", "norm"): "norm",
                ("mamba", "out_proj"): "out_proj"}


def shape(cfg: dict) -> dict:
    """The sizes a Zamba2 configuration file gives."""
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    hm = cfg["n_mamba_heads"]
    return {"L": cfg["num_hidden_layers"], "D": d, "d_in": d_in, "G": g,
            "N": n, "Hm": hm, "P": d_in // hm, "K": cfg["mamba_d_conv"],
            "C": d_in + 2 * g * n, "X": 2 * d_in + 2 * g * n + hm,
            "A": cfg["attention_hidden_size"],
            "Nq": cfg["num_attention_heads"],
            "Nkv": cfg["num_key_value_heads"],
            "Hd": cfg["attention_head_dim"], "F": cfg["ffn_hidden_size"],
            "r": cfg["adapter_rank"], "V": cfg["vocab_size"],
            "blocks": cfg["num_mem_blocks"],
            "sites": len(cfg["hybrid_layer_ids"]),
            "exits": len(cfg.get("exit_layers", ()))}


def model_config(cfg: dict):
    """The program's ``SiteConfig`` of a configuration file."""
    from repro_torch.configs.base import (ExitConfig, GroupedSSMConfig,
                                          SiteConfig)
    s = shape(cfg)
    if cfg["hidden_act"] != "gelu" or not cfg["use_shared_mlp_adapter"] \
            or cfg["use_shared_attention_adapter"] or not cfg["use_mem_rope"]:
        raise ValueError("bench zamba2_hybrid: builds gelu FFNs with MLP "
                         "adapters only, and RoPE at the sites")
    if s["A"] != 2 * s["D"]:
        raise ValueError("bench zamba2_hybrid: a site reads concat(x, "
                         "embedding), 2 x hidden_size")
    return SiteConfig(
        name=cfg["name"], family="hybrid", num_layers=s["L"], d_model=s["D"],
        num_heads=s["Nq"], num_kv_heads=s["Nkv"], head_dim=s["Hd"],
        d_ff=s["F"], vocab_size=s["V"], attention="full", rope="rope",
        rope_theta=float(cfg["rope_theta"]), act="geglu",
        tie_embeddings=bool(cfg.get("tie_word_embeddings")),
        ssm=GroupedSSMConfig(state_size=s["N"], conv_width=s["K"],
                             expand=cfg["mamba_expand"], head_dim=s["P"],
                             chunk_size=cfg["chunk_size"], n_groups=s["G"]),
        exits=ExitConfig(exit_layers=tuple(cfg.get("exit_layers", ())),
                         entropy_threshold=cfg.get("exit_entropy_threshold",
                                                   0.5)),
        hybrid_layer_ids=tuple(cfg["hybrid_layer_ids"]),
        num_mem_blocks=s["blocks"], site_concat_input=True,
        site_adapter_rank=s["r"], site_linear=True,
        attn_scale=(s["Hd"] / 2) ** -0.5,
        dtype=cfg.get("torch_dtype", "bfloat16"), source=cfg["source"])


def make(cfg: dict, seed: int, device) -> Dict[str, object]:
    """Every weight of the model ``cfg`` describes, from ``seed``."""
    s = shape(cfg)
    L, D, d_in, Hm, K, C, X = (s[k] for k in ("L", "D", "d_in", "Hm", "K",
                                              "C", "X"))
    A, Nq, Nkv, Hd, F, r, V = (s[k] for k in ("A", "Nq", "Nkv", "Hd", "F",
                                              "r", "V"))
    f32 = torch.float32
    gen = generator(seed, device)
    w = {"embed": draw(gen, (V, D), EMBED_STD, device=device)}
    w["final_norm"] = draw(gen, (D,), 0.1, 1.0, f32, device)
    w["ln"] = draw(gen, (L, D), 0.1, 1.0, device=device)
    w["in_proj"] = draw(gen, (L, D, X), 1 / math.sqrt(D), device=device)
    w["conv_w"] = draw(gen, (L, K, C), 1 / math.sqrt(K), device=device)
    w["conv_b"] = draw(gen, (L, C), 0.1, device=device)
    w["a_log"] = draw(gen, (L, Hm), 0.5, 1.0, device=device)
    w["d_skip"] = draw(gen, (L, Hm), 0.1, 1.0, device=device)
    w["dt_bias"] = draw(gen, (L, Hm), 1.0, -4.0, device=device)
    w["norm"] = draw(gen, (L, d_in), 0.1, 1.0, device=device)
    w["out_proj"] = draw(gen, (L, d_in, D), 1 / math.sqrt(d_in),
                         device=device)
    # the embedding half of a site's input norm, weighed up to the stream
    emb_half = torch.cat([torch.ones(A - D, device=device),
                          torch.full((D,), 1 / EMBED_STD, device=device)])
    w["blocks"] = [{
        "ln1": draw(gen, (A,), 0.1, 1.0, f32, device) * emb_half,
        "wq": draw(gen, (A, Nq, Hd), 1 / math.sqrt(A), device=device),
        "wk": draw(gen, (A, Nkv, Hd), 1 / math.sqrt(A), device=device),
        "wv": draw(gen, (A, Nkv, Hd), 1 / math.sqrt(A), device=device),
        "wo": draw(gen, (Nq, Hd, D), 1 / math.sqrt(Nq * Hd), device=device),
        "ln2": draw(gen, (D,), 0.1, 1.0, f32, device),
        "w_gate": draw(gen, (D, F), 1 / math.sqrt(D), device=device),
        "w_up": draw(gen, (D, F), 1 / math.sqrt(D), device=device),
        "w_down": draw(gen, (F, D), 1 / math.sqrt(F), device=device)}
        for _ in range(s["blocks"])]
    w["sites"] = [{
        "adapter_a": draw(gen, (D, r), 1 / math.sqrt(D), device=device),
        "adapter_b": draw(gen, (r, 2 * F), 1 / math.sqrt(r), device=device),
        "linear": draw(gen, (D, D), 1 / math.sqrt(D), device=device)}
        for _ in range(s["sites"])]
    w["exit_heads"] = [
        {"norm": draw(gen, (D,), 0.1, 1.0, f32, device),
         "w": draw(gen, (D, V), 1 / math.sqrt(D), device=device)}
        for _ in cfg.get("exit_layers", ())]
    return w


def port_params(model, w: Dict[str, object]):
    """The program's params tree over the benchmark's weights: each leaf
    a view of a benchmark tensor, checked against the shape and dtype of
    ``model.abstract_params()``."""
    params = {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]}}
    blocks = []
    for step in model.plan:
        if step[0] != "scan":
            continue
        _, kind, n, start = step
        if kind != "mamba":
            raise ValueError(f"bench zamba2_hybrid: layer kind {kind!r} has "
                             "no Mamba2 weights")
        block: Dict[str, dict] = {}
        for (group, leaf), name in LAYER_LEAVES.items():
            block.setdefault(group, {})[leaf] = w[name][start:start + n]
        blocks.append(block)
    params["blocks"] = blocks
    params["shared_attn"] = {
        "blocks": [{"ln1": {"scale": b["ln1"]},
                    "attn": {k: b[k] for k in ("wq", "wk", "wv", "wo")},
                    "ln2": {"scale": b["ln2"]},
                    "ffn": {k: b[k] for k in ("w_gate", "w_up", "w_down")}}
                   for b in w["blocks"]],
        "sites": [{"adapter": {"a": t["adapter_a"], "b": t["adapter_b"]},
                   "linear": t["linear"]} for t in w["sites"]]}
    if w["exit_heads"]:
        params["exit_heads"] = [{"norm": {"scale": e["norm"]}, "w": e["w"]}
                                for e in w["exit_heads"]]
    check(params, model.abstract_params())
    return params
