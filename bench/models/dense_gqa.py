"""Builder of a dense GQA decoder with early-exit heads (Llama, Mistral,
Granite), named ``"model": "dense_gqa"`` in a configuration file.

A builder module gives the runners three functions, so that another
kind of model is one more file here and a configuration naming it:

* ``model_config(cfg)``: the program's ``ModelConfig`` of the file;
* ``make(cfg, seed, device)``: every weight, drawn on the device from
  the seed (``bench/weights.py``), which the plain reference reads too;
* ``port_params(model, w)``: the program's params tree over those same
  tensors, checked against the shapes the program declares.

Draws: embeddings and an untied head N(0, 0.02); every projection
N(0, 1/fan_in); norm scales 1 + N(0, 0.1), so a norm that drops its
scale does not pass unseen.  Layer leaves are stacked over the layers,
one draw a stacked tensor.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench import costs
from bench.weights import check, draw, generator

# the port's stacked layer leaves, by (group, leaf) -> benchmark name
LAYER_LEAVES = {("ln1", "scale"): "ln1", ("attn", "wq"): "wq",
                ("attn", "wk"): "wk", ("attn", "wv"): "wv",
                ("attn", "wo"): "wo", ("ln2", "scale"): "ln2",
                ("ffn", "w_gate"): "w_gate", ("ffn", "w_up"): "w_up",
                ("ffn", "w_down"): "w_down"}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ExitConfig, ModelConfig
    d = cfg["hidden_size"]
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=d,
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or d // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attention="full", rope="rope", rope_theta=cfg["rope_theta"],
        tie_embeddings=bool(cfg.get("tie_word_embeddings")),
        exits=ExitConfig(exit_layers=tuple(cfg.get("exit_layers", ())),
                         entropy_threshold=cfg.get("exit_entropy_threshold",
                                                   0.5)),
        dtype=cfg.get("torch_dtype", "bfloat16"), source=cfg["source"])


def make(cfg: dict, seed: int, device) -> Dict[str, object]:
    """Every weight of the decoder that ``cfg`` describes, from ``seed``."""
    s = costs.shape(cfg)
    L, D, Nq, Nkv, H, F, V = (s[k] for k in ("L", "D", "Nq", "Nkv", "H",
                                             "F", "V"))
    gen = generator(seed, device)
    w = {"embed": draw(gen, (V, D), 0.02, device=device)}
    if not cfg.get("tie_word_embeddings"):
        w["lm_head"] = draw(gen, (V, D), 0.02, device=device)
    w["final_norm"] = draw(gen, (D,), 0.1, 1.0, torch.float32, device)
    w["ln1"] = draw(gen, (L, D), 0.1, 1.0, device=device)
    w["ln2"] = draw(gen, (L, D), 0.1, 1.0, device=device)
    w["wq"] = draw(gen, (L, D, Nq, H), 1 / math.sqrt(D), device=device)
    w["wk"] = draw(gen, (L, D, Nkv, H), 1 / math.sqrt(D), device=device)
    w["wv"] = draw(gen, (L, D, Nkv, H), 1 / math.sqrt(D), device=device)
    w["wo"] = draw(gen, (L, Nq, H, D), 1 / math.sqrt(Nq * H),
                   device=device)
    w["w_gate"] = draw(gen, (L, D, F), 1 / math.sqrt(D), device=device)
    w["w_up"] = draw(gen, (L, D, F), 1 / math.sqrt(D), device=device)
    w["w_down"] = draw(gen, (L, F, D), 1 / math.sqrt(F), device=device)
    w["exit_heads"] = [
        {"norm": draw(gen, (D,), 0.1, 1.0, torch.float32, device),
         "w": draw(gen, (D, V), 1 / math.sqrt(D), device=device)}
        for _ in cfg.get("exit_layers", ())]
    return w


def port_params(model, w: Dict[str, object]):
    """The program's params tree over the benchmark's weights: each leaf
    a view of a stacked tensor, checked against the shape and dtype of
    ``model.abstract_params()``."""
    params = {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]}}
    if "lm_head" in w:
        params["lm_head"] = w["lm_head"]
    blocks = []
    for step in model.plan:
        if step[0] != "scan":
            continue
        _, kind, n, start = step
        if kind != "dense":
            raise ValueError(f"bench dense_gqa: layer kind {kind!r} has no "
                             "GQA decoder weights")
        block: Dict[str, dict] = {}
        for (group, leaf), name in LAYER_LEAVES.items():
            block.setdefault(group, {})[leaf] = w[name][start:start + n]
        blocks.append(block)
    params["blocks"] = blocks
    if w["exit_heads"]:
        params["exit_heads"] = [{"norm": {"scale": e["norm"]}, "w": e["w"]}
                                for e in w["exit_heads"]]
    check(params, model.abstract_params())
    return params
