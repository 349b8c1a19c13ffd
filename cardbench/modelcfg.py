"""A configuration file (``configs/<name>.json``) as the program's
``ModelConfig``: the port's field for each published key."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def program_config(cfg: dict):
    from repro_torch.models.config import ModelConfig
    moe = bool(cfg.get("num_experts"))
    kw = dict(name=cfg["name"], family="moe" if moe else "dense",
              n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
              n_heads=cfg["num_attention_heads"],
              n_kv_heads=cfg["num_key_value_heads"],
              d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
              qkv_bias=cfg["qkv_bias"],
              tie_embeddings=cfg["tie_word_embeddings"],
              rope_theta=float(cfg["rope_theta"]),
              norm_eps=float(cfg["rms_norm_eps"]), dtype=cfg["torch_dtype"])
    if moe:
        f = cfg["moe_intermediate_size"]
        kw.update(n_experts=cfg["num_experts"],
                  topk=cfg["num_experts_per_tok"], moe_d_ff=f,
                  n_shared_experts=cfg["shared_expert_intermediate_size"]
                  // f,
                  capacity_factor=float(cfg["assumed"]["capacity_factor"]))
    mc = ModelConfig(**kw)
    if mc.padded_vocab != cfg["assumed"]["padded_vocab"]:
        raise ValueError(f"{cfg['name']}: the program pads the vocabulary to "
                         f"{mc.padded_vocab}, the file says "
                         f"{cfg['assumed']['padded_vocab']}")
    return mc
