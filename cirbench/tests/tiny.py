"""Tiny widths and traffic for rehearsing the cells on the CPU."""
from __future__ import annotations

import copy

TINY_VIT = {"image_size": 32, "patch_size": 16, "hidden_size": 64,
            "num_layers": 2, "num_heads": 4, "mlp_ratio": 2.0}
TINY_TEXT = {"vocab_size": 128, "hidden_size": 64, "num_layers": 2,
             "num_heads": 4, "intermediate_size": 96,
             "max_position_embeddings": 48, "encoder_width": 64,
             "merge_mlp_from": 1}


def tiny_config(cfg: dict, dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["vit"].update(TINY_VIT)
    cfg["text"].update(TINY_TEXT)
    cfg["embed_dim"] = 32
    cfg["dtype"] = dtype
    return cfg


def tiny_traffic(traffic: dict) -> dict:
    traffic = copy.deepcopy(traffic)
    traffic["images"] = 40
    traffic["queries"] = 24
    if "top_k" in traffic:
        traffic["top_k"] = 10
    if "k" in traffic:
        traffic["k"] = 10
    return traffic
