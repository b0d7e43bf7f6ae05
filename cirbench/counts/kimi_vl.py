"""Analytic operation and byte counts of Kimi-VL-A3B-Instruct as a point-wise
re-ranker (MoonViT, the projector, the deepseek_v3 decoder), from the
cell's shapes and the units of work done, by the rules of
``counts/blip.py``: products at 2 a multiply-add; norms, softmax, rotary
embeddings, SiLU and GELU left out; bytes in bfloat16.

The work the scorer needs, whatever the schedule:
- MoonViT and the projector once per corpus image;
- each query's prefix (its real tokens, never padding) once, causal;
- each (query, candidate) suffix of 216 tokens once, its rows attending to
  the prefix's tokens and causally to its own; at the last layer only the
  last row's query, attention output and FFN (the score reads nothing
  else), every row's latent and K/V (its keys); the two head rows of yes
  and no at the last row.

Routed experts: 2 * rows * k * 3 * D * F operations a layer (gate, up,
down), and as the least bytes of each grouped pass the experts' weights
read once plus each routed row's input read and output written once
(``moe_*``, per pass, for the roofline of the grouped products). Attention:
``attn_*`` is MoonViT's 72-wide self-attention alone (``d72_*``), 4 * N *
N * D a block, bytes q, k, v and out once.
"""
from __future__ import annotations

from cirbench.counts.blip import BF16, linear
from cirbench.counts.kernels import least_seconds


def image_tokens(cfg: dict) -> int:
    v = cfg["vision"]
    return (v["image_size"] // v["patch_size"] // v["merge"]) ** 2


def moonvit_image(cfg: dict) -> dict:
    """One image through MoonViT and the projector: (flops, d72 attention
    flops, d72 attention bytes)."""
    v = cfg["vision"]
    d, p, f = v["hidden_size"], v["patch_size"], v["intermediate_size"]
    n = (v["image_size"] // p) ** 2
    attn = 4.0 * n * n * d
    block = (linear(n, d, 3 * d) + attn + linear(n, d, d) + linear(n, d, f)
             + linear(n, f, d))
    merged = d * v["merge"] ** 2
    m = image_tokens(cfg)
    flops = (linear(n, p * p * 3, d) + v["num_layers"] * block
             + linear(m, merged, merged) + linear(m, merged,
                                                  cfg["hidden_size"]))
    return {"flops": flops, "attn_flops": v["num_layers"] * attn,
            "attn_bytes": v["num_layers"] * 4 * n * d * BF16}


def _projections(cfg: dict, rows: float) -> float:
    """MLA's products over ``rows`` tokens: q, kv_a, kv_b, o."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
    return (linear(rows, d, h * qk) + linear(rows, d, r
                                             + cfg["qk_rope_head_dim"])
            + linear(rows, r, h * (cfg["qk_nope_head_dim"] + vd))
            + linear(rows, h * vd, d))


def _keys(cfg: dict, rows: float) -> float:
    """The latent and K/V of ``rows`` tokens (kv_a, kv_b)."""
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["kv_lora_rank"]
    return (linear(rows, d, r + cfg["qk_rope_head_dim"])
            + linear(rows, r, h * (cfg["qk_nope_head_dim"]
                                   + cfg["v_head_dim"])))


def _scores(cfg: dict, pairs: float) -> float:
    """Attention's products over ``pairs`` (query row, key) pairs."""
    h = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2.0 * pairs * h * (qk + cfg["v_head_dim"])


def _ffn(cfg: dict, rows: float, dense: bool) -> float:
    d = cfg["hidden_size"]
    if dense:
        return 3 * linear(rows, d, cfg["intermediate_size"])
    f = cfg["moe_intermediate_size"]
    return (linear(rows, d, cfg["n_routed_experts"])
            + 3 * linear(rows * cfg["num_experts_per_tok"], d, f)
            + 3 * linear(rows, d, f * cfg["n_shared_experts"]))


def moe_pass(cfg: dict, rows: float) -> dict:
    """One grouped pass of a layer's routed experts over ``rows`` tokens:
    its operations and least bytes."""
    d, f, e = (cfg["hidden_size"], cfg["moe_intermediate_size"],
               cfg["n_routed_experts"])
    slots = rows * cfg["num_experts_per_tok"]
    return {"flops": 3 * linear(slots, d, f),
            "bytes": (e * 3 * d * f + slots * 2 * d) * BF16}


def lm_call(cfg: dict, prefix_lengths, n_suffix: float,
            suffix_len: int) -> float:
    """The LM's operations over prefixes of ``prefix_lengths`` tokens, each
    with ``n_suffix`` suffixes of ``suffix_len``."""
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    flops = 0.0
    for lp in prefix_lengths:
        lp = float(lp)
        rows = n_suffix * suffix_len
        flops += sum(_projections(cfg, lp) + _scores(cfg, lp * (lp + 1) / 2)
                     + _ffn(cfg, lp, i < dense) for i in range(layers))
        keys = n_suffix * (suffix_len * lp
                           + suffix_len * (suffix_len + 1) / 2)
        for i in range(layers - 1):
            flops += (_projections(cfg, rows) + _scores(cfg, keys)
                      + _ffn(cfg, rows, i < dense))
        # the last layer: every row's keys, the last row's q, o and FFN
        last = n_suffix
        flops += (_keys(cfg, rows) + _projections(cfg, last)
                  - _keys(cfg, last)
                  + _scores(cfg, last * (lp + suffix_len))
                  + _ffn(cfg, last, layers - 1 < dense))
        flops += linear(last, cfg["hidden_size"], 2)
    return flops


def rerank_eval_call(cfg: dict, n_images: int, prefix_lengths, n_suffix: int,
                     suffix_len: int, moe_passes: list[float]) -> dict:
    """One evaluation: the bank of ``n_images``, then every query's prefix
    and suffixes. ``moe_passes``: the routed rows of each grouped pass the
    call makes (from the schedule's shapes), for the experts' least time."""
    img = moonvit_image(cfg)
    passes = [moe_pass(cfg, rows) for rows in moe_passes]
    least = sum(least_seconds(p["flops"], p["bytes"]) for p in passes)
    moe_flops = sum(p["flops"] for p in passes)
    return {"flops": n_images * img["flops"]
            + lm_call(cfg, prefix_lengths, n_suffix, suffix_len),
            "d72_attn_flops": n_images * img["attn_flops"],
            "d72_attn_bytes": n_images * img["attn_bytes"],
            "moe_least_s": least, "moe_flops": moe_flops}
