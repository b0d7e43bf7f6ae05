"""Analytic operation and byte counts of BLIP-2's stage-I evaluation (EVA
ViT-g/14 + ``ln_vision``, the Q-Former), from the cell's shapes and the
units of work done, by the rules of ``counts/blip.py``: products at 2 a
multiply-add, LayerNorm, softmax and GELU left out; text at its real token
count (a caption's words + 2, at most ``text_len``); each image's
cross-attention keys and values projected once a call for every cross
layer, however many passes read them (the target pass and the fusion of
its captions).

Attention per call of the model, 4 * Lq * Lk * D operations; bytes in
bfloat16, queries and outputs once a call, keys and values once an image
and layer. ``d88_*`` are the ViT-g's self-attention alone (16 heads of
88, counted at 88 lanes, not at any padded width): the work of the
attention kernel's 88-wide instantiation.
"""
from __future__ import annotations

from cirbench.counts.blip import BF16, Counts, attn_ops, image_tokens, \
    linear, vit_image


def cross_layers(cfg: dict) -> int:
    return -(-cfg["text"]["num_layers"] // cfg["cross_attention_freq"])


def qformer_rows(cfg: dict, n_query: int, n_text: int, m: int) -> Counts:
    """One pass of the Q-Former over ``n_query`` query rows and ``n_text``
    text rows against ``m`` image tokens, without the image's K/V
    projections."""
    t = cfg["text"]
    d, f = t["hidden_size"], t["intermediate_size"]
    rows = n_query + n_text
    c = Counts()
    self_ = 4 * linear(rows, d, d) + attn_ops(rows, rows, d)
    cross = 2 * linear(n_query, d, d) + attn_ops(n_query, m, d)
    ffn = linear(rows, d, f) + linear(rows, f, d)
    c.flops += t["num_layers"] * (self_ + ffn) + cross_layers(cfg) * cross
    c.attn_flops += t["num_layers"] * attn_ops(rows, rows, d) \
        + cross_layers(cfg) * attn_ops(n_query, m, d)
    # self: q, k, v, out of every row; cross: q and out of the query rows
    c.attn_bytes += (t["num_layers"] * 4 * rows
                     + cross_layers(cfg) * 2 * n_query) * d * BF16
    return c


def image_kv(cfg: dict, m: int) -> Counts:
    """One image's cross-attention K/V in every cross layer."""
    t = cfg["text"]
    w, d = t["encoder_width"], t["hidden_size"]
    c = Counts()
    c.flops += cross_layers(cfg) * 2 * linear(m, w, d)
    c.attn_bytes += cross_layers(cfg) * 2 * m * d * BF16
    return c


def stage1_eval_call(cfg: dict, n_images: int, lengths,
                     n_queries: int) -> dict:
    """A stage-I evaluation: ``n_images`` through the ViT-g and the target
    pass, captions of ``lengths`` tokens fused with the queries, and the
    max-over-queries scoring of every caption against every image's
    ``num_query_tokens`` targets."""
    vit, t = cfg["vit"], cfg["text"]
    m, nq, e = image_tokens(vit), cfg["num_query_tokens"], cfg["embed_dim"]
    tower = vit_image(vit)
    c = Counts().add(tower, n_images)
    c.add(image_kv(cfg, m), n_images)
    c.add(qformer_rows(cfg, nq, 0, m), n_images)
    c.flops += n_images * linear(nq, t["hidden_size"], e)
    for length in lengths:
        c.add(qformer_rows(cfg, nq, min(int(length), cfg["text_len"]), m))
        c.flops += linear(1, t["hidden_size"], e)
    c.flops += linear(n_queries, e, n_images * nq)
    return {**c.as_dict(), "d88_attn_flops": n_images * tower.attn_flops,
            "d88_attn_bytes": n_images * tower.attn_bytes}
