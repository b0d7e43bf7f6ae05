"""Analytic operation and byte counts of the BLIP models' work, from the
cell's shapes and the units of work done. The model FLOPs count the
products (2 per multiply-add); LayerNorm, softmax and GELU are left out.

The counts are of the work the model needs, not of what a schedule runs:
- text at its real token count (a query's words + 2), never at the padded
  width of a bucket;
- each image's cross-attention keys and values projected once a call for
  every layer and stream, however many queries attend to it.
A schedule that pads rows or projects an image twice spends time on it
but does no more work, so a later change of kernel or schedule cannot make
these counts stale.

Attention is counted per attention call of the model: 4 * Lq * Lk * D
operations (the scores and the weighted sum, all heads), and its bytes
in bfloat16: queries and outputs once per call, keys and values once per
image and layer (a text self-attention's keys and values once per query).
Patterns from the JAX package's benchmark (``vit_fwd_flops``,
``med_fwd_flops``, ``dual_fwd_flops``), rewritten.
"""
from __future__ import annotations

BF16 = 2


def linear(n: float, d_in: int, d_out: int) -> float:
    return 2.0 * n * d_in * d_out


def attn_ops(lq: float, lk: float, d: int) -> float:
    return 4.0 * lq * lk * d


class Counts:
    """Running totals: ``flops`` of the whole model, ``attn_flops`` and
    ``attn_bytes`` of its attention."""

    def __init__(self):
        self.flops = 0.0
        self.attn_flops = 0.0
        self.attn_bytes = 0.0

    def add(self, other: "Counts", times: float = 1.0) -> "Counts":
        self.flops += other.flops * times
        self.attn_flops += other.attn_flops * times
        self.attn_bytes += other.attn_bytes * times
        return self

    def as_dict(self) -> dict:
        return {"flops": self.flops, "attn_flops": self.attn_flops,
                "attn_bytes": self.attn_bytes}


def vit_image(vit: dict) -> Counts:
    """One image through the ViT."""
    d, p = vit["hidden_size"], vit["patch_size"]
    n = (vit["image_size"] // p) ** 2
    s = n + 1
    mlp = int(d * vit["mlp_ratio"])
    c = Counts()
    c.flops += linear(n, p * p * 3, d)
    per_layer = (4 * linear(s, d, d) + attn_ops(s, s, d)
                 + linear(s, d, mlp) + linear(s, mlp, d))
    c.flops += vit["num_layers"] * per_layer
    c.attn_flops += vit["num_layers"] * attn_ops(s, s, d)
    c.attn_bytes += vit["num_layers"] * 4 * s * d * BF16
    return c


def image_tokens(vit: dict) -> int:
    return (vit["image_size"] // vit["patch_size"]) ** 2 + 1


def med_query(text: dict, length: int, m: int) -> Counts:
    """One query of ``length`` tokens through the MED in multimodal mode,
    against ``m`` image tokens, without the image's K/V projections."""
    d, f, n = text["hidden_size"], text["intermediate_size"], \
        text["num_layers"]
    c = Counts()
    self_ = 4 * linear(length, d, d) + attn_ops(length, length, d)
    cross = 2 * linear(length, d, d) + attn_ops(length, m, d)
    ffn = linear(length, d, f) + linear(length, f, d)
    c.flops += n * (self_ + cross + ffn)
    c.attn_flops += n * (attn_ops(length, length, d)
                         + attn_ops(length, m, d))
    # self: q, k, v, out of the query; cross: q and out
    c.attn_bytes += n * 6 * length * d * BF16
    return c


def med_image_kv(text: dict, m: int) -> Counts:
    """One image's cross-attention K/V in every MED layer."""
    w, d, n = text["encoder_width"], text["hidden_size"], text["num_layers"]
    c = Counts()
    c.flops += n * 2 * linear(m, w, d)
    c.attn_bytes += n * 2 * m * d * BF16
    return c


def dual_pair(text: dict, length: int, m: int) -> Counts:
    """One (query, candidate) pair through the dual-stream encoder and the
    head, without the candidate's K/V projections."""
    d, f, n = text["hidden_size"], text["intermediate_size"], \
        text["num_layers"]
    merges = n - text["merge_mlp_from"]
    c = Counts()
    per_stream = (4 * linear(length, d, d) + attn_ops(length, length, d)
                  + 2 * linear(length, d, d) + attn_ops(length, m, d)
                  + linear(length, d, f) + linear(length, f, d))
    c.flops += n * 2 * per_stream + merges * linear(length, 2 * d, d)
    c.flops += linear(1, 2 * d, d) + linear(1, d, 2)
    c.attn_flops += n * 2 * (attn_ops(length, length, d)
                             + attn_ops(length, m, d))
    c.attn_bytes += n * 2 * 6 * length * d * BF16
    return c


def dual_candidate_kv(text: dict, m: int) -> Counts:
    """One candidate's cross-attention K/V, both streams, every layer."""
    w, d, n = text["encoder_width"], text["hidden_size"], text["num_layers"]
    c = Counts()
    c.flops += n * 2 * 2 * linear(m, w, d)
    c.attn_bytes += n * 2 * 2 * m * d * BF16
    return c


def stage1_eval_call(cfg: dict, n_images: int, lengths, ref_images: int,
                     n_queries: int) -> Counts:
    """A stage-I evaluation: ``n_images`` embedded and pooled, queries of
    ``lengths`` fused against ``ref_images`` distinct reference images,
    and the cosine ranking of every query against the corpus."""
    vit, text = cfg["vit"], cfg["text"]
    m = image_tokens(vit)
    c = Counts().add(vit_image(vit), n_images)
    c.flops += n_images * linear(1, vit["hidden_size"], cfg["embed_dim"])
    c.add(med_image_kv(text, m), ref_images)
    for length in lengths:
        c.add(med_query(text, int(length), m))
        c.flops += linear(1, text["hidden_size"], cfg["embed_dim"])
    c.flops += linear(n_queries, cfg["embed_dim"], n_images)
    return c


def rerank_eval_call(cfg: dict, n_images: int, zt_lengths, ref_images: int,
                     pair_lengths, candidates: int) -> Counts:
    """A stage-II re-rank evaluation: the bank of ``n_images``, z_t of
    queries of ``zt_lengths`` over ``ref_images`` distinct references,
    and the pairs (one entry of ``pair_lengths`` each) over
    ``candidates`` distinct candidate images."""
    vit, text = cfg["vit"], cfg["text"]
    m = image_tokens(vit)
    c = Counts().add(vit_image(vit), n_images)
    c.add(med_image_kv(text, m), ref_images)
    for length in zt_lengths:
        c.add(med_query(text, int(length), m))
    c.add(dual_candidate_kv(text, m), candidates)
    for length in pair_lengths:
        c.add(dual_pair(text, int(length), m))
    return c
