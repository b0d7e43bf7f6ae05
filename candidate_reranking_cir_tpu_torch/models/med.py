"""MED text encoder (port of the JAX package's ``models/med.py``).

BLIP's single-stream BERT: word + position embeddings, post-LN layers of
self-attention, optional cross-attention over image tokens ('multimodal'
mode), and FFN; additive (1 - mask) * -10000 masking, LayerNorm eps 1e-12.

Training (``deterministic=False``, stage I) takes a seed table of shape
``TextEncoder.seed_shape``: row 0 seeds the embedding dropout, row i + 1
layer i as ``SEED_SITES`` int32 seeds (its generator for the hidden
dropouts and any attention dropout off the kernels' route, then the kernel
seeds of its self-attention and cross-attention). A layer re-seeds its
generator at the start of its forward, so a remat recomputation draws the
same masks. At B = 512 the cross-attention to the 577 image tokens takes
the folded in-kernel-dropout route (K8/K9); the 40-key text self-attention
is below ``attention_train.MIN_KV`` and drops out from the generator, as
the JAX package's does from ``jax.random``.
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import TextEncoderConfig
from candidate_reranking_cir_tpu_torch.models.layers import (
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
    _normal_,
    exact_gelu,
    remat,
    resolve_remat_policy,
    seeded_generator,
)
from candidate_reranking_cir_tpu_torch.ops.attention import make_additive_mask

SEED_SITES = 3  # generator, self-attention, cross-attention


class BertEmbeddings(nn.Module):
    """Word + absolute position embeddings, LayerNorm, dropout."""

    def __init__(self, cfg: TextEncoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        std = cfg.initializer_range
        self.word_embeddings = nn.Parameter(_normal_(
            torch.empty(cfg.vocab_size, cfg.hidden_size, device=device), std))
        self.position_embeddings = nn.Parameter(_normal_(
            torch.empty(cfg.max_position_embeddings, cfg.hidden_size,
                        device=device), std))
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype, device)
        self.drop = Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, *, deterministic: bool = True,
                generator=None):
        seq_len = input_ids.shape[-1]
        x = self.word_embeddings[input_ids.long()] \
            + self.position_embeddings[:seq_len]
        return self.drop(self.ln(x.to(self.dtype)),
                         deterministic=deterministic, generator=generator)


class BertSelfAttentionBlock(nn.Module):
    """Attention + output dense + residual + post-LN."""

    def __init__(self, cfg: TextEncoderConfig, kv_features: int | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.attn = MultiHeadAttention(cfg.num_heads, cfg.head_dim,
                                       cfg.hidden_size, kv_features, dtype,
                                       device, cfg.attention_dropout)
        self.drop = Dropout(cfg.hidden_dropout)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype, device)

    def forward(self, x, kv=None, bias=None, *, deterministic: bool = True,
                seed: int | None = None, generator=None):
        ctx = self.attn(x, kv, bias, deterministic=deterministic, seed=seed,
                        generator=generator)
        ctx = self.drop(ctx, deterministic=deterministic, generator=generator)
        return self.ln(ctx + x)


class BertFFN(nn.Module):
    """Intermediate GELU dense -> output dense -> dropout -> residual
    post-LN."""

    def __init__(self, cfg: TextEncoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                                  dtype, device)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, dtype,
                            device)
        self.drop = Dropout(cfg.hidden_dropout)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype, device)

    def forward(self, x, *, deterministic: bool = True, generator=None):
        h = self.output(exact_gelu(self.intermediate(x)))
        h = self.drop(h, deterministic=deterministic, generator=generator)
        return self.ln(h + x)


class MedLayer(nn.Module):
    """One MED layer; its cross-attention runs only in 'multimodal' mode.
    ``seeds``: the layer's row of the seed table, or None at eval.

    ``query_group`` Q > 1: image-major fusion. ``x`` holds Q queries per
    image ([G*Q, L, D] against ``image_kv`` [G, M, W]) and the
    cross-attention folds them into its row axis ([G, Q*L, D]), so each
    image's K/V projections run once per image, not once per query. The
    self-attention and the FFN stay per query; the residual and post-LN
    inside the block are row-wise, so running them folded is exact."""

    def __init__(self, cfg: TextEncoderConfig, multimodal: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = BertSelfAttentionBlock(cfg, None, dtype, device)
        self.cross_attn = (BertSelfAttentionBlock(cfg, cfg.encoder_width,
                                                  dtype, device)
                           if multimodal else None)
        self.ffn = BertFFN(cfg, dtype, device)

    def forward(self, x, text_bias, image_kv=None, image_bias=None,
                seeds=None, query_group: int = 1):
        det = seeds is None
        gen = None if det else seeded_generator(seeds[0], x.device)
        x = self.self_attn(x, None, text_bias, deterministic=det,
                           seed=None if det else seeds[1], generator=gen)
        if image_kv is not None:
            b, l, d = x.shape
            # [G*Q, L, D] -> [G, Q*L, D]: a view of contiguous rows
            xg = x.view(b // query_group, query_group * l, d)
            xg = self.cross_attn(xg, image_kv, image_bias, deterministic=det,
                                 seed=None if det else seeds[2],
                                 generator=gen)
            x = xg.view(b, l, d)
        return self.ffn(x, deterministic=det, generator=gen)


class TextEncoder(nn.Module):
    """Single-stream MED encoder returning last_hidden_state [B, L, D].

    mode='text': self-attention only; 'multimodal': every layer also
    cross-attends to ``image_embeds`` [B, M, W] (``image_mask`` [B, M]
    optional; image tokens are never padded on the ported paths).
    ``query_group`` Q > 1 (eval, multimodal): ``input_ids`` [G*Q, L] holds Q
    queries per image of ``image_embeds`` [G, M, W], image-contiguous
    (image-major fusion, see ``MedLayer``).
    ``cfg.remat`` recomputes each layer in backward when gradients are on,
    under ``cfg.remat_policy`` (``models/layers.py::remat``)."""

    def __init__(self, cfg: TextEncoderConfig, mode: str = "multimodal",
                 dtype=torch.float32, device=None):
        super().__init__()
        if mode not in ("text", "multimodal"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.remat_policy = (resolve_remat_policy(cfg.remat_policy)
                             if cfg.remat else None)
        self.mode = mode
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.layers = nn.ModuleList(
            MedLayer(cfg, mode == "multimodal", dtype, device)
            for _ in range(cfg.num_layers))

    @property
    def seed_shape(self) -> tuple[int, int]:
        return (len(self.layers) + 1, SEED_SITES)

    def forward(self, input_ids, attention_mask, image_embeds=None,
                image_mask=None, *, mode: str | None = None,
                deterministic: bool = True, seeds=None,
                query_group: int = 1):
        multimodal = (mode if mode is not None else self.mode) == "multimodal"
        if multimodal and self.mode != "multimodal":
            raise ValueError("this encoder was built without cross-attention")
        if not deterministic and seeds is None:
            raise ValueError("training needs a seed table")
        emb_gen = None if deterministic else seeded_generator(
            seeds[0][0], input_ids.device)
        x = self.embeddings(input_ids, deterministic=deterministic,
                            generator=emb_gen)
        text_bias = make_additive_mask(attention_mask)
        image_bias = None
        if multimodal:
            if image_embeds is None:
                raise ValueError("multimodal mode needs image_embeds")
            if query_group > 1 and \
                    input_ids.shape[0] != image_embeds.shape[0] * query_group:
                raise ValueError("query_group fusion needs input_ids [G*Q, L] "
                                 "with image_embeds [G, M, W]")
            image_embeds = image_embeds.to(self.dtype)
            if image_mask is not None:
                image_bias = make_additive_mask(image_mask)
        else:
            image_embeds, query_group = None, 1
        recompute = self.cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            row = None if deterministic else seeds[i + 1]
            if recompute:
                x = remat(layer, x, text_bias, image_embeds, image_bias, row,
                          query_group, policy=self.remat_policy)
            else:
                x = layer(x, text_bias, image_embeds, image_bias, row,
                          query_group)
        return x
