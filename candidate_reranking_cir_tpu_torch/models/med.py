"""MED text encoder (port of the JAX package's ``models/med.py``).

BLIP's single-stream BERT: word + position embeddings, post-LN layers of
self-attention, optional cross-attention over image tokens ('multimodal'
mode), and FFN; additive (1 - mask) * -10000 masking, LayerNorm eps 1e-12.
The embeddings, attention blocks and FFN carry the JAX package's dropout
sites (``deterministic=False`` with a generator); ``TextEncoder`` runs at
eval only (stage-I training is not ported yet).
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
)
from candidate_reranking_cir_tpu_torch.ops.attention import make_additive_mask


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
    """One MED layer; its cross-attention runs only in 'multimodal' mode."""

    def __init__(self, cfg: TextEncoderConfig, multimodal: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = BertSelfAttentionBlock(cfg, None, dtype, device)
        self.cross_attn = (BertSelfAttentionBlock(cfg, cfg.encoder_width,
                                                  dtype, device)
                           if multimodal else None)
        self.ffn = BertFFN(cfg, dtype, device)

    def forward(self, x, text_bias, image_kv=None, image_bias=None):
        x = self.self_attn(x, None, text_bias)
        if image_kv is not None:
            x = self.cross_attn(x, image_kv, image_bias)
        return self.ffn(x)


class TextEncoder(nn.Module):
    """Single-stream MED encoder returning last_hidden_state [B, L, D].

    mode='text': self-attention only; 'multimodal': every layer also
    cross-attends to ``image_embeds`` [B, M, W] (``image_mask`` [B, M]
    optional; image tokens are never padded on the eval path)."""

    def __init__(self, cfg: TextEncoderConfig, mode: str = "multimodal",
                 dtype=torch.float32, device=None):
        super().__init__()
        if mode not in ("text", "multimodal"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.layers = nn.ModuleList(
            MedLayer(cfg, mode == "multimodal", dtype, device)
            for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask, image_embeds=None,
                image_mask=None, *, mode: str | None = None):
        multimodal = (mode if mode is not None else self.mode) == "multimodal"
        if multimodal and self.mode != "multimodal":
            raise ValueError("this encoder was built without cross-attention")
        x = self.embeddings(input_ids)
        text_bias = make_additive_mask(attention_mask)
        image_bias = None
        if multimodal:
            if image_embeds is None:
                raise ValueError("multimodal mode needs image_embeds")
            image_embeds = image_embeds.to(self.dtype)
            if image_mask is not None:
                image_bias = make_additive_mask(image_mask)
        else:
            image_embeds = None
        for layer in self.layers:
            x = layer(x, text_bias, image_embeds, image_bias)
        return x
