"""Dual-stream re-rank encoder, candidate-major layout (port of the JAX
package's ``models/dual_encoder.py``).

Stream 0 starts from the stage-I query state z_t, stream 1 from fresh text
embeddings. Each layer: twin self-attention (own weights and LayerNorms),
twin cross-attention over the candidate's image tokens whose outputs are
averaged below ``merge_mlp_from`` and merged by a Linear(2D -> D) from
there on, a per-stream LayerNorm on the merged residual, and a shared FFN.
Output: the two streams' CLS states concatenated, [.., 2D].

Candidate-major: axis 0 indexes candidates and axis 1 the queries scored
against each, so a candidate's cross-attention K/V are projected once and
shared by all of its queries (``grid_cross_attention``).
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import TextEncoderConfig
from candidate_reranking_cir_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadAttention,
)
from candidate_reranking_cir_tpu_torch.models.med import (
    BertEmbeddings,
    BertFFN,
)
from candidate_reranking_cir_tpu_torch.ops.attention import (
    grid_cross_attention,
    make_additive_mask,
)


class DualLayer(nn.Module):
    """One dual-stream layer over h0, h1 [A, B, L, D] and cand [A, M, W]."""

    def __init__(self, cfg: TextEncoderConfig, merge_mlp: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        d, w = cfg.hidden_size, cfg.encoder_width
        hd = cfg.num_heads * cfg.head_dim
        self.num_heads, self.head_dim = cfg.num_heads, cfg.head_dim
        eps = cfg.layer_norm_eps
        for s in ("0", "1"):
            setattr(self, f"self_attn{s}", MultiHeadAttention(
                cfg.num_heads, cfg.head_dim, d, dtype=dtype, device=device))
            setattr(self, f"self_ln{s}", LayerNorm(d, eps, dtype, device))
            setattr(self, f"cross_q{s}", Dense(d, hd, dtype, device))
            setattr(self, f"cross_k{s}", Dense(w, hd, dtype, device))
            setattr(self, f"cross_v{s}", Dense(w, hd, dtype, device))
            setattr(self, f"cross_dense{s}", Dense(hd, d, dtype, device))
            setattr(self, f"cross_ln{s}", LayerNorm(d, eps, dtype, device))
        self.merge = Dense(2 * d, d, dtype, device) if merge_mlp else None
        self.ffn = BertFFN(cfg, dtype, device)

    def _cross(self, s: str, h, cand):
        heads = (self.num_heads, self.head_dim)
        q = getattr(self, f"cross_q{s}")(h).unflatten(-1, heads)
        k = getattr(self, f"cross_k{s}")(cand).unflatten(-1, heads)
        v = getattr(self, f"cross_v{s}")(cand).unflatten(-1, heads)
        ctx = grid_cross_attention(q, k, v).flatten(-2)
        return getattr(self, f"cross_dense{s}")(ctx)

    def forward(self, h0, h1, text_bias, cand):
        h0 = self.self_ln0(self.self_attn0(h0, None, text_bias) + h0)
        h1 = self.self_ln1(self.self_attn1(h1, None, text_bias) + h1)
        d0, d1 = self._cross("0", h0, cand), self._cross("1", h1, cand)
        if self.merge is not None:
            merged = self.merge(torch.cat([d0, d1], dim=-1))
        else:
            merged = (d0 + d1) * 0.5
        g0 = self.cross_ln0(merged + h0)
        g1 = self.cross_ln1(merged + h1)
        return self.ffn(g0), self.ffn(g1)


class DualStreamEncoder(nn.Module):
    """Candidate-major dual-stream encoder.

    input_ids, attention_mask [A, B, L] and z_t [A, B, L, D] per pair
    (candidate a x its b-th query); cand_feats [A, M, W] per candidate.
    Returns [A, B, 2D], the concatenated CLS states of both streams."""

    def __init__(self, cfg: TextEncoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.layers = nn.ModuleList(
            DualLayer(cfg, i >= cfg.merge_mlp_from, dtype, device)
            for i in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask, z_t, cand_feats):
        h1 = self.embeddings(input_ids)
        h0 = z_t.to(self.dtype)
        cand = cand_feats.to(self.dtype)
        text_bias = make_additive_mask(attention_mask)  # [A, B, 1, 1, L]
        for layer in self.layers:
            h0, h1 = layer(h0, h1, text_bias, cand)
        return torch.cat([h0[..., 0, :], h1[..., 0, :]], dim=-1)
