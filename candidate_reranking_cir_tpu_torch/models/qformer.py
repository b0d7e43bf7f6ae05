"""BLIP-2's Q-Former (Li et al. 2023, arXiv:2301.12597; Salesforce LAVIS
``lavis/models/blip2_models/Qformer.py`` as ``blip2_qformer.py`` builds
it), from the MED's blocks (``models/med.py``).

A BERT-base encoder (post-LN, eps 1e-12, additive -10000 padding mask)
with ``num_query_tokens`` learned query tokens:

- the embeddings are LN(cat(queries, word + position(text))): the text's
  positions start at 0 and the queries take none (the LayerNorm is
  row-wise, so the two parts are normalised apart);
- every layer's self-attention runs over all rows, the queries and the
  text together, under the padding mask (the queries' entries valid);
- in every ``cross_attention_freq``-th layer (0, 2, ..., 10 in BLIP-2) the
  query rows alone cross-attend to the image tokens, with keys and values
  projected from ``encoder_width``;
- the query rows then go through their own FFN (``ffn_query``: LAVIS's
  ``intermediate_query`` / ``output_query``), the text rows through the
  text FFN (``ffn``).

Image-major, as the MED fuses (``MedLayer``): ``query_group`` Q > 1 holds
Q captions an image, and a cross layer folds their query rows into one
[G, Q * T, D] row block against the image's [G, M, W] tokens, so that each
image's keys and values are projected once a layer, not once a caption.
Eval only: no dropout, no training state.
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import TextEncoderConfig
from candidate_reranking_cir_tpu_torch.models.layers import _normal_
from candidate_reranking_cir_tpu_torch.models.med import (
    BertEmbeddings,
    BertFFN,
    BertSelfAttentionBlock,
)
from candidate_reranking_cir_tpu_torch.ops.attention import make_additive_mask


class QFormerLayer(nn.Module):
    """One layer: self-attention over every row; with ``cross``, the query
    rows' cross-attention to the image; the query FFN and the text FFN."""

    def __init__(self, cfg: TextEncoderConfig, cross: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = BertSelfAttentionBlock(cfg, None, dtype, device)
        self.cross_attn = (BertSelfAttentionBlock(cfg, cfg.encoder_width,
                                                  dtype, device)
                           if cross else None)
        self.ffn = BertFFN(cfg, dtype, device)
        self.ffn_query = BertFFN(cfg, dtype, device)

    def forward(self, x, bias, image, n_query: int, query_group: int = 1):
        """x [G*Q, T + L, D] (T query rows, then L text rows); image
        [G, M, W]."""
        x = self.self_attn(x, None, bias)
        b, rows, d = x.shape
        q = x[:, :n_query]
        if self.cross_attn is not None:
            qg = q.reshape(b // query_group, query_group * n_query, d)
            q = self.cross_attn(qg, image).view(b, n_query, d)
        q = self.ffn_query(q)
        if rows == n_query:
            return q
        return torch.cat([q, self.ffn(x[:, n_query:])], dim=1)


class QFormer(nn.Module):
    """The Q-Former's encoder: the last hidden state [G*Q, T + L, D]."""

    def __init__(self, cfg: TextEncoderConfig, num_query_tokens: int,
                 cross_attention_freq: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.query_tokens = nn.Parameter(_normal_(
            torch.empty(1, num_query_tokens, cfg.hidden_size, device=device),
            cfg.initializer_range))
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cross_attention_freq == 0, dtype, device)
            for i in range(cfg.num_layers))

    @property
    def num_query_tokens(self) -> int:
        return self.query_tokens.shape[1]

    def forward(self, image_embeds, input_ids=None, attention_mask=None, *,
                query_group: int = 1):
        """The queries against ``image_embeds`` [G, M, W]: alone
        (``input_ids`` None; G rows), or joined to the captions
        ``input_ids`` / ``attention_mask`` [G*Q, L], Q captions an image,
        image-contiguous."""
        n_query = self.num_query_tokens
        g = image_embeds.shape[0]
        b = g * query_group if input_ids is None else input_ids.shape[0]
        if b != g * query_group:
            raise ValueError(f"{b} captions for {g} images of "
                             f"{query_group} captions each")
        x = self.embeddings.ln(self.query_tokens.expand(b, -1, -1)
                               .to(self.dtype))
        bias = None
        if input_ids is not None:
            x = torch.cat([x, self.embeddings(input_ids)], dim=1)
            bias = make_additive_mask(torch.cat(
                [attention_mask.new_ones(b, n_query), attention_mask], 1))
        image = image_embeds.to(self.dtype)
        for layer in self.layers:
            x = layer(x, bias, image, n_query, query_group)
        return x
