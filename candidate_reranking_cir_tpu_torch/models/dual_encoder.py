"""Dual-stream re-rank encoder (port of the JAX package's
``models/dual_encoder.py``).

Stream 0 starts from the stage-I query state z_t, stream 1 from fresh text
embeddings. Each layer: twin self-attention (own weights and LayerNorms),
twin cross-attention over the candidate's image tokens whose outputs are
averaged below ``merge_mlp_from`` and merged by a Linear(2D -> D) from
there on, a per-stream LayerNorm on the merged residual, and a shared FFN.
Output: the two streams' CLS states concatenated, [.., 2D].

Three candidate layouts:
- 'cand_major' (eval): axis 0 indexes candidates and axis 1 the queries
  scored against each, so a candidate's cross-attention K/V are projected
  once and shared by all of its queries (``grid_cross_attention``);
- 'shared' (training's in-batch B x B contrast): queries [Q] x one shared
  candidate set [C]; both streams broadcast over C and the candidates' K/V
  are shared across the query axis (``pair_cross_attention``);
- 'per_pair' (eval, query-major re-rank and serving): queries [Q] x their
  own candidates [Q, C]; one K/V per (query, candidate) pair
  (``dot_product_attention``, K3 at [Q*C, L, H, D] x [Q*C, M, H, D]). With
  a ``pair_map`` [Q, C] the candidates are a chunk's U unique ones
  [U, M, W]: K/V are projected once a unique candidate and gathered into
  the pair grid.

Every layout also runs with dropout (``deterministic=False``), through the
JAX package's train routes: the cross-attention K6/K7 where
``attention_train.eligible`` holds (candidate-major and shared on their
[A|C, B*Lq] folds, per pair on its [Q*C, L] entries), else plain
attention with dropout from the layer's generator.

Training (``deterministic=False``) takes a seed table of shape
``seed_shape``: row 0 seeds the embedding dropout, row i + 1 layer i as
``SEED_SITES`` int32 seeds (its generator for the non-kernel dropouts,
then the kernel seeds of self-attention 0/1 and cross-attention 0/1). A
layer re-seeds its generator at the start of its forward, so the forward
is a pure function of (inputs, weights, seeds) and a remat recomputation
draws the same masks.
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
    remat,
    resolve_remat_policy,
    seeded_generator,
)
from candidate_reranking_cir_tpu_torch.models.med import (
    BertEmbeddings,
    BertFFN,
)
from candidate_reranking_cir_tpu_torch.ops.attention import (
    dot_product_attention,
    grid_cross_attention,
    make_additive_mask,
    pair_cross_attention,
)

SEED_SITES = 5  # generator, self-attention 0/1, cross-attention 0/1
LAYOUTS = ("cand_major", "shared", "per_pair")


class DualLayer(nn.Module):
    """One dual-stream layer over h0, h1 [A, B, L, D] with cand [A, M, W]
    ('cand_major'), or h0, h1 [Q, C, L, D] with cand [C, M, W] ('shared'),
    [Q, C, M, W] ('per_pair') or [U, M, W] and ``pair_map`` [Q, C]
    ('per_pair', indexed)."""

    def __init__(self, cfg: TextEncoderConfig, merge_mlp: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        d, w = cfg.hidden_size, cfg.encoder_width
        hd = cfg.num_heads * cfg.head_dim
        self.num_heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.attention_dropout = cfg.attention_dropout
        eps = cfg.layer_norm_eps
        for s in ("0", "1"):
            setattr(self, f"self_attn{s}", MultiHeadAttention(
                cfg.num_heads, cfg.head_dim, d, dtype=dtype, device=device,
                dropout_rate=cfg.attention_dropout))
            setattr(self, f"self_ln{s}", LayerNorm(d, eps, dtype, device))
            setattr(self, f"cross_q{s}", Dense(d, hd, dtype, device))
            setattr(self, f"cross_k{s}", Dense(w, hd, dtype, device))
            setattr(self, f"cross_v{s}", Dense(w, hd, dtype, device))
            setattr(self, f"cross_dense{s}", Dense(hd, d, dtype, device))
            setattr(self, f"cross_ln{s}", LayerNorm(d, eps, dtype, device))
        self.merge = Dense(2 * d, d, dtype, device) if merge_mlp else None
        self.drop = Dropout(cfg.hidden_dropout)
        self.ffn = BertFFN(cfg, dtype, device)

    def _cross(self, s: str, h, cand, layout: str, det: bool, seed, gen,
               pair_map=None):
        heads = (self.num_heads, self.head_dim)
        q = getattr(self, f"cross_q{s}")(h).unflatten(-1, heads)
        k = getattr(self, f"cross_k{s}")(cand).unflatten(-1, heads)
        v = getattr(self, f"cross_v{s}")(cand).unflatten(-1, heads)
        drop = dict(dropout_rate=self.attention_dropout, deterministic=det,
                    seed=seed, generator=gen)
        if layout == "shared":
            ctx = pair_cross_attention(q, k, v, **drop)
        elif layout == "cand_major":
            ctx = grid_cross_attention(q, k, v, **drop)
        else:
            if pair_map is not None:
                # K/V of the U unique candidates -> the [Q, C] pair grid
                flat = pair_map.reshape(-1)
                k = k.index_select(0, flat).unflatten(0, pair_map.shape)
                v = v.index_select(0, flat).unflatten(0, pair_map.shape)
            ctx = dot_product_attention(q, k, v, **drop)
        return getattr(self, f"cross_dense{s}")(ctx.flatten(-2))

    def forward(self, h0, h1, text_bias, cand, seeds=None,
                layout: str = "cand_major", pair_map=None):
        det = seeds is None
        gen = None if det else seeded_generator(seeds[0], h0.device)
        site = (lambda i: None) if det else (lambda i: seeds[i])
        hs = []
        for s, h in (("0", h0), ("1", h1)):
            ctx = getattr(self, f"self_attn{s}")(
                h, None, text_bias, deterministic=det, seed=site(1 + int(s)),
                generator=gen)
            ctx = self.drop(ctx, deterministic=det, generator=gen)
            hs.append(getattr(self, f"self_ln{s}")(ctx, h))
        h0, h1 = hs
        d0 = self._cross("0", h0, cand, layout, det, site(3), gen, pair_map)
        d1 = self._cross("1", h1, cand, layout, det, site(4), gen, pair_map)
        if self.merge is not None:
            merged = self.merge(torch.cat([d0, d1], dim=-1))
        else:
            merged = (d0 + d1) * 0.5
        merged = self.drop(merged, deterministic=det, generator=gen)
        g0 = self.cross_ln0(merged, h0)
        g1 = self.cross_ln1(merged, h1)
        return (self.ffn(g0, deterministic=det, generator=gen),
                self.ffn(g1, deterministic=det, generator=gen))


class DualStreamEncoder(nn.Module):
    """Dual-stream encoder over a pair grid.

    'cand_major': input_ids, attention_mask [A, B, L] and z_t [A, B, L, D]
    per pair (candidate a x its b-th query); cand_feats [A, M, W] per
    candidate. Returns [A, B, 2D].
    'shared': input_ids, attention_mask [Q, L] and z_t [Q, L, D] per query;
    cand_feats [C, M, W] shared by all queries. Returns [Q, C, 2D].
    'per_pair': as 'shared', with cand_feats [Q, C, M, W] (each query's own
    candidates), or the U unique candidates [U, M, W] and ``pair_map``
    [Q, C] int (the indexed mode; 'per_pair' is then implied).

    ``cfg.remat`` recomputes each layer in backward when gradients are on,
    under ``cfg.remat_policy`` (``models/layers.py::remat``)."""

    def __init__(self, cfg: TextEncoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.remat_policy = (resolve_remat_policy(cfg.remat_policy)
                             if cfg.remat else None)
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.layers = nn.ModuleList(
            DualLayer(cfg, i >= cfg.merge_mlp_from, dtype, device)
            for i in range(cfg.num_layers))

    @property
    def seed_shape(self) -> tuple[int, int]:
        return (len(self.layers) + 1, SEED_SITES)

    def forward(self, input_ids, attention_mask, z_t, cand_feats, *,
                layout: str = "cand_major", deterministic: bool = True,
                seeds=None, pair_map=None):
        if pair_map is not None:
            layout = "per_pair"
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; expected one of "
                             f"{LAYOUTS}")
        if not deterministic and seeds is None:
            raise ValueError("training needs a seed table")
        emb_gen = None if deterministic else seeded_generator(
            seeds[0][0], input_ids.device)
        text_emb = self.embeddings(input_ids, deterministic=deterministic,
                                   generator=emb_gen)
        cand = cand_feats.to(self.dtype)
        text_bias = make_additive_mask(attention_mask)
        if layout == "cand_major":
            h0, h1 = z_t.to(self.dtype), text_emb    # [A, B, L, D]
        else:
            n_q, length, d = z_t.shape
            n_c = (pair_map.shape[1] if pair_map is not None
                   else cand.shape[0] if layout == "shared"
                   else cand.shape[1])
            shape = (n_q, n_c, length, d)
            h0 = z_t.to(self.dtype)[:, None].expand(shape)
            h1 = text_emb[:, None].expand(shape)
            text_bias = text_bias[:, None]           # [Q, 1, 1, 1, L]
        recompute = self.cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            row = None if deterministic else seeds[i + 1]
            if recompute:
                h0, h1 = remat(layer, h0, h1, text_bias, cand, row, layout,
                               pair_map, policy=self.remat_policy)
            else:
                h0, h1 = layer(h0, h1, text_bias, cand, row, layout,
                               pair_map)
        return torch.cat([h0[..., 0, :], h1[..., 0, :]], dim=-1)
