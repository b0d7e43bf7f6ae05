"""Stage-II re-ranker (port of the JAX package's
``models/blip_reranker.py``): ViT image encoder, dual-stream encoder, and
the cls head Linear(2D -> D) -> ReLU -> Linear(D -> 2) whose channel 0 is
the re-rank score. ``score_grid`` is the candidate-major eval layout,
``score_shared`` training's B x B pair grid over one shared candidate
set, ``score_per_query`` and ``score_indexed`` the query-major eval
layouts (each query with its own K candidates; the indexed one projects
the K/V of a chunk's unique candidates once)."""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import RerankerModelConfig
from candidate_reranking_cir_tpu_torch.models.dual_encoder import (
    DualStreamEncoder,
)
from candidate_reranking_cir_tpu_torch.models.layers import Dense
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


class RerankerModel(nn.Module):
    """Built on ``device`` (default 'cuda'; raises without a card unless
    device='cpu'); computes in ``dtype``."""

    # read by the stage-II engine: z_t and the pair scorers, not a prefix
    # pass (``models/kimi_vl.py``)
    prefix_scorer = False

    def __init__(self, cfg: RerankerModelConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.text.hidden_size
        self.visual_encoder = VisionTransformer(cfg.vit, dtype, device)
        self.text_encoder = DualStreamEncoder(cfg.text, dtype, device)
        self.cls_dense1 = Dense(2 * d, d, dtype, device)
        self.cls_dense2 = Dense(d, 2, dtype, device)

    def forward(self, images, input_ids, attention_mask, z_t, *,
                deterministic: bool = True, seeds=None):
        """Embed ``images`` and score the B x B pair grid against them
        (the JAX module's ``__call__``). ``seeds``: (ViT seed table, text
        encoder seed table) when not deterministic."""
        vit_seeds, text_seeds = (None, None) if seeds is None else seeds
        feats = self.embed_images(images, deterministic=deterministic,
                                  seeds=vit_seeds)
        return self.score_shared(z_t, input_ids, attention_mask, feats,
                                 deterministic=deterministic,
                                 seeds=text_seeds)

    def embed_images(self, images, *, deterministic: bool = True,
                     seeds=None):
        """``seeds``: the ViT's seed table (``visual_encoder.seed_shape``)
        when not deterministic."""
        return self.visual_encoder(images, deterministic=deterministic,
                                   seeds=seeds)

    def _cls_scores(self, cls_pair):
        h = torch.relu(self.cls_dense1(cls_pair))
        return self.cls_dense2(h)[..., 0].float()

    def score_shared(self, z_t, input_ids, attention_mask, cand_feats, *,
                     deterministic: bool = True, seeds=None):
        """[Q, L, D] x [C, M, W] -> [Q, C] scores (shared candidate set).
        ``seeds``: the text encoder's seed table
        (``text_encoder.seed_shape``) when not deterministic."""
        cls_pair = self.text_encoder(input_ids, attention_mask, z_t,
                                     cand_feats, layout="shared",
                                     deterministic=deterministic,
                                     seeds=seeds)
        return self._cls_scores(cls_pair)

    def score_per_query(self, z_t, input_ids, attention_mask, cand_feats, *,
                        deterministic: bool = True, seeds=None):
        """[Q, L, D] x [Q, K, M, W] -> [Q, K] scores (per-query
        candidates). ``seeds`` as ``score_shared``'s."""
        cls_pair = self.text_encoder(input_ids, attention_mask, z_t,
                                     cand_feats, layout="per_pair",
                                     deterministic=deterministic,
                                     seeds=seeds)
        return self._cls_scores(cls_pair)

    def score_indexed(self, z_t, input_ids, attention_mask, unique_cand,
                      pair_map, *, deterministic: bool = True, seeds=None):
        """[Q, L, D] x unique [U, M, W] + pair_map [Q, K] -> [Q, K] scores:
        each unique candidate's K/V projected once, gathered per pair.
        Equal to ``score_per_query(z_t, .., unique_cand[pair_map])``.
        ``seeds`` as ``score_shared``'s."""
        cls_pair = self.text_encoder(input_ids, attention_mask, z_t,
                                     unique_cand, pair_map=pair_map,
                                     deterministic=deterministic,
                                     seeds=seeds)
        return self._cls_scores(cls_pair)

    def score_grid(self, z_t, input_ids, attention_mask, cand_feats, *,
                   deterministic: bool = True, seeds=None):
        """Candidate-major grid: [A, B, L, D] x [A, M, W] -> [A, B] scores.
        ``seeds`` as ``score_shared``'s."""
        cls_pair = self.text_encoder(input_ids, attention_mask, z_t,
                                     cand_feats, deterministic=deterministic,
                                     seeds=seeds)
        return self._cls_scores(cls_pair)
