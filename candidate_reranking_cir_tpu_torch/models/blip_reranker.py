"""Stage-II re-ranker (port of the JAX package's
``models/blip_reranker.py``): ViT image encoder, dual-stream encoder, and
the cls head Linear(2D -> D) -> ReLU -> Linear(D -> 2) whose channel 0 is
the re-rank score. ``score_grid`` is the candidate-major eval layout,
``score_shared`` training's B x B pair grid over one shared candidate
set."""
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

    def score_grid(self, z_t, input_ids, attention_mask, cand_feats):
        """Candidate-major grid: [A, B, L, D] x [A, M, W] -> [A, B] scores."""
        cls_pair = self.text_encoder(input_ids, attention_mask, z_t,
                                     cand_feats)
        return self._cls_scores(cls_pair)
