"""BLIP-2 as a stage-I retrieval model (Li et al. 2023, arXiv:2301.12597;
Salesforce LAVIS ``lavis/models/blip2_models/blip2_qformer.py``,
``lavis/models/eva_vit.py::create_eva_vit_g``, ``blip2_pretrain.yaml``),
composed as SPRC (arXiv:2310.05473) composes it for CIR:

- image tokens: ``ln_vision(EVA ViT-g/14(image))`` [B, 257, 1408] (the
  ViT's final norm is ``ln_vision``, ``models/vit.py``);
- a corpus image's target: the Q-Former over its learned queries alone
  against its tokens, each query row through ``vision_proj`` and
  normalised: [B, T, E] (T = 32, E = 256);
- a composed query: the Q-Former over [queries; caption] against the
  reference image's tokens; the caption's first row (its [CLS], right after
  the T query rows) through ``text_proj`` and normalised: f_q [B, E];
- the score of (q, t): max_i <f_q, z_t,i>, LAVIS's ``sim_t2q.max(-1)``
  (``ops/topk.cosine_scores`` on a [N, T, E] index).

The surface ``retrieval/validate_engine.evaluate_cirr_stage1`` uses of a
stage-I model: ``embed_images``, ``target_features`` (the engine's layer
span 'targets', for a ``multi_vector`` model), ``fuse`` with
``query_group``; captions open with [CLS], not BLIP's [ENC]
(``enc_token``).
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import Blip2RetrievalModelConfig
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    l2_normalize,
)
from candidate_reranking_cir_tpu_torch.models.layers import Dense
from candidate_reranking_cir_tpu_torch.models.qformer import QFormer
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


class Blip2RetrievalModel(nn.Module):
    """Built on ``device`` (default 'cuda'; raises without a card unless
    device='cpu'); computes in ``dtype``. Eval only."""

    # read by the stage-I engine: T targets an image (``target_features``),
    # and captions that keep BERT's [CLS]
    multi_vector = True
    enc_token = False

    def __init__(self, cfg: Blip2RetrievalModelConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.visual_encoder = VisionTransformer(cfg.vit, dtype, device)
        self.qformer = QFormer(cfg.text, cfg.num_query_tokens,
                               cfg.cross_attention_freq, dtype, device)
        self.vision_proj = Dense(cfg.text.hidden_size, cfg.embed_dim, dtype,
                                 device)
        self.text_proj = Dense(cfg.text.hidden_size, cfg.embed_dim, dtype,
                               device)

    def embed_images(self, images, *, pool_and_normalize: bool = False):
        """[B, H, W, 3] -> image tokens [B, M, W] (``ln_vision`` applied);
        optionally also the targets [B, T, E] (``target_features``)."""
        feats = self.visual_encoder(images)
        if not pool_and_normalize:
            return feats
        return feats, self.target_features(feats)

    def target_features(self, feats):
        """Image tokens [B, M, W] -> the normalised projected query rows
        [B, T, E]."""
        return l2_normalize(self.vision_proj(self.qformer(feats)))

    def fuse(self, ref_image_feats, input_ids, attention_mask, *,
             query_group: int = 1):
        """The captions ``input_ids`` / ``attention_mask`` [G*Q, L] with the
        reference images' tokens [G, M, W] (Q captions an image,
        image-contiguous): f_q [G*Q, E]."""
        hidden = self.qformer(ref_image_feats, input_ids, attention_mask,
                              query_group=query_group)
        return l2_normalize(
            self.text_proj(hidden[:, self.cfg.num_query_tokens]))
