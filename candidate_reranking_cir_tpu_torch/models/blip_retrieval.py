"""Stage-I model at eval (port of the JAX package's
``models/blip_retrieval.py``): ViT image features and the MED fusion that
produces z_t, the stage-II query state."""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import RetrievalModelConfig
from candidate_reranking_cir_tpu_torch.models.layers import Dense
from candidate_reranking_cir_tpu_torch.models.med import TextEncoder
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    x32 = x.float()
    n = x32.square().sum(dim=dim, keepdim=True).sqrt()
    return (x32 / n.clamp_min(eps)).to(x.dtype)


class RetrievalModel(nn.Module):
    """Built on ``device`` (default 'cuda'; raises without a card unless
    device='cpu'); computes in ``dtype``."""

    def __init__(self, cfg: RetrievalModelConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.visual_encoder = VisionTransformer(cfg.vit, dtype, device)
        self.text_encoder = TextEncoder(cfg.text, "multimodal", dtype, device)
        self.vision_proj = Dense(cfg.vit.hidden_size, cfg.embed_dim, dtype,
                                 device)
        self.text_proj = Dense(cfg.text.hidden_size, cfg.embed_dim, dtype,
                               device)
        self.temp = nn.Parameter(torch.tensor(cfg.temp_init, device=device))

    def embed_images(self, images, *, pool_and_normalize: bool = False):
        """[B, H, W, 3] -> raw token features [B, M, D]; optionally also the
        normalized projected CLS [B, embed_dim]."""
        feats = self.visual_encoder(images)
        if not pool_and_normalize:
            return feats
        return feats, self.pool_image_features(feats)

    def pool_image_features(self, feats):
        """Raw [B, M, D] -> normalized projected CLS."""
        return l2_normalize(self.vision_proj(feats[:, 0]))

    def fuse(self, ref_image_feats, input_ids, attention_mask, *,
             return_raw: bool = False):
        """Text cross-attends to the reference image tokens.

        return_raw=True -> last_hidden_state z_t [B, L, D] (stage-II input);
        otherwise the normalized projected prediction [B, embed_dim]."""
        hidden = self.text_encoder(input_ids, attention_mask, ref_image_feats)
        if return_raw:
            return hidden
        return l2_normalize(self.text_proj(hidden[:, 0]))
