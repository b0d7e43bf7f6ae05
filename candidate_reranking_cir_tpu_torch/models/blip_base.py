"""BLIP_Base (port of the JAX package's ``models/blip_base.py``): the
reference's feature-extraction wrapper (blip.py:23-74), a ViT and the MED
with a forward-time ``mode``:

- 'image':      the ViT's token features [B, M, W];
- 'text':       the MED's last hidden state [B, L, D] without
                cross-attention (its weights are never read);
- 'multimodal': the MED cross-attending over the image tokens (callers
                encode with ``set_enc_token=True``, blip.py:66).
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import RetrievalModelConfig
from candidate_reranking_cir_tpu_torch.models.med import TextEncoder
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device

MODES = ("image", "text", "multimodal")


class BlipBase(nn.Module):
    """Built on ``device`` (default 'cuda'; raises without a card unless
    device='cpu'); computes in ``dtype``. ``cfg.embed_dim`` is not
    used."""

    def __init__(self, cfg: RetrievalModelConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit, dtype, device)
        self.text_encoder = TextEncoder(cfg.text, "multimodal", dtype, device)

    def forward(self, images, input_ids, attention_mask, *,
                mode: str = "multimodal", deterministic: bool = True,
                seeds=None):
        """``seeds``: (the ViT's seed table, the MED's) when not
        deterministic; a mode reads only its encoders' tables."""
        if mode not in MODES:
            raise ValueError("mode parameter must be image, text, or "
                             "multimodal")  # blip.py:48
        vit_seeds, text_seeds = (None, None) if seeds is None else seeds
        if mode == "text":
            return self.text_encoder(input_ids, attention_mask, mode="text",
                                     deterministic=deterministic,
                                     seeds=text_seeds)
        feats = self.visual_encoder(images, deterministic=deterministic,
                                    seeds=vit_seeds)
        if mode == "image":
            return feats
        return self.text_encoder(input_ids, attention_mask, feats,
                                 deterministic=deterministic,
                                 seeds=text_seeds)
