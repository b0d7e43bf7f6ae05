"""Stage-I model (port of the JAX package's ``models/blip_retrieval.py``):
ViT image features, the MED fusion that produces z_t (the stage-II query
state) or the normalized prediction, and the in-batch contrastive logits
of stage-I training."""
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

    # read by the stage-I engine: one pooled target an image, and captions
    # that open with BLIP's [ENC]
    multi_vector = False
    enc_token = True

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

    def embed_images(self, images, *, pool_and_normalize: bool = False,
                     deterministic: bool = True, seeds=None):
        """[B, H, W, 3] -> raw token features [B, M, D]; optionally also the
        normalized projected CLS [B, embed_dim]. ``seeds``: the ViT's seed
        table (``visual_encoder.seed_shape``) when not deterministic."""
        feats = self.visual_encoder(images, deterministic=deterministic,
                                    seeds=seeds)
        if not pool_and_normalize:
            return feats
        return feats, self.pool_image_features(feats)

    def pool_image_features(self, feats):
        """Raw [B, M, D] -> normalized projected CLS."""
        return l2_normalize(self.vision_proj(feats[:, 0]))

    def forward(self, images, input_ids, attention_mask, *,
                deterministic: bool = True, seeds=None,
                intermediates: dict | None = None,
                perturbations: dict | None = None):
        """JAX's convenience ``__call__``: embed ``images``, fuse them with
        the text, contrast the prediction with the pooled images; [B, B]
        logits. ``seeds``: (the ViT's seed table, the MED's) when not
        deterministic; ``intermediates`` / ``perturbations`` as
        ``fuse``'s."""
        vit_seeds, text_seeds = (None, None) if seeds is None else seeds
        feats, pooled = self.embed_images(
            images, pool_and_normalize=True, deterministic=deterministic,
            seeds=vit_seeds)
        pred = self.fuse(feats, input_ids, attention_mask,
                         deterministic=deterministic, seeds=text_seeds,
                         intermediates=intermediates,
                         perturbations=perturbations)
        return self.contrastive_logits(pred, pooled)

    def fuse(self, ref_image_feats, input_ids, attention_mask, *,
             return_raw: bool = False, deterministic: bool = True,
             seeds=None, query_group: int = 1,
             intermediates: dict | None = None,
             perturbations: dict | None = None):
        """Text cross-attends to the reference image tokens.

        return_raw=True -> last_hidden_state z_t [B, L, D] (stage-II input);
        otherwise the normalized projected prediction [B, embed_dim].
        ``seeds``: the MED's seed table (``text_encoder.seed_shape``) when
        not deterministic. ``query_group`` Q > 1: image-major fusion,
        input_ids / attention_mask [G*Q, L] (Q queries per image,
        image-contiguous) against ref_image_feats [G, M, D]; each layer's
        image K/V projections run once per image (the same function).
        ``intermediates`` / ``perturbations``: the MED's attention capture
        and perturbation (``TextEncoder.forward``; the config's
        ``capture_attention`` / ``perturb_attention``)."""
        hidden = self.text_encoder(input_ids, attention_mask, ref_image_feats,
                                   deterministic=deterministic, seeds=seeds,
                                   query_group=query_group,
                                   intermediates=intermediates,
                                   perturbations=perturbations)
        if return_raw:
            return hidden
        return l2_normalize(self.text_proj(hidden[:, 0]))

    def contrastive_logits(self, predicted, targets):
        """pred [B, E] x targets [N, E] -> [B, N] similarity / temp, in
        fp32."""
        logits = torch.einsum("be,ne->bn", predicted.float(), targets.float())
        return logits / self.temp
