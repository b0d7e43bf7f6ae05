"""A one-card check of the flagship scoring path (the PyTorch form of the
JAX package's ``__graft_entry__.entry()``): the stage-II ViT embeds the
candidate images and the dual-stream encoder scores the (query x
candidate) pair grid, at the full ``RerankerModelConfig`` (ViT-B/16 at 384
px, 577 tokens; the 12-layer dual encoder) in bf16 with zero weights.

    from candidate_reranking_cir_tpu_torch.entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    scores = fn(*args)            # [2, 4]: queries x candidates

On the card it launches K1 (the ViT's 577-row self-attention) and the
dual encoder's eval kernels.
"""
from __future__ import annotations

import torch

from candidate_reranking_cir_tpu_torch.config import RerankerModelConfig
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


def entry(device=None, cfg: RerankerModelConfig | None = None):
    """(fn, args): ``fn(*args)`` embeds 4 zero candidate images and scores
    them against 2 queries of ``cfg.text_len`` tokens, returning fp32
    [2, 4] scores. ``device``: default the card (raises without one);
    ``cfg``: default the full ``RerankerModelConfig``."""
    device = resolve_device(device)
    cfg = RerankerModelConfig() if cfg is None else cfg
    model = RerankerModel(cfg, dtype=torch.bfloat16, device=device).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()

    q, c, length = 2, 4, cfg.text_len
    size = cfg.vit.image_size
    images = torch.zeros(c, size, size, 3, device=device)
    input_ids = torch.zeros(q, length, dtype=torch.int32, device=device)
    mask = torch.ones(q, length, dtype=torch.int32, device=device)
    z_t = torch.zeros(q, length, cfg.text.hidden_size, device=device)

    def fn(images, input_ids, mask, z_t):
        with torch.inference_mode():
            feats = model.embed_images(images)
            return model.score_shared(z_t, input_ids, mask, feats)

    return fn, (images, input_ids, mask, z_t)
