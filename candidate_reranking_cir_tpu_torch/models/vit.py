"""Vision Transformer (port of the JAX package's ``models/vit.py``).

timm-style ViT at eval: space-to-depth patch embedding plus one matmul (the
same function as the stride-P convolution, without cuDNN), CLS token,
learned position embeddings, pre-LN blocks, final LayerNorm (eps 1e-6).
Images are channel-last [B, H, W, 3], as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import ViTConfig
from candidate_reranking_cir_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    Mlp,
    MultiHeadAttention,
    _normal_,
)


class PatchEmbed(nn.Module):
    """[B, H, W, 3] -> [B, (H/P)*(W/P), D]; each PxP patch flattened
    row-major, channel-last, then one dense layer."""

    def __init__(self, patch_size: int, hidden_size: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = Dense(patch_size * patch_size * 3, hidden_size, dtype,
                          device)

    def forward(self, images):
        b, h, w, c = images.shape
        p = self.patch_size
        x = images.reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                                p * p * c)
        return self.proj(x.to(self.dtype))


class ViTBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps, dtype, device)
        self.attn = MultiHeadAttention(cfg.num_heads, cfg.head_dim, d,
                                       dtype=dtype, device=device)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps, dtype, device)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), d, dtype, device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """ViT encoder returning all token states [B, 1 + num_patches, D]."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg.patch_size, d, dtype, device)
        self.cls_token = nn.Parameter(
            _normal_(torch.empty(1, 1, d, device=device)))
        self.pos_embed = nn.Parameter(
            _normal_(torch.empty(1, cfg.num_tokens, d, device=device)))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm = LayerNorm(d, cfg.layer_norm_eps, dtype, device)

    def forward(self, images):
        x = self.patch_embed(images)
        b = x.shape[0]
        cls = self.cls_token.to(self.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)
