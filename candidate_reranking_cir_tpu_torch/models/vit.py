"""Vision Transformer (port of the JAX package's ``models/vit.py``).

timm-style ViT: space-to-depth patch embedding plus one matmul (the same
function as the stride-P convolution, without cuDNN), CLS token, learned
position embeddings, pre-LN blocks with linearly increasing stochastic
depth, final LayerNorm (eps 1e-6). EVA ViT-g/14 (BLIP-2's tower,
``config.vit_config('g')``) is the same blocks with no key bias
(``qkv_bias`` 'qv') and BLIP-2's ``ln_vision`` as the final LayerNorm, at
its own eps (``final_norm_eps``). Images are channel-last [B, H, W, 3],
as in the JAX package. Training (``deterministic=False``) takes a seed
table of shape ``seed_shape``: row 0 seeds the embedding dropout, row
i + 1 block i (its generator, then its attention's kernel seed).
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import ViTConfig
from candidate_reranking_cir_tpu_torch.models.layers import (
    Dense,
    Dropout,
    LayerNorm,
    Mlp,
    MultiHeadAttention,
    _normal_,
    drop_path,
    remat,
    resolve_remat_policy,
    seeded_generator,
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
    """Pre-LN transformer block with stochastic depth ``drop_path_rate``."""

    def __init__(self, cfg: ViTConfig, drop_path_rate: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.hidden_size
        if cfg.qkv_bias not in ("qkv", "qv"):
            raise ValueError(f"unknown qkv_bias {cfg.qkv_bias!r} (expected "
                             "'qkv' or 'qv')")
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps, dtype, device)
        self.attn = MultiHeadAttention(cfg.num_heads, cfg.head_dim, d,
                                       dtype=dtype, device=device,
                                       dropout_rate=cfg.attention_dropout,
                                       key_bias=cfg.qkv_bias == "qkv")
        self.drop = Dropout(cfg.dropout)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps, dtype, device)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), d, dtype, device,
                       cfg.dropout)

    def forward(self, x, seeds=None):
        det = seeds is None
        gen = None if det else seeded_generator(seeds[0], x.device)
        h = self.attn(self.norm1(x), deterministic=det,
                      seed=None if det else seeds[1], generator=gen)
        h = self.drop(h, deterministic=det, generator=gen)
        x = x + drop_path(h, self.drop_path_rate, deterministic=det,
                          generator=gen)
        h = self.mlp(self.norm2(x), deterministic=det, generator=gen)
        return x + drop_path(h, self.drop_path_rate, deterministic=det,
                             generator=gen)


class VisionTransformer(nn.Module):
    """ViT encoder returning all token states [B, 1 + num_patches, D].

    ``cfg.remat`` recomputes each block in backward when gradients are on
    (the frozen ViT's no-grad embeds never pay for it), under
    ``cfg.remat_policy``; a block seeds its own generator, so stochastic
    depth and its kernel seed redraw the same masks in the
    recomputation."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.remat_policy = (resolve_remat_policy(cfg.remat_policy)
                             if cfg.remat else None)
        self.dtype = dtype
        d = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg.patch_size, d, dtype, device)
        self.cls_token = nn.Parameter(
            _normal_(torch.empty(1, 1, d, device=device)))
        self.pos_embed = nn.Parameter(
            _normal_(torch.empty(1, cfg.num_tokens, d, device=device)))
        # linearly spaced stochastic-depth rates (JAX: jnp.linspace)
        rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.num_layers,
                               dtype=torch.float32).tolist()
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, rate, dtype, device) for rate in rates)
        self.drop = Dropout(cfg.dropout)
        self.norm = LayerNorm(d, cfg.layer_norm_eps
                              if cfg.final_norm_eps is None
                              else cfg.final_norm_eps, dtype, device)

    @property
    def seed_shape(self) -> tuple[int, int]:
        return (len(self.blocks) + 1, 2)

    def forward(self, images, *, deterministic: bool = True, seeds=None):
        if not deterministic and seeds is None:
            raise ValueError("training needs a seed table")
        x = self.patch_embed(images)
        b = x.shape[0]
        cls = self.cls_token.to(self.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]].to(self.dtype)
        if not deterministic:
            x = self.drop(x, deterministic=False,
                          generator=seeded_generator(seeds[0][0], x.device))
        recompute = self.cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            row = None if deterministic else seeds[i + 1]
            x = remat(block, x, row, policy=self.remat_policy) if recompute \
                else block(x, row)
        return self.norm(x)
