"""MoonViT and its projector: Kimi-VL's vision tower (Kimi-VL technical
report, arXiv:2504.07491; SigLIP-SO400M's shape), at a fixed resolution.

- Image [B, 392, 392, 3], patch 14: a 28 x 28 grid of 784 patches, each
  flattened in (row, column, channel) order and embedded by one dense layer
  with a bias (the stride-14 convolution, without cuDNN), 3 -> 1,152.
- The learned [64, 64, 1,152] position table, bicubic-resized to 28 x 28
  (float32, ``align_corners`` False) and added.
- 27 pre-LN blocks (LayerNorm eps 1e-5): ``x += Wo attn(rope2d(Wqkv
  LN0(x)))`` with a qkv bias and 16 heads of 72, full bidirectional over the
  image's patches (K1 at 72-wide heads, ``ops/cuda_attention``), then
  ``x += fc1(gelu_tanh(fc0(LN1(x))))``, 1,152 -> 4,304 -> 1,152.
- The 2-D rotary embedding turns each head's lane pairs (2m, 2m + 1),
  m = 0..35, in float32: pair 2j by col * theta_j, pair 2j + 1 by
  row * theta_j, theta_j = 10,000 ** (-4j / 72), j = 0..17.
- A final LayerNorm. The projector: LayerNorm(1,152) on every token, each
  2 x 2 group of the grid concatenated in row-major order within the group
  (196 tokens of 4,608), Linear 4,608 -> 4,608 with a bias, the exact (erf)
  GELU, Linear 4,608 -> 2,048 with a bias.

Parameters are held in ``param_dtype`` (the compute dtype for Kimi-VL),
the LayerNorm gains and biases in float32 (``models/layers.LayerNorm``).
Eval only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from candidate_reranking_cir_tpu_torch.config import MoonViTConfig
from candidate_reranking_cir_tpu_torch.models.layers import Dense, LayerNorm
from candidate_reranking_cir_tpu_torch.ops.attention import (
    dot_product_attention_folded,
)


def patchify(images, patch: int):
    """[B, H, W, 3] -> [B, (H/P)(W/P), P*P*3], each patch in (row, column,
    channel) order."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (h // patch) * (w // patch), patch * patch * c)


def grid_angles(cfg: MoonViTConfig, device) -> torch.Tensor:
    """[grid^2, head_dim / 2] float32 angles of the 2-D rotary embedding,
    patches in row-major order."""
    n, hd = cfg.grid, cfg.head_dim
    j = torch.arange(hd // 4, dtype=torch.float64, device=device)
    theta = cfg.rope_theta ** (-4.0 * j / hd)
    rows = torch.arange(n, device=device).repeat_interleave(n).double()
    cols = torch.arange(n, device=device).repeat(n).double()
    ang = torch.empty(n * n, hd // 2, dtype=torch.float64, device=device)
    ang[:, 0::2] = cols[:, None] * theta
    ang[:, 1::2] = rows[:, None] * theta
    return ang.float()


def rope2d(x, cos, sin):
    """x [B, N, H, D]: lanes (2m, 2m + 1) turned by the angle of pair m
    (cos, sin [N, 1, D/2]), in float32, returned in x's dtype."""
    a, b = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).flatten(-2).to(x.dtype)


class MoonViTAttention(nn.Module):
    def __init__(self, cfg: MoonViTConfig, dtype, device, param_dtype):
        super().__init__()
        d = cfg.hidden_size
        self.heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.qkv = Dense(d, 3 * d, dtype, device, param_dtype=param_dtype)
        self.proj = Dense(d, d, dtype, device, param_dtype=param_dtype)

    def forward(self, x, cos, sin):
        b, n, _ = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.heads, self.head_dim)
        q, k = rope2d(qkv[:, :, 0], cos, sin), rope2d(qkv[:, :, 1], cos, sin)
        # v is read where it lies in the fused projection
        ctx = dot_product_attention_folded(
            q.flatten(-2), k.flatten(-2), qkv[:, :, 2].flatten(-2),
            num_heads=self.heads)
        return self.proj(ctx)


class MoonViTBlock(nn.Module):
    def __init__(self, cfg: MoonViTConfig, dtype, device, param_dtype):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm0 = LayerNorm(d, eps, dtype, device)
        self.attn = MoonViTAttention(cfg, dtype, device, param_dtype)
        self.norm1 = LayerNorm(d, eps, dtype, device)
        self.mlp = nn.ModuleDict({
            "fc0": Dense(d, cfg.intermediate_size, dtype, device,
                         param_dtype=param_dtype),
            "fc1": Dense(cfg.intermediate_size, d, dtype, device,
                         param_dtype=param_dtype)})

    def forward(self, x, cos, sin):
        h = self.attn(self.norm0(x), cos, sin)
        # the residual add and norm1 in one call; x becomes the sum
        h, x = self.norm1(x, h, keep_sum=True)
        h = F.gelu(self.mlp["fc0"](h), approximate="tanh")
        return x + self.mlp["fc1"](h)


class MoonViT(nn.Module):
    """Images [B, H, W, 3] -> the final-normed patch tokens [B, 784, 1,152]."""

    def __init__(self, cfg: MoonViTConfig, dtype=torch.float32, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = Dense(p * p * 3, d, dtype, device,
                                 param_dtype=param_dtype)
        self.pos_emb = nn.Parameter(torch.zeros(
            cfg.pos_grid, cfg.pos_grid, d, device=device, dtype=param_dtype))
        self.blocks = nn.ModuleList(
            MoonViTBlock(cfg, dtype, device, param_dtype)
            for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(d, cfg.layer_norm_eps, dtype, device)

    def positions(self):
        """The table bicubic-resized to the patch grid: [grid^2, D]."""
        n = self.cfg.grid
        table = self.pos_emb.float().permute(2, 0, 1)[None]
        out = F.interpolate(table, size=(n, n), mode="bicubic",
                            align_corners=False)
        return out[0].permute(1, 2, 0).reshape(n * n, -1)

    def forward(self, images):
        x = self.patch_embed(patchify(images, self.cfg.patch_size)
                             .to(self.dtype))
        x = x + self.positions().to(self.dtype)
        ang = grid_angles(self.cfg, x.device)[:, None]
        cos, sin = ang.cos(), ang.sin()
        for block in self.blocks:
            x = block(x, cos, sin)
        return self.final_norm(x)


class Projector(nn.Module):
    """MoonViT's tokens [B, grid^2, D] -> the LM's [B, (grid/m)^2, width]."""

    def __init__(self, cfg: MoonViTConfig, width: int, dtype=torch.float32,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        merged = d * cfg.merge ** 2
        self.pre_norm = LayerNorm(d, cfg.layer_norm_eps, dtype, device)
        self.linear_1 = Dense(merged, merged, dtype, device,
                              param_dtype=param_dtype)
        self.linear_2 = Dense(merged, width, dtype, device,
                              param_dtype=param_dtype)

    def forward(self, x):
        b, _, d = x.shape
        m, g = self.cfg.merge, self.cfg.grid // self.cfg.merge
        x = self.pre_norm(x).view(b, g, m, g, m, d).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, g * g, m * m * d)
        return self.linear_2(F.gelu(self.linear_1(x)))
