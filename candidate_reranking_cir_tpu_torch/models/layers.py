"""Shared building blocks (port of the JAX package's ``models/layers.py``).

Parameters are float32; each module computes in its ``dtype`` (bfloat16 on
the card by default in the CLIs) with float32 LayerNorm statistics and a
float32 softmax, as the JAX package does.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from candidate_reranking_cir_tpu_torch.ops.attention import (
    dot_product_attention,
    dot_product_attention_folded,
)


def exact_gelu(x):
    """Erf-based GELU. float32: the exact erf form. Other dtypes: the JAX
    package's rational erf (Abramowitz & Stegun 7.1.26) evaluated in
    float32 and cast back, reproduced term for term."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    x32 = x.float()
    u = x32.abs() * 0.7071067811865476
    t = 1.0 / (1.0 + 0.3275911 * u)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(x32) * (1.0 - poly * torch.exp(-u * u))
    return (0.5 * x32 * (1.0 + erf)).to(x.dtype)


def _normal_(t: torch.Tensor, std: float = 0.02) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std)


class LayerNorm(nn.Module):
    """Float32 LayerNorm that returns the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


class Dense(nn.Module):
    """Linear layer: float32 weight [out, in] cast to the compute dtype, the
    product rounded to it, then the bias added in it (JAX ``Dense``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32, device=None, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_normal_(
            torch.empty(out_features, in_features, device=device)))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention; q from ``x``, k/v from ``y`` (self when
    ``y`` is None). Returns the context projected back to ``out_features``.

    Eval routing as in the JAX package (layers.py:216-250): the folded
    [.., L, H*D] kernels for >= 128 query rows, or for cross-attention to
    >= 128 keys; the unfolded [.., L, H, D] kernels otherwise."""

    def __init__(self, num_heads: int, head_dim: int, out_features: int,
                 kv_features: int | None = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        width = num_heads * head_dim
        kv_features = out_features if kv_features is None else kv_features
        self.num_heads, self.head_dim = num_heads, head_dim
        self.query = Dense(out_features, width, dtype, device)
        self.key = Dense(kv_features, width, dtype, device)
        self.value = Dense(kv_features, width, dtype, device)
        self.out = Dense(width, out_features, dtype, device)

    def forward(self, x, y=None, bias=None):
        is_cross = y is not None
        y = x if y is None else y
        folded = x.shape[-2] >= 128 or (is_cross and y.shape[-2] >= 128)
        q, k, v = self.query(x), self.key(y), self.value(y)
        if folded:
            ctx = dot_product_attention_folded(q, k, v, bias,
                                               num_heads=self.num_heads)
        else:
            heads = (self.num_heads, self.head_dim)
            ctx = dot_product_attention(
                q.unflatten(-1, heads), k.unflatten(-1, heads),
                v.unflatten(-1, heads), bias).flatten(-2)
        return self.out(ctx)


class Mlp(nn.Module):
    """Transformer FFN: dense -> exact GELU -> dense."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype, device)
        self.fc2 = Dense(hidden_features, out_features, dtype, device)

    def forward(self, x):
        return self.fc2(exact_gelu(self.fc1(x)))
