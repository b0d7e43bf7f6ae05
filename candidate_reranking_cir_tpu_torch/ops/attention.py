"""Eval attention routing (port of the JAX package's ``ops/attention.py``).

Every function here reaches one of the kernels of ``ops/cuda_attention.py``
(the plain version of the same function for CPU tensors). Layouts follow
the JAX package: ``[..., seq, heads, head_dim]`` unfolded, ``[..., seq,
heads*head_dim]`` folded; the additive mask is ``(1 - mask) * -10000``.
"""
from __future__ import annotations

import torch

from candidate_reranking_cir_tpu_torch.ops.cuda_attention import (
    fused_attention,
    fused_attention_folded,
)

NEG_INF = -10000.0  # additive mask value, matches reference med.py:682


def make_additive_mask(mask, dtype=torch.float32):
    """[..., kv_len] 1/0 validity mask -> [..., 1, 1, kv_len] additive bias
    (broadcast axes: heads, q_len); bias = (1 - mask) * -10000."""
    bias = (1.0 - mask.to(torch.float32)) * NEG_INF
    return bias[..., None, None, :].to(dtype)


def _flat_bias(bias, batch_shape, lq: int, m: int):
    """Head-independent bias broadcastable to [..., 1, Lq, M] -> an
    [E, 1, Lq, M] view; broadcast axes keep stride 0."""
    if bias is None:
        return None
    if bias.ndim < 3 or bias.shape[-3] != 1:
        raise ValueError("only head-independent biases [..., 1, Lq|1, M] "
                         f"are supported; got {tuple(bias.shape)}")
    return bias.expand(*batch_shape, 1, lq, m).reshape(-1, 1, lq, m)


def dot_product_attention(q, k, v, bias=None):
    """Multi-head attention, unfolded: q [..., Lq, H, D]; k, v [..., M, H, D];
    bias None or head-independent, broadcastable to [..., 1, Lq, M].
    Returns [..., Lq, H, D] in q's dtype (K2 with a bias, K3 without)."""
    if q.ndim < 4 or k.ndim != q.ndim or k.shape[:-3] != q.shape[:-3]:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)}: leading "
                         "batch axes must match")
    batch_shape = q.shape[:-3]
    lq, h, d = q.shape[-3:]
    m = k.shape[-3]
    bias = _flat_bias(bias, batch_shape, lq, m)
    out = fused_attention(q.reshape(-1, lq, h, d), k.reshape(-1, m, h, d),
                          v.reshape(-1, m, h, d), bias)
    return out.reshape(*batch_shape, lq, h, d)


def dot_product_attention_folded(q, k, v, bias=None, *, num_heads: int):
    """Head-folded attention: q [..., Lq, H*D]; k, v [..., M, H*D]; bias
    None or head-independent, broadcastable to [..., 1, Lq, M].
    Returns [..., Lq, H*D] (K4 with a bias, K1 without)."""
    batch_shape = q.shape[:-2]
    lq, hd = q.shape[-2:]
    m = k.shape[-2]
    bias = _flat_bias(bias, batch_shape, lq, m)
    out = fused_attention_folded(
        q.reshape(-1, lq, hd), k.reshape(-1, m, hd), v.reshape(-1, m, hd),
        bias, num_heads=num_heads)
    return out.reshape(*batch_shape, lq, hd)


def grid_cross_attention(q, k, v):
    """Candidate-major cross-attention with per-candidate shared K/V.

    q [A, B, Lq, H, D] (candidate a x its b-th query); k, v [A, M, H, D].
    The B queries fold into the row axis, so each candidate's K/V serve
    B*Lq rows in one kernel entry (K3). Returns [A, B, Lq, H, D]."""
    a, b, lq, h, d = q.shape
    out = fused_attention(q.reshape(a, b * lq, h, d), k, v, None)
    return out.reshape(a, b, lq, h, d)


def pair_cross_attention(q, k, v):
    """Query-major pair grid with per-candidate shared K/V (eval form).

    q [Q, C, Lq, H, D]; k, v [C, M, H, D]. Queries fold into each
    candidate's row axis (K3). Returns [Q, C, Lq, H, D]."""
    n_q, n_c, lq, h, d = q.shape
    qt = q.transpose(0, 1).reshape(n_c, n_q * lq, h, d)
    out = fused_attention(qt, k, v, None)
    return out.reshape(n_c, n_q, lq, h, d).transpose(0, 1)
