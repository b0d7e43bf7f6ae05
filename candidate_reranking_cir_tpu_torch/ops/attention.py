"""Attention routing (port of the JAX package's ``ops/attention.py``).

Eval calls reach one of the kernels of ``ops/cuda_attention.py`` (K1-K4).
Train calls with dropout follow the JAX package's train routes: where
``attention_train.eligible`` holds, the in-kernel-dropout kernels of
``ops/attention_train.py`` (K6/K7 unfolded, K8/K9 folded; the mask keyed by
an int32 seed);
elsewhere plain attention with dropout drawn from a ``torch.Generator``,
as the JAX package's own XLA path draws it from ``jax.random``. CPU
tensors take the kernels' plain versions. Layouts follow the JAX package:
``[..., seq, heads, head_dim]`` unfolded, ``[..., seq, heads*head_dim]``
folded; the additive mask is ``(1 - mask) * -10000``.

Head widths no kernel of the port takes (Kimi-VL's latent attention: 192
lanes for q and k, 128 for v) go to ``F.scaled_dot_product_attention``
(``sdpa_attention``), with a boolean keep-mask or causal, counted in
``registry.SDPA``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from candidate_reranking_cir_tpu_torch.ops import attention_train, draws
from candidate_reranking_cir_tpu_torch.ops.registry import SDPA
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


def _dropout_probs(probs, rate: float, generator):
    """probs * keep / (1 - rate), keep ~ Bernoulli(1 - rate) drawn from
    ``generator`` on the probabilities' device."""
    if generator is None:
        raise ValueError("attention dropout needs a generator")
    keep = draws.uniform(probs.shape, generator, probs.device) < 1.0 - rate
    return probs * keep / (1.0 - rate)


def _plain_attention(spec_scores: str, spec_out: str, q, k, v, bias,
                     rate: float, generator):
    """The JAX package's XLA attention with dropout: fp32 scores times the
    scale, + bias, fp32 softmax, dropout, probabilities cast to q's dtype,
    fp32 P.V, output in q's dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum(spec_scores, q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    probs = _dropout_probs(probs, rate, generator).to(q.dtype)
    return torch.einsum(spec_out, probs.float(), v.float()).to(q.dtype)


def dot_product_attention(q, k, v, bias=None, *, dropout_rate: float = 0.0,
                          deterministic: bool = True, seed: int | None = None,
                          generator=None):
    """Multi-head attention, unfolded: q [..., Lq, H, D]; k, v [..., M, H, D];
    bias None or head-independent, broadcastable to [..., 1, Lq, M].
    Returns [..., Lq, H, D] in q's dtype.

    Eval (``deterministic`` or rate 0): K2 with a bias, K3 without. Train:
    K6/K7 with ``seed`` where ``attention_train.eligible``, else plain
    attention with dropout from ``generator``."""
    if q.ndim < 4 or k.ndim != q.ndim or k.shape[:-3] != q.shape[:-3]:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)}: leading "
                         "batch axes must match")
    batch_shape = q.shape[:-3]
    lq, h, d = q.shape[-3:]
    m = k.shape[-3]
    if deterministic or dropout_rate == 0.0:
        out = fused_attention(q.reshape(-1, lq, h, d), k.reshape(-1, m, h, d),
                              v.reshape(-1, m, h, d),
                              _flat_bias(bias, batch_shape, lq, m))
        return out.reshape(*batch_shape, lq, h, d)
    if attention_train.eligible(lq, bias, m, batch=math.prod(batch_shape)):
        out = attention_train.fused_attention_train(
            q.reshape(-1, lq, h, d), k.reshape(-1, m, h, d),
            v.reshape(-1, m, h, d), _flat_bias(bias, batch_shape, lq, m),
            seed, dropout_rate)
        return out.reshape(*batch_shape, lq, h, d)
    return _plain_attention("...qhd,...khd->...hqk", "...hqk,...khd->...qhd",
                            q, k, v, bias, dropout_rate, generator)


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


def dot_product_attention_folded_train(q, k, v, bias=None, *, num_heads: int,
                                       seed: int, dropout_rate: float):
    """Folded twin of the in-kernel-dropout train route (K8 forward, K9
    backward): q [..., Lq, H*D]; k, v [..., M, H*D]; bias None or
    head-independent, broadcastable to [..., 1, Lq, M] (the MED's text
    mask [B, 1, 1, L] when its self-attention qualifies). The caller checks
    ``attention_train.eligible``. Masks are keyed by the absolute entry
    index of the flattened batch, as unfolded."""
    batch_shape = q.shape[:-2]
    lq, hd = q.shape[-2:]
    m = k.shape[-2]
    out = attention_train.fused_attention_train_folded(
        q.reshape(-1, lq, hd), k.reshape(-1, m, hd), v.reshape(-1, m, hd),
        _flat_bias(bias, batch_shape, lq, m), seed, dropout_rate,
        num_heads=num_heads)
    return out.reshape(*batch_shape, lq, hd)


def grid_cross_attention(q, k, v, *, dropout_rate: float = 0.0,
                         deterministic: bool = True, seed: int | None = None,
                         generator=None):
    """Candidate-major cross-attention with per-candidate shared K/V.

    q [A, B, Lq, H, D] (candidate a x its b-th query); k, v [A, M, H, D].
    Returns [A, B, Lq, H, D]. Eval: the B queries fold into the row axis,
    so each candidate's K/V serve B*Lq rows in one kernel entry (K3).
    Train: the same fold (entry = candidate, row = query*Lq + token)
    through K6/K7 with ``seed`` where ``attention_train.eligible``, else
    plain attention with dropout from ``generator`` (the JAX package's
    routes, ``ops/attention.py::grid_cross_attention``)."""
    a, b, lq, h, d = q.shape
    train = not deterministic and dropout_rate > 0.0
    if not train or attention_train.eligible(b * lq, None, k.shape[-3]):
        qf = q.reshape(a, b * lq, h, d)
        if train:
            out = attention_train.fused_attention_train(
                qf, k, v, None, seed, dropout_rate)
        else:
            out = fused_attention(qf, k, v, None)
        return out.reshape(a, b, lq, h, d)
    return _plain_attention("ablhd,akhd->abhlk", "abhlk,akhd->ablhd",
                            q, k, v, None, dropout_rate, generator)


def pair_cross_attention(q, k, v, *, dropout_rate: float = 0.0,
                         deterministic: bool = True, seed: int | None = None,
                         generator=None):
    """Query-major pair grid with per-candidate shared K/V.

    q [Q, C, Lq, H, D]; k, v [C, M, H, D]. Returns [Q, C, Lq, H, D].
    Eval: the queries fold into each candidate's row axis (K3). Train: the
    same fold (entry = candidate, row = query*Lq + token) through K6/K7
    with ``seed`` where ``attention_train.eligible``, else plain attention
    with dropout from ``generator``."""
    n_q, n_c, lq, h, d = q.shape
    train = not deterministic and dropout_rate > 0.0
    if not train or attention_train.eligible(n_q * lq, None, k.shape[-3]):
        qt = q.transpose(0, 1).reshape(n_c, n_q * lq, h, d)
        if train:
            out = attention_train.fused_attention_train(
                qt, k, v, None, seed, dropout_rate)
        else:
            out = fused_attention(qt, k, v, None)
        return out.reshape(n_c, n_q, lq, h, d).transpose(0, 1)
    return _plain_attention("qclhd,ckhd->qchlk", "qchlk,ckhd->qclhd",
                            q, k, v, None, dropout_rate, generator)


def sdpa_attention(q, k, v, mask=None, *, causal: bool = False,
                   kind: str = "mla"):
    """Attention through ``F.scaled_dot_product_attention``: q [B, Lq, H, Dk];
    k [B, M, H, Dk]; v [B, M, H, Dv]; ``mask`` None or a boolean keep-mask
    broadcastable to [B, H, Lq, M]; ``causal`` (without a mask) masks key j
    > query i. Scale Dk ** -0.5; returns [B, Lq, H, Dv] in q's dtype.
    Counted in ``registry.SDPA[kind]``."""
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal)
    SDPA[kind] += 1
    return out.transpose(1, 2)
