"""Shared building blocks (port of the JAX package's ``models/layers.py``).

Parameters are float32; each module computes in its ``dtype`` (bfloat16 on
the card by default in the CLIs) with float32 LayerNorm statistics and a
float32 softmax, as the JAX package does.

Dropout randomness is explicit. Where the JAX package calls
``make_rng('dropout')``, a module here takes a ``torch.Generator`` (the
non-kernel dropouts) and, at attention sites that may take the
in-kernel-dropout kernels, an int32 ``seed``. ``deterministic=True`` (the
default) turns every dropout off, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from candidate_reranking_cir_tpu_torch.ops import attention_train, draws
from candidate_reranking_cir_tpu_torch.ops.activation import (  # noqa: F401
    bias_gelu,
    exact_gelu,
)
from candidate_reranking_cir_tpu_torch.ops.attention import (
    _dropout_probs,
    dot_product_attention,
    dot_product_attention_folded,
    dot_product_attention_folded_train,
)
from candidate_reranking_cir_tpu_torch.ops.cuda_attention import scaled_scores
from candidate_reranking_cir_tpu_torch.ops.norm import add_layer_norm


class DotsPolicy:
    """Remat policy 'dots', JAX's ``dots_with_no_batch_dims_saveable``: the
    outputs of the products without batch dimensions are kept for the
    backward pass, everything else is recomputed.

    Which ops those are was read on the CPU under a dispatch mode: the
    port's ``Dense`` (``F.linear`` of a [.., in] input, without a bias)
    reaches ``aten.mm`` and nothing else of the matmul family, every
    attention product (the plain versions' and the dual encoder's pair
    grid) reaches ``aten.bmm``, with batch dimensions, and the CUDA
    kernels are no aten op at all. So 'dots' saves ``aten.mm`` outputs:
    the Dense projections and the FFN, as JAX saves them; the attention,
    its kernels' ``autograd.Function``s (K6/K8 run again) and the
    elementwise work are recomputed.

    ``saved`` / ``recomputed`` count the forward's decisions (policy
    '' would recompute ``saved + recomputed`` ops)."""

    SAVE = frozenset({torch.ops.aten.mm.default})

    def __init__(self):
        self.saved = 0
        self.recomputed = 0

    def __call__(self, ctx, op, *args, **kwargs):
        save = op in self.SAVE
        if not ctx.is_recompute:
            if save:
                self.saved += 1
            else:
                self.recomputed += 1
        return CheckpointPolicy.MUST_SAVE if save \
            else CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn(self):
        return create_selective_checkpoint_contexts(self)


REMAT_POLICIES = {"dots": DotsPolicy}


def resolve_remat_policy(name: str):
    """A config's ``remat_policy`` -> None ('': recompute everything, the
    least memory) or a policy object for ``remat``. Unknown names raise,
    as in the JAX package."""
    if not name:
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; expected one of "
                         f"{('',) + tuple(REMAT_POLICIES)}")
    return REMAT_POLICIES[name]()


def remat(fn, *args, policy=None):
    """``fn(*args)``, recomputed in backward (``torch.utils.checkpoint``,
    non-reentrant) under ``policy`` (None: recompute everything). The RNG
    state is not saved: every layer seeds its own generators from its
    seed-table row, so the recomputation redraws the same masks (under
    the forward's ``ops/draws.py`` context)."""
    extra = {} if policy is None else {"context_fn": policy.context_fn}
    return checkpoint(draws.bound(fn), *args, use_reentrant=False,
                      preserve_rng_state=False, **extra)


def _normal_(t: torch.Tensor, std: float = 0.02) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std)


def seeded_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``: a layer makes its own
    from its seed-table entry at the start of its forward, so that a
    recomputation under remat draws the same masks."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``): keep ~ Bernoulli(1 - rate)
    drawn from an explicit generator; kept values are divided by 1 - rate
    in the input's dtype."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, *, deterministic: bool = True, generator=None):
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout needs a generator")
        keep_prob = 1.0 - self.rate
        keep = draws.uniform(x.shape, generator, x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def drop_path(x, rate: float, *, deterministic: bool, generator=None):
    """Stochastic depth over the leading (batch) axis (JAX ``_drop_path``)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("stochastic depth needs a generator")
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = draws.uniform(shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / max(1.0 - rate, 1e-6),
                       torch.zeros_like(x)).to(x.dtype)


class LayerNorm(nn.Module):
    """Float32 LayerNorm that returns the compute dtype, of ``x`` or of the
    residual sum ``x + residual`` (``ops/norm.add_layer_norm``: one kernel
    in bf16 on the card)."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, residual=None, keep_sum: bool = False):
        """``LayerNorm(x + residual)``; with ``keep_sum`` also the sum,
        as ``(y, x + residual)``."""
        return add_layer_norm(x, residual, self.weight, self.bias, self.eps,
                              keep_sum, self.dtype)


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

    def product(self, x):
        """The product without the bias, rounded to the compute dtype (what
        ``ops/activation.bias_gelu`` takes with ``self.bias``)."""
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))

    def forward(self, x):
        y = self.product(x)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    def gelu(self, x):
        """``exact_gelu(self(x))``, through ``ops/activation.bias_gelu``."""
        return bias_gelu(self.product(x), self.bias)


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention; q from ``x``, k/v from ``y`` (self when
    ``y`` is None). Returns the context projected back to ``out_features``.

    Routing as in the JAX package (layers.py:216-250). Eval: the folded
    [.., L, H*D] kernels for >= 128 query rows, or for cross-attention to
    >= 128 keys; the unfolded [.., L, H, D] kernels otherwise. Train with
    attention dropout: the folded in-kernel-dropout route where
    ``attention_train.eligible`` holds (with ``seed``), else the unfolded
    route, whose dropout comes from ``generator``.

    ``capture_attention`` / ``perturb_attention`` (JAX ``layers.py:178-187,
    303-323``): every call takes the plain introspection route
    (``_introspect``), never a folded one, after the ``cache`` and
    ``precomputed_kv`` branches too, as in JAX."""

    def __init__(self, num_heads: int, head_dim: int, out_features: int,
                 kv_features: int | None = None, dtype=torch.float32,
                 device=None, dropout_rate: float = 0.0,
                 capture_attention: bool = False,
                 perturb_attention: bool = False, key_bias: bool = True):
        super().__init__()
        width = num_heads * head_dim
        kv_features = out_features if kv_features is None else kv_features
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dropout_rate = dropout_rate
        self.capture_attention = capture_attention
        self.perturb_attention = perturb_attention
        self.query = Dense(out_features, width, dtype, device)
        # key_bias False: EVA ViT-g's key projection, which has none
        self.key = Dense(kv_features, width, dtype, device, bias=key_bias)
        self.value = Dense(kv_features, width, dtype, device)
        self.out = Dense(width, out_features, dtype, device)

    def forward(self, x, y=None, bias=None, *, deterministic: bool = True,
                seed: int | None = None, generator=None,
                kv_only: bool = False, precomputed_kv=None, cache=None,
                cache_index: int | None = None, record=None,
                perturbation=None):
        """``record`` (with ``capture_attention``): called with each call's
        fp32 probabilities [.., H, Lq, M], before the perturbation and the
        dropout. ``perturbation`` (with ``perturb_attention``): a tensor of
        that shape added to them (zeros with ``requires_grad``: its
        gradient is dLoss/dProbs).

        Incremental decoding (JAX ``layers.py:190-287``; each off by
        default, each on the unfolded route):

        kv_only         return (k, v) of ``y`` [.., M, H, D] only: a
                        decode projects the image K/V once, not per token.
        precomputed_kv  (k, v) [.., M, H, D] to attend over; their
                        projections are skipped.
        cache           (k_cache, v_cache) [.., T, H, D]: ``x`` is one
                        [.., 1, D] step whose K/V are written at
                        ``cache_index`` (in place) before it attends over
                        the whole cache. Returns (out, (k_cache, v_cache)).
        """
        heads = (self.num_heads, self.head_dim)
        introspect = self.capture_attention or self.perturb_attention
        if kv_only:
            y = x if y is None else y
            return (self.key(y).unflatten(-1, heads),
                    self.value(y).unflatten(-1, heads))
        if precomputed_kv is not None or cache is not None:
            q = self.query(x).unflatten(-1, heads)
            if precomputed_kv is not None:
                k, v = precomputed_kv
            else:
                k, v = cache
                k[..., cache_index:cache_index + 1, :, :] = \
                    self.key(x).unflatten(-1, heads).to(k.dtype)
                v[..., cache_index:cache_index + 1, :, :] = \
                    self.value(x).unflatten(-1, heads).to(v.dtype)
            if introspect:
                ctx = self._introspect(q, k, v, bias, deterministic,
                                       generator, record, perturbation)
            else:
                ctx = dot_product_attention(
                    q, k, v, bias, dropout_rate=self.dropout_rate,
                    deterministic=deterministic, seed=seed,
                    generator=generator)
            out = self.out(ctx.flatten(-2))
            return out if cache is None else (out, (k, v))
        is_cross = y is not None
        y = x if y is None else y
        if introspect:
            q, k, v = (proj(t).unflatten(-1, heads) for proj, t in
                       ((self.query, x), (self.key, y), (self.value, y)))
            return self.out(self._introspect(
                q, k, v, bias, deterministic, generator, record,
                perturbation).flatten(-2))
        train_drop = not deterministic and self.dropout_rate > 0.0
        if train_drop:
            folded = ((bias is None
                       or (bias.ndim >= 3 and bias.shape[-3] == 1))
                      and attention_train.eligible(
                          x.shape[-2], bias, y.shape[-2],
                          batch=math.prod(x.shape[:-2])))
        else:
            folded = x.shape[-2] >= 128 or (is_cross and y.shape[-2] >= 128)
        q, k, v = self.query(x), self.key(y), self.value(y)
        if folded and train_drop:
            ctx = dot_product_attention_folded_train(
                q, k, v, bias, num_heads=self.num_heads, seed=seed,
                dropout_rate=self.dropout_rate)
        elif folded:
            ctx = dot_product_attention_folded(q, k, v, bias,
                                               num_heads=self.num_heads)
        else:
            ctx = dot_product_attention(
                q.unflatten(-1, heads), k.unflatten(-1, heads),
                v.unflatten(-1, heads), bias, dropout_rate=self.dropout_rate,
                deterministic=deterministic, seed=seed,
                generator=generator).flatten(-2)
        return self.out(ctx)

    def _introspect(self, q, k, v, bias, deterministic: bool, generator,
                    record, perturbation):
        """The capture / perturbation route, JAX's XLA einsums in JAX's
        order (no kernel, as in JAX): the plain version's fp32 scores
        (``scaled_scores``) plus the fp32 bias; an fp32 softmax
        (max-subtracted exp and a divide); the record; the perturbation;
        dropout from ``generator``; the probabilities cast to the compute
        dtype for P.V with fp32 accumulation; the context in that dtype.
        q [.., Lq, H, D]; k, v [.., M, H, D]; returns [.., Lq, H, D]."""
        dtype = q.dtype
        scores = scaled_scores(q, k)
        if bias is not None:
            scores = scores + bias.float()
        scores = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = scores / scores.sum(dim=-1, keepdim=True)
        if self.capture_attention and record is not None:
            record(probs)
        if self.perturb_attention and perturbation is not None:
            probs = probs + perturbation
        if not deterministic and self.dropout_rate > 0.0:
            probs = _dropout_probs(probs, self.dropout_rate, generator)
        return torch.einsum("...hqk,...khd->...qhd", probs.to(dtype).float(),
                            v.float()).to(dtype)


class Mlp(nn.Module):
    """Transformer FFN: dense -> exact GELU -> dropout -> dense."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dtype=torch.float32, device=None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype, device)
        self.drop = Dropout(dropout_rate)
        self.fc2 = Dense(hidden_features, out_features, dtype, device)

    def forward(self, x, *, deterministic: bool = True, generator=None):
        h = self.drop(self.fc1.gelu(x), deterministic=deterministic,
                      generator=generator)
        return self.fc2(h)
