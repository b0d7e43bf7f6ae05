"""MED text encoder (port of the JAX package's ``models/med.py``).

BLIP's single-stream BERT: word + position embeddings, post-LN layers of
self-attention, optional cross-attention over image tokens ('multimodal'
mode), and FFN; additive (1 - mask) * -10000 masking, LayerNorm eps 1e-12.

Training (``deterministic=False``, stage I) takes a seed table of shape
``TextEncoder.seed_shape``: row 0 seeds the embedding dropout, row i + 1
layer i as ``SEED_SITES`` int32 seeds (its generator for the hidden
dropouts and any attention dropout off the kernels' route, then the kernel
seeds of its self-attention and cross-attention). A layer re-seeds its
generator at the start of its forward, so a remat recomputation draws the
same masks. At B = 512 the cross-attention to the 577 image tokens takes
the folded in-kernel-dropout route (K8/K9); the 40-key text self-attention
is below ``attention_train.MIN_KV`` and drops out from the generator, as
the JAX package's does from ``jax.random``.

The decoder's modes (JAX ``med.py:195-299``): ``causal=True`` adds a
lower-triangular mask to the padding mask (teacher-forced captioning);
``precompute_image_kv`` projects every layer's cross-attention K/V of the
image tokens once, and ``decode_cache`` runs one token a step against
per-layer self-attention K/V caches (``models/blip_decoder.py``).

Attention capture and perturbation (JAX ``med.py:230-239, 274-283``; the
config's ``capture_attention`` / ``perturb_attention``): ``forward`` fills
the caller's ``intermediates`` dict with every layer's probabilities,
stacked as JAX's ``nn.scan`` stacks its 'intermediates' collection, under
JAX's collection paths (``SELF_PROBS``, ``CROSS_PROBS``), and adds the
caller's ``perturbations`` (same keys and layout, zero tensors with
``requires_grad``; ``zero_perturbations`` makes them) to the
probabilities, so that their gradient is dLoss/dProbs. Under remat a
layer's probabilities are recorded in the forward pass only, not again
when ``torch.utils.checkpoint`` recomputes the layer in the backward.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import TextEncoderConfig
from candidate_reranking_cir_tpu_torch.models.layers import (
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
    _normal_,
    exact_gelu,
    remat,
    resolve_remat_policy,
    seeded_generator,
)
from candidate_reranking_cir_tpu_torch.ops.attention import make_additive_mask

SEED_SITES = 3  # generator, self-attention, cross-attention

# JAX's collection paths of the stacked probabilities
SELF_PROBS = "layers/self_attn/attn/attn_probs"
CROSS_PROBS = "layers/cross_attn/attn/attn_probs"


class LayerRecords:
    """One layer's captured probabilities ({path: [B, H, Lq, M]}). The
    layer's forward pass fills it; ``TextEncoder`` then closes it, so that
    a recomputation of the layer (remat) records nothing."""

    def __init__(self):
        self.probs = {}
        self.open = True

    def recorder(self, path: str):
        def record(probs):
            if self.open:
                self.probs[path] = probs
        return record


class BertEmbeddings(nn.Module):
    """Word + absolute position embeddings, LayerNorm, dropout."""

    def __init__(self, cfg: TextEncoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        std = cfg.initializer_range
        self.word_embeddings = nn.Parameter(_normal_(
            torch.empty(cfg.vocab_size, cfg.hidden_size, device=device), std))
        self.position_embeddings = nn.Parameter(_normal_(
            torch.empty(cfg.max_position_embeddings, cfg.hidden_size,
                        device=device), std))
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype, device)
        self.drop = Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, *, position: int | None = None,
                deterministic: bool = True, generator=None):
        """``position`` None embeds [.., L] at positions 0..L-1; an int
        embeds one [.., 1] token at that absolute position (a decode
        step)."""
        if position is None:
            pos = self.position_embeddings[:input_ids.shape[-1]]
        else:
            pos = self.position_embeddings[position:position + 1]
        x = self.word_embeddings[input_ids.long()] + pos
        return self.drop(self.ln(x.to(self.dtype)),
                         deterministic=deterministic, generator=generator)


class BertSelfAttentionBlock(nn.Module):
    """Attention + output dense + residual + post-LN."""

    def __init__(self, cfg: TextEncoderConfig, kv_features: int | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.attn = MultiHeadAttention(
            cfg.num_heads, cfg.head_dim, cfg.hidden_size, kv_features, dtype,
            device, cfg.attention_dropout,
            capture_attention=cfg.capture_attention,
            perturb_attention=cfg.perturb_attention)
        self.drop = Dropout(cfg.hidden_dropout)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype, device)

    def forward(self, x, kv=None, bias=None, *, deterministic: bool = True,
                seed: int | None = None, generator=None,
                precomputed_kv=None, cache=None,
                cache_index: int | None = None, record=None,
                perturbation=None):
        """``precomputed_kv`` / ``cache`` / ``record`` / ``perturbation``
        as ``MultiHeadAttention``'s; with a cache, returns (out, (k_cache,
        v_cache))."""
        ctx = self.attn(x, kv, bias, deterministic=deterministic, seed=seed,
                        generator=generator, precomputed_kv=precomputed_kv,
                        cache=cache, cache_index=cache_index, record=record,
                        perturbation=perturbation)
        if cache is not None:
            ctx, cache = ctx
        ctx = self.drop(ctx, deterministic=deterministic, generator=generator)
        out = self.ln(ctx + x)
        return out if cache is None else (out, cache)


class BertFFN(nn.Module):
    """Intermediate GELU dense -> output dense -> dropout -> residual
    post-LN."""

    def __init__(self, cfg: TextEncoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                                  dtype, device)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, dtype,
                            device)
        self.drop = Dropout(cfg.hidden_dropout)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype, device)

    def forward(self, x, *, deterministic: bool = True, generator=None):
        h = self.output(exact_gelu(self.intermediate(x)))
        h = self.drop(h, deterministic=deterministic, generator=generator)
        return self.ln(h + x)


class MedLayer(nn.Module):
    """One MED layer; its cross-attention runs only in 'multimodal' mode.
    ``seeds``: the layer's row of the seed table, or None at eval.

    ``query_group`` Q > 1: image-major fusion. ``x`` holds Q queries per
    image ([G*Q, L, D] against ``image_kv`` [G, M, W]) and the
    cross-attention folds them into its row axis ([G, Q*L, D]), so each
    image's K/V projections run once per image, not once per query. The
    self-attention and the FFN stay per query; the residual and post-LN
    inside the block are row-wise, so running them folded is exact."""

    def __init__(self, cfg: TextEncoderConfig, multimodal: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = BertSelfAttentionBlock(cfg, None, dtype, device)
        self.cross_attn = (BertSelfAttentionBlock(cfg, cfg.encoder_width,
                                                  dtype, device)
                           if multimodal else None)
        self.ffn = BertFFN(cfg, dtype, device)

    def forward(self, x, text_bias, image_kv=None, image_bias=None,
                seeds=None, query_group: int = 1, *, records=None,
                perturbations=None):
        """``records``: a ``LayerRecords`` to capture into;
        ``perturbations``: {path: this layer's [B, H, Lq, M] tensor}."""
        det = seeds is None
        gen = None if det else seeded_generator(seeds[0], x.device)
        x = self.self_attn(x, None, text_bias, deterministic=det,
                           seed=None if det else seeds[1], generator=gen,
                           **_hooks(records, perturbations, SELF_PROBS))
        if image_kv is not None:
            b, l, d = x.shape
            # [G*Q, L, D] -> [G, Q*L, D]: a view of contiguous rows
            xg = x.view(b // query_group, query_group * l, d)
            xg = self.cross_attn(xg, image_kv, image_bias, deterministic=det,
                                 seed=None if det else seeds[2],
                                 generator=gen,
                                 **_hooks(records, perturbations,
                                          CROSS_PROBS))
            x = xg.view(b, l, d)
        return self.ffn(x, deterministic=det, generator=gen)

    def image_kv(self, image_embeds):
        """This layer's cross-attention (k, v) [B, M, H, D] of the image
        tokens, projected once a decode."""
        return self.cross_attn.attn(image_embeds, kv_only=True)

    def decode_step(self, x, text_bias, cache, image_kv,
                    cache_index: int, *, records=None, perturbations=None):
        """One token ``x`` [B, 1, D] at ``cache_index``: its self-attention
        K/V are written into ``cache`` (k, v) [B, T, H, D] and it attends
        over the whole cache (``text_bias`` [B, 1, 1, T] masks the slots not
        yet written), then over the precomputed ``image_kv``. ``records``
        and ``perturbations`` as ``forward``'s."""
        x, cache = self.self_attn(
            x, None, text_bias, cache=cache, cache_index=cache_index,
            **_hooks(records, perturbations, SELF_PROBS))
        if self.cross_attn is not None:
            x = self.cross_attn(x, precomputed_kv=image_kv,
                                **_hooks(records, perturbations,
                                         CROSS_PROBS))
        return self.ffn(x), cache


def _hooks(records, perturbations, path: str) -> dict:
    """An attention call's ``record`` and ``perturbation`` arguments."""
    return {"record": None if records is None else records.recorder(path),
            "perturbation": None if perturbations is None
            else perturbations.get(path)}


class TextEncoder(nn.Module):
    """Single-stream MED encoder returning last_hidden_state [B, L, D].

    mode='text': self-attention only; 'multimodal': every layer also
    cross-attends to ``image_embeds`` [B, M, W] (``image_mask`` [B, M]
    optional; image tokens are never padded on the ported paths).
    ``query_group`` Q > 1 (eval, multimodal): ``input_ids`` [G*Q, L] holds Q
    queries per image of ``image_embeds`` [G, M, W], image-contiguous
    (image-major fusion, see ``MedLayer``).
    ``cfg.remat`` recomputes each layer in backward when gradients are on,
    under ``cfg.remat_policy`` (``models/layers.py::remat``)."""

    def __init__(self, cfg: TextEncoderConfig, mode: str = "multimodal",
                 dtype=torch.float32, device=None):
        super().__init__()
        if mode not in ("text", "multimodal"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.remat_policy = (resolve_remat_policy(cfg.remat_policy)
                             if cfg.remat else None)
        self.mode = mode
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.layers = nn.ModuleList(
            MedLayer(cfg, mode == "multimodal", dtype, device)
            for _ in range(cfg.num_layers))

    @property
    def seed_shape(self) -> tuple[int, int]:
        return (len(self.layers) + 1, SEED_SITES)

    def zero_perturbations(self, batch: int, length: int,
                           image_len: int | None = None, *,
                           device=None) -> dict:
        """Zero perturbations with ``requires_grad`` for a ``forward``
        over ``batch`` queries of ``length`` tokens (JAX's 'perturbations'
        collection as ``init`` makes it): {SELF_PROBS: [n_layers, B, H,
        L, L]} and, with ``image_len``, {CROSS_PROBS: [n_layers, B, H, L,
        image_len]}; fp32."""
        shape = (len(self.layers), batch, self.cfg.num_heads, length)
        out = {SELF_PROBS: torch.zeros(*shape, length, device=device)}
        if image_len is not None:
            out[CROSS_PROBS] = torch.zeros(*shape, image_len, device=device)
        return {k: v.requires_grad_() for k, v in out.items()}

    def forward(self, input_ids, attention_mask, image_embeds=None,
                image_mask=None, *, mode: str | None = None,
                causal: bool = False, deterministic: bool = True, seeds=None,
                query_group: int = 1, precompute_image_kv: bool = False,
                decode_cache=None, cache_index: int | None = None,
                intermediates: dict | None = None,
                perturbations: dict | None = None):
        """``causal`` adds (1 - tril) * -10000 to the padding bias, which
        becomes [B, 1, L, L] (the reference's decoder mode).

        ``precompute_image_kv``: returns every layer's cross-attention
        (k_img, v_img) of ``image_embeds``, stacked [n_layers, B, M, H, D];
        ``input_ids`` and ``attention_mask`` are not read.

        ``decode_cache`` (k_self, v_self, k_img, v_img), each stacked
        [n_layers, B, T|M, H, D]: one decode step. ``input_ids`` [B, 1] is
        the token at absolute position ``cache_index``, ``attention_mask``
        [B, T] the cache slots' validity (the slots after ``cache_index``
        are 0, so causality needs no mask of its own). The step's self K/V
        are written into k_self and v_self in place. Returns (hidden
        [B, 1, D], (k_self, v_self)). Both modes are eval only.

        ``intermediates`` (``cfg.capture_attention``): a dict that gets
        {SELF_PROBS: [n_layers, B, H, L, L], CROSS_PROBS: [n_layers, B, H,
        L, M]} (a decode step: [.., 1, T] and [.., 1, M]), fp32, before
        dropout. ``perturbations`` (``cfg.perturb_attention``): the same
        keys and shapes, added to the probabilities. With either flag set,
        ``query_group`` Q > 1 repeats each image's features across its
        queries and fuses query-major, so the records keep the per-query
        layout (JAX ``med.py:274-283``)."""
        multimodal = (mode if mode is not None else self.mode) == "multimodal"
        if multimodal and self.mode != "multimodal":
            raise ValueError("this encoder was built without cross-attention")
        if precompute_image_kv or decode_cache is not None:
            if not (multimodal and deterministic):
                raise ValueError("the decode modes need the multimodal "
                                 "encoder, deterministic")
            if precompute_image_kv:
                kv = [layer.image_kv(image_embeds.to(self.dtype))
                      for layer in self.layers]
                return (torch.stack([k for k, _ in kv]),
                        torch.stack([v for _, v in kv]))
            return self._decode_step(input_ids, attention_mask, decode_cache,
                                     cache_index, intermediates,
                                     perturbations)
        if not deterministic and seeds is None:
            raise ValueError("training needs a seed table")
        emb_gen = None if deterministic else seeded_generator(
            seeds[0][0], input_ids.device)
        x = self.embeddings(input_ids, deterministic=deterministic,
                            generator=emb_gen)
        text_bias = make_additive_mask(attention_mask)
        if causal:
            length = input_ids.shape[-1]
            tri = torch.tril(torch.ones(length, length,
                                        device=text_bias.device))
            text_bias = text_bias + (1.0 - tri) * -10000.0
        image_bias = None
        if multimodal:
            if image_embeds is None:
                raise ValueError("multimodal mode needs image_embeds")
            if query_group > 1 and (self.cfg.capture_attention
                                    or self.cfg.perturb_attention):
                # the records keep the per-query [B, H, L, M] layout, which
                # the image-major fold would change to [G, H, Q*L, M]
                image_embeds = image_embeds.repeat_interleave(query_group, 0)
                if image_mask is not None:
                    image_mask = image_mask.repeat_interleave(query_group, 0)
                query_group = 1
            if query_group > 1 and \
                    input_ids.shape[0] != image_embeds.shape[0] * query_group:
                raise ValueError("query_group fusion needs input_ids [G*Q, L] "
                                 "with image_embeds [G, M, W]")
            image_embeds = image_embeds.to(self.dtype)
            if image_mask is not None:
                image_bias = make_additive_mask(image_mask)
        else:
            image_embeds, query_group = None, 1
        recompute = self.cfg.remat and torch.is_grad_enabled()
        records = []
        for i, layer in enumerate(self.layers):
            row = None if deterministic else seeds[i + 1]
            hooks = self._layer_hooks(i, intermediates, perturbations,
                                      records)
            fn = functools.partial(layer, **hooks) if hooks else layer
            if recompute:
                x = remat(fn, x, text_bias, image_embeds, image_bias, row,
                          query_group, policy=self.remat_policy)
            else:
                x = fn(x, text_bias, image_embeds, image_bias, row,
                       query_group)
            if records:
                records[-1].open = False
        _stack_records(records, intermediates)
        return x

    def _layer_hooks(self, i: int, intermediates, perturbations,
                     records: list) -> dict:
        """Layer ``i``'s ``records`` (appended to ``records``) and
        ``perturbations`` arguments, or {} when it captures nothing."""
        hooks = {}
        if intermediates is not None and self.cfg.capture_attention:
            records.append(LayerRecords())
            hooks["records"] = records[-1]
        if perturbations is not None and self.cfg.perturb_attention:
            hooks["perturbations"] = {k: v[i]
                                      for k, v in perturbations.items()}
        return hooks

    def _decode_step(self, input_ids, attention_mask, decode_cache,
                     cache_index: int, intermediates=None,
                     perturbations=None):
        k_self, v_self, k_img, v_img = decode_cache
        x = self.embeddings(input_ids, position=cache_index)
        text_bias = make_additive_mask(attention_mask)
        records = []
        for i, layer in enumerate(self.layers):
            x, _ = layer.decode_step(
                x, text_bias, (k_self[i], v_self[i]), (k_img[i], v_img[i]),
                cache_index, **self._layer_hooks(i, intermediates,
                                                 perturbations, records))
        _stack_records(records, intermediates)
        return x, (k_self, v_self)


def _stack_records(records: list, intermediates) -> None:
    """Each path's per-layer probabilities, stacked to [n_layers, ...] into
    ``intermediates`` (as JAX's ``nn.scan`` stacks them)."""
    if not records:
        return
    for path in records[0].probs:
        intermediates[path] = torch.stack([r.probs[path] for r in records])
