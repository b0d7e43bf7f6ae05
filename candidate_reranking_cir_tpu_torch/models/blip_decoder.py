"""BLIP caption decoder (port of the JAX package's ``models/blip_decoder.py``):
the reference's BLIP_Decoder / BertLMHeadModel (blip.py:78-169,
med.py:825-969).

- ``BertLMHead``: transform dense -> GELU -> LayerNorm -> vocab projection
  (+ bias), the reference's BertLMPredictionHead (``cls.predictions.*``
  keys, loaded by ``runtime/weights.py``).
- ``CaptionDecoder``: ViT image encoder + causal MED decoder + LM head.

Two decoding paths with the same output:
- recompute (``greedy_caption`` / ``beam_caption``): a full-prefix forward
  a step, O(T^2); the parity reference;
- KV cache (``greedy_caption_cached`` / ``beam_caption_cached`` /
  ``sample_caption_cached``): the image cross-attention K/V projected once
  a decode and each layer's self-attention K/V written into a cache, one
  token a step (the reference's cache, med.py:179-190, 647-666).

The teacher-forced forward also runs with dropout (``deterministic=False``
and the ViT's and the MED's seed tables), through the attention routes of
``models/layers.py``: the in-kernel-dropout kernels where
``attention_train.eligible`` holds (K8/K9 for the ViT's 577-token
self-attention), plain attention with dropout from a layer's generator
elsewhere (the MED's caption-length self- and cross-attention at the
default thresholds). The decodes are eval only, as in the JAX package.

Every loop runs in Python under ``torch.inference_mode()``, one step at a
time, on the device of the image features: on the card the steps run the
attention kernels (K1 in the ViT and the recompute path's cross-attention,
K2 for the causal and cache-slot masks, K3 for the one-token cross-attention
over the precomputed image K/V), on the CPU their plain versions. Beam
selection breaks ties as ``lax.top_k`` does, lower index first (a stable
descending sort); sampling draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import RetrievalModelConfig
from candidate_reranking_cir_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    exact_gelu,
)
from candidate_reranking_cir_tpu_torch.models.med import TextEncoder
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


class BertLMHead(nn.Module):
    """hidden [.., D] -> vocab logits [.., V] (fp32)."""

    def __init__(self, hidden_size: int, vocab_size: int,
                 layer_norm_eps: float = 1e-12, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.transform = Dense(hidden_size, hidden_size, dtype, device)
        self.ln = LayerNorm(hidden_size, layer_norm_eps, dtype, device)
        self.decoder = Dense(hidden_size, vocab_size, dtype, device)

    def forward(self, hidden):
        h = self.ln(exact_gelu(self.transform(hidden)))
        return self.decoder(h).float()


class CaptionDecoder(nn.Module):
    """Image-conditioned causal language model. Built on ``device``
    (default 'cuda'; raises without a card unless device='cpu');
    computes in ``dtype``. ``cfg.embed_dim`` is not used."""

    def __init__(self, cfg: RetrievalModelConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.visual_encoder = VisionTransformer(cfg.vit, dtype, device)
        self.text_decoder = TextEncoder(cfg.text, "multimodal", dtype, device)
        self.lm_head = BertLMHead(cfg.text.hidden_size, cfg.text.vocab_size,
                                  cfg.text.layer_norm_eps, dtype, device)

    def forward(self, images, input_ids, attention_mask, *,
                deterministic: bool = True, seeds=None):
        """Teacher-forced logits [B, L, V] (fp32). ``seeds``: (the ViT's
        seed table, ``visual_encoder.seed_shape``; the MED's,
        ``text_decoder.seed_shape``) when not deterministic."""
        vit_seeds, text_seeds = (None, None) if seeds is None else seeds
        feats = self.visual_encoder(images, deterministic=deterministic,
                                    seeds=vit_seeds)
        return self.logits(feats, input_ids, attention_mask,
                           deterministic=deterministic, seeds=text_seeds)

    def logits(self, image_feats, input_ids, attention_mask, *,
               deterministic: bool = True, seeds=None):
        """The causal MED over ``image_feats`` and the LM head; ``seeds``
        the MED's seed table when not deterministic."""
        hidden = self.text_decoder(input_ids, attention_mask, image_feats,
                                   causal=True, deterministic=deterministic,
                                   seeds=seeds)
        return self.lm_head(hidden)

    def precompute_kv(self, image_feats):
        """Every layer's cross-attention K/V of the image tokens, projected
        once: (k_img, v_img), each [n_layers, B, M, H, D]."""
        return self.text_decoder(None, None, image_feats,
                                 precompute_image_kv=True)

    def decode_step(self, token_ids, cache_mask, decode_cache,
                    cache_index: int):
        """One cached step: ``token_ids`` [B, 1] at position
        ``cache_index``, ``cache_mask`` [B, T] the cache slots' validity.
        Writes the step's self-attention K/V into the cache in place and
        returns (vocab logits [B, V], (k_self, v_self))."""
        hidden, new_self = self.text_decoder(
            token_ids, cache_mask, decode_cache=decode_cache,
            cache_index=cache_index)
        return self.lm_head(hidden[:, 0]), new_self


def _self_cache(decoder: CaptionDecoder, b: int, max_len: int, device):
    """Zeroed self-attention caches (k, v) [n_layers, B, T, H, D]."""
    cfg = decoder.cfg.text
    shape = (cfg.num_layers, b, max_len, cfg.num_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=decoder.dtype, device=device),
            torch.zeros(shape, dtype=decoder.dtype, device=device))


def _prompt_prefix(bos_id: int, prompt_ids, device) -> torch.Tensor:
    """[bos, *prompt] int32: the decode's conditioning prefix (the
    reference tokenizes 'a picture of ', writes bos over token 0 and drops
    the trailing [SEP]: blip.py:119-127)."""
    return torch.tensor([bos_id, *prompt_ids], dtype=torch.int32,
                        device=device)


def _start(prefix, b: int, max_len: int, pad_id: int):
    """(ids [B, T] pad after the prefix, mask [B, T] 1 over the prefix)."""
    p = prefix.shape[0]
    if p >= max_len:
        raise ValueError("prompt must be shorter than max_len")
    ids = torch.full((b, max_len), pad_id, dtype=torch.int32,
                     device=prefix.device)
    ids[:, :p] = prefix
    mask = torch.zeros((b, max_len), dtype=torch.int32, device=prefix.device)
    mask[:, :p] = 1
    return ids, mask


def apply_repetition_penalty(logits, ids, mask, penalty: float):
    """HF CTRL-style repetition penalty (the processor of the reference's
    sampling path, blip.py:128-151, repetition_penalty 1.1): every token
    id present in the valid part of ``ids`` has its logit divided by
    ``penalty`` if positive, multiplied if negative, once however often it
    occurs. logits [B, V] fp32; ids [B, T] with validity ``mask`` [B, T].
    A true division, as the JAX function computes it outside ``jit``."""
    if penalty == 1.0:
        return logits
    present = torch.zeros(logits.shape, dtype=torch.int32,
                          device=logits.device).scatter_reduce(
        1, ids.long(), mask.to(torch.int32), reduce="amax")
    # a 0-dim tensor made on the device: no host-to-device copy, and a true
    # division on the card too (a Python scalar divisor becomes a product
    # with its reciprocal there)
    p = torch.full((), penalty, dtype=logits.dtype, device=logits.device)
    penalized = torch.where(logits < 0, logits * p, logits / p)
    return torch.where(present.bool(), penalized, logits)


def top_p_filter(logits, top_p: float):
    """Nucleus filtering with HF TopPLogitsWarper's semantics
    (transformers 4.25): sort descending, drop the tokens whose cumulative
    softmax probability exceeds ``top_p``, except the first one past the
    threshold (HF's shift right), so one token always survives.

    Returns (sorted logits with the dropped ones -inf [B, V], sort index
    [B, V]); sampling runs in the sorted space and maps back through the
    index, which keeps the kept set exact under tied logits (a stable
    sort: equal logits keep index order, as JAX's stable argsort)."""
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                         stable=True)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                       dim=-1)
    return sorted_logits.masked_fill(remove, float("-inf")), sort_idx


def _advance(ids, mask, finished, nxt, t: int, prefix, pad_id: int,
             eos_id: int):
    """Write step t's tokens at t + 1 (pad after a row finished; the prompt
    forced while t + 1 is inside the prefix) and return the new
    ``finished``."""
    nxt = torch.where(finished, pad_id, nxt.to(torch.int32))
    if t + 1 < prefix.shape[0]:
        nxt = prefix[t + 1].expand_as(nxt)
    ids[:, t + 1] = nxt
    mask[:, t + 1] = (~finished).to(torch.int32)
    return finished | (nxt == eos_id)


@torch.inference_mode()
def greedy_caption(decoder: CaptionDecoder, image_feats, *, bos_id: int,
                   eos_id: int, pad_id: int, max_len: int = 20,
                   prompt_ids: tuple = ()) -> torch.Tensor:
    """Greedy decode [B, max_len] int32 (bos first, pad after eos): a
    full-prefix forward a step over a fixed-length buffer; the causal mask
    makes the positions after t irrelevant to the logits at t.

    prompt_ids: an optional conditioning prefix after bos (see
    ``sample_caption_cached``)."""
    b = image_feats.shape[0]
    prefix = _prompt_prefix(bos_id, prompt_ids, image_feats.device)
    ids, mask = _start(prefix, b, max_len, pad_id)
    finished = torch.zeros(b, dtype=torch.bool, device=ids.device)
    for t in range(prefix.shape[0] - 1, max_len - 1):
        nxt = decoder.logits(image_feats, ids, mask)[:, t].argmax(dim=-1)
        finished = _advance(ids, mask, finished, nxt, t, prefix, pad_id,
                            eos_id)
    return ids


@torch.inference_mode()
def greedy_caption_cached(decoder: CaptionDecoder, image_feats, *,
                          bos_id: int, eos_id: int, pad_id: int,
                          max_len: int = 20,
                          prompt_ids: tuple = ()) -> torch.Tensor:
    """KV-cached greedy decode, with ``greedy_caption``'s output: the image
    cross-attention K/V projected once, then a one-token forward a step
    that writes its self-attention K/V into the cache (the prompt's steps
    only fill the cache). Every step runs: the JAX package scans all
    max_len - 1 of them, and no step waits on the host."""
    b = image_feats.shape[0]
    dev = image_feats.device
    prefix = _prompt_prefix(bos_id, prompt_ids, dev)
    k_img, v_img = decoder.precompute_kv(image_feats)
    k_self, v_self = _self_cache(decoder, b, max_len, dev)
    ids, mask = _start(prefix, b, max_len, pad_id)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(max_len - 1):
        logits, _ = decoder.decode_step(ids[:, t:t + 1], mask,
                                        (k_self, v_self, k_img, v_img), t)
        finished = _advance(ids, mask, finished, logits.argmax(dim=-1), t,
                            prefix, pad_id, eos_id)
    return ids


@torch.inference_mode()
def sample_caption_cached(decoder: CaptionDecoder, image_feats,
                          generator: torch.Generator, *, bos_id: int,
                          eos_id: int, pad_id: int, max_len: int = 30,
                          min_len: int = 10, top_p: float = 0.9,
                          repetition_penalty: float = 1.1,
                          prompt_ids: tuple = ()) -> torch.Tensor:
    """KV-cached nucleus sampling, the reference BLIP_Decoder's
    ``generate(sample=True)`` (blip.py:128-151: top_p 0.9, repetition
    penalty 1.1, min_length 10, eos = [SEP]).

    Each step applies the repetition penalty over the tokens so far, bans
    eos while the sequence (bos included) is shorter than ``min_len``,
    nucleus-filters in sorted space and draws one token by the Gumbel-max
    rule (as ``jax.random.categorical`` does) with uniforms from
    ``generator``, which must live on the features' device. The same
    generator state gives the same ids.

    prompt_ids: an optional conditioning prefix, the wordpiece ids of the
    reference's ``prompt`` after its leading token is replaced by bos and
    its trailing [SEP] dropped (blip.py:119-127 tokenizes 'a picture of ').
    Rows start [bos, *prompt_ids, generated...]; HF's cur_len accounting
    (min_length, the penalty over the prompt) is kept. () decodes from bos
    alone."""
    b = image_feats.shape[0]
    dev = image_feats.device
    prefix = _prompt_prefix(bos_id, prompt_ids, dev)
    k_img, v_img = decoder.precompute_kv(image_feats)
    k_self, v_self = _self_cache(decoder, b, max_len, dev)
    ids, mask = _start(prefix, b, max_len, pad_id)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    vocab = decoder.cfg.text.vocab_size
    is_eos = torch.arange(vocab, device=dev) == eos_id
    for t in range(max_len - 1):
        logits, _ = decoder.decode_step(ids[:, t:t + 1], mask,
                                        (k_self, v_self, k_img, v_img), t)
        logits = apply_repetition_penalty(logits, ids, mask,
                                          repetition_penalty)
        if t + 1 < min_len:  # HF MinLengthLogitsProcessor
            logits = logits.masked_fill(is_eos, float("-inf"))
        sorted_logits, sort_idx = top_p_filter(logits, top_p)
        u = torch.rand(sorted_logits.shape, generator=generator, device=dev)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        pos = (sorted_logits - torch.log(-torch.log(u))).argmax(dim=-1)
        nxt = sort_idx.gather(1, pos[:, None])[:, 0]
        finished = _advance(ids, mask, finished, nxt, t, prefix, pad_id,
                            eos_id)
    return ids


def _beam_step(state, lp, t: int, b: int, nb: int, pad_id: int,
               eos_id: int):
    """One beam step on ``state`` (ids, mask, scores, finished, lengths)
    with step t's log-probabilities ``lp`` [B*nb, V]: finished beams
    continue with exactly one token (pad, log-probability 0); the best
    ``nb`` of each image's nb x V candidates, ties to the lower index as
    ``lax.top_k`` breaks them, write their token at t + 1. Returns (the
    new state, the source row of each beam [B*nb])."""
    ids, mask, scores, finished, lengths = state
    vocab = lp.shape[-1]
    frozen = torch.full_like(lp, -1e9)
    frozen[:, pad_id] = 0.0
    lp = torch.where(finished[:, None], frozen, lp)
    cand = (scores[:, None] + lp).reshape(b, nb * vocab)
    top_scores, top_idx = torch.sort(cand, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :nb], top_idx[:, :nb]
    sel = (top_idx // vocab
           + torch.arange(b, device=lp.device)[:, None] * nb).reshape(-1)
    token = (top_idx % vocab).reshape(-1).to(torch.int32)
    ids = ids[sel]
    ids[:, t + 1] = token
    was_finished = finished[sel]
    mask = mask[sel]
    mask[:, t + 1] = (~was_finished).to(torch.int32)
    lengths = lengths[sel] + (~was_finished).to(torch.int32)
    finished = was_finished | (token == eos_id)
    return (ids, mask, top_scores.reshape(-1), finished, lengths), sel


def _beam_state(prefix, b: int, nb: int, max_len: int, pad_id: int):
    """(ids, mask, scores, finished, lengths) of B x nb beams; only beam 0
    of each image is alive at the start, so identical beams do not
    multiply."""
    ids, mask = _start(prefix, b * nb, max_len, pad_id)
    dev = ids.device
    scores = torch.tensor([0.0] + [-1e9] * (nb - 1), device=dev).repeat(b)
    finished = torch.zeros(b * nb, dtype=torch.bool, device=dev)
    lengths = torch.full((b * nb,), prefix.shape[0], dtype=torch.int32,
                         device=dev)
    return ids, mask, scores, finished, lengths


def _beam_best(state, b: int, nb: int, length_penalty: float):
    """Each image's beam of the best length-normalised score [B, T]."""
    ids, _, scores, _, lengths = state
    norm = scores / lengths.clamp_min(1).float() ** length_penalty
    best = norm.reshape(b, nb).argmax(dim=-1) \
        + torch.arange(b, device=ids.device) * nb
    return ids[best]


@torch.inference_mode()
def beam_caption(decoder: CaptionDecoder, image_feats, *, bos_id: int,
                 eos_id: int, pad_id: int, max_len: int = 20,
                 num_beams: int = 3, length_penalty: float = 1.0,
                 prompt_ids: tuple = ()) -> torch.Tensor:
    """Beam-search decode [B, max_len] (the reference BLIP_Decoder's
    default, blip.py:119-135: 3 beams): a full-prefix forward over the
    [B*beams] buffer a step; finished beams are frozen with a zero
    log-probability continuation and ranked by length-normalised score at
    the end. prompt_ids: as ``sample_caption_cached``'s."""
    b, nb = image_feats.shape[0], num_beams
    prefix = _prompt_prefix(bos_id, prompt_ids, image_feats.device)
    feats = image_feats.repeat_interleave(nb, dim=0)      # [B*nb, M, W]
    state = _beam_state(prefix, b, nb, max_len, pad_id)
    for t in range(prefix.shape[0] - 1, max_len - 1):
        ids, mask = state[:2]
        lp = torch.log_softmax(decoder.logits(feats, ids, mask)[:, t], dim=-1)
        state, _ = _beam_step(state, lp, t, b, nb, pad_id, eos_id)
        if bool(state[3].all()):
            break
    return _beam_best(state, b, nb, length_penalty)


@torch.inference_mode()
def beam_caption_cached(decoder: CaptionDecoder, image_feats, *,
                        bos_id: int, eos_id: int, pad_id: int,
                        max_len: int = 20, num_beams: int = 3,
                        length_penalty: float = 1.0,
                        prompt_ids: tuple = ()) -> torch.Tensor:
    """KV-cached beam search with ``beam_caption``'s output: a one-token
    forward a step; reordering the beams gathers the self-attention caches
    along the beam axis. The prompt's steps only fill the caches; the
    beam bookkeeping starts at the first generated position."""
    b, nb = image_feats.shape[0], num_beams
    dev = image_feats.device
    prefix = _prompt_prefix(bos_id, prompt_ids, dev)
    p = prefix.shape[0]
    feats = image_feats.repeat_interleave(nb, dim=0)      # [B*nb, M, W]
    k_img, v_img = decoder.precompute_kv(feats)
    k_self, v_self = _self_cache(decoder, b * nb, max_len, dev)
    state = _beam_state(prefix, b, nb, max_len, pad_id)
    for t in range(max_len - 1):
        ids, mask = state[:2]
        logits, _ = decoder.decode_step(ids[:, t:t + 1], mask,
                                        (k_self, v_self, k_img, v_img), t)
        if t + 1 < p:  # a prompt step: only its cache write matters
            continue
        state, sel = _beam_step(state, torch.log_softmax(logits, dim=-1), t,
                                b, nb, pad_id, eos_id)
        k_self, v_self = k_self[:, sel], v_self[:, sel]
        if bool(state[3].all()):
            break
    return _beam_best(state, b, nb, length_penalty)
