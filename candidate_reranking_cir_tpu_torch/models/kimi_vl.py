"""Kimi-VL-A3B-Instruct as a point-wise stage-II re-ranker (Kimi-VL
technical report, arXiv:2504.07491): a judge that reads (reference image,
modification text, candidate image) and scores the candidate, re-sorting
the stage-I top-K as the dual encoder does, as LamRA's re-ranker uses a
large multimodal model.

- The bank: each corpus image through MoonViT and the projector
  (``models/moonvit.py``): 196 LM tokens of 2,048 an image
  (``embed_images``; ``retrieval/index.build_index`` keeps them).
- A query's prefix: ``[template 3][media start 3][196 reference tokens]
  [media end 1][caption words]``, 206-233 tokens, one causal pass
  (``prefix``) that keeps every layer's MLA latent, 576 values a token.
- A candidate's suffix: ``[media start 3][196 candidate tokens][media end
  1][question 12][assistant start 4]``, 216 tokens at positions that
  continue its query's prefix; every suffix of a query sees that prefix's
  real tokens (never its padding, never another candidate) and its own
  tokens causally (``score``). Its score: logit(yes) - logit(no) at its last
  position, from those two rows of the head alone (exact), in float32.

Captions come from the port's tokenizer as [CLS] words [SEP]; the words'
ids are used as the LM's ids (``caption_ids``). The template, question
and answer ids are ``config.RerankTemplate``'s.

The engine reads ``prefix_scorer`` (True here, False on the dual encoder)
and runs ``retrieval/rerank.rerank_prefixed`` in place of the z_t and
pair scorers; no stage-I model takes part. Parameters are held in the
compute dtype, one copy on the card. Eval only.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import KimiVLRerankerConfig
from candidate_reranking_cir_tpu_torch.models.kimi_lm import KimiLM
from candidate_reranking_cir_tpu_torch.models.moonvit import MoonViT, Projector
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


class PrefixCache:
    """A chunk's prefix: each layer's latent [Q, Lp, 576] and the prefixes'
    real lengths [Q] (on the device)."""

    def __init__(self, latents: list, lengths):
        self.latents, self.lengths = latents, lengths


class KimiVLReranker(nn.Module):
    """Built on ``device`` (default 'cuda'; raises without a card unless
    device='cpu'), its parameters held in ``dtype``."""

    # read by the stage-II engine: a prefix pass a query, then its
    # candidates' suffixes, in place of z_t and the pair scorers
    prefix_scorer = True

    def __init__(self, cfg: KimiVLRerankerConfig, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        self.vision = MoonViT(cfg.vision, dtype, device, param_dtype=dtype)
        self.projector = Projector(cfg.vision, cfg.lm.hidden_size, dtype,
                                   device, param_dtype=dtype)
        self.lm = KimiLM(cfg.lm, dtype, device, param_dtype=dtype)
        t = cfg.template
        self.suffix_head = list(t.media_start_ids)
        self.suffix_tail = [*t.media_end_ids, *t.question_ids,
                            *t.assistant_ids]
        self.image_tokens = (cfg.vision.grid // cfg.vision.merge) ** 2

    def embed_images(self, images):
        """[B, H, W, 3] -> the LM's image tokens [B, 196, 2,048]."""
        return self.projector(self.vision(images))

    @staticmethod
    def caption_ids(tokenizer, captions: list[str], text_len: int) -> list:
        """Each caption's word ids (the tokenizer's [CLS] and [SEP] dropped),
        at most ``text_len`` - 2."""
        ids, mask = tokenizer.encode(captions, text_len)
        return [row[1:n - 1] for row, n in zip(ids, mask.sum(axis=1))]

    def _embed(self, ids: np.ndarray, tokens, at: int):
        """Embeddings of the id rows [B, L], ``tokens`` [B, M, D] put at
        positions at..at+M (their ids are placeholders)."""
        dev = tokens.device
        x = self.lm.embed(torch.from_numpy(ids).to(dev))
        x[:, at:at + tokens.shape[1]] = tokens.to(x.dtype)
        return x

    def prefix(self, ref_tokens, caption_ids: list) -> PrefixCache:
        """The causal pass over Q prefixes, right-padded: ref_tokens [Q, 196,
        D], caption_ids one id array a query."""
        t = self.cfg.template
        head = [*t.template_ids, *t.media_start_ids]
        tail = list(t.media_end_ids)
        at = len(head)
        lengths = [at + self.image_tokens + len(tail) + len(c)
                   for c in caption_ids]
        ids = np.zeros((len(caption_ids), max(lengths)), np.int64)
        for row, cap in zip(ids, caption_ids):
            row[:at] = head
            row[at + self.image_tokens:][:len(tail) + len(cap)] = [*tail,
                                                                  *cap]
        x = self._embed(ids, ref_tokens, at)
        return PrefixCache(self.lm.prefix_latents(x),
                           torch.tensor(lengths, device=x.device))

    def score(self, cache: PrefixCache, cand_tokens):
        """logit(yes) - logit(no) [Q, C] float32 of each query's C candidates
        cand_tokens [Q, C, 196, D], after the prefixes of ``cache``."""
        q, c = cand_tokens.shape[:2]
        t = self.cfg.template
        row = [*self.suffix_head, *([0] * self.image_tokens),
               *self.suffix_tail]
        ids = np.tile(np.asarray(row, np.int64), (q * c, 1))
        x = self._embed(ids, cand_tokens.flatten(0, 1), len(self.suffix_head))
        positions = cache.lengths.repeat_interleave(c)[:, None] \
            + torch.arange(len(row), device=x.device)[None]
        last = self.lm.suffix_last(x, positions, cache.latents,
                                   cache.lengths, c)
        # the two head rows in float32: a difference of two logits is read
        head = self.lm.lm_head.weight[[t.yes_id, t.no_id]].float()
        logits = torch.nn.functional.linear(last.float(), head)
        return (logits[:, 0] - logits[:, 1]).view(q, c)
