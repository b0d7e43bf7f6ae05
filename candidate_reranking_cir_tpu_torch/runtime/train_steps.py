"""Stage-II train step (port of the JAX package's ``runtime/train_steps.py``,
``stage2_loss`` and ``make_stage2_train_step``).

One step of the reference pipeline (stage2_train.py:440-479): the stage-II
ViT embeds the reference and target images and the frozen stage-I MED fuses
the reference features with the caption into z_t, both at eval and without
gradients (unless ``finetune_vit``); then the dual encoder scores the B x B
pair grid, the loss is the row-wise cross-entropy against the diagonal,
and one backward and one optimizer step follow.

Randomness is explicit: ``step(batch, generator)`` draws, before any layer
runs, one int32 seed table for the whole step from ``generator`` (where the
JAX package folds the step count into its dropout key). Kernel dropout
sites take their seeds from the table; every other dropout comes from a
device generator that its layer seeds from the table.
"""
from __future__ import annotations

import torch

from candidate_reranking_cir_tpu_torch.parallel.contrastive import (
    cross_entropy_rows,
)

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def draw_seeds(generator: torch.Generator,
               shape: tuple[int, int]) -> list[list[int]]:
    """An int32 seed table of ``shape`` drawn from ``generator``."""
    table = torch.randint(INT32_MIN, INT32_MAX + 1, shape,
                          generator=generator, dtype=torch.int64,
                          device=generator.device)
    return table.tolist()


def stage2_loss(reranker, z_t, tgt_feats, batch, seeds):
    """Row-wise CE of the [B, B] pair-grid logits against the diagonal.
    Returns (loss, logits)."""
    logits = reranker.score_shared(z_t, batch["input_ids"],
                                   batch["attention_mask"], tgt_feats,
                                   deterministic=False, seeds=seeds)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return cross_entropy_rows(logits, labels), logits


def _to_device(batch: dict, device) -> dict:
    keys = ("ref_images", "target_images", "input_ids", "attention_mask")
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in keys}


def make_stage2_train_step(stage1, reranker, optimizer, *,
                           finetune_vit: bool = False):
    """``step(batch, generator) -> loss`` (a 0-dim tensor on the device).

    batch: ref_images, target_images [B, H, W, 3] float32; input_ids,
    attention_mask [B, L] (arrays or tensors, moved to the model's device).
    ``optimizer``: the ``runtime.optim.AdamW`` over the reranker's
    trainable parameters. Gradients reach only the dual encoder and the
    cls head unless ``finetune_vit``."""
    device = next(reranker.parameters()).device

    def step(batch, generator: torch.Generator):
        b = _to_device(batch, device)
        text_seeds = draw_seeds(generator, reranker.text_encoder.seed_shape)
        if finetune_vit:
            vit_seeds = draw_seeds(generator,
                                   reranker.visual_encoder.seed_shape)
            ref_feats = reranker.embed_images(
                b["ref_images"], deterministic=False, seeds=vit_seeds)
            tgt_feats = reranker.embed_images(
                b["target_images"], deterministic=False, seeds=vit_seeds)
        else:
            with torch.no_grad():
                ref_feats = reranker.embed_images(b["ref_images"])
                tgt_feats = reranker.embed_images(b["target_images"])
        with torch.no_grad():
            z_t = stage1.fuse(ref_feats.detach(), b["input_ids"],
                              b["attention_mask"], return_raw=True)
        loss, _ = stage2_loss(reranker, z_t, tgt_feats, b, text_seeds)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
