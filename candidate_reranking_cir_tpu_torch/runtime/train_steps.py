"""Train steps for stage I and stage II (port of the JAX package's
``runtime/train_steps.py``).

Stage I (``stage1_loss``, ``make_stage1_train_step``): the ViT embeds the
reference images (frozen: at eval, without gradients, in chunks of
``_VIT_CHUNK``), the MED fuses them with the captions into the
normalized prediction, and the loss is the row-wise cross-entropy of the
in-batch [B, B] contrastive logits pred @ targets^T / temp against the
diagonal. The targets are cached pooled features (``target_pooled``), or
embedded in the step.

Stage II (``stage2_loss``, ``make_stage2_train_step``), one step of the
reference pipeline (stage2_train.py:440-479): the stage-II ViT embeds the
reference and target images and the frozen stage-I MED fuses the
reference features with the caption into z_t, both at eval and without
gradients (unless ``finetune_vit``); then the dual encoder scores the
B x B pair grid, the loss is the row-wise cross-entropy against the
diagonal, and one backward and one optimizer step follow.

Randomness is explicit: ``step(batch, generator)`` draws, before any layer
runs, the int32 seed tables of the step from ``generator`` (where the JAX
package folds the step count into its dropout key). Kernel dropout sites
take their seeds from the tables; every other dropout comes from a device
generator that its layer seeds from them.
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


def _to_device(batch: dict, device) -> dict:
    keys = ("ref_images", "target_images", "target_pooled", "input_ids",
            "attention_mask")
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in keys if k in batch}


# ---------------------------------------------------------------------------
# Stage I

_VIT_CHUNK = 32  # the JAX package's frozen-embed chunk (its throughput peak
                 # on the TPU); here it bounds the frozen ViT's activations


def _frozen_embed(model, images, *, pooled: bool):
    """Eval-mode ViT embed without gradients, in chunks of ``_VIT_CHUNK``
    when the batch is a larger multiple of it (one call otherwise). Returns
    raw [B, M, D], or (raw, pooled [B, E]) when ``pooled``."""
    def one(x):
        return model.embed_images(x, pool_and_normalize=pooled)

    b = images.shape[0]
    with torch.no_grad():
        if b <= _VIT_CHUNK or b % _VIT_CHUNK:
            return one(images)
        outs = [one(x) for x in images.split(_VIT_CHUNK)]
    if pooled:
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def stage1_loss(model, batch, seeds=None, *, finetune_vit: bool,
                train: bool = True):
    """batch: ref_images [B, H, W, 3]; input_ids, attention_mask [B, L];
    and either target_images [B, H, W, 3] or target_pooled [B, E]
    (precomputed normalized target features: valid with a frozen ViT,
    whose features do not change). ``seeds`` (when ``train``):
    {"text": the MED's seed table, "vit": the ViT's, with
    ``finetune_vit``}; the reference and target embeds share the ViT's,
    as the JAX package passes both the same rngs. Returns (loss,
    logits [B, B])."""
    if "target_pooled" in batch:
        if finetune_vit and train:
            raise ValueError("cached target features require a frozen ViT")
        tgt_pooled = batch["target_pooled"].detach()
        ref_feats = _frozen_embed(model, batch["ref_images"], pooled=False)
    elif finetune_vit and train:
        ref_feats = model.embed_images(batch["ref_images"],
                                       deterministic=False,
                                       seeds=seeds["vit"])
        _, tgt_pooled = model.embed_images(
            batch["target_images"], pool_and_normalize=True,
            deterministic=False, seeds=seeds["vit"])
    else:
        # frozen ViT: eval mode, no gradient (stage1_train.py:396-403)
        ref_feats = _frozen_embed(model, batch["ref_images"], pooled=False)
        _, tgt_pooled = _frozen_embed(model, batch["target_images"],
                                      pooled=True)
    pred = model.fuse(ref_feats, batch["input_ids"], batch["attention_mask"],
                      deterministic=not train,
                      seeds=seeds["text"] if train else None)
    logits = model.contrastive_logits(pred, tgt_pooled)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return cross_entropy_rows(logits, labels), logits


def make_stage1_train_step(model, optimizer, *, finetune_vit: bool = False):
    """``step(batch, generator) -> loss`` (a 0-dim tensor on the device).

    batch: as ``stage1_loss`` takes it (arrays or tensors, moved to the
    model's device). ``optimizer``: the ``runtime.optim.AdamW`` over the
    model's trainable parameters (``visual_encoder`` frozen unless
    ``finetune_vit``)."""
    device = next(model.parameters()).device

    def step(batch, generator: torch.Generator):
        b = _to_device(batch, device)
        seeds = {"text": draw_seeds(generator, model.text_encoder.seed_shape)}
        if finetune_vit:
            seeds["vit"] = draw_seeds(generator,
                                      model.visual_encoder.seed_shape)
        loss, _ = stage1_loss(model, b, seeds, finetune_vit=finetune_vit)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# Stage II

def stage2_loss(reranker, z_t, tgt_feats, batch, seeds):
    """Row-wise CE of the [B, B] pair-grid logits against the diagonal.
    Returns (loss, logits)."""
    logits = reranker.score_shared(z_t, batch["input_ids"],
                                   batch["attention_mask"], tgt_feats,
                                   deterministic=False, seeds=seeds)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return cross_entropy_rows(logits, labels), logits


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
