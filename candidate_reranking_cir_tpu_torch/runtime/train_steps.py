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

Over a mesh (``mesh``, ``parallel/mesh.py``) each rank takes its block of
the global batch (``shard_batch``) and the step returns the global loss:
- stage I: the in-batch contrast becomes ``global_contrastive_loss``,
  local queries against every rank's targets (gathered with a gradient);
- stage II: the candidates are sharded. Each rank embeds its block of
  reference and target images, fuses its queries' z_t and all-gathers
  z_t, ids and masks (no gradient); its dual encoder scores every query
  against its own candidates, [B, B_loc], and the columns are gathered
  with a gradient into the [B, B] grid, whose rows of the rank's queries
  make its loss. Sharding the candidates keeps each cross-attention
  kernel entry (one candidate) whole, so K6/K7 key their masks as on one
  card;
- each rank's loss is the mean over its rows and the optimizer averages
  the gradients over the ranks (``runtime/optim.AdamW``), which is the
  global mean's gradient;
- dropout draws are the global draws' blocks (``ops/draws.py``): a step
  at any world size gives the one-rank step's loss.

Randomness is explicit: ``step(batch, seed)`` draws, before any layer
runs, the int32 seed tables of the step from a generator seeded with the
run's ``seed`` and the optimizer's micro-step count (``step_generator``),
as the JAX package folds its step count into one constant dropout key. So
the tables are a pure function of (seed, micro-step), and a run resumed
from a checkpoint draws what the uninterrupted run draws. Kernel dropout
sites take their seeds from the tables; every other dropout comes from a
device generator that its layer seeds from them.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.ops.draws import sharded_draws
from candidate_reranking_cir_tpu_torch.parallel import mesh as pmesh
from candidate_reranking_cir_tpu_torch.parallel.contrastive import (
    cross_entropy_rows,
    global_contrastive_loss,
)

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def step_generator(seed: int, micro_step: int) -> torch.Generator:
    """The CPU generator of micro-step ``micro_step`` of a run seeded with
    ``seed`` (both >= 0): the two mixed by numpy's ``SeedSequence``."""
    mixed = np.random.SeedSequence([seed, micro_step]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(int(mixed[0]) << 32
                                         | int(mixed[1]))


def draw_seeds(generator: torch.Generator,
               shape: tuple[int, int]) -> list[list[int]]:
    """An int32 seed table of ``shape`` drawn from ``generator``."""
    table = torch.randint(INT32_MIN, INT32_MAX + 1, shape,
                          generator=generator, dtype=torch.int64,
                          device=generator.device)
    return table.tolist()


def rank_draws(mesh, rows: int, axis: int = 0, min_ndim: int = 0):
    """The draws of this rank's block of ``rows`` rows on ``axis`` of a
    batch split over ``mesh`` (``ops/draws.py``); one-card draws without
    a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return sharded_draws(axis, mesh.rank * rows, rows, mesh.size * rows,
                         min_ndim)


def global_loss(mesh, loss):
    """The mean of the ranks' losses (the loss itself without a mesh)."""
    loss = loss.detach()
    return loss if mesh is None else pmesh.all_reduce(mesh, loss.clone(),
                                                      "mean")


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
                train: bool = True, mesh=None):
    """batch: ref_images [B, H, W, 3]; input_ids, attention_mask [B, L];
    and either target_images [B, H, W, 3] or target_pooled [B, E]
    (precomputed normalized target features: valid with a frozen ViT,
    whose features do not change). ``seeds`` (when ``train``):
    {"text": the MED's seed table, "vit": the ViT's, with
    ``finetune_vit``}; the reference and target embeds share the ViT's,
    as the JAX package passes both the same rngs. ``mesh``: the batch is
    this rank's block and the contrast global (``global_contrastive_loss``).
    Returns (loss, logits [B, B_global])."""
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
    return global_contrastive_loss(pred, tgt_pooled, model.temp, mesh)


def make_stage1_train_step(model, optimizer, *, finetune_vit: bool = False,
                           mesh=None):
    """``step(batch, seed) -> loss`` (a 0-dim tensor on the device); the
    seed tables come from ``step_generator(seed, optimizer.micro_steps)``.

    batch: as ``stage1_loss`` takes it (arrays or tensors, moved to the
    model's device). ``optimizer``: the ``runtime.optim.AdamW`` over the
    model's trainable parameters (``visual_encoder`` frozen unless
    ``finetune_vit``), over the same ``mesh``. With a mesh, ``batch`` is
    this rank's block of the global batch and the loss returned is the
    global one."""
    device = next(model.parameters()).device

    def step(batch, seed: int):
        b = _to_device(batch, device)
        generator = step_generator(seed, optimizer.micro_steps)
        seeds = {"text": draw_seeds(generator, model.text_encoder.seed_shape)}
        if finetune_vit:
            seeds["vit"] = draw_seeds(generator,
                                      model.visual_encoder.seed_shape)
        with rank_draws(mesh, b["input_ids"].shape[0]):
            loss, _ = stage1_loss(model, b, seeds, finetune_vit=finetune_vit,
                                  mesh=mesh)
            optimizer.zero_grad()
            loss.backward()
        optimizer.step()
        return global_loss(mesh, loss)

    return step


# ---------------------------------------------------------------------------
# Stage II

def stage2_loss(reranker, z_t, tgt_feats, batch, seeds, mesh=None):
    """Row-wise CE of the [B, B] pair-grid logits against the diagonal.
    Returns (loss, logits). With ``mesh``: z_t and the batch's ids and
    mask hold every query, ``tgt_feats`` this rank's block of candidates;
    the [B, B_loc] scores are gathered into the grid, and the loss is the
    mean over this rank's queries' rows."""
    n_q = z_t.shape[0]
    with rank_draws(mesh, tgt_feats.shape[0], axis=1, min_ndim=4):
        logits = reranker.score_shared(z_t, batch["input_ids"],
                                       batch["attention_mask"], tgt_feats,
                                       deterministic=False, seeds=seeds)
    labels = torch.arange(n_q, device=logits.device)
    if mesh is None:
        return cross_entropy_rows(logits, labels), logits
    logits = pmesh.gather_with_grad(mesh, logits, dim=1)
    rows = pmesh.shard_rows(mesh, n_q)
    return cross_entropy_rows(logits[rows], labels[rows]), logits


def make_stage2_train_step(stage1, reranker, optimizer, *,
                           finetune_vit: bool = False, mesh=None):
    """``step(batch, seed) -> loss`` (a 0-dim tensor on the device); the
    seed tables come from ``step_generator(seed, optimizer.micro_steps)``.

    batch: ref_images, target_images [B, H, W, 3] float32; input_ids,
    attention_mask [B, L] (arrays or tensors, moved to the model's device).
    ``optimizer``: the ``runtime.optim.AdamW`` over the reranker's
    trainable parameters, over the same ``mesh``. Gradients reach only
    the dual encoder and the cls head unless ``finetune_vit``. With a
    mesh, ``batch`` is this rank's block of the global batch (its queries
    and its candidates) and the loss returned is the global one."""
    device = next(reranker.parameters()).device

    def step(batch, seed: int):
        b = _to_device(batch, device)
        generator = step_generator(seed, optimizer.micro_steps)
        text_seeds = draw_seeds(generator, reranker.text_encoder.seed_shape)
        with rank_draws(mesh, b["input_ids"].shape[0]):
            if finetune_vit:
                vit_seeds = draw_seeds(generator,
                                       reranker.visual_encoder.seed_shape)
                ref_feats = reranker.embed_images(
                    b["ref_images"], deterministic=False, seeds=vit_seeds)
                tgt_feats = reranker.embed_images(
                    b["target_images"], deterministic=False,
                    seeds=vit_seeds)
            else:
                with torch.no_grad():
                    ref_feats = reranker.embed_images(b["ref_images"])
                    tgt_feats = reranker.embed_images(b["target_images"])
            with torch.no_grad():
                z_t = stage1.fuse(ref_feats.detach(), b["input_ids"],
                                  b["attention_mask"], return_raw=True)
                if mesh is not None:
                    z_t, ids, mask = (pmesh.all_gather(mesh, x) for x in (
                        z_t, b["input_ids"], b["attention_mask"]))
                    b = {**b, "input_ids": ids, "attention_mask": mask}
            loss, _ = stage2_loss(reranker, z_t, tgt_feats, b, text_seeds,
                                  mesh)
            optimizer.zero_grad()
            loss.backward()
        optimizer.step()
        return global_loss(mesh, loss)

    return step
