"""Contrastive losses (port of the JAX package's
``parallel/contrastive.py``).

The global-batch contrast: each rank's local queries are contrasted
against the target features of the whole global batch, all-gathered over
the mesh with a gradient (``parallel/mesh.py::gather_with_grad``); the
softmax normalizes over the global batch. Without a mesh it is the
reference's in-batch B x B contrast.
"""
from __future__ import annotations

import torch

from candidate_reranking_cir_tpu_torch.parallel.mesh import gather_with_grad


def global_contrastive_loss(predicted, targets, temp, mesh=None):
    """predicted [B_loc, E] and targets [B_loc, E] (normalized), temp a
    scalar. Returns (the mean CE over the local rows, [B_loc, B_glob] fp32
    logits). Row i's positive is the i-th target of the same rank's block:
    global index rank * B_loc + i. ``mesh`` None is JAX's
    ``axis_name=None`` case."""
    predicted, targets = predicted.float(), targets.float()
    if mesh is not None:
        all_targets, rank = gather_with_grad(mesh, targets), mesh.rank
    else:
        all_targets, rank = targets, 0
    logits = torch.einsum("be,ne->bn", predicted, all_targets) / temp
    b_loc = predicted.shape[0]
    labels = rank * b_loc + torch.arange(b_loc, device=logits.device)
    return cross_entropy_rows(logits, labels), logits


def cross_entropy_rows(logits, labels):
    """Row-wise cross-entropy over fp32 logits, the mean over rows (stage-II
    B x B loss, reference stage2_train.py:466-472)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()
