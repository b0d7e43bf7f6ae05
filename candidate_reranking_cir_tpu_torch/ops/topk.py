"""Top-K retrieval primitives (port of the JAX package's ``ops/topk.py``).

Distances are 1 - pred @ index.T as float32 products (TF32 is off, see
``runtime/device.py``). Rankings are stable: equal distances keep corpus
order, as the JAX package's stable argsort and ``lax.top_k`` do. The
per-shard merge over a mesh (``sharded_cosine_topk``) is not ported.
"""
from __future__ import annotations

import torch


def cosine_scores(pred: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[Q, E] x [N, E] -> [Q, N] similarity, float32."""
    return pred.float() @ index.float().T


def cosine_rank(pred: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Full ascending-by-distance ranking [Q, N]; equal distances keep
    index order."""
    return torch.argsort(1.0 - cosine_scores(pred, index), dim=-1,
                         stable=True)


def cosine_topk(pred: torch.Tensor, index: torch.Tensor, k: int,
                valid: torch.Tensor | None = None):
    """Top-k by similarity: (scores [Q, k], indices [Q, k]); equal scores
    keep index order, as ``lax.top_k`` breaks ties by the lowest index
    (``torch.topk`` promises no order among equal values on the card).
    ``valid`` [N] bool: rows where it is False score -inf (a serving
    index's tombstoned and free slots), below every real candidate."""
    sims = cosine_scores(pred, index)
    if valid is not None:
        sims = sims.masked_fill(~valid[None, :], float("-inf"))
    scores, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]
