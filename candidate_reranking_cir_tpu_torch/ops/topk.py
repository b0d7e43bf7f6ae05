"""Top-K retrieval primitives (port of the JAX package's ``ops/topk.py``).

Distances are 1 - pred @ index.T as float32 products (TF32 is off, see
``runtime/device.py``); an index of several vectors an item ([N, T, E]:
BLIP-2's 32 query outputs an image) scores each item by its best vector.
Rankings are stable: equal distances keep corpus order, as the JAX
package's stable argsort and ``lax.top_k`` do.
``sharded_cosine_topk`` ranks a corpus whose rows are split over a mesh:
each rank's top-k, then a top-k over the all-gathered candidates.
"""
from __future__ import annotations

import torch

from candidate_reranking_cir_tpu_torch.parallel.mesh import all_gather


# the most [rows, N * T] float32 scores a block of a multi-vector index's
# products holds before the max over T (64 MB)
MULTI_BLOCK_SCORES = 1 << 24


def cosine_scores(pred: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[Q, E] x [N, E] -> [Q, N] similarity, float32. An index [N, T, E]
    scores an item by its best vector, max_t <pred, index[n, t]> (LAVIS's
    ``sim_t2q.max(-1)``), in blocks of query rows, so that [Q, N, T] is
    never held whole."""
    if index.ndim == 2:
        return pred.float() @ index.float().T
    n, t, e = index.shape
    flat = index.float().reshape(n * t, e).T
    out = torch.empty((pred.shape[0], n), dtype=torch.float32,
                      device=pred.device)
    rows = max(1, MULTI_BLOCK_SCORES // (n * t))
    for i in range(0, pred.shape[0], rows):
        out[i:i + rows] = torch.amax(
            (pred[i:i + rows].float() @ flat).view(-1, n, t), dim=-1)
    return out


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


def sharded_cosine_topk(pred: torch.Tensor, index_shard: torch.Tensor,
                        k: int, mesh, shard_offset: int | None = None):
    """Top-k over a corpus split over ``mesh`` in contiguous row blocks:
    each rank ranks its block ``index_shard`` (whose first row is global
    row ``shard_offset``, default rank x block length), then the ranks'
    candidates are all-gathered and ranked again: an O(k x ranks) merge,
    not a global sort. Every rank returns the same (scores [Q, k], global
    indices [Q, k]). Ties fall as ``lax.top_k`` breaks them over the
    gathered list, at the lowest position: shard order, which is the
    global index order."""
    if shard_offset is None:
        shard_offset = mesh.rank * index_shard.shape[0]
    sims, local_idx = cosine_topk(pred, index_shard, k)
    all_sims = all_gather(mesh, sims, dim=-1)
    all_idx = all_gather(mesh, local_idx + shard_offset, dim=-1)
    merged, pos = torch.sort(all_sims, dim=-1, descending=True, stable=True)
    return merged[:, :k], all_idx.gather(-1, pos[:, :k])
