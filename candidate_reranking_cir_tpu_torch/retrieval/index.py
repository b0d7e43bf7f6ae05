"""Corpus index building (port of the JAX package's ``retrieval/index.py``
with a float bank).

Raw token features are stored in bfloat16 by default, as in the JAX
package; the bank, and the pooled features where asked for, stay on the
device that embedded them. Over a mesh every rank embeds its rows of each
image batch and the bank is replicated, or with ``shard_index`` split over
the ranks in contiguous row blocks (the layout of corpora beyond one
card's memory, which ``rerank_candidate_major(index_sharded=True)``
reads).
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.parallel import mesh as pmesh
from candidate_reranking_cir_tpu_torch.runtime import tracing
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


def iter_batches(dataset, batch_size: int
                 ) -> Iterable[tuple[list[str], np.ndarray]]:
    """Yield (names, [B, H, W, 3] float32) batches from a 'classic' dataset
    (rows a skip_errors dataset dropped, returned as None, are skipped).

    Fast path: when the dataset's transform has ``batch_from_paths`` (the
    native pipeline's thread-pool decode, ``data/native_pipe.py``) and
    errors raise (the default policy), a whole batch decodes and
    preprocesses in one native call that releases the GIL, with no
    ``np.stack``."""
    batch_fn = getattr(getattr(dataset, "transform", None),
                       "batch_from_paths", None)
    if (batch_fn is not None and getattr(dataset, "mode", "") == "classic"
            and not getattr(dataset, "skip_errors", False)):
        all_names = dataset.index_names
        for start in range(0, len(all_names), batch_size):
            chunk = all_names[start:start + batch_size]
            yield chunk, batch_fn([dataset.image_path(nm) for nm in chunk])
        return
    names, images = [], []
    for i in range(len(dataset)):
        sample = dataset[i]
        if sample is None:
            continue
        names.append(sample["name"])
        images.append(sample["image"])
        if len(names) == batch_size:
            yield names, np.stack(images)
            names, images = [], []
    if names:
        yield names, np.stack(images)


def _embed_batch(embed_fn, images, device, pooled: bool, shard_mesh,
                 batch_size: int):
    """``embed_fn`` over one batch: (raw, pooled or None) on ``device``.
    Under ``shard_mesh`` the batch is padded to ``batch_size``, each rank
    embeds its rows, and the rows are gathered and the padding cut; ranks
    outside a shrunk ``shard_mesh`` receive them."""
    valid = len(images)
    if shard_mesh is not None and not shard_mesh.member:
        return pmesh.share(shard_mesh)
    if shard_mesh is not None:
        if valid < batch_size:
            images = np.concatenate([images, np.zeros(
                (batch_size - valid, *images.shape[1:]), images.dtype)])
        images = images[pmesh.shard_rows(shard_mesh, batch_size)]
    with tracing.trace_phase("index.upload"):
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        x = x.to(device)
    out = embed_fn(x)
    raw, pool = out if pooled else (out, None)
    if shard_mesh is not None:
        raw = pmesh.all_gather(shard_mesh, raw)[:valid]
        if pool is not None:
            pool = pmesh.all_gather(shard_mesh, pool)[:valid]
    return pmesh.share(shard_mesh, (raw, pool))


@torch.inference_mode()
def build_index(dataset, embed_fn: Callable, batch_size: int = 32, *,
                feature_dtype=torch.bfloat16, device=None,
                pooled: bool = False, keep_raw: bool = True, mesh=None,
                shard_index: bool = False):
    """Embed the whole corpus with ``embed_fn`` ([B, H, W, 3] tensor on
    ``device`` -> raw [B, M, D], or (raw, pooled [B, E]) with ``pooled``).

    Returns (bank [N, M, D] feature_dtype on ``device``, names); with
    ``pooled``, (bank, pooled [N, E] fp32 on ``device``, names), the bank
    None when not ``keep_raw`` (the stage-I trainer's target-feature cache
    never holds the [N, M, D] token bank). The flags are the JAX
    function's; without ``pooled`` the bank must be kept.

    mesh: every rank embeds its rows of each batch (``fit_mesh(mesh,
    batch_size)``: a batch the mesh does not divide runs on its first
    ranks, and the others receive the result) and gets the whole bank, on
    the mesh's device. shard_index (with a mesh): the bank is padded with
    zero rows to a multiple of the mesh size and each rank keeps its
    contiguous block of N_pad / size rows, redistributed batch by batch
    (a batch's gathered rows, then this rank's share of them), so the
    whole bank never sits on one rank; ``pooled`` stays whole. Sharding
    needs every sample of ``dataset`` (no ``skip_errors`` drops).

    Each batch's assembly and its copy to ``device`` are the phase spans
    'index.load' and 'index.upload' (``runtime/tracing``); a copy from
    pageable memory first waits for the device's queued work."""
    if not (pooled or keep_raw):
        raise ValueError("build_index with neither pooled nor keep_raw "
                         "returns nothing")
    device = resolve_device(device) if mesh is None else mesh.device
    shard_mesh = pmesh.fit_mesh(mesh, batch_size)
    block = None
    if mesh is not None and shard_index:
        block = -(-len(dataset) // mesh.size)
        lo = mesh.rank * block
    chunks, pooled_chunks, names_all = [], [], []
    batches = iter_batches(dataset, batch_size)
    while True:
        with tracing.trace_phase("index.load"):
            batch = next(batches, None)
        if batch is None:
            break
        names, images = batch
        raw, pool = _embed_batch(embed_fn, images, device, pooled,
                                 shard_mesh, batch_size)
        if pooled:
            pooled_chunks.append(pool.float())
        if keep_raw:
            if block is not None:  # this rank's rows of the batch
                start = len(names_all)
                raw = raw[max(lo - start, 0):max(lo + block - start, 0)]
            chunks.append(raw.to(feature_dtype))
        names_all.extend(names)
    bank = torch.cat(chunks) if keep_raw else None
    if block is not None and keep_raw:
        if len(names_all) != len(dataset):
            raise ValueError("shard_index needs every corpus sample; "
                             f"{len(dataset) - len(names_all)} were dropped")
        if len(bank) < block:  # the padding rows of the last blocks
            bank = torch.cat([bank, bank.new_zeros(
                (block - len(bank), *bank.shape[1:]))])
    if pooled:
        return bank, torch.cat(pooled_chunks), names_all
    return bank, names_all
