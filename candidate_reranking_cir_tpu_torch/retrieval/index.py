"""Corpus index building on one device (port of the JAX package's
``retrieval/index.py`` with a float bank).

Raw token features are stored in bfloat16 by default, as in the JAX
package; the bank, and the pooled features where asked for, stay on the
device that embedded them.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

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


@torch.inference_mode()
def build_index(dataset, embed_fn: Callable, batch_size: int = 32, *,
                feature_dtype=torch.bfloat16, device=None,
                pooled: bool = False, keep_raw: bool = True):
    """Embed the whole corpus with ``embed_fn`` ([B, H, W, 3] tensor on
    ``device`` -> raw [B, M, D], or (raw, pooled [B, E]) with ``pooled``).

    Returns (bank [N, M, D] feature_dtype on ``device``, names); with
    ``pooled``, (bank, pooled [N, E] fp32 on ``device``, names), the bank
    None when not ``keep_raw`` (the stage-I trainer's target-feature cache
    never holds the [N, M, D] token bank). The flags are the JAX
    function's; without ``pooled`` the bank must be kept."""
    if not (pooled or keep_raw):
        raise ValueError("build_index with neither pooled nor keep_raw "
                         "returns nothing")
    device = resolve_device(device)
    chunks, pooled_chunks, names_all = [], [], []
    for names, images in iter_batches(dataset, batch_size):
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        out = embed_fn(x.to(device))
        if pooled:
            out, pool = out
            pooled_chunks.append(pool.float())
        if keep_raw:
            chunks.append(out.to(feature_dtype))
        names_all.extend(names)
    bank = torch.cat(chunks) if keep_raw else None
    if pooled:
        return bank, torch.cat(pooled_chunks), names_all
    return bank, names_all
