"""Corpus index building on one device (port of the JAX package's
``retrieval/index.py`` with a float bank).

Raw token features are stored in bfloat16 by default, as in the JAX
package; the bank stays on the device that embedded it.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


def iter_batches(dataset, batch_size: int
                 ) -> Iterable[tuple[list[str], np.ndarray]]:
    """Yield (names, [B, H, W, 3] float32) batches from a 'classic' dataset
    (rows a skip_errors dataset dropped, returned as None, are skipped)."""
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
                feature_dtype=torch.bfloat16, device=None):
    """Embed the whole corpus with ``embed_fn`` ([B, H, W, 3] tensor on
    ``device`` -> raw [B, M, D]). Returns (bank [N, M, D] feature_dtype on
    ``device``, names)."""
    device = resolve_device(device)
    chunks, names_all = [], []
    for names, images in iter_batches(dataset, batch_size):
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        chunks.append(embed_fn(x.to(device)).to(feature_dtype))
        names_all.extend(names)
    return torch.cat(chunks), names_all
