"""One axis of ``jax.image.resize(..., 'bicubic')`` as a weight matrix.

Used by ``ops/image_ops.py`` (device-side preprocessing) and
``runtime/weights.py::interpolate_pos_embed`` (the ViT position
embedding's resize).
"""
from __future__ import annotations

import numpy as np


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s
    'bicubic'; torch's bicubic takes a = -0.75)."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float64 weights of ``jax.image.resize(..., 'bicubic')``
    along one axis (``jax._src.image.scale.compute_weight_mat``): half-pixel
    centres, the kernel widened by the scale when shrinking (antialias),
    each output's weights over the input normalized to sum 1 (so the
    border renormalizes rather than clamps)."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in)[:, None]) \
        / max(inv_scale, 1.0)
    w = _keys_cubic(dist)                                  # [n_in, n_out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T
