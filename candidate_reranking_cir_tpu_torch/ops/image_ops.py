"""Device-side image preprocessing (port of the JAX package's
``ops/image_ops.py``).

The PIL path (``data/preprocessing.py``) stays the pixel-parity reference.
This module runs the same TargetPad -> resize -> center-crop ->
CLIP-normalize pipeline on uint8 RGB tensors on any device, so that a
loader could send uint8 pixels to the card (a quarter of the fp32 bytes)
and leave only the decode on the host. Like the JAX package's, these are
library functions: no path of the package calls them.

The resize is ``jax.image.resize(..., 'bicubic')``, not
``torch.nn.functional.interpolate``'s bicubic (a = -0.75 without
antialias, PIL's weights with it): Keys' cubic kernel with a = -0.5,
half-pixel centres, antialiased when it shrinks (the kernel widened by the
scale), each output's weights renormalized to sum 1 at the border
(``ops/resize.py``'s ``resize_matrix``, which
``runtime/weights.py::interpolate_pos_embed`` uses too). The matrices are
built once per source shape on the host and applied on the device as two
fp32 products, H then W.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    CLIP_MEAN,
    CLIP_STD,
)
from candidate_reranking_cir_tpu_torch.ops.resize import resize_matrix


def _target_pad_amounts(h: int, w: int, target_ratio: float):
    """(vertical, horizontal) zero padding of each side, as the host's
    ``target_pad`` computes it from the static shape; None below the
    ratio."""
    if max(w, h) / min(w, h) < target_ratio:
        return None
    scaled_max_wh = max(w, h) / target_ratio
    return (max(int((scaled_max_wh - h) / 2), 0),
            max(int((scaled_max_wh - w) / 2), 0))


def pad_to_target_ratio(image: torch.Tensor,
                        target_ratio: float) -> torch.Tensor:
    """[H, W, 3] (or [B, H, W, 3]) uint8 -> zero-padded so that its aspect
    ratio is at most ``target_ratio`` (data_utils.py:45-68); unchanged
    below it."""
    h, w = image.shape[-3:-1]
    pads = _target_pad_amounts(h, w, target_ratio)
    if pads is None:
        return image
    vp, hp = pads
    return F.pad(image, (0, 0, hp, hp, vp, vp))


def _crop_size(h: int, w: int, dim: int) -> tuple[int, int]:
    """The short side resized to ``dim`` (torchvision's Resize(int))."""
    if w <= h:
        return max(int(round(h * dim / w)), dim), dim
    return dim, max(int(round(w * dim / h)), dim)


@functools.lru_cache(maxsize=64)
def _crop_matrices(h: int, w: int, dim: int) -> tuple[np.ndarray, ...]:
    """The fp32 weights of the resize along H and W, restricted to the
    rows and columns the centre crop keeps: [dim, H] and [dim, W], built
    once per source shape (as JAX traces once per shape)."""
    new_h, new_w = _crop_size(h, w, dim)
    top = int(round((new_h - dim) / 2.0))
    left = int(round((new_w - dim) / 2.0))
    return (resize_matrix(h, new_h)[top:top + dim].astype(np.float32),
            resize_matrix(w, new_w)[left:left + dim].astype(np.float32))


def resize_and_crop(images: torch.Tensor, dim: int) -> torch.Tensor:
    """[.., H, W, 3] -> fp32 [.., dim, dim, 3]: the short side resized to
    ``dim`` (bicubic, as ``jax.image.resize``), then the centre crop."""
    h, w = images.shape[-3:-1]
    rows, cols = (torch.from_numpy(m).to(images.device)
                  for m in _crop_matrices(h, w, dim))
    # two plain products, each one large GEMM: H against [.., H, W*C],
    # then W against [.., dim, C, W] (channels folded into the rows, not
    # left as a 3-wide free axis)
    x = torch.matmul(rows, images.to(torch.float32).flatten(-2))
    x = x.unflatten(-1, (w, images.shape[-1])).transpose(-1, -2)
    return torch.matmul(x, cols.T).transpose(-1, -2).contiguous()


def normalize_clip(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] fp32 [.., 3] -> CLIP mean/std normalized."""
    mean = torch.as_tensor(CLIP_MEAN, device=images01.device)
    std = torch.as_tensor(CLIP_STD, device=images01.device)
    return (images01 - mean) / std


def preprocess_image(image: torch.Tensor, dim: int = 384,
                     target_ratio: float = 1.25) -> torch.Tensor:
    """The whole single-image pipeline: uint8 [H, W, 3] -> normalized fp32
    [dim, dim, 3] on the image's device."""
    img = pad_to_target_ratio(image, target_ratio)
    return normalize_clip(resize_and_crop(img, dim) / 255.0)


def preprocess_batch_uniform(images: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, H, W, 3] uint8 batch of same-size images (already padded on the
    host) -> normalized fp32 [B, dim, dim, 3] on the batch's device."""
    return normalize_clip(resize_and_crop(images, dim) / 255.0)
