"""Host-side image preprocessing (PIL decode path).

Pipeline parity with the reference transforms (data_utils.py:23-101):
TargetPad(ratio)/SquarePad -> Resize(short side = dim, bicubic) ->
CenterCrop(dim) -> RGB -> scale to [0,1] -> CLIP mean/std normalization.

Output is channels-last float32 [H, W, 3] (the JAX package's layout, which
the port keeps at its public functions; the reference is NCHW). An own copy
of the JAX package's ``data/preprocessing.py``. PIL is imported lazily.
"""
from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _pil():
    import PIL.Image

    return PIL.Image


def square_pad(image, _dim=None):
    """Zero-pad to square (data_utils.py:23-42)."""
    w, h = image.size
    max_wh = max(w, h)
    hp = int((max_wh - w) / 2)
    vp = int((max_wh - h) / 2)
    return _pad(image, hp, vp)


def target_pad(image, target_ratio: float):
    """Pad only when the aspect ratio exceeds target_ratio, to reach it
    (data_utils.py:45-68)."""
    w, h = image.size
    if max(w, h) / min(w, h) < target_ratio:
        return image
    scaled_max_wh = max(w, h) / target_ratio
    hp = max(int((scaled_max_wh - w) / 2), 0)
    vp = max(int((scaled_max_wh - h) / 2), 0)
    return _pad(image, hp, vp)


def _pad(image, hp: int, vp: int):
    PILImage = _pil()
    if hp == 0 and vp == 0:
        return image
    w, h = image.size
    out = PILImage.new(image.mode, (w + 2 * hp, h + 2 * vp), 0)
    out.paste(image, (hp, vp))
    return out


def resize_short_side(image, dim: int):
    """torchvision Resize(int) semantics: short side -> dim, bicubic."""
    PILImage = _pil()
    w, h = image.size
    if w <= h:
        new_w, new_h = dim, max(int(round(h * dim / w)), dim)
    else:
        new_w, new_h = max(int(round(w * dim / h)), dim), dim
    return image.resize((new_w, new_h), PILImage.BICUBIC)


def center_crop(image, dim: int):
    w, h = image.size
    left = int(round((w - dim) / 2.0))
    top = int(round((h - dim) / 2.0))
    return image.crop((left, top, left + dim, top + dim))


def normalize(array01: np.ndarray) -> np.ndarray:
    return (array01 - CLIP_MEAN) / CLIP_STD


def make_transform(kind: str = "targetpad", dim: int = 384,
                   target_ratio: float = 1.25):
    """Returns PIL.Image -> float32 [dim, dim, 3] callable."""

    def transform(image):
        if kind == "targetpad":
            img = target_pad(image, target_ratio)
        elif kind == "squarepad":
            img = square_pad(image)
        else:
            raise ValueError(f"unknown transform {kind!r}")
        img = resize_short_side(img, dim)
        img = center_crop(img, dim)
        img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return normalize(arr)

    return transform


def load_image(path) -> "object":
    PILImage = _pil()
    return PILImage.open(path)
