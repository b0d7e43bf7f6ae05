"""Device-side preprocessing of the port (``ops/image_ops.py``) against
the JAX package's (``ops/image_ops.py``) and against the PIL path.

Tolerances: the padding bit for bit; the normalized pixels 1e-4 of the
JAX pipeline (both resize in fp32 with the same bicubic weights, summed
in another order); against PIL, tests/test_image_ops.py's bound (mean
|difference| below 0.12 in normalized units on smooth content: the two
bicubics differ in kernel details).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from candidate_reranking_cir_tpu.ops import image_ops as jops
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    make_transform,
    target_pad,
)
from candidate_reranking_cir_tpu_torch.ops import image_ops as tops

TOL = 1e-4
# (H, W): portrait and landscape, padded and not, shrinking and growing
# to 32
SHAPES = [(60, 48), (48, 60), (40, 100), (100, 40), (20, 30), (30, 20),
          (33, 33), (77, 45)]


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


def _smooth(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.stack([yy, xx, yy + xx], -1) % 255).astype(np.float32)
    return (0.8 * base + 10).astype(np.uint8)


@pytest.mark.parametrize("h,w", SHAPES)
def test_pad_to_target_ratio_equals_jax_and_the_host(h, w):
    import PIL.Image

    arr = _image(0, h, w)
    out = tops.pad_to_target_ratio(torch.from_numpy(arr), 1.25).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(jops.pad_to_target_ratio(jnp.asarray(arr), 1.25)))
    host = np.asarray(target_pad(PIL.Image.fromarray(arr), 1.25))
    np.testing.assert_array_equal(out, host)


def test_normalize_clip_matches_jax():
    x = np.random.default_rng(1).random((4, 4, 3)).astype(np.float32)
    out = tops.normalize_clip(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jops.normalize_clip(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("dim", [32, 24])
def test_preprocess_image_matches_jax(h, w, dim):
    arr = _image(2, h, w)
    out = tops.preprocess_image(torch.from_numpy(arr), dim, 1.25)
    ref = np.asarray(jops.preprocess_image(jnp.asarray(arr), dim, 1.25))
    assert out.dtype == torch.float32 and out.shape == (dim, dim, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("h,w", [(60, 48), (40, 100), (20, 30)])
def test_preprocess_batch_uniform_matches_jax(h, w):
    arr = np.stack([_image(3 + i, h, w) for i in range(3)])
    out = tops.preprocess_batch_uniform(torch.from_numpy(arr), 32)
    ref = np.asarray(jops.preprocess_batch_uniform(jnp.asarray(arr), 32))
    assert out.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("h,w", [(60, 48), (48, 60), (40, 100), (20, 30)])
def test_device_pipeline_close_to_pil(h, w):
    import PIL.Image

    smooth = _smooth(h, w)
    out = tops.preprocess_image(torch.from_numpy(smooth), 32, 1.25).numpy()
    pil = make_transform("targetpad", 32, 1.25)(PIL.Image.fromarray(smooth))
    assert out.shape == pil.shape == (32, 32, 3)
    assert np.abs(out - pil).mean() < 0.12
