"""Kernels K1-K4 of the port: the plain PyTorch version (what the wrappers
run on CPU tensors) against the Pallas kernel it replaces, run by the
Pallas interpreter. Tolerances follow tests/test_pallas_attention*.py:
fp32 atol 2e-5, bf16 atol 2e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu.ops import attention as jattn
from candidate_reranking_cir_tpu.ops.pallas_attention import (
    _fused_attention_folded_impl,
    _fused_attention_fwd_impl,
)
from candidate_reranking_cir_tpu_torch.ops import attention as tattn
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D = 64


def _qkv(seed, e, lq, m, h):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, lq, h, D)).astype(np.float32),
            rng.normal(size=(e, m, h, D)).astype(np.float32),
            rng.normal(size=(e, m, h, D)).astype(np.float32))


def _key_mask(seed, e, m):
    """1/0 key mask with padded tail keys (at least one valid key)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, m + 1, size=e)
    lens[0] = m - 3 if m > 3 else m
    return (np.arange(m)[None] < lens[:, None]).astype(np.int32)


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), t(x, td)


# shapes: (entries, Lq, M, heads); M not a multiple of 8, and Lq = 1
SHAPES = [(2, 17, 17, 2), (3, 1, 23, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,lq,m,h", SHAPES)
def test_k1_folded_plain_matches_pallas(dtype, e, lq, m, h):
    q, k, v = _qkv(0, e, lq, m, h)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x.reshape(e, -1, h * D), dtype)
                                    for x in (q, k, v))
    ref = _fused_attention_folded_impl(jq, jk, jv, None, h, interpret=True)
    out = ck.fused_attention_folded(tq, tk, tv, num_heads=h)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (e, lq, h * D)
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,lq,m,h", [(3, 9, 9, 2), (2, 1, 13, 2)])
def test_k2_bias_plain_matches_pallas(dtype, e, lq, m, h):
    q, k, v = _qkv(1, e, lq, m, h)
    mask = _key_mask(2, e, m)
    jbias = jattn.make_additive_mask(jnp.asarray(mask))      # [E, 1, 1, M]
    tbias = tattn.make_additive_mask(t(mask))
    np.testing.assert_array_equal(f32(tbias), f32(jbias))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    ref = _fused_attention_fwd_impl(
        jq, jk, jv, jnp.broadcast_to(jbias, (e, 1, lq, m)), interpret=True)
    out = ck.fused_attention(tq, tk, tv, tbias)  # row stride 0: no copy
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_candidate_fold_plain_matches_pallas(dtype):
    """K3 as the candidate-major path calls it: B queries x L rows folded
    into one row axis per candidate, against that candidate's M keys."""
    a, b, lq, m, h = 2, 3, 5, 19, 2
    rng = np.random.default_rng(3)
    q = rng.normal(size=(a, b, lq, h, D)).astype(np.float32)
    _, k, v = _qkv(4, a, 1, m, h)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    ref = _fused_attention_fwd_impl(jq.reshape(a, b * lq, h, D), jk, jv, None,
                                    interpret=True).reshape(a, b, lq, h, D)
    out = tattn.grid_cross_attention(tq, tk, tv)
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])
    # the JAX routing function itself (fused, interpreted on the CPU)
    ref_route = jattn.grid_cross_attention(jq, jk, jv, fused=True)
    np.testing.assert_allclose(f32(out), f32(ref_route), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,lq,m,h", SHAPES)
def test_k4_folded_bias_plain_matches_pallas(dtype, e, lq, m, h):
    q, k, v = _qkv(5, e, lq, m, h)
    mask = _key_mask(6, e, m)
    jbias = jnp.broadcast_to(jattn.make_additive_mask(jnp.asarray(mask)),
                             (e, 1, lq, m))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x.reshape(e, -1, h * D), dtype)
                                    for x in (q, k, v))
    ref = _fused_attention_folded_impl(jq, jk, jv, jbias, h, interpret=True)
    out = ck.fused_attention_folded(tq, tk, tv,
                                    tattn.make_additive_mask(t(mask)),
                                    num_heads=h)
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])


def test_pair_cross_attention_matches_jax():
    """Eval form of the shared-candidate pair grid (K3 with queries folded
    into each candidate's rows)."""
    n_q, n_c, lq, m, h = 2, 3, 4, 11, 2
    rng = np.random.default_rng(7)
    q = rng.normal(size=(n_q, n_c, lq, h, D)).astype(np.float32)
    k = rng.normal(size=(n_c, m, h, D)).astype(np.float32)
    v = rng.normal(size=(n_c, m, h, D)).astype(np.float32)
    ref = jattn.pair_cross_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     fused=True)
    out = tattn.pair_cross_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5)


def test_dot_product_attention_dual_stream_bias_matches_jax():
    """K2 as the dual-stream self-attention calls it: [A, B, L, H, D] with
    an [A, B, 1, 1, L] mask, flattened to entries without copying the
    bias's broadcast rows."""
    a, b, lq, h = 2, 3, 7, 2
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(a, b, lq, h, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((a, b, lq), np.int32)
    mask[0, 1, 4:] = 0
    mask[1, 2, 2:] = 0
    ref = jattn.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        jattn.make_additive_mask(jnp.asarray(mask)), fused=True)
    out = tattn.dot_product_attention(t(q), t(k), t(v),
                                      tattn.make_additive_mask(t(mask)))
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5)


def test_plain_version_rejects_head_dependent_bias():
    q, k, v = (t(x) for x in _qkv(9, 2, 3, 5, 2))
    with pytest.raises(ValueError):
        ck.fused_attention(q, k, v, torch.zeros(2, 2, 3, 5))
