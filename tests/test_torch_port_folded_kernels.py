"""Head-folded train kernels K8/K9 of the port, on the CPU.

The port's plain versions (what ``fused_attention_train_folded`` runs on
CPU tensors) against the Pallas kernels they replace,
``_fwd_impl_folded`` / ``_bwd_impl_folded``, run by the Pallas
interpreter. Tolerances follow tests/test_pallas_attention*.py: fp32 atol
2e-5 forward and 3e-5 gradients, bf16 atol 2e-2. The entry-blocked shapes
(the JAX package runs 8 or 4 entries per program) show that the mask is
keyed by the absolute entry index on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu.ops import attention as jattn
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import registry

D = 64
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 3e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEED = -424242

SHAPE = (2, 9, 21, 2)           # e, lq, m, h
BLOCKED_FWD = (8, 16, 33, 2)    # JAX: 8 entries per forward program
BLOCKED_BOTH = (8, 32, 33, 3)   # JAX: 4 per program, forward and backward


def _inputs(seed, e, lq, m, h, with_bias, dtype="float32"):
    """Folded q, k, v, g [E, L, H*D] and an [E, 1, Lq, M] key-mask bias
    (or None), as JAX arrays and as CPU tensors in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(scale=0.5, size=s).astype(np.float32)
              for s in ((e, lq, h * D), (e, m, h * D), (e, m, h * D),
                        (e, lq, h * D))]
    bias = None
    if with_bias:
        lens = rng.integers(1, m + 1, size=e)
        mask = (np.arange(m)[None] < lens[:, None]).astype(np.int32)
        bias = np.broadcast_to(
            np.asarray(jattn.make_additive_mask(jnp.asarray(mask))),
            (e, 1, lq, m)).copy()
    jd, td = DTYPES[dtype]
    jx = [jnp.asarray(a, jd) for a in arrays]
    tx = [t(a, td) for a in arrays]
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else t(bias)
    return jx, tx, jb, tb


def test_blocked_shapes_are_entry_blocked_in_jax():
    e, lq, _, _ = BLOCKED_FWD
    assert jpat._pick_entries(e, lq, jpat.MAX_ENTRIES_FWD) == 8
    assert jpat._pick_entries(e, lq) == 1
    e, lq, _, _ = BLOCKED_BOTH
    assert jpat._pick_entries(e, lq, jpat.MAX_ENTRIES_FWD) == 8
    assert jpat._pick_entries(e, lq) == 4


@pytest.mark.parametrize("dtype,rate,with_bias,shape", [
    *[("float32", r, b, SHAPE) for r in (0.0, 0.1) for b in (False, True)],
    ("bfloat16", 0.1, True, SHAPE),
    ("float32", 0.1, False, BLOCKED_FWD),
    ("float32", 0.1, True, BLOCKED_BOTH),
    ("bfloat16", 0.1, False, BLOCKED_BOTH),
])
def test_k8_plain_forward_matches_pallas(dtype, rate, with_bias, shape):
    (jq, jk, jv, _), (tq, tk, tv, _), jb, tb = _inputs(1, *shape, with_bias,
                                                        dtype)
    e, lq, m, h = shape
    ref = jpat._fwd_impl_folded(jq, jk, jv, jb, jnp.array([SEED], jnp.int32),
                                rate, h, interpret=True)
    out = tat.attention_train_folded_plain(
        tq, tk, tv, tat._train_bias3(tb, e, lq, m), SEED, rate, num_heads=h)
    assert out.shape == (e, lq, h * D) and out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(f32(out), f32(ref), atol=FWD_TOL[dtype])


@pytest.mark.parametrize("rate,with_bias,shape", [
    (0.0, False, SHAPE), (0.1, False, SHAPE), (0.0, True, SHAPE),
    (0.1, True, SHAPE), (0.1, False, BLOCKED_FWD), (0.1, True, BLOCKED_BOTH),
])
def test_k9_plain_backward_matches_pallas(rate, with_bias, shape):
    (jq, jk, jv, jg), (tq, tk, tv, tg), jb, tb = _inputs(2, *shape,
                                                         with_bias)
    e, lq, m, h = shape
    refs = jpat._bwd_impl_folded(jq, jk, jv, jb,
                                 jnp.array([SEED], jnp.int32), jg, rate, h,
                                 interpret=True)
    outs = tat.attention_train_folded_bwd_plain(
        tq, tk, tv, tat._train_bias3(tb, e, lq, m), SEED, tg, rate,
        num_heads=h)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape
        np.testing.assert_allclose(f32(out), f32(ref), atol=GRAD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_folded_wrapper_on_cpu_runs_the_plain_versions(with_bias):
    """``fused_attention_train_folded`` on CPU tensors: the plain forward,
    and under autograd the plain backward, bit for bit; no launch."""
    e, lq, m, h = BLOCKED_BOTH
    _, (tq, tk, tv, tg), _, tb = _inputs(3, e, lq, m, h, with_bias)
    registry.reset()
    x = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    out = tat.fused_attention_train_folded(*x, tb, SEED, 0.1, num_heads=h)
    grads = torch.autograd.grad(out, x, tg)
    bias3 = tat._train_bias3(tb, e, lq, m)
    assert torch.equal(out, tat.attention_train_folded_plain(
        tq, tk, tv, bias3, SEED, 0.1, num_heads=h))
    refs = tat.attention_train_folded_bwd_plain(tq, tk, tv, bias3, SEED, tg,
                                                0.1, num_heads=h)
    for a, b in zip(grads, refs):
        assert torch.equal(a, b)
    assert set(tat.LAUNCHES.values()) == {0}


def test_folded_and_unfolded_wrappers_agree():
    """The mask does not depend on the layout: K8/K9's route equals
    K6/K7's on the [E, L, H, D] views."""
    e, lq, m, h = SHAPE
    _, (tq, tk, tv, tg), _, tb = _inputs(4, e, lq, m, h, True)
    x = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    out = tat.fused_attention_train_folded(*x, tb, SEED, 0.1, num_heads=h)
    grads = torch.autograd.grad(out, x, tg)
    y = [a.unflatten(-1, (h, D)).clone().requires_grad_()
         for a in (tq, tk, tv)]
    ref = tat.fused_attention_train(*y, tb, SEED, 0.1)
    refs = torch.autograd.grad(ref, y, tg.unflatten(-1, (h, D)))
    assert torch.equal(out, ref.flatten(-2))
    for a, b in zip(grads, refs):
        assert torch.equal(a, b.flatten(-2))


def test_folded_train_attention_gradcheck_float64():
    """The folded route's explicit backward is the gradient of its forward
    (rate 0.1, float64 on the plain path, with a key-mask bias)."""
    e, lq, m, h, d = 2, 3, 5, 2, 4
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(e, n, h * d, generator=g, dtype=torch.float64,
                           requires_grad=True) for n in (lq, m, m))
    bias = torch.zeros(e, 1, 1, m, dtype=torch.float32)
    bias[1, ..., -2:] = -10000.0

    def fn(q, k, v):
        return tat.fused_attention_train_folded(q, k, v, bias, 11, 0.1,
                                                num_heads=h)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-7)


def test_folded_wrapper_rejects_bad_arguments():
    q = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="divisible"):
        tat.fused_attention_train_folded(q, q, q, None, 0, 0.1, num_heads=4)
    with pytest.raises(ValueError, match="int32"):
        tat.fused_attention_train_folded(q, q, q, None, 2 ** 31, 0.1,
                                         num_heads=2)
    with pytest.raises(ValueError, match="rate"):
        tat.fused_attention_train_folded(q, q, q, None, 0, 1.0, num_heads=2)
    with pytest.raises(ValueError, match="shapes"):
        tat.fused_attention_train_folded(q, q[:1], q[:1], None, 0, 0.1,
                                         num_heads=2)
