"""The softmax scale at head widths other than 64.

The JAX package folds 1/sqrt(d) into q (in q's dtype) only where that
scale is an exact power of two (``_is_exact_pow2``,
``ops/pallas_attention.py``; ``_head_scores``,
``ops/pallas_attention_train.py``); otherwise it multiplies the fp32
scores by it. The port's plain versions (what its wrappers run on CPU
tensors) must follow the same rule: at d = 6 or 8 in bf16, rounding
``q * scale`` to bf16 moves the scores, and the outputs, by more than one
bf16 ulp.

Tolerance, chosen before the plain versions were repaired: one bf16 ulp of
the reference output's largest magnitude (``_ulp``), per output. q and k
are drawn with std 4, so that the scores are large enough for the folded
rounding to show.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu.ops import attention as jattn
from candidate_reranking_cir_tpu.ops import pallas_attention as jpa
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

SEED = 4321
E, LQ, M, H = 4, 16, 33, 2


def _ulp(ref) -> float:
    """One bf16 ulp at the largest magnitude of ``ref``: 2^(e - 7) for a
    largest magnitude in [2^e, 2^(e + 1))."""
    top = float(np.abs(f32(ref)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def _inputs(seed, d, with_bias, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(scale=s, size=shape).astype(np.float32)
              for s, shape in ((4.0, (E, LQ, H, d)), (4.0, (E, M, H, d)),
                               (1.0, (E, M, H, d)), (1.0, (E, LQ, H, d)))]
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = [jnp.asarray(a, jd) for a in arrays]
    tx = [t(a, dtype) for a in arrays]
    jb = tb = None
    if with_bias:
        lens = rng.integers(1, M + 1, size=E)
        mask = (np.arange(M)[None] < lens[:, None]).astype(np.int32)
        bias = np.broadcast_to(
            np.asarray(jattn.make_additive_mask(jnp.asarray(mask))),
            (E, 1, LQ, M)).copy()
        jb, tb = jnp.asarray(bias), t(bias)
    return jx, tx, jb, tb


@pytest.mark.parametrize("d", [6, 8])
@pytest.mark.parametrize("kid", ["K2", "K3"])
def test_eval_plain_follows_the_scale_rule(kid, d):
    (jq, jk, jv, _), (tq, tk, tv, _), jb, tb = _inputs(SEED, d, kid == "K2")
    ref = jpa._fused_attention_fwd_impl(jq, jk, jv, jb, interpret=True)
    out = ck.fused_attention(tq, tk, tv, tb)
    np.testing.assert_allclose(f32(out), f32(ref), atol=_ulp(ref), rtol=0)


@pytest.mark.parametrize("d", [6, 8])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k6_plain_follows_the_scale_rule(rate, d):
    (jq, jk, jv, _), (tq, tk, tv, _), _, _ = _inputs(SEED + 1, d, False)
    ref = jpat._fwd_impl(jq, jk, jv, None, jnp.array([SEED], jnp.int32),
                         rate, interpret=True)
    out = tat.attention_train_plain(tq, tk, tv, None, SEED, rate)
    np.testing.assert_allclose(f32(out), f32(ref), atol=_ulp(ref), rtol=0)


@pytest.mark.parametrize("d", [6, 8])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k7_plain_follows_the_scale_rule(rate, d):
    (jq, jk, jv, jg), (tq, tk, tv, tg), _, _ = _inputs(SEED + 2, d, False)
    refs = jpat._bwd_impl(jq, jk, jv, None, jnp.array([SEED], jnp.int32),
                          jg, rate, interpret=True)
    outs = tat.attention_train_bwd_plain(tq, tk, tv, None, SEED, tg, rate)
    for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
        np.testing.assert_allclose(f32(out), f32(ref), atol=_ulp(ref),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_bias", [False, True])
def test_d64_plain_is_bit_equal_to_the_folded_scale(dtype, with_bias):
    _, (tq, tk, tv, tg), _, tb = _inputs(SEED + 3, 64, with_bias, dtype)
    bias3 = None if tb is None else tb[:, 0]
    scale = 64 ** -0.5
    folded = torch.einsum("elhd,emhd->ehlm", (tq * scale).float(),
                          tk.float())
    # the rule's product for a power-of-two scale is the folded one
    probs = tat._probs(tq, tk, bias3, torch.float32)
    scores = folded if bias3 is None else folded + bias3.unsqueeze(1)
    scores = scores - scores.amax(dim=-1, keepdim=True)
    expected = torch.exp(scores)
    expected = expected / expected.sum(dim=-1, keepdim=True)
    assert torch.equal(probs, expected)
    # and the eval plain version's output
    p16 = expected.to(tv.dtype)
    out = torch.einsum("ehlm,emhd->elhd", p16.float(), tv.float()).to(dtype)
    assert torch.equal(ck.attention_plain(tq, tk, tv, bias3), out)
