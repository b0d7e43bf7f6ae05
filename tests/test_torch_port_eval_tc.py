"""The tensor-core eval kernel's order of work (bf16, no bias: K1 and K3),
emulated on the CPU and held against the Pallas kernels it replaces (run by
the Pallas interpreter) and against the port's plain version.

The emulation follows ``csrc/attention_tc.cuh``: 64-key tiles; sweep 1
keeps each row's running max and the fp32 sum of exp(s - max), rescaled
when the max grows; sweep 2 recomputes each tile's scores, divides
exp(s - max) by the sum, rounds p to the input type and accumulates P.V in
fp32 tile by tile. (The kernel's quotient, from one reciprocal per row and
two FMAs per score, equals the divide here: see
``test_row_reciprocal_quotient_is_the_divide``.) Tolerances follow
tests/test_pallas_attention*.py: fp32 atol 2e-5, bf16 atol 2e-2.

Also here: the wrapper's report of the route, how it raises on the C entry
point's refusals (misaligned views, too many keys) and errors, and the
names ``chip_smoke.py`` gives the eval kernels in a profile."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu.ops.pallas_attention import (
    _fused_attention_folded_impl,
    _fused_attention_fwd_impl,
)
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
from candidate_reranking_cir_tpu_torch.ops import registry

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D = 64
TILE = 64


def emulate_tc(q, k, v):
    """q [E, Lq, H, D]; k, v [E, M, H, D] -> [E, Lq, H, D] in q's dtype,
    in the tensor-core kernel's sweep order."""
    qs = (q * D ** -0.5).float()
    m = k.shape[1]
    e, lq, h, _ = q.shape
    row_max = torch.full((e, h, lq), -torch.inf)
    row_sum = torch.zeros(e, h, lq)
    for j in range(0, m, TILE):
        s = torch.einsum("elhd,emhd->ehlm", qs, k[:, j:j + TILE].float())
        mx = torch.maximum(row_max, s.amax(-1))
        row_sum = row_sum * torch.exp(row_max - mx) \
            + torch.exp(s - mx[..., None]).sum(-1)
        row_max = mx
    out = torch.zeros(e, lq, h, D)
    for j in range(0, m, TILE):
        s = torch.einsum("elhd,emhd->ehlm", qs, k[:, j:j + TILE].float())
        p = (torch.exp(s - row_max[..., None]) / row_sum[..., None]).to(
            v.dtype)
        out += torch.einsum("ehlm,emhd->elhd", p.float(),
                            v[:, j:j + TILE].float())
    return out.to(q.dtype)


def _qkv(seed, e, lq, m, h, q_scale=1.0):
    rng = np.random.default_rng(seed)
    return ((q_scale * rng.normal(size=(e, lq, h, D))).astype(np.float32),
            rng.normal(size=(e, m, h, D)).astype(np.float32),
            rng.normal(size=(e, m, h, D)).astype(np.float32))


# (entries, Lq, M, heads): one key; exactly one tile; one past a tile; a
# ragged tail over three tiles; Lq = 1 and Lq one past a 64-row tile
SHAPES = [(2, 3, 1, 2), (2, 17, 64, 2), (1, 40, 65, 2), (2, 5, 150, 1),
          (1, 1, 70, 2), (1, 65, 20, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,lq,m,h", SHAPES)
def test_tc_order_matches_pallas_k3(dtype, e, lq, m, h):
    jd, td = DTYPES[dtype]
    q, k, v = _qkv(lq * 100 + m, e, lq, m, h)
    ref = _fused_attention_fwd_impl(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                    None, interpret=True)
    out = emulate_tc(*(t(x, td) for x in (q, k, v)))
    assert out.dtype == td and out.shape == (e, lq, h, D)
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,lq,m,h", SHAPES[:3])
def test_tc_order_matches_pallas_k1_folded(dtype, e, lq, m, h):
    jd, td = DTYPES[dtype]
    q, k, v = _qkv(lq * 100 + m + 1, e, lq, m, h)
    ref = _fused_attention_folded_impl(
        *(jnp.asarray(x.reshape(e, -1, h * D), jd) for x in (q, k, v)), None,
        h, interpret=True)
    out = emulate_tc(*(t(x, td) for x in (q, k, v)))
    np.testing.assert_allclose(f32(out.flatten(-2)), f32(ref),
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,lq,m,h,q_scale", [
    (2, 40, 577, 2, 1.0),     # the MED cross-attention's shape, 10 tiles
    (1, 130, 200, 1, 6.0),    # |q.k|/8 up to about 30
])
def test_tc_order_matches_plain(dtype, e, lq, m, h, q_scale):
    td = DTYPES[dtype][1]
    q, k, v = (t(x, td) for x in _qkv(7 + lq, e, lq, m, h, q_scale))
    ref = ck.attention_plain(q, k, v)
    out = emulate_tc(q, k, v)
    if q_scale > 1:
        s = torch.einsum("elhd,emhd->ehlm", (q * D ** -0.5).float(),
                         k.float())
        assert s.abs().max() > 20  # the shift by the max matters here
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])


def _rn32(x: Fraction) -> np.float32:
    """The exact rational x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.uint32)) & 1))


def _fma32(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_row_reciprocal_quotient_is_the_divide():
    """The kernel's p / sum (csrc/attention_tc.cuh divide()): inv = 1 / sum
    correctly rounded once per row, q0 = p * inv, then q0 + (p - q0 * sum)
    * inv through two exact-remainder FMAs, is the correctly rounded
    quotient, bit for bit, over the range the softmax gives it: p = 2^-x
    in (2^-60, 1], sums in [1, 600]."""
    rng = np.random.default_rng(11)
    p = np.exp2(-rng.uniform(0, 60, 3000)).astype(np.float32)
    sums = rng.uniform(1, 600, 3000).astype(np.float32)
    p[:4], sums[:4] = 1, np.float32([1, 3, 7, 577])
    for a, b in zip(p, sums):
        inv = np.float32(1) / b
        q0 = a * inv
        quotient = _fma32(_fma32(-q0, b, a), inv, q0)
        assert quotient == a / b, (a, b)


def test_routing_sends_bf16_without_bias_to_tensor_cores():
    """bf16 takes the tensor cores with or without a bias (K2/K4 since
    their bias variant); fp32 stays on the FMA kernel."""
    assert ck.uses_tensor_cores(torch.bfloat16)
    assert not ck.uses_tensor_cores(torch.float32)


def _tc_aligned(x) -> bool:
    """The tensor-core kernel's rule for q, k and v, as csrc/attention_tc.cuh
    states it (the C entry point alone enforces it): base pointer and
    entry, row and head strides 16-byte aligned."""
    return x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])


def test_alignment_check_accepts_the_paths_views():
    """The views the path hands the kernel meet the rule: q/k/v sliced from
    one fused projection, and pair_cross_attention's transposed q."""
    e, lq, h = 2, 5, 3
    qkv = torch.zeros(e, lq, 3 * h * D, dtype=torch.bfloat16)
    views = {n: x.unflatten(-1, (h, D))
             for n, x in zip("qkv", qkv.chunk(3, dim=-1))}
    q = torch.zeros(1, 4, 6, h, D, dtype=torch.bfloat16)
    views["pair q"] = q.transpose(0, 1).reshape(4, 6, h, D)
    assert views["pair q"].data_ptr() == q.data_ptr()  # a view, not a copy
    assert all(_tc_aligned(x) for x in views.values())
    ck.raise_on_error(0, "K3", views)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2, 8, 1, 72, dtype=torch.bfloat16)[..., 4:68],
    lambda: torch.zeros(2, 8, 1, 68, dtype=torch.bfloat16)[..., :64],
    lambda: torch.zeros(2, 8, 3, 68, dtype=torch.bfloat16)[..., :64],
], ids=["pointer", "row_stride", "head_stride"])
def test_alignment_check_refuses_misaligned_views(make):
    """The entry point's alignment refusal raises a ValueError that names
    each view's pointer offset and strides."""
    q = make()
    assert not _tc_aligned(q)
    with pytest.raises(ValueError, match="aligned") as info:
        ck.raise_on_error(ck.REFUSED_ALIGNMENT, "K3", {"q": q})
    assert f"strides {tuple(q.stride())}" in str(info.value)
    assert f"pointer offset {q.data_ptr() % 16}" in str(info.value)


@pytest.mark.parametrize("err,exc,match", [
    (ck.REFUSED_KEYS, ValueError, "5000 keys exceed"),
    (1, RuntimeError, "cudaError 1"),
    (700, RuntimeError, "cudaError 700"),
], ids=["keys", "invalid_value", "illegal_address"])
def test_raise_on_error_maps_the_entry_points_codes(err, exc, match):
    views = {"q": torch.zeros(1, 4, 1, D), "k": torch.zeros(1, 5000, 1, D)}
    with pytest.raises(exc, match=match):
        ck.raise_on_error(err, "K2", views)


@pytest.mark.parametrize("mode,requires,autograd", [
    ("grad", True, True), ("grad", False, False), ("no_grad", True, False),
    ("inference", True, False)])
def test_card_forward_takes_autograd_only_for_gradients(monkeypatch, mode,
                                                        requires, autograd):
    """The card's forward goes through ``registry.PlainBackward`` only
    where a gradient is wanted (the kernel is replaced by the plain
    version, as the card's cannot run here)."""
    calls = []
    monkeypatch.setattr(ck, "_kernel_forward", lambda kid, q, k, v, b: (
        calls.append(kid), ck.attention_plain(q, k, v, b))[1])
    q, k, v = (t(x).requires_grad_(requires) for x in _qkv(3, 1, 5, 7, 2))
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    with ctx():
        out = registry.run(ck._kernel_forward, ck._plain_forward, "K3", q,
                           k, v, None)
    assert calls == ["K3"]
    assert (out.grad_fn is not None) == autograd
    if autograd:
        assert type(out.grad_fn).__name__ == "PlainBackwardBackward"
    np.testing.assert_allclose(f32(out), f32(ck.attention_plain(q, k, v)),
                               atol=1e-6)


@pytest.mark.parametrize("name,family", [
    ("void crc::tc::attn_fwd_tc_kernel<1, false>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, int, int, float, crc::Strides)", "K1-K4"),
    ("void crc::tc::attn_fwd_tc_kernel<2, true>(...)", "K1-K4"),
    ("void crc::tc::attn_fwd_tc_kernel<1, true, 64>(...)", "K1-K4"),
    ("void crc::tc::attn_fwd_tc_kernel<2, false, 88>(...)", "K1-K4"),
    ("void (anonymous namespace)::attn_fwd_kernel<true>(float const*, ...)",
     "fp32 K1-K4"),
    ("void (anonymous namespace)::attn_fwd_kernel<false>(...)",
     "fp32 K1-K4"),
])
def test_profile_families_name_the_eval_kernels(name, family):
    assert family in chip_smoke.kernel_family(name)
    if "fp32" not in family:
        assert chip_smoke.kernel_family(name) == chip_smoke.TC_FAMILY
    # the fp32-FMA body has a family of its own, which the bf16 profiles
    # must not see
    fma = chip_smoke.kernel_family(
        "void (anonymous namespace)::attn_fwd_kernel<false>(...)")
    assert fma == chip_smoke.FMA_EVAL_FAMILY != chip_smoke.TC_FAMILY
    assert fma in chip_smoke.FMA_FAMILIES


@pytest.mark.parametrize("name,bias", [
    ("void crc::tc::attn_fwd_tc_kernel<1, true, 64>(__nv_bfloat16 const*, "
     "__nv_bfloat", True),
    ("void crc::tc::attn_fwd_tc_kernel<2, true, 64>(...)", True),
    ("void crc::tc::attn_fwd_tc_kernel<1, false, 64>(...)", False),
    ("void crc::tc::attn_fwd_tc_kernel<2, false, 88>(...)", False),
])
def test_bias_instantiation_read_from_the_name(name, bias):
    """The single-program replay's K2 check reads the bias argument of
    the eval kernel's template, whatever follows it (the head width)."""
    assert chip_smoke.is_bias_instantiation(name) is bias


@pytest.mark.parametrize("every", [False, True])
def test_planted_fault_noises_the_chosen_launches(monkeypatch, every):
    # chip_smoke.py's control for its bf16 check: noise of the given share
    # of the output's std on the first launch of one kernel, or on each
    # of its launches, and on no other kernel's
    monkeypatch.setattr(ck, "_kernel_forward",
                        lambda kid, q4, k4, v4, bias3: q4.clone())
    x = torch.randn(2, 8, 2, 4, generator=torch.Generator().manual_seed(0))
    with chip_smoke.planted_fault("K2", 0.5, 3, every) as planted:
        outs = [ck._kernel_forward(kid, x, x, x, None)
                for kid in ("K1", "K2", "K2")]
    assert planted == (["K2", "K2"] if every else ["K2"])
    assert torch.equal(outs[0], x)
    noise = outs[1] - x
    assert 0.25 * x.std() < noise.std() < 1.0 * x.std()
    assert torch.equal(outs[2], x) != every
    assert ck._kernel_forward("K2", x, x, x, None).equal(x)  # restored


def test_planted_fault_fails_when_its_kernel_never_launched(monkeypatch):
    monkeypatch.setattr(ck, "_kernel_forward",
                        lambda kid, q4, k4, v4, bias3: q4.clone())
    with pytest.raises(SystemExit):
        with chip_smoke.planted_fault("K3", 0.5, 3, False):
            pass
