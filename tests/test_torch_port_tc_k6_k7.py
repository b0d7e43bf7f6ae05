"""The tensor-core kernels' order of work for K6 and K7 (the stage-II
dropout attention forward and backward), emulated on the CPU and held
against the Pallas kernels they replace (run by the Pallas interpreter) and
against the port's plain versions.

K6's emulation follows ``attn_train_fwd_tc_kernel``
(``csrc/attention_train_tc.cuh`` over the eval kernel's body in
``csrc/attention_tc.cuh``): sweep 1 keeps each row's running max and
rescaled sum over 64-key tiles; sweep 2 forms p = exp(s - max) / sum per
tile, then, at rate > 0, kept ? p / (1 - rate) : 0 with the K5 mask, and
only then rounds p to the input type before P.V.

K7's is ``emulate_tc_bwd`` of ``tests/test_torch_port_tc_k2_k9.py``: the
row pass and key pass that K7 and K9 share, here over unfolded [E, L, H, D]
inputs and at query lengths that take several 64-row blocks of the row
pass and several 64-row chunks of the key pass.

Tolerances follow tests/test_pallas_attention*.py: fp32 atol 2e-5 forward
and 3e-5 gradients, bf16 atol 2e-2.

Also here: K6's route predicate, how the K6 and K7 wrappers raise on the
entry points' codes, and the profile families ``chip_smoke.py`` gives the
new kernels."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
from test_torch_port_tc_k2_k9 import emulate_tc_bwd

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D = 64
TILE = 64
SCALE = D ** -0.5
SEED = 4242


def emulate_k6(q, k, v, seed, rate):
    """q [E, Lq, H, D]; k, v [E, M, H, D] -> [E, Lq, H, D] in q's dtype, in
    the tensor-core K6 kernel's order."""
    e, lq, h, _ = q.shape
    m = k.shape[1]
    keep = tat._keep(seed, q, m, rate) if rate > 0.0 else None
    inv = 1.0 / (1.0 - rate)

    def scores(j):
        return torch.einsum("elhd,emhd->ehlm", q.float(),
                            k[:, j:j + TILE].float()) * SCALE

    row_max = torch.full((e, h, lq), -torch.inf)
    row_sum = torch.zeros(e, h, lq)
    for j in range(0, m, TILE):                     # sweep 1
        s = scores(j)
        mx = torch.maximum(row_max, s.amax(-1))
        row_sum = row_sum * torch.exp(row_max - mx) \
            + torch.exp(s - mx[..., None]).sum(-1)
        row_max = mx
    out = torch.zeros(e, lq, h, D)
    for j in range(0, m, TILE):                     # sweep 2
        p = torch.exp(scores(j) - row_max[..., None]) / row_sum[..., None]
        if keep is not None:
            p = torch.where(keep[..., j:j + TILE], p * inv, 0.0)
        out += torch.einsum("ehlm,emhd->elhd", p.to(v.dtype).float(),
                            v[:, j:j + TILE].float())
    return out.to(q.dtype)


def _inputs(seed, e, lq, m, h, dtype, scale=1.0):
    """q, k, v, g [E, L, H, D] for JAX and for the port (same numbers)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(scale=scale, size=(e, n, h, D)).astype(np.float32)
              for n in (lq, m, m, lq)]
    jd, td = DTYPES[dtype]
    return [jnp.asarray(a, jd) for a in arrays], [t(a, td) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,m", [(40, 45), (70, 77), (130, 130)])
def test_k6_tc_order_matches_pallas(dtype, rate, lq, m):
    """One key tile (45), two (77: the second of 13 keys) and three (130);
    one warpgroup (40), two (70, 130: a second block of 2 rows)."""
    e, h = 2, 2
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(lq * m, e, lq, m, h, dtype)
    ref = jpat._fwd_impl(jq, jk, jv, None, jnp.array([SEED], jnp.int32), rate,
                         interpret=True)
    out = emulate_k6(tq, tk, tv, SEED, rate)
    assert out.shape == ref.shape and out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])
    plain = tat.attention_train_plain(tq, tk, tv, None, SEED, rate)
    np.testing.assert_allclose(f32(out), f32(plain), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,m", [(140, 77), (200, 130)])
def test_k7_tc_order_matches_pallas(dtype, rate, lq, m):
    """Unfolded, at Lq 140 (three 64-row blocks of the row pass, three
    64-row chunks of the key pass, the last of 12 rows) and 200 (four
    each), ragged M (77: two key tiles; 130: three)."""
    e, h = 2, 2
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(lq + m, e, lq, m, h, dtype,
                                                 scale=0.5)
    refs = jpat._bwd_impl(jq, jk, jv, None, jnp.array([SEED], jnp.int32), jg,
                          rate, interpret=True)
    outs = emulate_tc_bwd(tq, tk, tv, tg, SEED, rate)
    plains = tat.attention_train_bwd_plain(tq, tk, tv, None, SEED, tg, rate)
    for out, ref, plain in zip(outs, refs, plains):
        assert out.shape == ref.shape and out.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(f32(out), f32(ref), atol=GRAD_TOL[dtype])
        np.testing.assert_allclose(f32(out), f32(plain),
                                   atol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype,bias,folded,tc", [
    (torch.bfloat16, None, False, True),             # K6 on the tensor cores
    (torch.bfloat16, torch.zeros(1, 4, 4), False, False),
    (torch.float32, None, False, False),
    (torch.bfloat16, None, True, True),              # K8 on the tensor cores too
])
def test_k6_route_predicate(dtype, bias, folded, tc):
    assert tat.fwd_uses_tensor_cores(dtype, bias, folded) == tc


class _FakeTrainLibrary:
    """Stands in for the train library: its K6 and K7 entry points return
    ``code`` without launching anything."""

    def __init__(self, code: int):
        self.code = code

    def crc_attention_train_max_keys(self):
        return 1000

    def crc_attention_train_forward(self, *args):
        return self.code

    crc_attention_train_backward = crc_attention_train_forward


@pytest.mark.parametrize("kid", ["K6", "K7"])
@pytest.mark.parametrize("code,exc,match", [
    (ck.REFUSED_ALIGNMENT, ValueError, "aligned"),
    (700, RuntimeError, "launch failed: cudaError 700"),
])
def test_k6_k7_wrappers_raise_on_the_entry_points_codes(monkeypatch, kid,
                                                        code, exc, match):
    from candidate_reranking_cir_tpu_torch.ops import build

    monkeypatch.setattr(build, "load",
                        lambda name: _FakeTrainLibrary(code))
    monkeypatch.setattr(tat, "_stream", lambda device: 0)
    q, k, v, g = (torch.zeros(2, n, 2, D, dtype=torch.bfloat16)
                  for n in (4, 9, 9, 4))
    before = dict(tat.LAUNCHES)
    with pytest.raises(exc, match=f"{kid}.*{match}|{match}.*{kid}"):
        if kid == "K6":
            tat._kernel_fwd(q, k, v, None, 0, 0.1)
        else:
            tat._kernel_bwd(q, k, v, None, 0, g, 0.1)
    assert tat.LAUNCHES == before


@pytest.mark.parametrize("name,family", [
    ("void crc::tc::attn_train_fwd_tc_kernel<2>(__nv_bfloat16 const*, ...)",
     chip_smoke.TC_K6_FAMILY),
    ("void crc::tc::attn_train_fwd_tc_kernel<1>(...)",
     chip_smoke.TC_K6_FAMILY),
    ("void crc::tc::attn_train_bwd_tc_rows_kernel<2>(...)",
     chip_smoke.TC_K7_FAMILY),
    ("void crc::tc::attn_train_bwd_tc_rows_kernel<1>(...)",
     chip_smoke.TC_K7_FAMILY),
    ("crc::tc::attn_train_bwd_tc_keys_kernel(__nv_bfloat16 const*, ...)",
     chip_smoke.TC_K7_FAMILY),
    ("void (anonymous namespace)::attn_train_fwd_kernel<float, false>(...)",
     chip_smoke.FMA_K6_FAMILY),
    ("void (anonymous namespace)::attn_train_fwd_kernel<__nv_bfloat16, "
     "true>(...)", chip_smoke.FMA_K6_FAMILY),
    ("void (anonymous namespace)::attn_bwd_rows_kernel<float, false>(...)",
     chip_smoke.FMA_K7_FAMILY),
    ("void (anonymous namespace)::attn_bwd_keys_kernel<__nv_bfloat16, true>"
     "(...)", chip_smoke.FMA_K7_FAMILY),
    ("void crc::tc::attn_bwd_tc_rows_kernel<1>(...)", chip_smoke.TC_K9_FAMILY),
    ("void crc::tc::attn_fwd_tc_kernel<2, false>(...)", chip_smoke.TC_FAMILY),
])
def test_profile_families_name_the_k6_k7_kernels(name, family):
    """Each kernel has its family, and a bf16 profile fails on time in the
    fp32-FMA K6 and K7 families as in the other FMA ones."""
    assert chip_smoke.kernel_family(name) == family
    assert (family in chip_smoke.FMA_FAMILIES) == ("FMA" in family)


@pytest.mark.parametrize("kid,kernel", [
    ("K6", "attn_train_fwd_tc_kernel"),
    ("K7", "attn_train_bwd_tc_rows_kernel"),
    ("K7", "attn_train_bwd_tc_keys_kernel"),
    ("K9", "attn_bwd_tc_keys_kernel"),
])
def test_smoke_sources_hold_the_kernels(kid, kernel):
    """The JSON line's ``source`` of each redesigned kernel is the file
    that defines its ``__global__`` entry point."""
    src = Path(chip_smoke.__file__).parent / chip_smoke.SOURCES[kid]
    assert f"\n{kernel}(" in src.read_text()
