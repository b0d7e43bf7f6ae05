"""The tensor-core kernels' order of work for K2/K4 (the eval kernel's bias
variant) and K9 (the head-folded dropout-attention backward), emulated on
the CPU and held against the Pallas kernels they replace (run by the Pallas
interpreter) and against the port's plain versions.

K2's emulation follows ``csrc/attention_tc.cuh``: the bias added to the
scaled fp32 score, then max, exp, sum and a divide of that; one 64-key
tile (M <= 64) in a single step, more in two sweeps (running max and
rescaled sum, then p per tile, rounded to the input type before P.V).

K9's follows ``csrc/attention_train_tc.cuh``: a row pass over 64-key
tiles whose first sweep keeps each row's max, sum and the online delta
sum(d_probs * exp(s - max)) / sum, and whose second forms d_scores and dq;
a key pass per 64-key tile over 64-row chunks that forms S^T = K.Q^T and
dP^T = V.G^T, regenerates the mask with the hash taking (row, key) from
the transposed element (query row on the column axis), and accumulates
dv from dropped split into a bf16 hi + lo pair and dk from d_scores.
``emulate_tc_bwd`` is that order over unfolded [E, L, H, D] inputs, which
K7 runs too (``tests/test_torch_port_tc_k6_k7.py``); ``emulate_k9`` takes
it to the folded layout.

Tolerances follow tests/test_pallas_attention*.py: fp32 atol 2e-5 forward
and 3e-5 gradients, bf16 atol 2e-2.

Also here: the backward's route predicate, how K9's wrapper raises on the
refusal code, and the names ``chip_smoke.py`` gives the new kernels in a
profile."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu.ops import attention as jattn
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu.ops.pallas_attention import (
    _fused_attention_fwd_impl,
)
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D = 64
TILE = 64
SCALE = D ** -0.5
SEED = 90210


# ---------------------------------------------------------------------------
# K2 / K4: the bias variant of the tensor-core eval kernel


def emulate_tc_bias(q, k, v, bias3):
    """q [E, Lq, H, D]; k, v [E, M, H, D]; bias3 fp32 [E, Lq, M] ->
    [E, Lq, H, D] in q's dtype, in the kernel's order."""
    m = k.shape[1]
    b = bias3.float().unsqueeze(1)                          # [E, 1, Lq, M]

    def scores(j):
        s = torch.einsum("elhd,emhd->ehlm", q.float(),
                         k[:, j:j + TILE].float())
        return s * SCALE + b[..., j:j + TILE]   # scale * s is exact

    if m <= TILE:                                           # one step
        s = scores(0)
        row_max = s.amax(-1)
        row_sum = torch.exp(s - row_max[..., None]).sum(-1)
        tiles = [(0, s)]
    else:                                                   # two sweeps
        e, lq, h, _ = q.shape
        row_max = torch.full((e, h, lq), -torch.inf)
        row_sum = torch.zeros(e, h, lq)
        for j in range(0, m, TILE):
            s = scores(j)
            mx = torch.maximum(row_max, s.amax(-1))
            row_sum = row_sum * torch.exp(row_max - mx) \
                + torch.exp(s - mx[..., None]).sum(-1)
            row_max = mx
        tiles = [(j, scores(j)) for j in range(0, m, TILE)]
    out = torch.zeros(q.shape)
    for j, s in tiles:
        p = (torch.exp(s - row_max[..., None]) / row_sum[..., None]).to(
            v.dtype)
        out += torch.einsum("ehlm,emhd->elhd", p.float(),
                            v[:, j:j + TILE].float())
    return out.to(q.dtype)


def _bias_inputs(seed, e, lq, m, h, full):
    """q, k, v and an [E, 1, Lq|1, M] bias: a key mask of -10000 past
    each entry's length (rows broadcast), or a full random bias with
    masked keys and, in entry 0, a row masked everywhere but one key."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(e, n, h, D)).astype(np.float32)
               for n in (lq, m, m))
    if full:
        bias = rng.normal(size=(e, 1, lq, m)).astype(np.float32)
        bias[rng.random(size=bias.shape) < 0.3] = -10000.0
        bias[0, 0, 0] = -10000.0
        bias[0, 0, 0, m // 2] = 0.0
    else:
        lens = rng.integers(1, m + 1, size=e)
        mask = (np.arange(m)[None] < lens[:, None]).astype(np.int32)
        bias = np.asarray(jattn.make_additive_mask(jnp.asarray(mask)))
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full", [False, True], ids=["key_mask", "full"])
@pytest.mark.parametrize("n", [8, 40, 77])
def test_tc_bias_order_matches_pallas_k2(dtype, full, n):
    """Lq = M = n: one tile at 8 and 40, two sweeps at 77."""
    jd, td = DTYPES[dtype]
    e, h = 2, 2
    q, k, v, bias = _bias_inputs(n + full, e, n, n, h, full)
    ref = _fused_attention_fwd_impl(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                    jnp.asarray(bias), interpret=True)
    bias3 = ck._bias3(t(bias), e, n, n)
    if not full:
        assert bias3.stride(1) == 0      # the key mask broadcast over rows
    out = emulate_tc_bias(*(t(x, td) for x in (q, k, v)), bias3)
    assert out.dtype == td and out.shape == (e, n, h, D)
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])
    plain = ck.attention_plain(*(t(x, td) for x in (q, k, v)), bias3)
    np.testing.assert_allclose(f32(out), f32(plain), atol=TOL[dtype])


@pytest.mark.parametrize("lq,m", [(40, 77), (77, 40), (8, 150)])
def test_tc_bias_order_matches_plain_ragged(lq, m):
    """Lq != M, bf16, a full bias: a row masked everywhere but one key
    gives that key's v row."""
    e, h = 2, 3
    q, k, v, bias = _bias_inputs(lq * m, e, lq, m, h, True)
    tq, tk, tv = (t(x, torch.bfloat16) for x in (q, k, v))
    bias3 = ck._bias3(t(bias), e, lq, m)
    out = emulate_tc_bias(tq, tk, tv, bias3)
    np.testing.assert_allclose(f32(out), f32(ck.attention_plain(
        tq, tk, tv, bias3)), atol=TOL["bfloat16"])
    assert torch.equal(out[0, 0], tv[0, m // 2])


# ---------------------------------------------------------------------------
# K9: the tensor-core backward


def _keep_t(seed, e, h, r0, rows, key0, keys, m, rate):
    """The mask as the key pass regenerates it: [E, H, keys, rows], element
    (i, j) the hash of (row = r0 + j, col = key0 + i) with cols = m."""
    b = torch.arange(e).view(e, 1, 1, 1)
    hh = torch.arange(h).view(1, h, 1, 1)
    salt = tat._lowbias32((seed + b * 0x101 + hh) & 0xFFFFFFFF)
    key = torch.arange(key0, key0 + keys).view(keys, 1)
    row = torch.arange(r0, r0 + rows).view(1, rows)
    bits = tat._lowbias32((salt + row * m + key) & 0xFFFFFFFF)
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    return u >= torch.tensor(rate, dtype=torch.float32)


def emulate_tc_bwd(q, k, v, g, seed, rate):
    """q, g [E, Lq, H, D]; k, v [E, M, H, D] -> (dq, dk, dv) [E, L, H, D]
    in the order of the tensor-core backward passes that K7 and K9 share
    (rows of one row tile are independent, so the row pass takes all rows
    at once; the key pass takes 64-row chunks, as many as Lq needs)."""
    dtype = q.dtype
    qh, kh, vh, gh = (x.float() for x in (q, k, v, g))
    e, lq, h, _ = qh.shape
    m = kh.shape[1]
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    keep = tat._keep(seed, qh, m, rate) if rate > 0.0 else None

    def d_probs(dd, kept):
        return dd if kept is None else torch.where(kept, dd * inv, 0.0)

    def row_tile(j):
        s = torch.einsum("elhd,emhd->ehlm", qh, kh[:, j:j + TILE]) * SCALE
        dp = torch.einsum("elhd,emhd->ehlm", gh, vh[:, j:j + TILE])
        return s, dp, None if keep is None else keep[..., j:j + TILE]

    # row pass, sweep 1: max, sum and the online delta
    row_max = torch.full((e, h, lq), -torch.inf)
    row_sum = torch.zeros(e, h, lq)
    row_d = torch.zeros(e, h, lq)
    for j in range(0, m, TILE):
        s, dp, kept = row_tile(j)
        mx = torch.maximum(row_max, s.amax(-1))
        ex = torch.exp(s - mx[..., None])
        alpha = torch.exp(row_max - mx)
        row_sum = row_sum * alpha + ex.sum(-1)
        row_d = row_d * alpha + (d_probs(dp, kept) * ex).sum(-1)
        row_max = mx
    delta = row_d / row_sum
    # sweep 2: d_scores in the input type, dq
    dq = torch.zeros(e, lq, h, D)
    for j in range(0, m, TILE):
        s, dp, kept = row_tile(j)
        p = torch.exp(s - row_max[..., None]) / row_sum[..., None]
        ds = (p * (d_probs(dp, kept) - delta[..., None]) * SCALE).to(dtype)
        dq += torch.einsum("ehlm,emhd->elhd", ds.float(), kh[:, j:j + TILE])
    # key pass: per 64-key tile, 64-row chunks, transposed products
    dk = torch.zeros(e, m, h, D)
    dv = torch.zeros(e, m, h, D)
    for j in range(0, m, TILE):
        keys = min(TILE, m - j)
        for r0 in range(0, lq, TILE):
            rows = min(TILE, lq - r0)
            qc, gc = qh[:, r0:r0 + rows], gh[:, r0:r0 + rows]
            st = torch.einsum("emhd,elhd->ehml", kh[:, j:j + keys],
                              qc) * SCALE                    # [E,H,keys,rows]
            dpt = torch.einsum("emhd,elhd->ehml", vh[:, j:j + keys], gc)
            mx = row_max[..., None, r0:r0 + rows]
            p = torch.exp(st - mx) / row_sum[..., None, r0:r0 + rows]
            kept = None if keep is None else _keep_t(
                seed, e, h, r0, rows, j, keys, m, rate)
            dropped = p if kept is None else torch.where(kept, p * inv, 0.0)
            hi = dropped.to(torch.bfloat16).float()
            lo = (dropped - hi).to(torch.bfloat16).float()
            ds = (p * (d_probs(dpt, kept) - delta[..., None, r0:r0 + rows])
                  * SCALE).to(dtype).float()
            dv[:, j:j + keys] += torch.einsum("ehml,elhd->emhd", hi, gc) \
                + torch.einsum("ehml,elhd->emhd", lo, gc)
            dk[:, j:j + keys] += torch.einsum("ehml,elhd->emhd", ds, qc)
    return tuple(x.to(dtype) for x in (dq, dk, dv))


def emulate_k9(q, k, v, g, seed, rate, num_heads):
    """Folded q, g [E, Lq, H*D]; k, v [E, M, H*D] -> folded (dq, dk, dv):
    the shared passes on the [E, L, H, D] views."""
    grads = emulate_tc_bwd(*(tat._heads(x, num_heads) for x in (q, k, v, g)),
                           seed, rate)
    return tuple(x.flatten(-2) for x in grads)


def _k9_inputs(seed, e, lq, m, h, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(scale=0.5, size=s).astype(np.float32)
              for s in ((e, lq, h * D), (e, m, h * D), (e, m, h * D),
                        (e, lq, h * D))]
    jd, td = DTYPES[dtype]
    return [jnp.asarray(a, jd) for a in arrays], [t(a, td) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,m", [(32, 77), (40, 45), (70, 77)])
def test_k9_tc_order_matches_pallas(dtype, rate, lq, m):
    """Lq 32, 40 (one row tile) and 70 (two row chunks), ragged M (77:
    two key tiles, the second of 13 keys; 45: one)."""
    e, h = 2, 2
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _k9_inputs(lq + m, e, lq, m, h,
                                                    dtype)
    refs = jpat._bwd_impl_folded(jq, jk, jv, None,
                                 jnp.array([SEED], jnp.int32), jg, rate, h,
                                 interpret=True)
    outs = emulate_k9(tq, tk, tv, tg, SEED, rate, h)
    plains = tat.attention_train_folded_bwd_plain(tq, tk, tv, None, SEED, tg,
                                                  rate, num_heads=h)
    for out, ref, plain in zip(outs, refs, plains):
        assert out.shape == ref.shape and out.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(f32(out), f32(ref), atol=GRAD_TOL[dtype])
        np.testing.assert_allclose(f32(out), f32(plain),
                                   atol=GRAD_TOL[dtype])


def test_k9_transposed_mask_is_the_row_pass_mask():
    """The key pass's hash of (row = r0 + j, key = key0 + i) is the K5
    mask transposed; swapping row and key gives another mask at rate > 0."""
    e, h, lq, m, rate = 2, 3, 70, 77, 0.1
    keep = tat.keep_mask(SEED, torch.arange(e).view(e, 1),
                         torch.arange(h).view(1, h), lq, m, rate)
    kt = _keep_t(SEED, e, h, 64, 6, 64, 13, m, rate)
    assert torch.equal(kt, keep[..., 64:70, 64:77].transpose(-1, -2))
    assert not torch.equal(kt, _keep_t(SEED, e, h, 64, 13, 64, 6, m, rate)
                           .transpose(-1, -2))


@pytest.mark.parametrize("dtype,bias,folded,tc", [
    (torch.bfloat16, None, True, True),
    (torch.bfloat16, torch.zeros(1, 4, 4), True, False),
    (torch.float32, None, True, False),
    (torch.bfloat16, None, False, True),             # K7 on them too
])
def test_k9_route_predicate(dtype, bias, folded, tc):
    assert tat.bwd_uses_tensor_cores(dtype, bias, folded) == tc


class _FakeTrainLibrary:
    """Stands in for the train library: its backward entry points return
    ``code`` without launching anything."""

    def __init__(self, code: int):
        self.code = code

    def crc_attention_train_max_keys(self):
        return 1000

    def crc_attention_train_folded_backward(self, *args):
        return self.code

    crc_attention_train_backward = crc_attention_train_folded_backward


@pytest.mark.parametrize("code,exc,match", [
    (ck.REFUSED_ALIGNMENT, ValueError, "aligned"),
    (700, RuntimeError, "K9 launch failed: cudaError 700"),
])
def test_k9_wrapper_raises_on_the_entry_points_codes(monkeypatch, code, exc,
                                                     match):
    from candidate_reranking_cir_tpu_torch.ops import build

    monkeypatch.setattr(build, "load",
                        lambda name: _FakeTrainLibrary(code))
    monkeypatch.setattr(tat, "_stream", lambda device: 0)
    q, k, v, g = (torch.zeros(2, n, 2, D, dtype=torch.bfloat16)
                  for n in (4, 9, 9, 4))
    before = tat.LAUNCHES["K9"]
    with pytest.raises(exc, match=match):
        tat._kernel_bwd(q, k, v, None, 0, g, 0.1, folded=True)
    assert tat.LAUNCHES["K9"] == before


@pytest.mark.parametrize("name,family", [
    ("void crc::tc::attn_bwd_tc_rows_kernel<1>(__nv_bfloat16 const*, ...)",
     chip_smoke.TC_K9_FAMILY),
    ("void crc::tc::attn_bwd_tc_rows_kernel<2>(...)", chip_smoke.TC_K9_FAMILY),
    ("crc::tc::attn_bwd_tc_keys_kernel(__nv_bfloat16 const*, ...)",
     chip_smoke.TC_K9_FAMILY),
    ("void (anonymous namespace)::attn_bwd_rows_folded_kernel<float, false>"
     "(...)", chip_smoke.FMA_K9_FAMILY),
    ("void (anonymous namespace)::attn_bwd_keys_folded_kernel<__nv_bfloat16,"
     " true>(...)", chip_smoke.FMA_K9_FAMILY),
    ("void crc::tc::attn_fwd_tc_kernel<1, true>(...)", chip_smoke.TC_FAMILY),
])
def test_profile_families_name_the_new_kernels(name, family):
    assert chip_smoke.kernel_family(name) == family
    assert (family in chip_smoke.FMA_FAMILIES) == ("FMA" in family)
