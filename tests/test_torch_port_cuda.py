"""CUDA kernels K1-K9 against their plain PyTorch versions, on the card
(bf16 K1-K4 on the tensor-core eval kernel, fp32 on the fp32-FMA one; bf16
K6-K9 without a bias on the tensor-core train kernels; the fp32 and bias
launches of K6-K9 on fp32-FMA kernels).

Marked ``cuda``: they skip where no card is present. On a machine with a
card (which need not have JAX), run them without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: fp32 atol 2e-5 forward and 3e-5 gradients, bf16 atol 2e-2
(tests/test_pallas_attention*); the K5 mask bit for bit.
"""
import ctypes

import numpy as np
import pytest
import torch

from candidate_reranking_cir_tpu_torch.ops import attention as tattn
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # built and loaded before any test captures a graph
    from candidate_reranking_cir_tpu_torch.ops import build

    build.load_attention_library()
    build.load_attention_train_library()
    return torch.device("cuda")


def _rand(dev, dtype, *shape, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev, dtype)


def _mask_bias(dev, e, m):
    lens = torch.arange(e) % m + 1
    mask = (torch.arange(m)[None] < lens[:, None]).float()
    return tattn.make_additive_mask(mask.to(dev))      # [E, 1, 1, M]


def _demangle(name: bytes) -> str:
    demangle = ctypes.CDLL("libstdc++.so.6")["__cxa_demangle"]
    demangle.restype = ctypes.c_void_p
    demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int(1)
    out = demangle(name, None, None, ctypes.byref(status))
    return ctypes.string_at(out).decode() if status.value == 0 and out \
        else name.decode()


def _graph_kernel_names(graph: int) -> set:
    """The demangled names of a cudaGraph_t's kernel nodes, from libcuda
    (cuGraphKernelNodeGetParams_v2: the node's CUfunction at offset 0 of
    its params, or its CUkernel at offset 56)."""
    cuda = ctypes.CDLL("libcuda.so.1")

    def check(err):
        assert err == 0, f"libcuda error {err}"

    count = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(ctypes.c_void_p(graph), None,
                               ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                               ctypes.byref(count)))
    names = set()
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_uint64 * 16)()
        check(cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                 params))
        name = ctypes.c_char_p()
        if params[0]:
            check(cuda.cuFuncGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params[0])))
        else:
            check(cuda.cuKernelGetName(ctypes.byref(name),
                                       ctypes.c_void_p(params[7])))
        names.add(_demangle(name.value))
    return names


def _kernel_names(fn) -> set:
    """Names of the device kernels one call of ``fn`` launches: the call is
    captured in a CUDA graph, whose kernel nodes libcuda names, and the
    graph is replayed once, so that what ``fn`` returns holds its results.
    (Not the profiler: on the card it loses a kernel's record now and
    then.)"""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    names = _graph_kernel_names(graph.raw_cuda_graph())
    graph.replay()
    torch.cuda.synchronize()
    return names


def _launched(names: set, kernel: str) -> bool:
    return any(kernel in n for n in names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,lq,m", [(2, 577, 577), (3, 1, 23), (2, 40, 577)])
def test_folded_kernels_match_plain(dev, dtype, e, lq, m):
    h = 12
    q = _rand(dev, dtype, e, lq, h * 64, seed=1)
    k = _rand(dev, dtype, e, m, h * 64, seed=2)
    v = _rand(dev, dtype, e, m, h * 64, seed=3)
    for kid, bias in (("K1", None), ("K4", _mask_bias(dev, e, m))):
        before = ck.LAUNCHES[kid]
        out = ck.fused_attention_folded(q, k, v, bias, num_heads=h)
        torch.cuda.synchronize()
        assert ck.LAUNCHES[kid] == before + 1
        b3 = None if bias is None else bias[:, 0].expand(e, lq, m)
        ref = ck.attention_plain(q.unflatten(-1, (h, 64)),
                                 k.unflatten(-1, (h, 64)),
                                 v.unflatten(-1, (h, 64)), b3).flatten(-2)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfolded_kernels_match_plain(dev, dtype):
    a, b, lq, m, h = 3, 4, 9, 577, 12
    q = _rand(dev, dtype, a, b, lq, h, 64, seed=4)
    k = _rand(dev, dtype, a, m, h, 64, seed=5)
    v = _rand(dev, dtype, a, m, h, 64, seed=6)
    before = ck.LAUNCHES["K3"]
    out = tattn.grid_cross_attention(q, k, v)
    assert ck.LAUNCHES["K3"] == before + 1
    ref = ck.attention_plain(q.reshape(a, b * lq, h, 64), k, v)
    torch.testing.assert_close(out.reshape(a, b * lq, h, 64).float(),
                               ref.float(), rtol=0, atol=TOL[dtype])

    qs = _rand(dev, dtype, a, b, lq, h, 64, seed=7)
    mask = torch.ones(a, b, lq, device=dev)
    mask[0, 1, 5:] = 0
    mask[2, 3, 1:] = 0
    bias = tattn.make_additive_mask(mask)
    before = ck.LAUNCHES["K2"]
    out = tattn.dot_product_attention(qs, qs, qs, bias)
    assert ck.LAUNCHES["K2"] == before + 1
    flat = qs.reshape(a * b, lq, h, 64)
    ref = ck.attention_plain(flat, flat, flat,
                             bias.reshape(a * b, 1, 1, lq)[:, 0]
                             .expand(a * b, lq, lq))
    torch.testing.assert_close(out.reshape(a * b, lq, h, 64).float(),
                               ref.float(), rtol=0, atol=TOL[dtype])


# ---------------------------------------------------------------------------
# the tensor-core kernel (bf16, no bias: K1 and K3)


def _tc_check(dev, e, lq, m, h, seed, q_scale=1.0):
    """K3 (unfolded) and K1 (folded) on the same bf16 inputs against the
    plain version; each must launch its own kernel id once."""
    q = _rand(dev, torch.float32, e, lq, h, 64, seed=seed) * q_scale
    q = q.to(torch.bfloat16)
    k = _rand(dev, torch.bfloat16, e, m, h, 64, seed=seed + 1)
    v = _rand(dev, torch.bfloat16, e, m, h, 64, seed=seed + 2)
    ref = ck.attention_plain(q, k, v)
    before = dict(ck.LAUNCHES)
    out3 = ck.fused_attention(q, k, v)
    out1 = ck.fused_attention_folded(q.flatten(-2), k.flatten(-2),
                                     v.flatten(-2), num_heads=h)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["K3"] == before["K3"] + 1
    assert ck.LAUNCHES["K1"] == before["K1"] + 1
    for out in (out3, out1.unflatten(-1, (h, 64))):
        assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("m", [1, 40, 64, 65, 577])
@pytest.mark.parametrize("lq", [1, 40, 63, 64, 65, 577, 1280])
def test_tc_kernel_matches_plain(dev, lq, m):
    _tc_check(dev, 2, lq, m, 3, seed=100 + lq + m)


def test_tc_kernel_large_scores_and_many_keys(dev):
    """|q.k|/8 up to about 30 (the max subtraction carries the softmax),
    and more keys than the fp32-FMA kernel's shared-memory cap."""
    _tc_check(dev, 3, 130, 577, 2, seed=200, q_scale=6.0)
    _tc_check(dev, 1, 40, 3000, 2, seed=210)


def test_tc_kernel_strided_views(dev):
    """Folded q/k/v sliced out of one fused projection (row stride 3 x
    768), and pair_cross_attention's transposed q (a view for one query, a
    copy for three)."""
    e, lq, m, h = 2, 70, 577, 12
    qkv = _rand(dev, torch.bfloat16, e, lq, 3 * h * 64, seed=220)
    q, k, v = qkv.chunk(3, dim=-1)
    assert q.stride(1) == 3 * h * 64
    out = ck.fused_attention_folded(q, k, v, num_heads=h)
    ref = ck.attention_plain(*(x.unflatten(-1, (h, 64)) for x in (q, k, v)))
    torch.testing.assert_close(out.unflatten(-1, (h, 64)).float(),
                               ref.float(), rtol=0, atol=TOL[torch.bfloat16])
    for n_q in (1, 3):
        n_c, lq = 4, 24
        qp = _rand(dev, torch.bfloat16, n_q, n_c, lq, h, 64, seed=230 + n_q)
        kp = _rand(dev, torch.bfloat16, n_c, m, h, 64, seed=240)
        vp = _rand(dev, torch.bfloat16, n_c, m, h, 64, seed=241)
        before = ck.LAUNCHES["K3"]
        out = tattn.pair_cross_attention(qp, kp, vp)
        assert ck.LAUNCHES["K3"] == before + 1
        qt = qp.transpose(0, 1).reshape(n_c, n_q * lq, h, 64)
        ref = ck.attention_plain(qt, kp, vp).reshape(n_c, n_q, lq, h, 64)
        torch.testing.assert_close(out.float(), ref.transpose(0, 1).float(),
                                   rtol=0, atol=TOL[torch.bfloat16])


def test_tc_kernel_refuses_misaligned_views(dev):
    x = _rand(dev, torch.bfloat16, 2, 8, 1, 72)
    q = x[..., 4:68]                       # base pointer 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        ck.fused_attention(q, q, q)
    y = _rand(dev, torch.bfloat16, 2, 8, 1 * 68)[..., :64]  # row stride 68
    with pytest.raises(ValueError, match="aligned"):
        ck.fused_attention_folded(y, y, y, num_heads=1)


def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    q = _rand(dev, torch.float32, 2, 8, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        ck.fused_attention(q, q, q)
    q = _rand(dev, torch.float16, 2, 8, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        ck.fused_attention(q, q, q)
    q = _rand(dev, torch.float32, 1, 4, 1, 64)
    kv = _rand(dev, torch.float32, 1, 5000, 1, 64)
    with pytest.raises(ValueError, match="keys"):
        ck.fused_attention(q, kv, kv)


# ---------------------------------------------------------------------------
# the tensor-core kernel with a bias (bf16: K2 and K4)


def _full_bias(dev, e, lq, m, seed):
    """[E, 1, Lq, M] fp32: a random additive bias with masked (-10000)
    keys, and in entry 0 a row masked everywhere but one key and a row
    masked everywhere."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bias = torch.randn(e, 1, lq, m, generator=g)
    bias[torch.rand(e, 1, lq, m, generator=g) < 0.3] = -10000.0
    bias[0, 0, 0] = -10000.0
    bias[0, 0, 0, m // 2] = 0.0
    if lq > 1:
        bias[0, 0, 1] = -10000.0
    return bias.to(dev)


def _bias_check(dev, e, lq, m, h, bias, seed):
    """K2 (unfolded) and K4 (folded) on the same bf16 inputs with ``bias``
    against the plain version, each launching the tensor-core kernel once
    and the fp32-FMA one never."""
    q = _rand(dev, torch.bfloat16, e, lq, h, 64, seed=seed)
    k = _rand(dev, torch.bfloat16, e, m, h, 64, seed=seed + 1)
    v = _rand(dev, torch.bfloat16, e, m, h, 64, seed=seed + 2)
    ref = ck.attention_plain(q, k, v, bias[:, 0].expand(e, lq, m))
    before = dict(ck.LAUNCHES)
    outs = {}
    names = _kernel_names(lambda: outs.update(
        K2=ck.fused_attention(q, k, v, bias),
        K4=ck.fused_attention_folded(q.flatten(-2), k.flatten(-2),
                                     v.flatten(-2), bias, num_heads=h)))
    assert ck.LAUNCHES["K2"] == before["K2"] + 1
    assert ck.LAUNCHES["K4"] == before["K4"] + 1
    assert _launched(names, "attn_fwd_tc_kernel")
    assert not _launched(names, "attn_fwd_kernel<")
    for out in (outs["K2"], outs["K4"].unflatten(-1, (h, 64))):
        assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=TOL[torch.bfloat16])
    return q, k, v, outs


@pytest.mark.parametrize("lq,m", [(8, 8), (40, 40), (40, 77), (577, 577)])
def test_tc_bias_kernel_matches_plain_key_mask(dev, lq, m):
    """The key mask broadcast over the rows (row stride 0), as the text
    self-attention hands it."""
    e = 5
    bias = _mask_bias(dev, e, m)
    assert bias[:, 0].expand(e, lq, m).stride(1) == 0
    _bias_check(dev, e, lq, m, 12, bias, seed=300 + lq + m)


@pytest.mark.parametrize("lq,m", [(8, 8), (40, 40), (40, 77), (577, 577)])
def test_tc_bias_kernel_matches_plain_full_bias(dev, lq, m):
    """A full [E, Lq, M] bias; a row masked everywhere but one key gives
    that key's v row, exactly."""
    e = 3
    bias = _full_bias(dev, e, lq, m, seed=lq + m)
    _, _, v, outs = _bias_check(dev, e, lq, m, 4, bias, seed=400 + lq + m)
    assert torch.equal(outs["K2"][0, 0], v[0, m // 2])


def test_tc_bias_kernel_strided_views(dev):
    """q/k/v sliced out of one fused projection (K2's unfolded views and
    K4's folded ones), and a full bias sliced out of a wider tensor."""
    e, lq, h = 3, 40, 12
    qkv = _rand(dev, torch.bfloat16, e, lq, 3 * h * 64, seed=500)
    q, k, v = qkv.chunk(3, dim=-1)
    wide = _full_bias(dev, e, lq, lq + 9, seed=501)
    bias = wide[..., :lq]
    assert bias.stride(2) == lq + 9
    b3 = bias[:, 0].expand(e, lq, lq)
    ref = ck.attention_plain(*(x.unflatten(-1, (h, 64)) for x in (q, k, v)),
                             b3)
    out4 = ck.fused_attention_folded(q, k, v, bias, num_heads=h)
    out2 = ck.fused_attention(*(x.unflatten(-1, (h, 64)) for x in (q, k, v)),
                              bias)
    for out in (out2, out4.unflatten(-1, (h, 64))):
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# K1-K4 gradients: kernel forward, plain-recompute backward


@pytest.mark.parametrize("folded,with_bias", [(True, False), (False, True),
                                              (False, False), (True, True)])
def test_eval_kernels_have_plain_gradients(dev, folded, with_bias):
    e, lq, m, h = 2, 40, 577, 12
    shape_q = (e, lq, h * 64) if folded else (e, lq, h, 64)
    shape_kv = (e, m, h * 64) if folded else (e, m, h, 64)
    q = _rand(dev, torch.float32, *shape_q, seed=8).requires_grad_()
    k = _rand(dev, torch.float32, *shape_kv, seed=9).requires_grad_()
    v = _rand(dev, torch.float32, *shape_kv, seed=10).requires_grad_()
    g = _rand(dev, torch.float32, *shape_q, seed=11)
    bias = _mask_bias(dev, e, m) if with_bias else None
    if folded:
        out = ck.fused_attention_folded(q, k, v, bias, num_heads=h)
    else:
        out = ck.fused_attention(q, k, v, bias)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), g)

    def as4(x):
        return x.unflatten(-1, (h, 64)) if folded else x

    b3 = None if bias is None else bias[:, 0].expand(e, lq, m)
    ref = ck.attention_plain(as4(q), as4(k), as4(v), b3)
    refs = torch.autograd.grad(ref, (q, k, v), as4(g))
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-5)


# ---------------------------------------------------------------------------
# K5-K7 against their plain versions

GRAD_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("seed,b,h,rows,cols", [
    (12345, 0, 0, 640, 577), (-2 ** 31, 15, 11, 640, 577),
    (2 ** 31 - 1, 9_000_000, 3, 33, 65)])
def test_k5_mask_bit_exact(dev, seed, b, h, rows, cols):
    out = tat.write_keep_mask(torch.empty(rows, cols, dtype=torch.uint8,
                                          device=dev), seed, b, h, 0.1)
    ref = tat.keep_mask(seed, b, h, rows, cols, 0.1, device=dev)
    assert torch.equal(out.bool(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,lq,m,with_bias", [(3, 37, 45, True),
                                              (16, 640, 577, False)])
def test_k6_k7_match_plain(dev, dtype, e, lq, m, with_bias):
    h, seed, rate = 12, -99, 0.1
    q = _rand(dev, dtype, e, lq, h, 64, seed=12)
    k = _rand(dev, dtype, e, m, h, 64, seed=13)
    v = _rand(dev, dtype, e, m, h, 64, seed=14)
    g = _rand(dev, dtype, e, lq, h, 64, seed=15)
    bias = None
    if with_bias:
        bias = tat._train_bias3(_mask_bias(dev, e, m), e, lq, m)
    before = dict(tat.LAUNCHES)
    outs, grads = [], []
    names = _kernel_names(lambda: (
        outs.append(tat._kernel_fwd(q, k, v, bias, seed, rate)),
        grads.extend(tat._kernel_bwd(q, k, v, bias, seed, g, rate))))
    out = outs[0]
    assert tat.LAUNCHES["K6"] == before["K6"] + 1
    assert tat.LAUNCHES["K7"] == before["K7"] + 1
    # the route: bf16 without a bias on the tensor-core kernels only
    tc = dtype == torch.bfloat16 and not with_bias
    assert tat.fwd_uses_tensor_cores(dtype, bias, False) == tc
    assert tat.bwd_uses_tensor_cores(dtype, bias, False) == tc
    assert _launched(names, "attn_train_fwd_tc_kernel") == tc
    assert _launched(names, "attn_train_fwd_kernel<") != tc
    for kernel in ("attn_train_bwd_tc_rows_kernel",
                   "attn_train_bwd_tc_keys_kernel"):
        assert _launched(names, kernel) == tc
    for kernel in ("attn_bwd_rows_kernel<", "attn_bwd_keys_kernel<"):
        assert _launched(names, kernel) != tc
    assert not _launched(names, "attn_bwd_tc_rows_kernel")   # K9's
    ref = tat.attention_train_plain(q, k, v, bias, seed, rate)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])
    refs = tat.attention_train_bwd_plain(q, k, v, bias, seed, g, rate)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=GRAD_TOL[dtype])


def test_train_attention_autograd_on_the_card(dev):
    """fused_attention_train's autograd.Function: K6 forward, K7 backward."""
    e, lq, m, h = 2, 130, 300, 12
    q = _rand(dev, torch.float32, e, lq, h, 64, seed=16).requires_grad_()
    k = _rand(dev, torch.float32, e, m, h, 64, seed=17).requires_grad_()
    v = _rand(dev, torch.float32, e, m, h, 64, seed=18).requires_grad_()
    g = _rand(dev, torch.float32, e, lq, h, 64, seed=19)
    out = tat.fused_attention_train(q, k, v, None, 7, 0.1)
    grads = torch.autograd.grad(out, (q, k, v), g)
    refs = tat.attention_train_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         None, 7, g, 0.1)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-5)


def test_train_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = _rand(dev, torch.float32, 2, 8, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        tat.fused_attention_train(q, q, q, None, 0, 0.1)
    q = _rand(dev, torch.float16, 2, 8, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        tat.fused_attention_train(q, q, q, None, 0, 0.1)
    q = _rand(dev, torch.float32, 1, 4, 1, 64)
    kv = _rand(dev, torch.float32, 1, 5000, 1, 64)
    with pytest.raises(ValueError, match="keys"):
        tat.fused_attention_train(q, kv, kv, None, 0, 0.1)
    with pytest.raises(ValueError, match="int32"):
        tat.fused_attention_train(q, q, q, None, 2 ** 31, 0.1)
    qf = _rand(dev, torch.float16, 2, 8, 128)
    with pytest.raises(ValueError, match="dtype"):
        tat.fused_attention_train_folded(qf, qf, qf, None, 0, 0.1,
                                         num_heads=2)
    qf = _rand(dev, torch.float32, 2, 8, 256)[..., ::2]  # strided heads
    with pytest.raises(ValueError, match="stride"):
        tat.fused_attention_train_folded(qf, qf, qf, None, 0, 0.1,
                                         num_heads=2)


# ---------------------------------------------------------------------------
# K8/K9 (head-folded) against their plain versions


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,lq,m,with_bias", [(3, 37, 45, True),
                                              (64, 40, 577, False),
                                              (16, 24, 577, True)])
def test_k8_k9_match_plain(dev, dtype, e, lq, m, with_bias):
    h, seed, rate = 12, 2 ** 31 - 5, 0.1
    q = _rand(dev, dtype, e, lq, h * 64, seed=20)
    k = _rand(dev, dtype, e, m, h * 64, seed=21)
    v = _rand(dev, dtype, e, m, h * 64, seed=22)
    g = _rand(dev, dtype, e, lq, h * 64, seed=23)
    bias = None
    if with_bias:
        bias = tat._train_bias3(_mask_bias(dev, e, m), e, lq, m)
    heads = [tat._heads(x, h) for x in (q, k, v, g)]
    before = dict(tat.LAUNCHES)
    out = tat._kernel_fwd(*heads[:3], bias, seed, rate, folded=True)
    grads = []
    names = _kernel_names(lambda: grads.extend(tat._kernel_bwd(
        *heads[:3], bias, seed, heads[3], rate, folded=True)))
    assert tat.LAUNCHES["K8"] == before["K8"] + 1
    assert tat.LAUNCHES["K9"] == before["K9"] + 1
    # the route: bf16 without a bias on the tensor-core passes only
    tc = tat.bwd_uses_tensor_cores(dtype, bias, True)
    assert tc == (dtype == torch.bfloat16 and not with_bias)
    for kernel in ("attn_bwd_tc_rows_kernel", "attn_bwd_tc_keys_kernel"):
        assert _launched(names, kernel) == tc
    for kernel in ("attn_bwd_rows_folded_kernel",
                   "attn_bwd_keys_folded_kernel"):
        assert _launched(names, kernel) != tc
    assert tat.LAUNCHES["K6"] == before["K6"]
    assert tat.LAUNCHES["K7"] == before["K7"]
    ref = tat.attention_train_folded_plain(q, k, v, bias, seed, rate,
                                           num_heads=h)
    torch.testing.assert_close(out.flatten(-2).float(), ref.float(), rtol=0,
                               atol=TOL[dtype])
    refs = tat.attention_train_folded_bwd_plain(q, k, v, bias, seed, g, rate,
                                                num_heads=h)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a.flatten(-2).float(), b.float(), rtol=0,
                                   atol=GRAD_TOL[dtype])


@pytest.mark.parametrize("with_bias", [False, True])
def test_folded_train_attention_autograd_on_the_card(dev, with_bias):
    """fused_attention_train_folded's autograd: K8 forward, K9 backward,
    against the plain versions (fp32)."""
    e, lq, m, h = 8, 40, 577, 12
    q = _rand(dev, torch.float32, e, lq, h * 64, seed=24).requires_grad_()
    k = _rand(dev, torch.float32, e, m, h * 64, seed=25).requires_grad_()
    v = _rand(dev, torch.float32, e, m, h * 64, seed=26).requires_grad_()
    g = _rand(dev, torch.float32, e, lq, h * 64, seed=27)
    bias = _mask_bias(dev, e, m) if with_bias else None
    before = dict(tat.LAUNCHES)
    out = tat.fused_attention_train_folded(q, k, v, bias, -3, 0.1,
                                           num_heads=h)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert tat.LAUNCHES["K8"] == before["K8"] + 1
    assert tat.LAUNCHES["K9"] == before["K9"] + 1
    b3 = None if bias is None else tat._train_bias3(bias, e, lq, m)
    ref = tat.attention_train_folded_plain(q.detach(), k.detach(), v.detach(),
                                           b3, -3, 0.1, num_heads=h)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    refs = tat.attention_train_folded_bwd_plain(
        q.detach(), k.detach(), v.detach(), b3, -3, g, 0.1, num_heads=h)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-5)


# ---------------------------------------------------------------------------
# K9 on the tensor cores (bf16, no bias)


def _k9_inputs(dev, e, lq, m, h, seed):
    return [_rand(dev, torch.bfloat16, e, n, h * 64, seed=seed + i)
            for i, n in enumerate((lq, m, m, lq))]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [577, 45])
@pytest.mark.parametrize("lq", [32, 40, 64, 130])
def test_k9_tensor_cores_match_plain(dev, lq, m, rate):
    e, h, seed = 6, 12, 12345
    q, k, v, g = _k9_inputs(dev, e, lq, m, h, seed=600 + lq + m)
    heads = [tat._heads(x, h) for x in (q, k, v, g)]
    grads = []
    names = _kernel_names(lambda: grads.extend(tat._kernel_bwd(
        *heads[:3], None, seed, heads[3], rate, folded=True)))
    assert _launched(names, "attn_bwd_tc_rows_kernel")
    assert _launched(names, "attn_bwd_tc_keys_kernel")
    assert not _launched(names, "attn_bwd_rows_folded_kernel")
    refs = tat.attention_train_folded_bwd_plain(q, k, v, None, seed, g, rate,
                                                num_heads=h)
    for a, b in zip(grads, refs):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        torch.testing.assert_close(a.flatten(-2).float(), b.float(), rtol=0,
                                   atol=GRAD_TOL[torch.bfloat16])


def test_k9_tensor_cores_autograd(dev):
    """fused_attention_train_folded's autograd in bf16 without a bias: K8
    forward, K9 backward on the tensor cores, against the plain versions."""
    e, lq, m, h, seed, rate = 8, 40, 577, 12, -7, 0.1
    q, k, v, g = _k9_inputs(dev, e, lq, m, h, seed=700)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(tat.LAUNCHES)
    out = tat.fused_attention_train_folded(*x, None, seed, rate, num_heads=h)
    grads = torch.autograd.grad(out, x, g)
    assert tat.LAUNCHES["K8"] == before["K8"] + 1
    assert tat.LAUNCHES["K9"] == before["K9"] + 1
    refs = tat.attention_train_folded_bwd_plain(q, k, v, None, seed, g, rate,
                                                num_heads=h)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=GRAD_TOL[torch.bfloat16])


def test_k9_tensor_cores_refuse_misaligned_views(dev):
    """A base pointer 8 bytes off: the entry point refuses it and the
    wrapper raises a ValueError."""
    e, lq, m, h = 2, 40, 577, 12
    x = _rand(dev, torch.bfloat16, e, lq, h * 64 + 8)[..., 4:4 + h * 64]
    k, v = (_rand(dev, torch.bfloat16, e, m, h * 64, seed=s) for s in (1, 2))
    heads = [tat._heads(t, h) for t in (x, k, v)]
    with pytest.raises(ValueError, match="aligned"):
        tat._kernel_bwd(*heads, None, 0, tat._heads(x.contiguous(), h), 0.1,
                        folded=True)


# ---------------------------------------------------------------------------
# K6 and K7 on the tensor cores (bf16, no bias)


def _k6_k7_check(dev, q, k, v, g, seed, rate):
    """K6 and K7 on bf16 [E, L, H, D] views against the plain versions,
    each on its tensor-core kernels only; dk and dv (sums over all rows)
    are held, like dq, within GRAD_TOL of each reference's max |value|."""
    outs, grads = [], []
    names = _kernel_names(lambda: (
        outs.append(tat._kernel_fwd(q, k, v, None, seed, rate)),
        grads.extend(tat._kernel_bwd(q, k, v, None, seed, g, rate))))
    for kernel in ("attn_train_fwd_tc_kernel", "attn_train_bwd_tc_rows_kernel",
                   "attn_train_bwd_tc_keys_kernel"):
        assert _launched(names, kernel)
    for kernel in ("attn_train_fwd_kernel<", "attn_bwd_rows_kernel<",
                   "attn_bwd_keys_kernel<", "attn_bwd_tc_rows_kernel"):
        assert not _launched(names, kernel)
    ref = tat.attention_train_plain(q, k, v, None, seed, rate)
    assert outs[0].dtype == torch.bfloat16 and torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0].float(), ref.float(), rtol=0,
                               atol=TOL[torch.bfloat16])
    refs = tat.attention_train_bwd_plain(q, k, v, None, seed, g, rate)
    for a, b in zip(grads, refs):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= GRAD_TOL[torch.bfloat16] * b.float().abs().max().item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [577, 45])
@pytest.mark.parametrize("lq", [64, 130, 640])
def test_k6_k7_tensor_cores_match_plain(dev, lq, m, rate):
    """64 rows (one block of K6 and of K7's row pass, one key-pass
    chunk), 130 (K6's two-warpgroup blocks, a partial one; three row
    blocks and chunks of K7) and the stage-II width (640: ten row blocks
    and chunks)."""
    e, h, seed = 4, 12, 424242
    q, g = (_rand(dev, torch.bfloat16, e, lq, h, 64, seed=800 + i + lq + m)
            for i in (0, 1))
    k, v = (_rand(dev, torch.bfloat16, e, m, h, 64, seed=810 + i + lq + m)
            for i in (0, 1))
    _k6_k7_check(dev, q, k, v, g, seed, rate)


def test_k6_k7_tensor_cores_strided_views(dev):
    """q, k, v sliced out of fused projections (row strides 3 x 768 and
    2 x 768), g a transposed copy's view, on the tensor-core route."""
    e, lq, m, h = 3, 130, 577, 12
    qx = _rand(dev, torch.bfloat16, e, lq, 3 * h * 64, seed=900)
    kv = _rand(dev, torch.bfloat16, e, m, 2 * h * 64, seed=901)
    q = qx[..., h * 64:2 * h * 64].unflatten(-1, (h, 64))
    k, v = (x.unflatten(-1, (h, 64)) for x in kv.chunk(2, dim=-1))
    assert q.stride(1) == 3 * h * 64 and k.stride(1) == 2 * h * 64
    g = _rand(dev, torch.bfloat16, lq, e, h, 64, seed=902).transpose(0, 1)
    assert not g.is_contiguous()
    _k6_k7_check(dev, q, k, v, g, 5, 0.1)


def test_k6_k7_tensor_cores_refuse_misaligned_views(dev):
    """A base pointer 8 bytes off: the entry points refuse it and the
    wrappers raise a ValueError; nothing runs on the FMA kernels."""
    e, lq, m, h = 2, 130, 577, 12
    x = _rand(dev, torch.bfloat16, e, lq, h * 64 + 8)[..., 4:4 + h * 64]
    q = x.unflatten(-1, (h, 64))
    k, v = (_rand(dev, torch.bfloat16, e, m, h, 64, seed=s) for s in (1, 2))
    g = q.contiguous()
    before = dict(tat.LAUNCHES)
    with pytest.raises(ValueError, match="K6.*aligned"):
        tat._kernel_fwd(q, k, v, None, 0, 0.1)
    with pytest.raises(ValueError, match="K7.*aligned"):
        tat._kernel_bwd(q, k, v, None, 0, g, 0.1)
    assert tat.LAUNCHES == before


def test_k6_k7_tensor_cores_autograd(dev):
    """fused_attention_train's autograd in bf16 without a bias, at the
    stage-II width: K6 forward and K7 backward on the tensor cores, against
    the plain versions."""
    e, lq, m, h, seed, rate = 4, 640, 577, 12, -11, 0.1
    q, g = (_rand(dev, torch.bfloat16, e, lq, h, 64, seed=950 + i)
            for i in (0, 1))
    k, v = (_rand(dev, torch.bfloat16, e, m, h, 64, seed=952 + i)
            for i in (0, 1))
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(tat.LAUNCHES)
    out = tat.fused_attention_train(*x, None, seed, rate)
    grads = torch.autograd.grad(out, x, g)
    assert tat.LAUNCHES["K6"] == before["K6"] + 1
    assert tat.LAUNCHES["K7"] == before["K7"] + 1
    ref = tat.attention_train_plain(q, k, v, None, seed, rate)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[torch.bfloat16])
    refs = tat.attention_train_bwd_plain(q, k, v, None, seed, g, rate)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=GRAD_TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# K8 on the tensor cores (bf16, no bias)


def _k8_inputs(dev, e, lq, m, h, seed):
    return [_rand(dev, torch.bfloat16, e, n, h * 64, seed=seed + i)
            for i, n in enumerate((lq, m, m))]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [64, 577, 640])
@pytest.mark.parametrize("lq", [1, 8, 32, 40, 64, 65, 100])
def test_k8_tensor_cores_match_plain(dev, lq, m, rate):
    """One key tile (64: the one-step form), the MED's 577 keys and ten
    full tiles (640); 1-64 rows in one warpgroup (idle warp halves at 1,
    8, 32 and 40 rows), 65 and 100 in two; four one-warpgroup blocks an
    SM, as the kernel's design has it."""
    e, h, seed = 6, 12, 2024
    q, k, v = _k8_inputs(dev, e, lq, m, h, seed=1000 + lq + m)
    if lq <= 64:
        assert tat.folded_forward_blocks_per_sm(lq, m) == 4
    outs = []
    before = dict(tat.LAUNCHES)
    names = _kernel_names(lambda: outs.append(tat._kernel_fwd(
        *(tat._heads(x, h) for x in (q, k, v)), None, seed, rate,
        folded=True)))
    assert tat.LAUNCHES["K8"] == before["K8"] + 1
    assert tat.LAUNCHES["K6"] == before["K6"]
    assert _launched(names, "attn_train_fwd_folded_tc_kernel<"
                     + ("1>" if lq <= 64 else "2>"))
    assert not _launched(names, "attn_train_fwd_folded_kernel<")
    assert not _launched(names, "attn_train_fwd_tc_kernel<")   # K6's
    out = outs[0]
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    ref = tat.attention_train_folded_plain(q, k, v, None, seed, rate,
                                           num_heads=h)
    torch.testing.assert_close(out.flatten(-2).float(), ref.float(), rtol=0,
                               atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("lq,m", [(32, 577), (40, 577), (64, 640), (1, 130),
                                  (40, 700), (100, 577), (32, 64)])
def test_k8_equals_k6_bit_for_bit(dev, lq, m):
    """K8 on [E, L, H*D] and K6 on the [E, L, H, D] copy of the same data
    give the same bits: K8's two-stage ring, its L2 hints and the folded
    stride change no output (K6 runs a three-stage ring)."""
    e, h, seed, rate = 8, 12, -31337, 0.1
    q, k, v = _k8_inputs(dev, e, lq, m, h, seed=1100 + lq + m)
    k8 = tat._kernel_fwd(*(tat._heads(x, h) for x in (q, k, v)), None, seed,
                         rate, folded=True)
    q4, k4, v4 = (tat._heads(x, h).contiguous() for x in (q, k, v))
    k6 = tat._kernel_fwd(q4, k4, v4, None, seed, rate)
    assert torch.equal(k8, k6)


def test_k8_tensor_cores_refuse_misaligned_views(dev):
    """A base pointer 8 bytes off: the entry point refuses it (before any
    launch), and the wrapper raises a ValueError and counts none."""
    e, lq, m, h = 2, 40, 577, 12
    x = _rand(dev, torch.bfloat16, e, lq, h * 64 + 8)[..., 4:4 + h * 64]
    k, v = (_rand(dev, torch.bfloat16, e, m, h * 64, seed=s) for s in (1, 2))
    heads = [tat._heads(t, h) for t in (x, k, v)]
    before = dict(tat.LAUNCHES)
    with pytest.raises(ValueError, match="K8.*aligned"):
        tat._kernel_fwd(*heads, None, 0, 0.1, folded=True)
    assert tat.LAUNCHES == before


@pytest.mark.parametrize("dtype,with_bias", [(torch.float32, False),
                                             (torch.float32, True),
                                             (torch.bfloat16, True)])
def test_k8_fp32_and_bias_stay_on_the_fma_body(dev, dtype, with_bias):
    e, lq, m, h, seed, rate = 8, 40, 577, 12, 5, 0.1
    q = _rand(dev, dtype, e, lq, h * 64, seed=1300)
    k = _rand(dev, dtype, e, m, h * 64, seed=1301)
    v = _rand(dev, dtype, e, m, h * 64, seed=1302)
    bias = tat._train_bias3(_mask_bias(dev, e, m), e, lq, m) \
        if with_bias else None
    assert not tat.fwd_uses_tensor_cores(dtype, bias, True)
    outs = []
    names = _kernel_names(lambda: outs.append(tat._kernel_fwd(
        *(tat._heads(x, h) for x in (q, k, v)), bias, seed, rate,
        folded=True)))
    assert _launched(names, "attn_train_fwd_folded_kernel<")
    assert not _launched(names, "attn_train_fwd_folded_tc_kernel")
    ref = tat.attention_train_folded_plain(q, k, v, bias, seed, rate,
                                           num_heads=h)
    torch.testing.assert_close(outs[0].flatten(-2).float(), ref.float(),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("lq", [32, 40])
def test_k8_k9_tensor_cores_gradient(dev, lq):
    """fused_attention_train_folded in bf16 without a bias at the stage-I
    MED's shape: K8 on the tensor cores forward, K9 backward, against the
    plain forward and backward."""
    e, m, h, seed, rate = 16, 577, 12, 99, 0.1
    q, k, v = _k8_inputs(dev, e, lq, m, h, seed=1400 + lq)
    g = _rand(dev, torch.bfloat16, e, lq, h * 64, seed=1410 + lq)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(tat.LAUNCHES)
    res = {}
    names = _kernel_names(lambda: res.update(
        out=tat.fused_attention_train_folded(*x, None, seed, rate,
                                             num_heads=h)))
    assert _launched(names, "attn_train_fwd_folded_tc_kernel")
    grads = torch.autograd.grad(res["out"], x, g)
    assert tat.LAUNCHES["K8"] == before["K8"] + 1
    assert tat.LAUNCHES["K9"] == before["K9"] + 1
    ref = tat.attention_train_folded_plain(q, k, v, None, seed, rate,
                                           num_heads=h)
    torch.testing.assert_close(res["out"].float(), ref.float(), rtol=0,
                               atol=TOL[torch.bfloat16])
    refs = tat.attention_train_folded_bwd_plain(q, k, v, None, seed, g, rate,
                                                num_heads=h)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=GRAD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,rows", [(256, 8), (64, 64), (128, 128),
                                    (32, 320)])
def test_k1_image_major_med_shapes_match_plain(dev, dtype, g, rows):
    """K1 at the stage-I eval's image-major MED cross-attention: Q queries
    of w tokens fold into Q*w rows (8 to 320) against each image's 577
    tokens; bf16 on the tensor cores, on a folded view of the rows."""
    h, m = 12, 577
    x = _rand(dev, dtype, g * 2, rows // 2, h * 64, seed=1500 + rows)
    q = x.view(g, rows, h * 64)        # [G*Q, w, D] -> [G, Q*w, D]
    k = _rand(dev, dtype, g, m, h * 64, seed=1501 + rows)
    v = _rand(dev, dtype, g, m, h * 64, seed=1502 + rows)
    res = {}
    names = _kernel_names(lambda: res.update(
        out=ck.fused_attention_folded(q, k, v, None, num_heads=h)))
    if dtype == torch.bfloat16:
        assert _launched(names, "attn_fwd_tc_kernel")
    ref = ck.attention_plain(q.unflatten(-1, (h, 64)),
                             k.unflatten(-1, (h, 64)),
                             v.unflatten(-1, (h, 64))).flatten(-2)
    torch.testing.assert_close(res["out"].float(), ref.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("ties", [False, True])
def test_ranked_slices_on_the_card_match_the_cpu(dev, ties):
    """The stage-I ranking on the card against the CPU at CIRR-val's corpus
    size: the stable top-w indices and the exact entity ranks. Entries are
    multiples of 2^-8 (with ``ties``: of 1/4, and duplicated corpus rows),
    so every product and distance is exact whatever the summation order
    and the two devices must agree bit for bit, ties included."""
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        ranked_slices,
    )

    g = torch.Generator().manual_seed(7)
    n_q, n, e = 300, 2297, 16
    if ties:
        idx = torch.randint(-2, 3, (n, e), generator=g).float() / 4
        idx[100:200] = idx[:100]
        pred = idx[torch.randint(0, n, (n_q,), generator=g)].clone()
    else:
        idx = torch.round(torch.randn(n, e, generator=g) * 64) / 256
        pred = torch.round(torch.randn(n_q, e, generator=g) * 64) / 256
    ent = torch.randint(0, n, (n_q, 7), generator=g).numpy()
    cpu = ranked_slices(pred, idx, 501, ent)
    card = ranked_slices(pred.to(dev), idx.to(dev), 501, ent)
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)


# head width 64, as the kernels take; 145 image tokens, so the ViT and the
# MED's cross-attention take the folded route (K1) as at full size
CARD_MODEL_CONFIG = {
    "vit": {"image_size": 192, "patch_size": 16, "hidden_size": 128,
            "num_layers": 1, "num_heads": 2},
    "text": {"vocab_size": 256, "hidden_size": 128, "num_layers": 2,
             "num_heads": 2, "intermediate_size": 256, "encoder_width": 128,
             "hidden_dropout": 0.0, "attention_dropout": 0.0,
             "merge_mlp_from": 1},
    "embed_dim": 32,
}


def _run_clis(root, flags, tag: str, capsys) -> dict:
    """validate -> top-K file -> validate_stage2, and both test1
    submissions, with ``flags``; their printed metrics and files."""
    from candidate_reranking_cir_tpu_torch.cli import (
        cirr_test_submission,
        cirr_test_submission_stage2,
        validate,
        validate_stage2,
    )
    from candidate_reranking_cir_tpu_torch.data.topk_io import load_topk_file

    s1, s2 = ["--stage1-path", str(root / "s1.pt")], \
        ["--stage2-path", str(root / "s2.pt")]
    topk, t1 = root / f"val_{tag}.npz", root / f"test1_{tag}.npz"
    sub = root / f"sub_{tag}"
    validate.main(flags + s1 + ["--save-topk", "--k", "8", "--topk-out",
                                str(topk), "--q-batch", "4"])
    validate_stage2.main(flags + s1 + s2 + ["--top-k-path", str(topk),
                                            "--K-value", "4"])
    cirr_test_submission.main(flags + s1 + [
        "--submission-name", "s1", "--out-dir", str(sub), "--save-topk",
        "--k", "4", "--topk-out", str(t1)])
    cirr_test_submission_stage2.main(flags + s1 + s2 + [
        "--top-k-path", str(t1), "--K-value", "4", "--submission-name", "s2",
        "--out-dir", str(sub)])
    printed = [line for line in capsys.readouterr().out.splitlines()
               if " = " in line]
    return {"printed": printed, "topk": load_topk_file(topk),
            "files": {p.name: p.read_bytes() for p in sorted(sub.iterdir())}}


def test_cli_round_trip_on_the_card(dev, tmp_path, capsys):
    """The four eval CLIs with --device cuda on a synthetic CIRR split
    (tests/test_torch_port_cli.py's) and small models of head width 64:
    in fp32 the same metrics, top-K file and submission files as on the
    CPU; in bf16 they run through K1-K3 and give metrics in [0, 100]."""
    pytest.importorskip("PIL")
    from test_torch_port_cli import common_flags, make_workdir

    make_workdir(tmp_path, CARD_MODEL_CONFIG)
    size = CARD_MODEL_CONFIG["vit"]["image_size"]
    runs = {d: _run_clis(tmp_path, common_flags(tmp_path, size, device=d)
                         + ["--no-bf16"], f"fp32_{d}", capsys)
            for d in ("cpu", "cuda")}
    assert runs["cuda"]["printed"] == runs["cpu"]["printed"]
    assert runs["cuda"]["files"] == runs["cpu"]["files"]
    for key, val in runs["cpu"]["topk"].items():
        np.testing.assert_array_equal(runs["cuda"]["topk"][key], val)
    before = dict(ck.LAUNCHES)
    bf16 = _run_clis(tmp_path, common_flags(tmp_path, size, device="cuda"),
                     "bf16", capsys)
    assert all(ck.LAUNCHES[k] > before[k] for k in ("K1", "K2", "K3")), \
        (before, ck.LAUNCHES)
    for line in bf16["printed"]:
        assert 0.0 <= float(line.split(" = ")[1]) <= 100.0, line


def _train_cli_root(root, text_overrides=None):
    """tests/test_trainers.py's synthetic CIRR split at the size of
    CARD_MODEL_CONFIG (with ``text_overrides``), and reference-format
    pretrains of both stages from the port's seed-0 weights on the CPU,
    so that every run starts from the same weights whatever its device."""
    import json

    from _torch_port_train_data import write_cirr

    from candidate_reranking_cir_tpu_torch import config as tcfg
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.runtime.convert import (
        export_stage1,
        export_stage2,
        save_torch_checkpoint,
    )

    config = json.loads(json.dumps(CARD_MODEL_CONFIG))
    config["text"].update(text_overrides or {})
    size = config["vit"]["image_size"]
    write_cirr(root, size=(size + 8, size))
    (root / "model_config.json").write_text(json.dumps(config))
    vit = tcfg.ViTConfig(**config["vit"])
    text = tcfg.TextEncoderConfig(**config["text"])
    torch.manual_seed(0)
    s1 = RetrievalModel(tcfg.RetrievalModelConfig(
        vit=vit, text=text, embed_dim=config["embed_dim"], text_len=10),
        device="cpu")
    s2 = RerankerModel(tcfg.RerankerModelConfig(vit=vit, text=text,
                                                text_len=10), device="cpu")
    with torch.no_grad():
        # a cls head whose scores tell the pairs apart (at its init scale
        # the loss is ln 4 to 1e-6), with logits of a few hundred, whose
        # float32 rounding stays well inside the tolerance
        for dense in (s2.cls_dense1, s2.cls_dense2):
            dense.weight.normal_(0.0, 0.5)
    save_torch_checkpoint(root / "s1.pt", export_stage1(s1.state_dict()),
                          "BLIP_Retrieval")
    save_torch_checkpoint(root / "s2.pt", export_stage2(s2.state_dict()),
                          "BLIP_NLVR")


def _train_cli_runs(root, device: str, tag: str, bf16: bool = False) -> dict:
    """Both trainer CLIs, one epoch each, on ``_train_cli_root``'s split
    and from its pretrains: the step losses and the checkpoints'
    parameter names."""
    from _torch_port_train_data import RecordingComet, trainer_flags

    from candidate_reranking_cir_tpu_torch.cli import (
        stage1_train,
        stage2_train,
        validate,
    )
    from candidate_reranking_cir_tpu_torch.runtime.checkpoint import (
        read_train_state,
    )

    size = CARD_MODEL_CONFIG["vit"]["image_size"]
    flags = trainer_flags(root, size, root / "model_config.json",
                          device=device, bf16=bf16)
    out, models = {}, root / f"models_{tag}"
    common = flags + ["--output-dir", str(models), "--num-epochs", "1",
                      "--batch-size", "4", "--blip-max-epoch", "2"]
    topk = root / f"topk_{tag}.npz"
    for stage, module, extra in (
            ("stage1", stage1_train, ["--pretrained", str(root / "s1.pt")]),
            ("stage2", stage2_train, [
                "--pretrained", str(root / "s2.pt"),
                "--stage1-path", str(models / "stage1" / "saved_models"
                                     / "blip_mean"),
                "--top-k-path", str(topk), "--K-value", "4"])):
        comet = RecordingComet()
        saved = module.make_comet
        module.make_comet = lambda *a, **k: comet
        try:
            module.main(common + ["--experiment-name", stage] + extra)
        finally:
            module.make_comet = saved
        state = read_train_state(models / stage / "saved_models"
                                 / "blip_last")
        out[stage] = (comet.losses, sorted(state["params"]))
        if stage == "stage1":
            validate.main(flags + [
                "--stage1-path", str(models / "stage1" / "saved_models"
                                     / "blip_mean"),
                "--save-topk", "--k", "6", "--topk-out", str(topk),
                "--batch-size", "4"])
    return out


def test_trainer_clis_on_the_card_match_the_cpu(dev, tmp_path):
    """The stage-I and stage-II trainer CLIs with --device cuda in fp32
    (dropout 0), from the same pretrains, take the CPU's step losses within
    1e-4 and save the same parameters."""
    pytest.importorskip("PIL")
    _train_cli_root(tmp_path)
    runs = {d: _train_cli_runs(tmp_path, d, d) for d in ("cpu", "cuda")}
    for stage in ("stage1", "stage2"):
        (cpu_losses, cpu_keys), (card_losses, card_keys) = \
            runs["cpu"][stage], runs["cuda"][stage]
        assert len(cpu_losses) == 2 and card_keys == cpu_keys
        np.testing.assert_allclose(card_losses, cpu_losses, rtol=0,
                                   atol=1e-4)


def test_trainer_clis_in_bf16_launch_k6_to_k9(dev, tmp_path, monkeypatch):
    """In bf16 with attention dropout 0.1 and the kernels' thresholds at 0,
    the stage-I trainer runs K8/K9 and the stage-II trainer K6/K7 (K5
    inside them); the losses are finite."""
    pytest.importorskip("PIL")
    _train_cli_root(tmp_path, {"attention_dropout": 0.1})
    monkeypatch.setattr(tat, "MIN_KV", 0)
    monkeypatch.setattr(tat, "MIN_ROWS", 0)
    tat.reset_launch_counts()
    runs = _train_cli_runs(tmp_path, "cuda", "bf16", bf16=True)
    assert all(tat.LAUNCHES[k] > 0 for k in ("K5", "K6", "K7", "K8", "K9")), \
        tat.LAUNCHES
    for losses, _ in runs.values():
        assert losses and np.isfinite(losses).all()
