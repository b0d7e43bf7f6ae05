"""CUDA kernels K1-K4 against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no card is present. On a machine with a
card (which need not have JAX), run them without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: fp32 atol 2e-5, bf16 atol 2e-2 (tests/test_pallas_attention*).
"""
import pytest
import torch

from candidate_reranking_cir_tpu_torch.ops import attention as tattn
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(dev, dtype, *shape, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev, dtype)


def _mask_bias(dev, e, m):
    lens = torch.arange(e) % m + 1
    mask = (torch.arange(m)[None] < lens[:, None]).float()
    return tattn.make_additive_mask(mask.to(dev))      # [E, 1, 1, M]


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
