"""The port's int8 banks (``ops/quant.py``) against the JAX package's.

The same operations in the same order (an fp32 amax, max(amax, 1e-12) /
127, round half to even, a clip to +-127) give JAX's ``q`` and ``scale``
bit for bit on the CPU, from fp32 and from bf16 input; ``take_rows``
dequantizes after the gather as JAX does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from candidate_reranking_cir_tpu.ops import quant as jq
from candidate_reranking_cir_tpu_torch.ops import quant as tq


def _bank(seed: int, dtype: str) -> np.ndarray:
    """[9, 5, 24] rows of mixed scale, a zero row and exact half-steps
    (values whose x / scale lands on .5, to exercise round half to
    even)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(9, 5, 24)) * rng.uniform(0.01, 4.0, (9, 5, 1))
    x[2, 3] = 0.0
    x[4, 1, :4] = [127.0, 0.5, 1.5, -2.5]
    x = x.astype(np.float32)
    if dtype == "bf16":  # values a bf16 bank holds
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _as_port(x: np.ndarray, dtype: str) -> torch.Tensor:
    out = torch.from_numpy(x.copy())
    return out.to(torch.bfloat16) if dtype == "bf16" else out


def _as_jax(x: np.ndarray, dtype: str):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_bank_bit_equal_to_jax(dtype):
    x = _bank(0, dtype)
    ref = jq.quantize_bank(_as_jax(x, dtype))
    out = tq.quantize_bank(_as_port(x, dtype))
    assert out.q.dtype == torch.int8 and out.scale.dtype == torch.float32
    assert tuple(out.shape) == ref.shape and out.nbytes == ref.nbytes
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.scale.numpy().view(np.uint32),
                                  np.asarray(ref.scale).view(np.uint32))


@pytest.mark.parametrize("chunk", [1, 2, 4, 512])
def test_chunked_equals_one_shot(chunk):
    x = _as_port(_bank(1, "fp32"), "fp32")
    whole = tq.quantize_bank(x, chunk=x.shape[0])
    part = tq.quantize_bank(x, chunk=chunk)
    assert torch.equal(part.q, whole.q) and torch.equal(part.scale,
                                                        whole.scale)


def test_error_within_half_a_step():
    x = _as_port(_bank(2, "fp32"), "fp32")
    bank = tq.quantize_bank(x)
    back = tq.dequantize(bank, torch.float32)
    bound = x.abs().amax(dim=-1, keepdim=True) / 254.0
    # half a step, plus the fp32 rounding of x / scale and q * scale
    assert ((back - x).abs() <= bound * (1 + 1e-5) + 1e-30).all()
    assert tq.bank_len(bank) == tq.bank_len(x) == x.shape[0]


@pytest.mark.parametrize("kind", ["int8", "plain_fp32", "plain_bf16"])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_take_rows_matches_jax(kind, dtype):
    x = _bank(3, "bf16" if kind == "plain_bf16" else "fp32")
    src = "bf16" if kind == "plain_bf16" else "fp32"
    jbank, tbank = _as_jax(x, src), _as_port(x, src)
    if kind == "int8":
        jbank, tbank = jq.quantize_bank(jbank), tq.quantize_bank(tbank)
    idx = np.asarray([[4, 0, 4], [8, 2, 1]])
    jdt = None if dtype is None else jnp.float32
    tdt = None if dtype is None else torch.float32
    ref = jq.take_rows(jbank, jnp.asarray(idx), jdt)
    out = tq.take_rows(tbank, torch.from_numpy(idx), tdt)
    want = {None: {"int8": torch.bfloat16, "plain_fp32": torch.float32,
                   "plain_bf16": torch.bfloat16}[kind],
            "float32": torch.float32}[dtype]
    assert out.dtype == want and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
    # one row by an int index, as the serving engine gathers it
    one = tq.take_rows(tbank, 4, tdt)
    np.testing.assert_array_equal(
        one.float().numpy(), np.asarray(jq.take_rows(jbank, 4, jdt),
                                        np.float32))


def test_int8_bank_halves_a_bf16_bank():
    x = torch.zeros(4, 577, 768, dtype=torch.bfloat16)
    bank = tq.quantize_bank(x)
    ratio = bank.nbytes / (x.numel() * x.element_size())
    assert ratio == pytest.approx((768 + 4) / (2 * 768))
    moved = bank.to("cpu")
    assert isinstance(moved, tq.Int8Bank) and moved.q.device.type == "cpu"
    assert moved.scale.device.type == "cpu"
