"""``models/layers.Dense``: the casts to the compute dtype kept once per
weight version, and the routes by what a call observes.

- the CPU's route, fp32 and grad mode give the eager formula
  ``F.linear(x.to(dt), w.to(dt)) + b.to(dt)`` bit for bit, gradients too;
- the kept casts are counted in ``registry.DENSE`` ("cast" on a miss,
  "cached" on a hit), are made again after an optimizer step,
  ``load_state_dict``, ``.to()`` and a ``.data`` assignment (in place
  where the shapes allow), and are no part of ``state_dict``;
- a copy made under inference mode serves no-grad calls and the other way
  round;
- ``registry.reset()`` zeroes ``DENSE``, and ``counts()`` holds no key of
  it;
- a second bf16 eval call of each model takes every cast from the cache.

CPU only, at tiny shapes (the card's epilogue route is in
``tests/test_torch_port_cuda.py``).
"""
import contextlib

import pytest
import torch
import torch.nn.functional as F

from _torch_port_dense_models import MODELS
from candidate_reranking_cir_tpu_torch.models import layers
from candidate_reranking_cir_tpu_torch.ops import registry
from candidate_reranking_cir_tpu_torch.retrieval import validate_engine as tv

BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
MODES = {"no_grad": torch.no_grad, "inference": torch.inference_mode,
         "grad": contextlib.nullcontext}


def _randn(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.view(BITS[a.dtype]) == b.view(BITS[b.dtype])).all())


def _eager(x, w, b, dtype):
    """``Dense``'s formula as the eager route computes it."""
    y = F.linear(x.to(dtype), w.to(dtype))
    return y if b is None else y + b.to(dtype)


def _dense(dtype, bias=True, seed=0, n_in=24, n_out=40):
    d = layers.Dense(n_in, n_out, dtype, "cpu", bias=bias)
    with torch.no_grad():
        d.weight.copy_(_randn(n_out, n_in, seed=seed))
        if bias:
            d.bias.copy_(_randn(n_out, seed=seed + 1))
    return d


def _input(kind: str, seed=10):
    if kind == "2d":
        return _randn(6, 24, seed=seed)                      # fp32 input
    if kind == "3d":
        return _randn(2, 5, 24, seed=seed, dtype=torch.bfloat16)
    # a stride-0 view, as the dual encoder's per-pair layouts pass
    return _randn(3, 1, 5, 24, seed=seed,
                  dtype=torch.bfloat16).expand(3, 4, 5, 24)


@pytest.mark.parametrize("kind", ["2d", "3d", "expanded"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routes_are_bit_equal_to_the_eager_formula(dtype, mode, bias, kind):
    """Forward, ``product`` and ``gelu``, on a miss and on a hit."""
    d = _dense(dtype, bias)
    x = _input(kind)
    w, b = d.weight.detach(), None if d.bias is None else d.bias.detach()
    want = _eager(x, w, b, dtype)
    with MODES[mode]():
        for _ in range(2):
            assert _same_bits(d(x), want)
            assert _same_bits(d.product(x), _eager(x, w, None, dtype))
            assert _same_bits(d.gelu(x), layers.exact_gelu(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grad_mode_keeps_the_eager_gradients(dtype):
    """Under grad mode, after a no-grad call made the casts, the gradients
    of x, the weight and the bias are the formula's, bit for bit."""
    d = _dense(dtype)
    x = _input("3d").float().requires_grad_()
    g = _randn(2, 5, 40, seed=20, dtype=dtype)
    with torch.no_grad():
        d(x)
    before = dict(registry.DENSE)
    got = torch.autograd.grad(d(x), (x, d.weight, d.bias), g)
    assert registry.DENSE == before          # grad mode counts nothing
    w = d.weight.detach().clone().requires_grad_()
    b = d.bias.detach().clone().requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    want = torch.autograd.grad(_eager(x2, w, b, dtype), (x2, w, b), g)
    for a, c in zip(got, want):
        assert _same_bits(a, c)


def test_counts_hits_and_misses():
    d = _dense(torch.bfloat16)
    x = _input("3d")
    registry.reset()
    with torch.no_grad():
        d(x)
        assert registry.DENSE == {"cast": 1, "cached": 0}
        d(x)
        d.product(x)
        d.gelu(x)
        assert registry.DENSE == {"cast": 1, "cached": 3}
    d(x)                                          # grad mode: not counted
    with torch.no_grad():
        _dense(torch.float32)(x)                  # fp32: not counted
    assert registry.DENSE == {"cast": 1, "cached": 3}


def _adamw_torch(d):
    opt = torch.optim.AdamW(d.parameters(), lr=0.1, foreach=True)
    d(_input("3d")).float().sum().backward()
    opt.step()


def _adamw_port(d):
    from candidate_reranking_cir_tpu_torch.runtime.optim import AdamW

    opt = AdamW(d.parameters(), lambda step: 0.1, 0.05)
    d(_input("3d")).float().sum().backward()
    opt.step()


def _load(d):
    d.load_state_dict({k: v + 1.0 for k, v in d.state_dict().items()})


def _to(d):
    d.to(torch.float64)
    with torch.no_grad():
        d.weight.mul_(2.0)
    d.to(torch.float32)


def _data(d):
    d.weight.data = d.weight.data * 3.0


@pytest.mark.parametrize("change", [_adamw_torch, _adamw_port, _load, _to,
                                    _data],
                         ids=["adamw_torch", "adamw_port", "load_state_dict",
                              "to", "data"])
def test_a_changed_weight_is_cast_again(change):
    d = _dense(torch.bfloat16)
    x = _input("3d")
    with torch.no_grad():
        old = d(x)
    change(d)
    registry.reset()
    with torch.no_grad():
        got = d(x)
        d(x)
    assert registry.DENSE == {"cast": 1, "cached": 1}
    assert _same_bits(got, _eager(x, d.weight.detach(), d.bias.detach(),
                                  torch.bfloat16))
    assert not torch.equal(got, old)


def test_casts_are_refreshed_in_place():
    """A new version of the same shapes is written into the kept copies,
    whose addresses a captured graph reads: ``kept_casts`` brings them up
    to date, so ``_weight_ptrs`` (the single program's key) holds after
    ``load_state_dict`` and changes when the parameters move."""
    d = _dense(torch.bfloat16)
    with torch.inference_mode():
        kept = layers.kept_casts(d)
        key = tv._weight_ptrs(d)
    _load(d)
    with torch.inference_mode():
        now = layers.kept_casts(d)
        assert tv._weight_ptrs(d) == key
    assert [t.data_ptr() for t in now] == [t.data_ptr() for t in kept]
    assert _same_bits(now[0], d.weight.detach().bfloat16())
    assert _same_bits(now[1], d.bias.detach().bfloat16())
    held = [p.data for p in d.parameters()]   # so the move takes new ones
    _to(d)
    with torch.inference_mode():
        assert tv._weight_ptrs(d) != key
    del held
    assert layers.kept_casts(layers.Dense(4, 4, torch.float32, "cpu")) == ()


@pytest.mark.parametrize("first,second", [("inference", "no_grad"),
                                          ("no_grad", "inference")])
def test_casts_serve_inference_and_no_grad_alike(first, second):
    d = _dense(torch.bfloat16)
    x = _input("3d")
    with MODES[first]():
        d(x)
    registry.reset()
    with MODES[second]():
        got = d(x)
    assert registry.DENSE == {"cast": 0, "cached": 1}
    assert _same_bits(got, _eager(x, d.weight.detach(), d.bias.detach(),
                                  torch.bfloat16))
    with MODES[second]():
        _load(d)
        got = d(x)                            # refreshed in place
    assert registry.DENSE == {"cast": 1, "cached": 1}
    assert _same_bits(got, _eager(x, d.weight.detach(), d.bias.detach(),
                                  torch.bfloat16))


def test_inference_tensor_weights_take_the_eager_route():
    """Parameters made under inference mode keep no version: the casts are
    made on every call, and nothing is counted or kept."""
    with torch.inference_mode():
        d = _dense(torch.bfloat16)
        x = _input("3d")
        registry.reset()
        got = d(x)
        want = _eager(x, d.weight, d.bias, torch.bfloat16)
    assert registry.DENSE == {"cast": 0, "cached": 0}
    assert d._casts is None
    assert _same_bits(got, want)


def test_state_dict_is_unchanged_by_the_casts():
    model, call = MODELS["retrieval"](torch.bfloat16, "cpu")
    before = {k: (v.dtype, tuple(v.shape))
              for k, v in model.state_dict().items()}
    with torch.inference_mode():
        call()
    after = {k: (v.dtype, tuple(v.shape))
             for k, v in model.state_dict().items()}
    assert after == before
    assert all(dt == torch.float32 for dt, _ in after.values())
    d = _dense(torch.bfloat16)
    with torch.no_grad():
        d(_input("3d"))
    assert d._casts is not None and list(d.state_dict()) == ["weight",
                                                              "bias"]


def test_reset_zeroes_dense_and_counts_leave_it_out():
    with torch.no_grad():
        _dense(torch.bfloat16)(_input("3d"))
    assert registry.DENSE["cast"] > 0
    registry.reset()
    assert registry.DENSE == {"cast": 0, "cached": 0}
    assert not set(registry.DENSE) & set(registry.counts())
    assert all(registry.DENSE is not f for f in registry.LAUNCH_FAMILIES)


@pytest.mark.parametrize("name", list(MODELS))
def test_a_second_eval_call_takes_every_cast_from_the_cache(name):
    """bf16 on the CPU: the first call casts each ``Dense`` once, the
    second none; both give the same outputs."""
    model, call = MODELS[name](torch.bfloat16, "cpu")
    n_dense = sum(isinstance(m, layers.Dense) for m in model.modules())
    registry.reset()
    with torch.inference_mode():
        first = call()
    assert 0 < registry.DENSE["cast"] <= n_dense
    registry.reset()
    with torch.inference_mode():
        second = call()
    assert registry.DENSE["cast"] == 0 and registry.DENSE["cached"] > 0
    for a, b in zip(first, second):
        assert torch.equal(a, b)
