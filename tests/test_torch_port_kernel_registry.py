"""``ops/registry`` and ``ops/build``'s loader table: one record of the
port's hand-written kernels.

- every kernel id has one counter, ``reset()`` zeroes them all, and the
  attention modules' ``LAUNCHES`` keep exactly the ids the benchmark's
  trace check sums (``cirbench/harness.launches``);
- ``build.LIBRARIES`` names every library under ``csrc/`` and each one's
  C entry points with their arguments, and ``load`` declares them;
- ``registry.run`` enters ``PlainBackward`` only where a gradient is
  wanted, and its backward gives the plain version's gradients for eval
  attention, G1 and G2 (the kernel's forward replaced by the plain
  version, as the card's cannot run here);
- the kernel wrappers define no autograd Function of their own.

CPU only, at tiny shapes.
"""
import ast
import re
from pathlib import Path

import pytest
import torch

from candidate_reranking_cir_tpu_torch.ops import activation as act
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import build
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
from candidate_reranking_cir_tpu_torch.ops import norm, registry

KERNEL_IDS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "G1",
              "G2")
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _randn(*shape, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.view(BITS[a.dtype]) == b.view(BITS[b.dtype])).all())


# ---------------------------------------------------------------------------
# the counters

WIDE_IDS = ("K1_d88", "K3_d88", "K1_d72", "K3_d72")


@pytest.mark.parametrize("kid", KERNEL_IDS + WIDE_IDS)
def test_every_kernel_has_one_counter(kid):
    assert sum(kid in family for family in registry.LAUNCH_FAMILIES) == 1
    assert kid in registry.counts()


def test_counts_hold_every_launch_family_and_nothing_else():
    assert list(registry.counts()) == [*KERNEL_IDS, *WIDE_IDS]
    assert set(registry.PLAIN_CALLS) == {"G1", "G2"}


def test_reset_zeroes_every_family_in_place():
    families = (*registry.LAUNCH_FAMILIES, registry.PLAIN_CALLS)
    for family in families:
        for key in family:
            family[key] = 7
    registry.reset()
    assert all(n == 0 for family in families for n in family.values())
    assert ck.LAUNCHES is registry.EVAL and tat.LAUNCHES is registry.TRAIN


def test_attention_launches_keep_the_ids_the_benchmark_sums():
    """``cirbench/harness.launches`` sums the two attention dicts and holds
    the sum against the attention kernels of a trace: G1, G2 and the
    88-wide counts must stay out of them."""
    from cirbench import harness

    assert list(ck.LAUNCHES) == ["K1", "K2", "K3", "K4"]
    assert list(tat.LAUNCHES) == ["K5", "K6", "K7", "K8", "K9"]
    registry.reset()
    try:
        registry.FUSED["G1"] += 1
        registry.FUSED["G2"] += 1
        registry.WIDE["K1_d88"] += 1
        assert list(harness.launches()) == list(KERNEL_IDS[:9])
        assert sum(harness.launches().values()) == 0
    finally:
        registry.reset()


# ---------------------------------------------------------------------------
# the loader table

def _c_entry_points(name: str) -> dict:
    """The ``extern "C"`` entry points of ``csrc/<name>.cu`` and their
    parameter counts."""
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    block = src[src.index('extern "C" {'):]
    return {fn: 0 if not params.strip() else params.count(",") + 1
            for fn, params in re.findall(r"^int (crc_\w+)\(([^)]*)\)", block,
                                         re.M)}


def test_loader_table_names_every_library():
    assert set(build.LIBRARIES) == {p.stem
                                    for p in build.CSRC_DIR.glob("*.cu")}


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_loader_table_declares_every_entry_point(name):
    entries = _c_entry_points(name)
    assert entries and entries == {fn: len(args) for fn, args
                                   in build.LIBRARIES[name].items()}


def test_load_declares_the_table_signatures(monkeypatch):
    class FakeEntry:
        argtypes = restype = None

    class FakeLibrary:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, entry):
            fn = FakeEntry()
            setattr(self, entry, fn)
            return fn

    monkeypatch.setattr(build, "build",
                        lambda name: (Path(f"lib{name}.so"), 0.0, ""))
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLibrary)
    build.load.cache_clear()
    try:
        lib = build.load("layer_norm")
        assert lib is build.load("layer_norm")
        fn = lib.crc_add_layer_norm
        assert fn.argtypes == list(
            build.LIBRARIES["layer_norm"]["crc_add_layer_norm"])
        assert fn.restype is build.ctypes.c_int
    finally:
        build.load.cache_clear()


# ---------------------------------------------------------------------------
# the plain-backward route

def _attention_args():
    q, k, v = (_randn(2, n, 2, 8, seed=s) for s, n in ((1, 5), (2, 7),
                                                        (3, 7)))
    bias3 = ck._bias3(torch.randn(2, 1, 1, 7), 2, 5, 7)
    return ("K2", q, k, v, bias3), (False, True, True, True, False)


def _bias_gelu_args():
    return (_randn(6, 16, seed=4) * 3, torch.randn(16)), (True, True)


def _layer_norm_args():
    args = (_randn(6, 24, seed=5), _randn(6, 24, seed=6),
            1 + 0.1 * torch.randn(24), 0.1 * torch.randn(24), 1e-6, True,
            None)
    return args, (True, True, True, True, False, False, False)


# family -> (wrapper module, the plain version, its arguments)
FAMILIES = {
    "eval attention": (ck, ck._plain_forward, _attention_args),
    "G1": (act, act.bias_gelu_plain, _bias_gelu_args),
    "G2": (norm, norm.add_layer_norm_plain, _layer_norm_args),
}


def _outputs_and_grads(fn, args, wants):
    ins = [a.clone().requires_grad_() if w else a
           for a, w in zip(args, wants)]
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [_randn(*o.shape, seed=9 + i)
                                   for i, o in enumerate(outs)])
    return out, [*outs, *(a.grad for a, w in zip(ins, wants) if w)]


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_backward_gives_the_plain_gradients(family, monkeypatch):
    module, plain, make = FAMILIES[family]
    monkeypatch.setattr(module, "_kernel_forward", plain)
    args, wants = make()
    _, ref = _outputs_and_grads(plain, args, wants)
    out, got = _outputs_and_grads(
        lambda *a: registry.run(module._kernel_forward, plain, *a), args,
        wants)
    first = out[0] if isinstance(out, tuple) else out
    assert type(first.grad_fn).__name__ == "PlainBackwardBackward"
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        assert _same_bits(a, r)


@pytest.mark.parametrize("mode", ["no_grad", "inference", "no input wants"])
@pytest.mark.parametrize("family", FAMILIES)
def test_run_calls_the_kernel_directly_without_a_gradient(family, mode,
                                                          monkeypatch):
    module, plain, make = FAMILIES[family]
    calls = []
    monkeypatch.setattr(module, "_kernel_forward",
                        lambda *a: (calls.append(1), plain(*a))[1])
    args, wants = make()
    if mode != "no input wants":
        args = [a.clone().requires_grad_() if w else a
                for a, w in zip(args, wants)]
    ctx = {"no_grad": torch.no_grad, "inference": torch.inference_mode,
           "no input wants": torch.enable_grad}[mode]
    with ctx():
        out = registry.run(module._kernel_forward, plain, *args)
    outs = out if isinstance(out, tuple) else (out,)
    assert calls == [1]
    assert all(o.grad_fn is None for o in outs)


def test_eval_attention_bias_gets_no_gradient(monkeypatch):
    """As the JAX package's ``custom_vjp``: q, k and v get the plain
    version's gradients and a bias that wants one gets none."""
    monkeypatch.setattr(ck, "_kernel_forward", ck._plain_forward)
    (kid, q, k, v, bias3), _ = _attention_args()
    q, bias3 = q.clone().requires_grad_(), bias3.clone().requires_grad_()
    registry.run(ck._kernel_forward, ck._plain_forward, kid, q, k, v,
                 bias3).float().sum().backward()
    assert q.grad is not None and bias3.grad is None


@pytest.mark.parametrize("module", [act, norm, ck],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_wrappers_define_no_autograd_function(module):
    tree = ast.parse(Path(module.__file__).read_text())
    bases = [ast.unparse(b) for node in ast.walk(tree)
             if isinstance(node, ast.ClassDef) for b in node.bases]
    assert not [b for b in bases if b.endswith("Function")]
