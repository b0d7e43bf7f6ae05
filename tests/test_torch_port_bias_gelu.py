"""``ops/activation.bias_gelu``: fc1's bias add and the exact GELU of every
FFN of the port, against the eager route (``Dense`` then ``exact_gelu``),
which stays the definition.

CPU tests: the plain route is bit-equal to the eager one in bf16 and fp32,
the FFN modules' outputs and ``Dense.gelu`` are bit-equal to what they
computed before, the kernel's counter stays at 0, the kernel's input
checks, the ``autograd.Function``'s backward with the forward taken by the
plain version, and the kernels' names in the elementwise family.

Tests marked ``cuda`` need a card (they skip here); they hold the kernel
bit for bit to the eager route on the card at the paths' shapes. On a
machine with a card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_bias_gelu.py
"""
import pytest
import torch

from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.models import layers
from candidate_reranking_cir_tpu_torch.models.blip_decoder import BertLMHead
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.models.med import BertFFN
from candidate_reranking_cir_tpu_torch.ops import activation as act

TINY_VIT = tcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                          num_layers=1, num_heads=2)
TINY_TEXT = tcfg.TextEncoderConfig(vocab_size=64, hidden_size=16,
                                   num_layers=2, num_heads=2,
                                   intermediate_size=32, encoder_width=16,
                                   merge_mlp_from=1)
DTYPES = (torch.bfloat16, torch.float32)
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
        torch.float16: torch.int16}


def _same_bits(a, b) -> bool:
    """Bit for bit, the sign of zero included; NaN equals NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a.view(BITS[a.dtype]) == b.view(BITS[b.dtype])
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def _product(shape, dtype, device="cpu", seed=0, scale=3.0):
    """fc1-like products, widened to GELU's tails, with signed zeros,
    tiny and large values planted in the first row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(*shape, generator=g) * scale
    flat = x.view(-1)
    special = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 1e-3, -1e-3, 8.0,
                            -8.0, 40.0, -40.0, 1e4, -1e4])
    k = min(len(special), flat.numel())
    flat[:k] = special[:k]
    return x.to(device, dtype)


def _bias(n, device="cpu", seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(n, generator=g) * 0.5).to(device)


@pytest.fixture
def counts():
    act.reset_launch_counts()
    yield act
    act.reset_launch_counts()


# ---------------------------------------------------------------------------
# CPU

@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_bias_gelu_is_dense_then_exact_gelu(dtype, with_bias, counts):
    """On the CPU ``bias_gelu`` is bit-equal to the eager ``Dense`` +
    ``exact_gelu`` in bf16 and fp32, and launches nothing."""
    torch.manual_seed(0)
    dense = layers.Dense(24, 40, dtype, bias=with_bias)
    if with_bias:
        with torch.no_grad():
            dense.bias.copy_(_bias(40))
    x = torch.randn(3, 5, 24) * 4
    got = act.bias_gelu(dense.product(x), dense.bias)
    assert _same_bits(got, act.exact_gelu(dense(x)))
    assert got.dtype == dtype
    assert counts.LAUNCHES == {"bias_gelu": 0}
    assert counts.PLAIN_CALLS == {"bias_gelu": 1}


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_signed_zeros_without_bias(dtype):
    """Without a bias no add is made: -0 stays -0."""
    p = torch.tensor([[0.0, -0.0, 1.0, -1.0]]).to(dtype)
    got = act.bias_gelu(p)
    assert _same_bits(got, act.exact_gelu(p))
    assert torch.signbit(got[0, 1]) and not torch.signbit(got[0, 0])


def _old_mlp(m, x):
    return m.fc2(act.exact_gelu(m.fc1(x)))


def _old_ffn(m, x):
    return m.ln(m.output(act.exact_gelu(m.intermediate(x))) + x)


def _old_lm_head(m, x):
    return m.decoder(m.ln(act.exact_gelu(m.transform(x)))).float()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("module", ["Mlp", "BertFFN", "BertLMHead"])
def test_cpu_ffn_modules_unchanged(module, dtype, counts):
    """``Mlp``, ``BertFFN`` and ``BertLMHead`` compute on the CPU what they
    computed before they called ``bias_gelu``, bit for bit."""
    torch.manual_seed(0)
    if module == "Mlp":
        m, old = layers.Mlp(16, 64, 16, dtype), _old_mlp
    elif module == "BertFFN":
        m, old = BertFFN(TINY_TEXT, dtype), _old_ffn
    else:
        m, old = BertLMHead(16, 64, dtype=dtype), _old_lm_head
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(_bias(p.numel(), seed=len(name)))
    x = (torch.randn(2, 7, 16) * 2).to(dtype)
    with torch.no_grad():
        assert _same_bits(m.eval()(x), old(m, x))
    assert counts.LAUNCHES == {"bias_gelu": 0}
    assert counts.PLAIN_CALLS == {"bias_gelu": 1}


def test_cpu_models_count_plain_calls_only(counts):
    """A CPU forward of the ViT, the MED and the dual encoder takes the
    plain route once an FFN and never the kernel."""
    torch.manual_seed(0)
    s1 = RetrievalModel(tcfg.RetrievalModelConfig(
        vit=TINY_VIT, text=TINY_TEXT, embed_dim=8), device="cpu").eval()
    s2 = RerankerModel(tcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT),
                       device="cpu").eval()
    with torch.no_grad():
        _ffn_forwards(s1, s2, "cpu")
    assert counts.LAUNCHES == {"bias_gelu": 0}
    assert counts.PLAIN_CALLS["bias_gelu"] > 0


@pytest.mark.parametrize("case", ["fp16", "strided", "fp16 bias",
                                  "bias shape", "bias strided"])
def test_kernel_input_checks(case):
    """What the kernel does not take raises before any launch (checked on
    CPU tensors; the card test runs the whole route)."""
    p, b = torch.zeros(4, 16, dtype=torch.bfloat16), torch.zeros(16)
    if case == "fp16":
        p = p.half()
    elif case == "strided":
        p = torch.zeros(16, 4, dtype=torch.bfloat16).t()
    elif case == "fp16 bias":
        b = b.half()
    elif case == "bias shape":
        b = torch.zeros(8)
    else:
        b = torch.zeros(32)[::2]
    with pytest.raises(ValueError):
        act._check_kernel_inputs(p, b)


@pytest.mark.parametrize("with_bias", [True, False])
def test_function_backward_recomputes_plain(with_bias, monkeypatch):
    """``_BiasGelu``'s backward gives the eager route's gradients (its
    forward taken by the plain version, as on a card it is the kernel's
    bit-equal output)."""
    monkeypatch.setattr(act, "_kernel_forward", act.bias_gelu_plain)
    p0 = _product((6, 16), torch.bfloat16)
    b0 = _bias(16) if with_bias else None
    g = _product((6, 16), torch.bfloat16, seed=3, scale=1.0)

    def grads(fn):
        p = p0.clone().requires_grad_()
        b = None if b0 is None else b0.clone().requires_grad_()
        out = fn(p, b)
        out.backward(g)
        return out, p.grad, None if b is None else b.grad

    ref = grads(act.bias_gelu_plain)
    got = grads(act._BiasGelu.apply)
    for a, r in zip(got, ref):
        assert (a is None and r is None) or _same_bits(a, r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_cpu_dense_gelu_is_exact_gelu_of_dense(dtype, with_bias):
    """``Dense.gelu``, which the three FFNs call, is ``exact_gelu`` of the
    ``Dense``'s output bit for bit."""
    torch.manual_seed(2)
    dense = layers.Dense(24, 40, dtype, bias=with_bias)
    if with_bias:
        with torch.no_grad():
            dense.bias.normal_()
    x = _product((5, 24), torch.float32, scale=1.0)
    with torch.no_grad():
        assert _same_bits(dense.gelu(x), act.exact_gelu(dense(x)))


def test_kernel_names_count_as_elementwise():
    """The kernels' names hold none of the substrings by which the smoke
    script's profile and the benchmark's trace reader pick out attention or
    matmul kernels, so their time counts as elementwise work; the smoke
    script counts them as G1 with the attention kernels' launches."""
    import re
    from pathlib import Path

    import chip_smoke
    from cirbench.counts import kernels as bench_kernels

    src = (Path(act.__file__).parents[1] / "csrc" / "activation.cu"
           ).read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)",
                       src)
    assert sorted(names) == ["bias_gelu_scalar_kernel",
                             "bias_gelu_vec_kernel"]
    for name in names:
        assert chip_smoke.kernel_family(name) == \
            "elementwise, norms, gathers, optimizer"
        assert bench_kernels.family(name) == bench_kernels.OTHER
    chip_smoke.reset_launch_counts()
    assert chip_smoke.launch_counts() == dict.fromkeys(chip_smoke.SOURCES, 0)


def _ffn_forwards(s1, s2, dev):
    """The ViT (``embed_images``), the MED's multimodal fusion and the dual
    encoder's candidate-major grid at tiny widths."""
    feats = s2.embed_images(torch.zeros(2, 16, 16, 3, device=dev))
    ids = torch.ones(2, 6, dtype=torch.int32, device=dev)
    mask = torch.ones(2, 6, dtype=torch.int32, device=dev)
    z = s1.fuse(feats, ids, mask, return_raw=True)
    s2.score_grid(z[:, None], ids[:, None], mask[:, None], feats)


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from candidate_reranking_cir_tpu_torch.ops import build

    build.load_activation_library()
    return torch.device("cuda")


# the paths' shapes: the ViT's fc1 at embed batch 32 (32 x 577 rows), a
# candidate-major dual-encoder chunk [A, B * L, 3072] (8 candidates x 32
# queries x 40 tokens), the caption head's transform [beams, L, 768], and
# ragged row counts
CARD_SHAPES = [(32 * 577, 3072), (8, 32 * 40, 3072), (48, 20, 768),
               (1, 3072), (7, 3072), (4099, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_card_kernel_bit_equal(dev, shape, with_bias, counts):
    p = _product(shape, torch.bfloat16, dev)
    b = _bias(shape[-1], dev) if with_bias else None
    ref = act.bias_gelu_plain(p, b)
    got = act.bias_gelu(p, b)
    torch.cuda.synchronize()
    assert counts.LAUNCHES == {"bias_gelu": 1}
    assert counts.PLAIN_CALLS == {"bias_gelu": 0}
    assert _same_bits(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("case", ["width 3071", "width 100",
                                  "misaligned", "inf"])
def test_card_scalar_path_and_specials(dev, case, with_bias):
    """Widths that are no multiple of 8 and a misaligned (contiguous) view
    take the scalar body; infinities follow the eager route too."""
    n = {"width 3071": 3071, "width 100": 100}.get(case, 3072)
    if case == "misaligned":
        flat = _product((33 * n + 1,), torch.bfloat16, dev)
        p = flat[1:].view(33, n)
    else:
        p = _product((33, n), torch.bfloat16, dev)
    if case == "inf":
        p[0, :4] = torch.tensor([float("inf"), -float("inf"), 3e38, -3e38])
    b = _bias(n, dev) if with_bias else None
    assert _same_bits(act.bias_gelu(p, b), act.bias_gelu_plain(p, b))


@pytest.mark.cuda
def test_card_signed_zeros_without_bias(dev):
    p = torch.tensor([[0.0, -0.0] * 8] * 3, device=dev).bfloat16()
    got = act.bias_gelu(p)
    assert _same_bits(got, act.bias_gelu_plain(p))
    assert bool(torch.signbit(got[:, 1::2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
def test_card_gradients_equal_eager(dev, with_bias, counts):
    p0 = _product((4099, 3072), torch.bfloat16, dev)
    b0 = _bias(3072, dev) if with_bias else None
    g = _product((4099, 3072), torch.bfloat16, dev, seed=3, scale=1.0)

    def run(fn):
        p = p0.clone().requires_grad_()
        b = None if b0 is None else b0.clone().requires_grad_()
        out = fn(p, b)
        out.backward(g)
        return out, p.grad, None if b is None else b.grad

    ref = run(act.bias_gelu_plain)
    got = run(act.bias_gelu)
    assert counts.LAUNCHES == {"bias_gelu": 1}
    for a, r in zip(got, ref):
        assert (a is None and r is None) or _same_bits(a, r)


@pytest.mark.cuda
def test_card_graph_replay_equals_eager(dev, counts):
    p = _product((32 * 577, 3072), torch.bfloat16, dev)
    b = _bias(3072, dev)
    eager = act.bias_gelu(p, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = act.bias_gelu(p, b)
    p.copy_(_product((32 * 577, 3072), torch.bfloat16, dev, seed=5))
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(out, act.bias_gelu_plain(p, b))
    assert not _same_bits(out, eager)
    assert counts.LAUNCHES == {"bias_gelu": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "strided"])
def test_card_refusals(dev, case, counts):
    p = _product((64, 3072), torch.bfloat16, dev)
    p = p.half() if case == "fp16" else p[:, ::2]
    with pytest.raises(ValueError):
        act.bias_gelu(p, _bias(p.shape[-1], dev))
    assert counts.LAUNCHES == {"bias_gelu": 0}


@pytest.mark.cuda
def test_card_counts_one_launch_a_call(dev, counts):
    p, b = _product((7, 3072), torch.bfloat16, dev), _bias(3072, dev)
    for i in range(1, 4):
        act.bias_gelu(p, b)
        assert counts.LAUNCHES == {"bias_gelu": i}
    act.bias_gelu(p.float(), b)
    assert counts.LAUNCHES == {"bias_gelu": 3}
    assert counts.PLAIN_CALLS == {"bias_gelu": 1}


@pytest.mark.cuda
def test_card_models_take_the_kernel(dev, counts):
    """A bf16 eval forward of the ViT, the MED and the dual encoder on the
    card launches the kernel for every FFN and never takes the plain
    route; the fp32 models take only the plain route."""
    torch.manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        s1 = RetrievalModel(tcfg.RetrievalModelConfig(
            vit=TINY_VIT, text=TINY_TEXT, embed_dim=8), dtype,
            device="cuda").eval()
        s2 = RerankerModel(tcfg.RerankerModelConfig(
            vit=TINY_VIT, text=TINY_TEXT), dtype, device="cuda").eval()
        act.reset_launch_counts()
        with torch.inference_mode():
            _ffn_forwards(s1, s2, "cuda")
        if dtype == torch.bfloat16:
            assert act.PLAIN_CALLS == {"bias_gelu": 0}
            assert act.LAUNCHES["bias_gelu"] > 0
        else:
            assert act.LAUNCHES == {"bias_gelu": 0}
            assert act.PLAIN_CALLS["bias_gelu"] > 0
