"""``ops/norm.add_layer_norm``: the residual add and LayerNorm of every
block of the port, against the eager route (the bf16 add, then
``LayerNorm``'s fp32 statistics), which stays the definition.

CPU tests: the plain route is bit-equal to the parent's ``LayerNorm`` of
``x + residual`` in bf16 and fp32; the CPU and fp32 routes count plain
calls and launch nothing; ``keep_sum``; the kernel's input checks; the
blocks that call it (``ViTBlock``, ``BertSelfAttentionBlock``, ``BertFFN``,
``DualLayer`` in its three layouts, the Q-Former) are bit-equal to their
parent's forwards, dropout and stochastic depth included; the
``autograd.Function``'s backward with the forward taken by the plain
version; the kernels' names in the elementwise family.

Tests marked ``cuda`` need a card (they skip here). The kernel sums its
fp32 statistics in another order than PyTorch's reductions, so they hold
it to the plain version within bf16's 2e-2 (absolute and relative) at the
paths' shapes, and the sum it keeps bit for bit. On a machine with a card
(which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_layer_norm.py
"""
import pytest
import torch

from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.models import dual_encoder, layers, med
from candidate_reranking_cir_tpu_torch.models import vit as tvit
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.models.qformer import QFormer
from candidate_reranking_cir_tpu_torch.ops import norm
from candidate_reranking_cir_tpu_torch.ops.attention import make_additive_mask

TINY_VIT = tcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                          num_layers=2, num_heads=2)
TINY_TEXT = tcfg.TextEncoderConfig(vocab_size=64, hidden_size=16,
                                   num_layers=2, num_heads=2,
                                   intermediate_size=32, encoder_width=16,
                                   merge_mlp_from=1)
DTYPES = (torch.bfloat16, torch.float32)
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
        torch.float16: torch.int16}
TOL = 2e-2            # bf16's bound (ROADMAP B, numerics)


def _same_bits(a, b) -> bool:
    """Bit for bit, the sign of zero included; NaN equals NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a.view(BITS[a.dtype]) == b.view(BITS[b.dtype])
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def _randn(shape, dtype=torch.float32, device="cpu", seed=0, scale=1.0,
           shift=0.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale + shift).to(device,
                                                                 dtype)


def _params(n, device="cpu", seed=1):
    """A drawn gain and bias, as trained weights have."""
    return (1.0 + _randn((n,), device=device, seed=seed, scale=0.2),
            _randn((n,), device=device, seed=seed + 1, scale=0.1))


def _parent_ln(x, weight, bias, eps, dtype):
    """The parent's ``LayerNorm.forward``, verbatim."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dtype)


@pytest.fixture
def counts():
    norm.reset_launch_counts()
    yield norm
    norm.reset_launch_counts()


# ---------------------------------------------------------------------------
# CPU: the plain route and the wrapper

@pytest.mark.parametrize("eps", [1e-6, 1e-12])
@pytest.mark.parametrize("with_residual", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_plain_is_parent_layer_norm(dtype, with_residual, eps, counts):
    """``add_layer_norm`` (and its plain version) on the CPU is the parent's
    ``LayerNorm`` of ``x + residual`` bit for bit, and launches nothing."""
    x = _randn((3, 5, 40), dtype, scale=3.0, shift=0.5)
    r = _randn((3, 5, 40), dtype, seed=2) if with_residual else None
    w, b = _params(40)
    ref = _parent_ln(x if r is None else x + r, w, b, eps, dtype)
    assert _same_bits(norm.add_layer_norm_plain(x, r, w, b, eps), ref)
    assert _same_bits(norm.add_layer_norm(x, r, w, b, eps, dtype=dtype), ref)
    assert counts.LAUNCHES == {"add_layer_norm": 0}
    assert counts.PLAIN_CALLS == {"add_layer_norm": 1}


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_layer_norm_module_is_parent(dtype, counts):
    """``LayerNorm(x)`` and ``LayerNorm(x, residual)`` are the parent's
    module of ``x`` and of ``x + residual``, in the module's dtype."""
    ln = layers.LayerNorm(24, 1e-5, dtype)
    with torch.no_grad():
        ln.weight.copy_(_params(24)[0])
        ln.bias.copy_(_params(24)[1])
    x, r = _randn((7, 24), dtype, scale=2.0), _randn((7, 24), dtype, seed=3)
    with torch.no_grad():
        assert _same_bits(ln(x), _parent_ln(x, ln.weight, ln.bias, 1e-5,
                                            dtype))
        assert _same_bits(ln(x, r), _parent_ln(x + r, ln.weight, ln.bias,
                                               1e-5, dtype))
    assert counts.PLAIN_CALLS == {"add_layer_norm": 2}


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_keep_sum(dtype, counts):
    """With ``keep_sum`` the route returns ``(y, x + residual)``, the sum
    bit-equal to the eager add; without it ``y`` alone."""
    x, r = _randn((4, 6, 32), dtype, scale=2.0), _randn((4, 6, 32), dtype,
                                                         seed=4)
    w, b = _params(32)
    y, s = norm.add_layer_norm(x, r, w, b, 1e-6, keep_sum=True)
    assert _same_bits(s, x + r)
    assert _same_bits(y, norm.add_layer_norm(x, r, w, b, 1e-6))
    assert _same_bits(y, _parent_ln(x + r, w, b, 1e-6, dtype))
    assert counts.PLAIN_CALLS == {"add_layer_norm": 2}


def test_cpu_fp32_and_cpu_inputs_take_the_plain_route(counts):
    """fp32, bf16 and fp16 on the CPU, and a bf16 input with an fp32
    residual (an fp32 sum), all take the plain version."""
    w, b = _params(16)
    x = _randn((2, 16))
    for xx, rr in ((x, None), (x.bfloat16(), None), (x.half(), None),
                   (x.bfloat16(), x)):
        got = norm.add_layer_norm(xx, rr, w, b, 1e-6)
        s = xx if rr is None else xx + rr
        assert _same_bits(got, _parent_ln(s, w, b, 1e-6, s.dtype))
    assert counts.LAUNCHES == {"add_layer_norm": 0}
    assert counts.PLAIN_CALLS == {"add_layer_norm": 4}


@pytest.mark.parametrize("case", ["residual shape", "keep_sum alone"])
def test_route_refusals(case, counts):
    """A residual of another shape (no silent broadcast) and a sum to keep
    without a residual raise on every route."""
    x, (w, b) = _randn((4, 16)), _params(16)
    with pytest.raises(ValueError):
        if case == "residual shape":
            norm.add_layer_norm(x, _randn((1, 16)), w, b, 1e-6)
        else:
            norm.add_layer_norm(x, None, w, b, 1e-6, keep_sum=True)
    assert counts.PLAIN_CALLS == {"add_layer_norm": 0}


@pytest.mark.parametrize("case", ["fp16", "fp16 residual", "fp32 residual",
                                  "residual device", "weight shape",
                                  "weight fp16", "bias strided",
                                  "fp32 output", "empty width"])
def test_kernel_input_checks(case):
    """What the kernel does not take raises before any launch (checked on
    CPU tensors; the card tests run the whole route)."""
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    r = torch.zeros(4, 16, dtype=torch.bfloat16)
    w, b, dtype = torch.ones(16), torch.zeros(16), None
    if case == "fp16":
        x = x.half()
    elif case == "fp16 residual":
        r = r.half()
    elif case == "fp32 residual":
        r = r.float()
    elif case == "residual device":
        r = torch.zeros(4, 16, dtype=torch.bfloat16, device="meta")
    elif case == "weight shape":
        w = torch.ones(8)
    elif case == "weight fp16":
        w = w.half()
    elif case == "bias strided":
        b = torch.zeros(32)[::2]
    elif case == "fp32 output":
        dtype = torch.float32
    else:
        x = r = torch.zeros(4, 0, dtype=torch.bfloat16)
        w, b = torch.ones(0), torch.zeros(0)
    with pytest.raises(ValueError):
        norm._check_kernel_inputs(x, r, w, b, dtype)
    norm._check_kernel_inputs(torch.zeros(4, 16, dtype=torch.bfloat16),
                              None, torch.ones(16), torch.zeros(16),
                              torch.bfloat16)


@pytest.mark.parametrize("with_residual, keep_sum",
                         [(True, False), (True, True), (False, False)])
def test_function_backward_recomputes_plain(with_residual, keep_sum,
                                            monkeypatch):
    """``_AddLayerNorm``'s backward gives the eager route's gradients for
    every input (its forward taken by the plain version here; on a card it
    is the kernel's)."""
    monkeypatch.setattr(norm, "_kernel_forward", norm.add_layer_norm_plain)
    shape = (6, 24)
    x0 = _randn(shape, torch.bfloat16, scale=2.0)
    r0 = _randn(shape, torch.bfloat16, seed=2) if with_residual else None
    w0, b0 = _params(24)
    gy = _randn(shape, torch.bfloat16, seed=5)
    gs = _randn(shape, torch.bfloat16, seed=6)

    def grads(fn):
        ins = [None if t is None else t.clone().requires_grad_()
               for t in (x0, r0, w0, b0)]
        out = fn(*ins, 1e-6, keep_sum, torch.bfloat16)
        outs = out if keep_sum else (out,)
        torch.autograd.backward(outs, (gy, gs)[:len(outs)])
        return [*outs] + [None if t is None else t.grad for t in ins]

    ref = grads(norm.add_layer_norm_plain)
    got = grads(norm._AddLayerNorm.apply)
    for a, r in zip(got, ref):
        assert (a is None and r is None) or _same_bits(a, r)


def test_kernel_names_count_as_elementwise():
    """The kernels' names hold none of the substrings by which the smoke
    script's profile and the benchmark's trace reader pick out attention or
    matmul kernels, so their time counts as elementwise work; the smoke
    script counts them as G2 with the other kernels' launches."""
    import re
    from pathlib import Path

    import chip_smoke
    from cirbench.counts import kernels as bench_kernels

    src = (Path(norm.__file__).parents[1] / "csrc" / "layer_norm.cu"
           ).read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)",
                       src)
    assert sorted(names) == ["add_layer_norm_scalar_kernel",
                             "add_layer_norm_vec_kernel"]
    for name in names:
        assert chip_smoke.kernel_family(name) == \
            "elementwise, norms, gathers, optimizer"
        assert bench_kernels.family(name) == bench_kernels.OTHER
    assert "G2" in chip_smoke.SOURCES and "G2" in chip_smoke.REPLACES
    chip_smoke.reset_launch_counts()
    assert chip_smoke.launch_counts()["G2"] == 0


# ---------------------------------------------------------------------------
# CPU: the blocks against their parent's forwards

def _parent_layer_norm_forward(self, x):
    return _parent_ln(x, self.weight, self.bias, self.eps, self.dtype)


def _parent_vit_block_forward(self, x, seeds=None):
    det = seeds is None
    gen = None if det else layers.seeded_generator(seeds[0], x.device)
    h = self.attn(self.norm1(x), deterministic=det,
                  seed=None if det else seeds[1], generator=gen)
    h = self.drop(h, deterministic=det, generator=gen)
    x = x + layers.drop_path(h, self.drop_path_rate, deterministic=det,
                             generator=gen)
    h = self.mlp(self.norm2(x), deterministic=det, generator=gen)
    return x + layers.drop_path(h, self.drop_path_rate, deterministic=det,
                                generator=gen)


def _parent_self_block_forward(self, x, kv=None, bias=None, *,
                               deterministic=True, seed=None, generator=None,
                               precomputed_kv=None, cache=None,
                               cache_index=None, record=None,
                               perturbation=None):
    ctx = self.attn(x, kv, bias, deterministic=deterministic, seed=seed,
                    generator=generator, precomputed_kv=precomputed_kv,
                    cache=cache, cache_index=cache_index, record=record,
                    perturbation=perturbation)
    if cache is not None:
        ctx, cache = ctx
    ctx = self.drop(ctx, deterministic=deterministic, generator=generator)
    out = self.ln(ctx + x)
    return out if cache is None else (out, cache)


def _parent_ffn_forward(self, x, *, deterministic=True, generator=None):
    h = self.output(self.intermediate.gelu(x))
    h = self.drop(h, deterministic=deterministic, generator=generator)
    return self.ln(h + x)


def _parent_dual_layer_forward(self, h0, h1, text_bias, cand, seeds=None,
                               layout="cand_major", pair_map=None):
    det = seeds is None
    gen = None if det else layers.seeded_generator(seeds[0], h0.device)
    site = (lambda i: None) if det else (lambda i: seeds[i])
    hs = []
    for s, h in (("0", h0), ("1", h1)):
        ctx = getattr(self, f"self_attn{s}")(
            h, None, text_bias, deterministic=det, seed=site(1 + int(s)),
            generator=gen)
        ctx = self.drop(ctx, deterministic=det, generator=gen)
        hs.append(getattr(self, f"self_ln{s}")(ctx + h))
    h0, h1 = hs
    d0 = self._cross("0", h0, cand, layout, det, site(3), gen, pair_map)
    d1 = self._cross("1", h1, cand, layout, det, site(4), gen, pair_map)
    if self.merge is not None:
        merged = self.merge(torch.cat([d0, d1], dim=-1))
    else:
        merged = (d0 + d1) * 0.5
    merged = self.drop(merged, deterministic=det, generator=gen)
    g0 = self.cross_ln0(merged + h0)
    g1 = self.cross_ln1(merged + h1)
    return (self.ffn(g0, deterministic=det, generator=gen),
            self.ffn(g1, deterministic=det, generator=gen))


PARENT_FORWARDS = (
    (layers.LayerNorm, _parent_layer_norm_forward),
    (tvit.ViTBlock, _parent_vit_block_forward),
    (med.BertSelfAttentionBlock, _parent_self_block_forward),
    (med.BertFFN, _parent_ffn_forward),
    (dual_encoder.DualLayer, _parent_dual_layer_forward),
)


def _new_and_parent(fn, monkeypatch):
    """``fn()`` with this tree's forwards, then with the parent's."""
    torch.manual_seed(11)
    new = fn()
    for cls, forward in PARENT_FORWARDS:
        monkeypatch.setattr(cls, "forward", forward)
    torch.manual_seed(11)
    return new, fn()


def _draw_params(module, seed=7):
    """Every gain and bias drawn, so that no LayerNorm is the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias") or name.endswith("weight") \
                    and p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def _assert_same(new, old):
    new = new if isinstance(new, tuple) else (new,)
    old = old if isinstance(old, tuple) else (old,)
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert _same_bits(a, b)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_vit_block_is_parent(dtype, train, monkeypatch):
    """``ViTBlock`` (the residual add inside ``norm2``, kept as the stream)
    and the whole ViT with its final norm, with dropout and stochastic depth
    drawn in the parent's order when training."""
    cfg = tcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                         num_layers=2, num_heads=2, dropout=0.1,
                         drop_path_rate=0.2)
    model = _draw_params(tvit.VisionTransformer(cfg, dtype))
    images = _randn((3, 16, 16, 3))
    seeds = [[5, 6], [7, 8], [9, 10]] if train else None

    def run():
        with torch.no_grad():
            return model(images, deterministic=not train, seeds=seeds)

    _assert_same(*_new_and_parent(run, monkeypatch))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_med_blocks_are_parent(dtype, train, monkeypatch):
    """``BertSelfAttentionBlock`` (self and cross) and ``BertFFN`` with and
    without their dropout."""
    cfg = tcfg.TextEncoderConfig(vocab_size=64, hidden_size=16, num_layers=1,
                                 num_heads=2, intermediate_size=32,
                                 encoder_width=24)
    self_blk = _draw_params(med.BertSelfAttentionBlock(cfg, None, dtype))
    cross_blk = _draw_params(med.BertSelfAttentionBlock(cfg, 24, dtype), 8)
    ffn = _draw_params(med.BertFFN(cfg, dtype), 9)
    x = _randn((2, 6, 16), dtype, scale=2.0)
    image = _randn((2, 10, 24), dtype, seed=3)
    bias = make_additive_mask(torch.tensor([[1] * 6, [1] * 4 + [0] * 2]))

    def run():
        gen = layers.seeded_generator(3, "cpu") if train else None
        with torch.no_grad():
            h = self_blk(x, None, bias, deterministic=not train,
                         generator=gen)
            c = cross_blk(h, image, deterministic=not train, generator=gen)
            return h, c, ffn(c, deterministic=not train, generator=gen)

    _assert_same(*_new_and_parent(run, monkeypatch))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layout", ["cand_major", "shared", "per_pair",
                                    "indexed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_dual_encoder_is_parent(dtype, layout, train, monkeypatch):
    """``DualStreamEncoder`` in every layout: the candidate-major grid, and
    the shared, per-pair and indexed layouts, whose first layer takes h0 and
    h1 as stride-0 ``expand`` views."""
    enc = _draw_params(dual_encoder.DualStreamEncoder(TINY_TEXT, dtype))
    q, c, length = 2, 3, 5
    ids = torch.randint(1, 64, (q, length), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.tensor([[1] * 5, [1] * 3 + [0] * 2])
    z_t = _randn((q, length, 16), dtype, seed=4)
    kw = {"layout": layout}
    if layout == "cand_major":
        ids, mask = ids[None].expand(c, -1, -1), mask[None].expand(c, -1, -1)
        z_t = z_t[None].expand(c, -1, -1, -1)
        cand = _randn((c, 7, 16), seed=5)
    elif layout == "shared":
        cand = _randn((c, 7, 16), seed=5)
    elif layout == "per_pair":
        cand = _randn((q, c, 7, 16), seed=5)
    else:
        cand = _randn((4, 7, 16), seed=5)
        kw = {"pair_map": torch.tensor([[0, 2, 3], [1, 2, 0]])}
    if train:
        kw["deterministic"] = False
        kw["seeds"] = [[i * 5 + j for j in range(5)] for i in range(3)]

    def run():
        with torch.no_grad():
            return enc(ids, mask, z_t, cand, **kw)

    _assert_same(*_new_and_parent(run, monkeypatch))


@pytest.mark.parametrize("with_text", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_qformer_is_parent(dtype, with_text, monkeypatch):
    """The Q-Former: the queries' LayerNorm, its self- and cross-attention
    blocks over the query rows' slices, both FFNs, image-major."""
    cfg = tcfg.TextEncoderConfig(vocab_size=64, hidden_size=16, num_layers=2,
                                 num_heads=2, intermediate_size=32,
                                 max_position_embeddings=16, encoder_width=24)
    qf = _draw_params(QFormer(cfg, 4, 2, dtype))
    image = _randn((2, 9, 24), seed=6)
    kw = {"query_group": 2}
    if with_text:
        kw.update(input_ids=torch.randint(1, 64, (4, 5), generator=torch
                                          .Generator().manual_seed(1)),
                  attention_mask=torch.tensor([[1] * 5, [1] * 3 + [0] * 2,
                                               [1] * 4 + [0], [1] * 5]))

    def run():
        with torch.no_grad():
            return qf(image, **kw)

    _assert_same(*_new_and_parent(run, monkeypatch))


def test_cpu_models_count_plain_calls_only(counts, monkeypatch):
    """A CPU forward of the ViT, the MED and the dual encoder takes the
    plain route once a LayerNorm and never the kernel."""
    calls = _count_layer_norm_calls(monkeypatch)
    torch.manual_seed(0)
    s1, s2 = _tiny_models("cpu", torch.float32)
    with torch.no_grad():
        _forwards(s1, s2, "cpu")
    assert counts.LAUNCHES == {"add_layer_norm": 0}
    assert counts.PLAIN_CALLS["add_layer_norm"] == calls["n"] > 0


def _count_layer_norm_calls(monkeypatch) -> dict:
    calls = {"n": 0}
    forward = layers.LayerNorm.forward

    def counting(self, *args, **kwargs):
        calls["n"] += 1
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(layers.LayerNorm, "forward", counting)
    return calls


def _tiny_models(dev, dtype):
    s1 = RetrievalModel(tcfg.RetrievalModelConfig(
        vit=TINY_VIT, text=TINY_TEXT, embed_dim=8), dtype, device=dev).eval()
    s2 = RerankerModel(tcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT),
                       dtype, device=dev).eval()
    return s1, s2


def _forwards(s1, s2, dev):
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

    build.load_layer_norm_library()
    return torch.device("cuda")


def _within_bf16(got, ref) -> float:
    """Holds ``got`` to ``ref`` within bf16's 2e-2 and returns the share of
    elements whose bits differ."""
    assert got.dtype == ref.dtype == torch.bfloat16
    a, b = got.float(), ref.float()
    assert bool(((a - b).abs() <= TOL + TOL * b.abs()).all()), \
        f"max |err| {(a - b).abs().max().item():.3e}"
    return float((got.view(torch.int16) != ref.view(torch.int16))
                 .float().mean())


# the paths' shapes: a dual-encoder chunk's rows [18464, 768], the ViT-B's
# 32 x 577 rows at [10240, 768]'s neighbour, the EVA ViT-g's batch of 32
# [8224, 1408], the Q-Former's query rows [.., 32, 768]; then a ragged
# width (the scalar body) and row counts that are no multiple of the 8 rows
# a block
CARD_SHAPES = [(18464, 768), (10240, 768), (8224, 1408), (256, 32, 768),
               (4099, 1407), (4099, 768), (3, 1408)]
MODES = ["plain", "residual", "residual+sum"]


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-6, 1e-5, 1e-12])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_card_kernel_within_bf16(dev, shape, mode, eps, counts):
    x = _randn(shape, torch.bfloat16, dev, scale=3.0, shift=0.5)
    r = None if mode == "plain" else _randn(shape, torch.bfloat16, dev, 2)
    w, b = _params(shape[-1], dev)
    keep = mode == "residual+sum"
    ref = norm.add_layer_norm_plain(x, r, w, b, eps, keep)
    got = norm.add_layer_norm(x, r, w, b, eps, keep)
    torch.cuda.synchronize()
    assert counts.LAUNCHES == {"add_layer_norm": 1}
    assert counts.PLAIN_CALLS == {"add_layer_norm": 0}
    if keep:
        assert _same_bits(got[1], ref[1])
        got, ref = got[0], ref[0]
    share = _within_bf16(got, ref)
    assert share < 0.01, f"{share:.2%} of the elements differ"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["misaligned", "expand", "row slice",
                                  "width 16", "one row"])
def test_card_layouts(dev, case, counts):
    """A misaligned contiguous view takes the scalar body; an expand view
    and a row slice are made contiguous once; narrow widths and one row."""
    n = 16 if case == "width 16" else 768
    if case == "misaligned":
        x = _randn((33 * n + 1,), torch.bfloat16, dev)[1:].view(33, n)
        r = _randn((33, n), torch.bfloat16, dev, 2)
    elif case == "expand":
        x = _randn((4, 3, 5, n), torch.bfloat16, dev)
        r = _randn((4, 1, 5, n), torch.bfloat16, dev, 2).expand(4, 3, 5, n)
    elif case == "row slice":
        full = _randn((6, 40, n), torch.bfloat16, dev)
        x, r = full[:, :32], _randn((6, 32, n), torch.bfloat16, dev, 2)
    else:
        rows = 1 if case == "one row" else 19
        x, r = (_randn((rows, n), torch.bfloat16, dev),
                _randn((rows, n), torch.bfloat16, dev, 2))
    w, b = _params(n, dev)
    got, s = norm.add_layer_norm(x, r, w, b, 1e-6, keep_sum=True)
    ref, s_ref = norm.add_layer_norm_plain(x, r, w, b, 1e-6, True)
    assert _same_bits(s, s_ref)
    _within_bf16(got, ref)
    assert counts.LAUNCHES == {"add_layer_norm": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("keep_sum", [False, True])
def test_card_gradients_equal_plain(dev, keep_sum, counts):
    """The backward recomputes the plain version, so the gradients are the
    plain version's bit for bit."""
    shape = (4099, 768)
    ins0 = (_randn(shape, torch.bfloat16, dev, scale=2.0),
            _randn(shape, torch.bfloat16, dev, 2), *_params(768, dev))
    gy = _randn(shape, torch.bfloat16, dev, 5)
    gs = _randn(shape, torch.bfloat16, dev, 6)

    def run(fn):
        ins = [t.clone().requires_grad_() for t in ins0]
        out = fn(*ins, 1e-12, keep_sum)
        outs = out if keep_sum else (out,)
        torch.autograd.backward(outs, (gy, gs)[:len(outs)])
        return [t.grad for t in ins]

    ref = run(norm.add_layer_norm_plain)
    got = run(norm.add_layer_norm)
    assert counts.LAUNCHES == {"add_layer_norm": 1}
    for a, r in zip(got, ref):
        assert _same_bits(a, r)


@pytest.mark.cuda
def test_card_graph_replay_equals_eager(dev, counts):
    """One call captured in a CUDA graph and replayed on new inputs is
    bit-equal to an eager launch on them."""
    shape = (8224, 1408)
    x = _randn(shape, torch.bfloat16, dev)
    r = _randn(shape, torch.bfloat16, dev, 2)
    w, b = _params(1408, dev)
    first = norm.add_layer_norm(x, r, w, b, 1e-6, keep_sum=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, s = norm.add_layer_norm(x, r, w, b, 1e-6, keep_sum=True)
    x.copy_(_randn(shape, torch.bfloat16, dev, 7))
    graph.replay()
    torch.cuda.synchronize()
    eager, eager_s = norm.add_layer_norm(x, r, w, b, 1e-6, keep_sum=True)
    assert _same_bits(out, eager) and _same_bits(s, eager_s)
    assert not _same_bits(out, first[0])
    assert counts.LAUNCHES == {"add_layer_norm": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "fp32 output"])
def test_card_refusals(dev, case, counts):
    x = _randn((64, 768), torch.bfloat16, dev)
    w, b = _params(768, dev)
    with pytest.raises(ValueError):
        if case == "fp16":
            norm.add_layer_norm(x.half(), None, w, b, 1e-6)
        else:
            norm.add_layer_norm(x, None, w, b, 1e-6, dtype=torch.float32)
    assert counts.LAUNCHES == {"add_layer_norm": 0}


@pytest.mark.cuda
def test_card_models_launch_once_a_layer_norm(dev, counts, monkeypatch):
    """A bf16 eval forward of the ViT, the MED and the dual encoder on the
    card launches the kernel once for every LayerNorm call and never takes
    the plain route; the fp32 models take only the plain route."""
    calls = _count_layer_norm_calls(monkeypatch)
    for dtype in (torch.bfloat16, torch.float32):
        torch.manual_seed(0)
        s1, s2 = _tiny_models("cuda", dtype)
        norm.reset_launch_counts()
        calls["n"] = 0
        with torch.inference_mode():
            _forwards(s1, s2, "cuda")
        if dtype == torch.bfloat16:
            assert norm.PLAIN_CALLS == {"add_layer_norm": 0}
            assert norm.LAUNCHES["add_layer_norm"] == calls["n"] > 0
        else:
            assert norm.LAUNCHES == {"add_layer_norm": 0}
            assert norm.PLAIN_CALLS["add_layer_norm"] == calls["n"] > 0
