"""Per-module parity: the port (device='cpu', fp32, kernels' plain versions)
against the JAX package's modules with fused_attention=True (Pallas run by
the interpreter on the CPU), same weights, same numpy inputs.
Tolerance: atol 1e-4 on outputs unless stated otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import (
    TINY_TEXT,
    TINY_VIT,
    f32,
    fused,
    np_tree,
    port_cfg,
    t,
)
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models import layers as jl
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.models.dual_encoder import (
    DualStreamEncoder as JDual,
)
from candidate_reranking_cir_tpu.models.med import TextEncoder as JText
from candidate_reranking_cir_tpu.models.vit import VisionTransformer as JViT
from candidate_reranking_cir_tpu_torch.models import layers as tl
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.models.dual_encoder import (
    DualStreamEncoder,
)
from candidate_reranking_cir_tpu_torch.models.med import TextEncoder
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
    jax_tree_to_state,
)

ATOL = 1e-4


def _load(module, jax_params, **kw):
    """JAX params (variables or their 'params') -> the port module."""
    tree = jax_params.get("params", jax_params)
    module.load_state_dict(jax_tree_to_state(np_tree(tree), **kw),
                           strict=True)
    return module.eval()


def _mask(rng, shape, min_len=2):
    lens = rng.integers(min_len, shape[-1] + 1, size=shape[:-1])
    return (np.arange(shape[-1]) < lens[..., None]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_gelu(dtype):
    """bf16: the port reproduces the JAX rational-erf form; results may
    differ by one bf16 ulp where fp32 exp rounds differently (rtol 2^-7)."""
    x = np.random.default_rng(0).normal(scale=3.0, size=(512,)).astype(
        np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    ref = jl.exact_gelu(jnp.asarray(x, jd))
    out = tl.exact_gelu(t(x, td))
    assert out.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(f32(out), f32(ref), atol=1e-6)
    else:
        np.testing.assert_allclose(f32(out), f32(ref), rtol=2 ** -7,
                                   atol=1e-6)


def test_layernorm_and_dense():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    ln = jl.LayerNorm(1e-12)
    p = {"params": {"scale": rng.normal(size=16).astype(np.float32),
                    "bias": rng.normal(size=16).astype(np.float32)}}
    port_ln = _load(tl.LayerNorm(16, 1e-12, device="cpu"), p)
    np.testing.assert_allclose(f32(port_ln(t(x))), f32(ln.apply(p, x)),
                               atol=ATOL)

    dense = jl.Dense(7)
    p = dense.init(jax.random.key(1), x)
    p["params"]["bias"] = rng.normal(size=7).astype(np.float32)
    port_dense = _load(tl.Dense(16, 7, device="cpu"), p)
    np.testing.assert_allclose(f32(port_dense(t(x))), f32(dense.apply(p, x)),
                               atol=ATOL)


@pytest.mark.parametrize("route", ["unfolded", "folded_cross"])
def test_multi_head_attention_routes(route):
    """unfolded: short masked self-attention (K2 route); folded_cross:
    cross-attention to >= 128 keys (K1 route)."""
    rng = np.random.default_rng(2)
    h, hd = 2, 16
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    if route == "unfolded":
        y, y_t = None, None
        bias_np = _mask(rng, (2, 6))
        jb = jnp.asarray(bias_np)
        from candidate_reranking_cir_tpu.ops.attention import (
            make_additive_mask as jmask,
        )
        from candidate_reranking_cir_tpu_torch.ops.attention import (
            make_additive_mask as tmask,
        )
        jbias, tbias = jmask(jb), tmask(t(bias_np))
        kv = 32
    else:
        y = rng.normal(size=(2, 130, 24)).astype(np.float32)
        y_t = t(y)
        jbias = tbias = None
        kv = 24
    jm = jl.MultiHeadAttention(h, hd, 32, fused=True)
    p = jm.init(jax.random.key(3), x, y, jbias)
    ref = jm.apply(p, x, y, jbias)
    tm = _load(tl.MultiHeadAttention(h, hd, 32, kv, device="cpu"), p)
    np.testing.assert_allclose(f32(tm(t(x), y_t, tbias)), f32(ref), atol=ATOL)


def test_vision_transformer():
    imgs = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    p = JViT(TINY_VIT).init(jax.random.key(4), imgs)
    ref = JViT(fused(TINY_VIT)).apply(p, imgs)
    tm = _load(VisionTransformer(port_cfg(TINY_VIT), device="cpu"), p)
    with torch.no_grad():
        out = tm(t(imgs))
    assert out.shape == (2, TINY_VIT.num_tokens, TINY_VIT.hidden_size)
    np.testing.assert_allclose(f32(out), f32(ref), atol=ATOL)


def test_text_encoder_multimodal():
    """Masked text self-attention (K2) and cross-attention to >= 128 image
    tokens (K1 route); 130 tokens keeps the fold rule's branch real."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 250, size=(2, 9)).astype(np.int32)
    mask = _mask(rng, (2, 9))
    img = rng.normal(size=(2, 130, 24)).astype(np.float32)
    p = JText(TINY_TEXT).init(jax.random.key(5), ids, mask, img)
    ref = JText(fused(TINY_TEXT)).apply(p, ids, mask, img)
    tm = _load(TextEncoder(port_cfg(TINY_TEXT), device="cpu"), p)
    with torch.no_grad():
        out = tm(t(ids), t(mask), t(img))
    np.testing.assert_allclose(f32(out), f32(ref), atol=ATOL)


def test_retrieval_fuse_return_raw():
    cfg = jcfg.RetrievalModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                    embed_dim=16, text_len=10)
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 250, size=(2, 10)).astype(np.int32)
    mask = _mask(rng, (2, 10))
    p = JRetrieval(cfg).init(jax.random.key(6), imgs, ids, mask)
    jm = JRetrieval(jcfg.RetrievalModelConfig(
        vit=fused(TINY_VIT), text=fused(TINY_TEXT), embed_dim=16,
        text_len=10))
    feats = jm.apply(p, imgs, method=JRetrieval.embed_images)
    ref = jm.apply(p, feats, ids, mask, return_raw=True,
                   method=JRetrieval.fuse)
    tm = RetrievalModel(port_cfg(cfg), device="cpu")
    tm.load_state_dict(from_jax_params(np_tree(p), port_cfg(cfg)))
    with torch.no_grad():
        out = tm.fuse(t(np.asarray(feats)), t(ids), t(mask), return_raw=True)
        pred = tm.fuse(t(np.asarray(feats)), t(ids), t(mask))
    np.testing.assert_allclose(f32(out), f32(ref), atol=ATOL)
    ref_pred = jm.apply(p, feats, ids, mask, method=JRetrieval.fuse)
    np.testing.assert_allclose(f32(pred), f32(ref_pred), atol=ATOL)


def _grid_inputs(seed, a=2, b=3, lq=7, m=17):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 250, size=(a, b, lq)).astype(np.int32)
    mask = _mask(rng, (a, b, lq))
    z_t = rng.normal(size=(a, b, lq, 24)).astype(np.float32)
    cand = rng.normal(size=(a, m, 24)).astype(np.float32)
    return ids, mask, z_t, cand


def test_dual_stream_encoder_cand_major():
    """merge_mlp_from=1 of 2 layers: one averaged, one MLP-merged layer."""
    ids, mask, z_t, cand = _grid_inputs(6)
    p = JDual(TINY_TEXT).init(jax.random.key(7), ids, mask, z_t, cand,
                              layout="cand_major")
    ref = JDual(fused(TINY_TEXT)).apply(p, ids, mask, z_t, cand,
                                        layout="cand_major")
    tm = _load(DualStreamEncoder(port_cfg(TINY_TEXT), device="cpu"), p,
               mlp_offset=TINY_TEXT.merge_mlp_from)
    with torch.no_grad():
        out = tm(t(ids), t(mask), t(z_t), t(cand))
    assert out.shape == (2, 3, 48)
    np.testing.assert_allclose(f32(out), f32(ref), atol=ATOL)


def test_reranker_score_grid():
    cfg = jcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT, text_len=7)
    ids, mask, z_t, cand = _grid_inputs(7)
    imgs = np.zeros((2, 32, 32, 3), np.float32)
    p = JReranker(cfg).init(jax.random.key(8), imgs, ids[0], mask[0], z_t[0])
    jm = JReranker(jcfg.RerankerModelConfig(vit=fused(TINY_VIT),
                                            text=fused(TINY_TEXT),
                                            text_len=7))
    ref = jm.apply(p, z_t, ids, mask, cand, method=JReranker.score_grid)
    tm = RerankerModel(port_cfg(cfg), device="cpu")
    tm.load_state_dict(from_jax_params(np_tree(p), port_cfg(cfg)))
    with torch.no_grad():
        out = tm.score_grid(t(z_t), t(ids), t(mask), t(cand))
    assert out.shape == (2, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(f32(out), f32(ref), atol=ATOL)
