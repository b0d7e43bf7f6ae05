"""Weights carried into the port: JAX params -> ``from_jax_params``, and
JAX params -> the reference key format (``runtime/convert.py`` exports)
-> ``load_reference_state_dict``, directly and through a ``.pt`` file.
Both loaders must give the same state and the JAX model's outputs
(atol 1e-4; the JAX side runs its Pallas kernels interpreted)."""
import jax
import numpy as np
import pytest
import torch

from _torch_port_utils import TINY_TEXT, TINY_VIT, f32, fused, np_tree, \
    port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.runtime import convert
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
    load_reference_state_dict,
)

ATOL = 1e-4
L = 8


def _inputs(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 250, size=(2, L)).astype(np.int32)
    mask = np.ones((2, L), np.int32)
    mask[1, 5:] = 0
    return imgs, ids, mask


def _assert_same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].shape == b[key].shape, key
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0,
                                   msg=key)


@pytest.fixture(scope="module")
def stage1():
    cfg = jcfg.RetrievalModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                    embed_dim=16, text_len=L)
    imgs, ids, mask = _inputs(0)
    params = np_tree(JRetrieval(cfg).init(jax.random.key(0), imgs, ids, mask))
    return cfg, params


@pytest.fixture(scope="module")
def stage2():
    cfg = jcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT, text_len=L)
    imgs, ids, mask = _inputs(1)
    z = np.zeros((2, L, 24), np.float32)
    params = np_tree(JReranker(cfg).init(jax.random.key(1), imgs, ids, mask,
                                         z))
    return cfg, params


def test_stage1_loaders_agree_and_match_jax(stage1, tmp_path):
    cfg, params = stage1
    pcfg = port_cfg(cfg)
    sd_jax = from_jax_params(params, pcfg)
    ref_sd = convert.export_stage1(params, cfg)
    _assert_same_state(load_reference_state_dict(ref_sd, pcfg), sd_jax)
    path = tmp_path / "stage1.pt"
    convert.save_torch_checkpoint(str(path), ref_sd, "BLIP_Retrieval")
    _assert_same_state(load_reference_state_dict(str(path), pcfg), sd_jax)

    model = RetrievalModel(pcfg, device="cpu")
    model.load_state_dict(sd_jax, strict=True)
    imgs, ids, mask = _inputs(2)
    jm = JRetrieval(jcfg.RetrievalModelConfig(
        vit=fused(TINY_VIT), text=fused(TINY_TEXT), embed_dim=16,
        text_len=L))
    feats, pooled = jm.apply(params, imgs, pool_and_normalize=True,
                             method=JRetrieval.embed_images)
    z = jm.apply(params, feats, ids, mask, return_raw=True,
                 method=JRetrieval.fuse)
    with torch.no_grad():
        t_feats, t_pooled = model.embed_images(t(imgs),
                                               pool_and_normalize=True)
        t_z = model.fuse(t_feats, t(ids), t(mask), return_raw=True)
    np.testing.assert_allclose(f32(t_feats), f32(feats), atol=ATOL)
    np.testing.assert_allclose(f32(t_pooled), f32(pooled), atol=ATOL)
    np.testing.assert_allclose(f32(t_z), f32(z), atol=ATOL)


def test_stage2_loaders_agree_and_match_jax(stage2, tmp_path):
    cfg, params = stage2
    pcfg = port_cfg(cfg)
    sd_jax = from_jax_params(params, pcfg)
    ref_sd = convert.export_stage2(params, cfg)
    _assert_same_state(load_reference_state_dict(ref_sd, pcfg), sd_jax)
    path = tmp_path / "stage2.pt"
    convert.save_torch_checkpoint(str(path), ref_sd, "BLIP_NLVR")
    _assert_same_state(load_reference_state_dict(path, pcfg), sd_jax)

    model = RerankerModel(pcfg, device="cpu")
    model.load_state_dict(load_reference_state_dict(str(path), pcfg),
                          strict=True)
    imgs, _, _ = _inputs(3)
    rng = np.random.default_rng(4)
    a, b = 2, 3
    ids = rng.integers(1, 250, size=(a, b, L)).astype(np.int32)
    mask = np.ones((a, b, L), np.int32)
    mask[1, :, 4:] = 0
    z_t = rng.normal(size=(a, b, L, 24)).astype(np.float32)
    jm = JReranker(jcfg.RerankerModelConfig(vit=fused(TINY_VIT),
                                            text=fused(TINY_TEXT),
                                            text_len=L))
    feats = jm.apply(params, imgs, method=JReranker.embed_images)
    scores = jm.apply(params, z_t, ids, mask, feats,
                      method=JReranker.score_grid)
    with torch.no_grad():
        t_feats = model.embed_images(t(imgs))
        t_scores = model.score_grid(t(z_t), t(ids), t(mask), t_feats)
    np.testing.assert_allclose(f32(t_feats), f32(feats), atol=ATOL)
    np.testing.assert_allclose(f32(t_scores), f32(scores), atol=ATOL)


def test_reference_loader_rejects_pos_embed_of_another_grid(stage1):
    """A square grid of another size is resized as the JAX converter
    resizes it (a BLIP pretrain's 14 x 14 at 224 px); a grid that is not
    square is refused."""
    cfg, params = stage1
    ref_sd = convert.export_stage1(params, cfg)
    pos = np.random.default_rng(5).normal(0, 0.02, (1, 5, 24))
    ref_sd["visual_encoder.pos_embed"] = pos.astype(np.float32)
    loaded = load_reference_state_dict(ref_sd, port_cfg(cfg))
    want = convert.interpolate_pos_embed(pos.astype(np.float32),
                                         cfg.vit.num_patches)
    np.testing.assert_allclose(f32(loaded["visual_encoder.pos_embed"]),
                               want, atol=1e-6)
    ref_sd["visual_encoder.pos_embed"] = np.zeros((1, 6, 24), np.float32)
    with pytest.raises(ValueError, match="pos_embed"):
        load_reference_state_dict(ref_sd, port_cfg(cfg))
