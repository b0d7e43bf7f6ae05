"""Dropout in the re-ranker's per-pair, indexed and candidate-major layouts
against the JAX package on the CPU (captioning with dropout:
``tests/test_torch_port_caption_dropout.py``, which shares these helpers).

Attention dropout 0.1, hidden dropout and drop-path 0, the kernel
thresholds ``MIN_KV`` and ``MIN_ROWS`` at 0 in both packages and JAX's
seed pinned, so that every attention site takes the in-kernel-dropout
route with the K5 hash mask on both sides (the JAX kernels interpreted,
the port's plain versions); elsewhere JAX draws ``jax.random.bernoulli``,
which no port reproduces. Each grid keeps B*Lq within ``MAX_LQ``.

``score_per_query``, ``score_indexed`` and ``score_grid``: logits 1e-4,
the gradients of a weighted mean of them 3e-5 against ``jax.grad``, and
the mask applied (the logits differ from the eval ones).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32, fused, np_tree, port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.runtime.weights import from_jax_params

SEED = 424242
LOGIT_TOL, GRAD_TOL = 1e-4, 3e-5
L, W, M = 6, 32, 9                 # text length, width, candidate tokens
VIT = jcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=W,
                     num_layers=1, num_heads=2, attention_dropout=0.1)
TEXT = jcfg.TextEncoderConfig(vocab_size=64, hidden_size=W, num_layers=2,
                              num_heads=2, intermediate_size=48,
                              encoder_width=W, merge_mlp_from=2,
                              hidden_dropout=0.0, attention_dropout=0.1)


@pytest.fixture(scope="module", autouse=True)
def kernel_route():
    """Every attention through the hash mask: thresholds 0, one seed."""
    mp = pytest.MonkeyPatch()
    for mod in (jpat, tat):
        mp.setattr(mod, "MIN_KV", 0)
        mp.setattr(mod, "MIN_ROWS", 0)
    mp.setattr(jpat, "seed_from_rng",
               lambda rng: jnp.array([SEED], jnp.int32))
    yield
    mp.undo()


def _seeds(*modules):
    return tuple([[SEED] * m.seed_shape[1]] * m.seed_shape[0]
                 for m in modules)


def _jax_grads(fn, params):
    """(output, grads) of fn(params) = (loss, output), one jit."""
    (_, out), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    return np.asarray(out), np_tree(grads)


def _port_grads(model, fn):
    model.zero_grad()
    loss, out = fn()
    loss.backward()
    return out.detach(), {n: p.grad for n, p in model.named_parameters()
                          if p.grad is not None}


def _assert_grads(grads, ref_tree, cfg):
    ref = from_jax_params(ref_tree, port_cfg(cfg))
    assert grads and set(grads) <= set(ref)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3
    for name, g in grads.items():
        np.testing.assert_allclose(f32(g), f32(ref[name]), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the re-ranker's layouts

@pytest.fixture(scope="module")
def reranker():
    cfg = jcfg.RerankerModelConfig(vit=VIT, text=TEXT, text_len=L)
    params = np_tree(jax.jit(JReranker(cfg).init)(
        jax.random.key(2), np.zeros((2, 16, 16, 3), np.float32),
        np.ones((2, L), np.int32), np.ones((2, L), np.int32),
        np.zeros((2, L, W), np.float32)))
    # larger trained weights than the 0.02 init, so the scores and their
    # gradients are far from their trivial values
    params = jax.tree_util.tree_map(
        lambda a: a * 4.0 if a.ndim >= 2 else a, params)
    jmodel = JReranker(dataclasses.replace(cfg, text=fused(TEXT)))
    port = RerankerModel(port_cfg(cfg), device="cpu")
    port.load_state_dict(from_jax_params(params, port_cfg(cfg)))
    return cfg, jmodel, params, port


def _layout_inputs(rng, layout):
    """(z_t, ids, mask, candidates, pair_map or None), numpy."""
    lead = (4, 3) if layout == "grid" else (3,)     # [A, B] or [Q]
    z_t = rng.normal(size=(*lead, L, W)).astype(np.float32)
    ids = rng.integers(1, 64, size=(*lead, L)).astype(np.int32)
    mask = np.ones((*lead, L), np.int32)
    mask[..., 0, 4:] = 0
    if layout == "grid":
        return z_t, ids, mask, rng.normal(size=(4, M, W)).astype(
            np.float32), None
    if layout == "per_query":
        return z_t, ids, mask, rng.normal(size=(3, 4, M, W)).astype(
            np.float32), None
    pair_map = rng.integers(0, 5, size=(3, 4)).astype(np.int32)
    return z_t, ids, mask, rng.normal(size=(5, M, W)).astype(
        np.float32), pair_map


METHODS = {"per_query": "score_per_query", "indexed": "score_indexed",
           "grid": "score_grid"}


@pytest.mark.parametrize("layout", ["per_query", "indexed", "grid"])
def test_reranker_layout_with_dropout_matches_jax(reranker, layout):
    cfg, jmodel, params, port = reranker
    inputs = _layout_inputs(np.random.default_rng(len(layout)), layout)
    args = [a for a in inputs if a is not None]
    weights = np.random.default_rng(9).normal(
        size=(4, 3) if layout == "grid" else (3, 4)).astype(np.float32)
    method = getattr(JReranker, METHODS[layout])

    def loss(p):
        out = jmodel.apply(p, *args, method=method, deterministic=False,
                           rngs={"dropout": jax.random.key(5)})
        return (out * weights).mean(), out

    ref, ref_grads = _jax_grads(loss, params)
    targs = [t(a) for a in inputs[:4]]
    if inputs[4] is not None:
        targs.append(t(inputs[4]).long())
    score = getattr(port, METHODS[layout])

    def run():
        out = score(*targs, deterministic=False,
                    seeds=_seeds(port.text_encoder)[0])
        return (out * t(weights)).mean(), out

    out, grads = _port_grads(port, run)
    assert out.shape == ref.shape
    np.testing.assert_allclose(f32(out), ref, rtol=0, atol=LOGIT_TOL)
    _assert_grads(grads, ref_grads, cfg)
    with torch.no_grad():
        assert float((score(*targs) - out).abs().max()) > 1e-3
