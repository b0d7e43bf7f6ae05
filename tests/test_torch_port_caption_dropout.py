"""Captioning with dropout (``CaptionDecoder``, ``BlipBase``) against the
JAX package on the CPU, with the kernel thresholds at 0 and JAX's seed
pinned, as ``tests/test_torch_port_dropout_layouts.py`` holds the
re-ranker's layouts (its helpers and its fixture): the ViT's and the MED's
self-attention (the causal bias included) and cross-attention all take
the in-kernel-dropout route with the K5 hash mask on both sides.

- ``CaptionDecoder``'s teacher-forced logits 1e-4 and the gradients of its
  caption loss (the mean next-token negative log-likelihood) 3e-5 against
  ``jax.grad``, and the mask applied;
- ``BlipBase``'s three modes 2e-5 and the multimodal gradients 3e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_utils import f32, fused, np_tree, port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models import blip_decoder as jdec
from candidate_reranking_cir_tpu.models.blip_base import BlipBase as JBase
from candidate_reranking_cir_tpu_torch.models import blip_decoder as pdec
from candidate_reranking_cir_tpu_torch.models.blip_base import BlipBase
from candidate_reranking_cir_tpu_torch.runtime.weights import from_jax_params
from test_torch_port_dropout_layouts import (  # noqa: F401 (the fixture)
    LOGIT_TOL,
    TEXT,
    VIT,
    L,
    W,
    _assert_grads,
    _jax_grads,
    _port_grads,
    _seeds,
    kernel_route,
)

BASE_TOL = 2e-5
CAP_CFG = jcfg.RetrievalModelConfig(vit=VIT, text=TEXT, text_len=L)


def _caption_inputs():
    rng = np.random.default_rng(4)
    imgs = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(1, 64, size=(2, L)).astype(np.int32)
    mask = np.ones((2, L), np.int32)
    mask[1, 4:] = 0
    return imgs, ids, mask


def _caption_loss_np(logits, ids, mask, xp):
    """Mean next-token negative log-likelihood over the valid targets."""
    if xp is jnp:
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logp, ids[:, 1:, None], axis=-1)[..., 0]
    else:
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, ids[:, 1:, None].long())[..., 0]
    valid = mask[:, 1:]
    return (nll * valid).sum() / valid.sum()


def test_caption_decoder_with_dropout_matches_jax():
    imgs, ids, mask = _caption_inputs()
    params = np_tree(jax.jit(jdec.CaptionDecoder(CAP_CFG).init)(
        jax.random.key(6), imgs, ids, mask))
    jmodel = jdec.CaptionDecoder(dataclasses.replace(
        CAP_CFG, vit=fused(VIT), text=fused(TEXT)))

    def loss(p):
        out = jmodel.apply(p, imgs, ids, mask, deterministic=False,
                           rngs={"dropout": jax.random.key(7)})
        return _caption_loss_np(out, ids, mask, jnp), out

    ref, ref_grads = _jax_grads(loss, params)
    port = pdec.CaptionDecoder(port_cfg(CAP_CFG), device="cpu")
    port.load_state_dict(from_jax_params(params, port_cfg(CAP_CFG)))
    seeds = _seeds(port.visual_encoder, port.text_decoder)

    def run():
        out = port(t(imgs), t(ids), t(mask), deterministic=False,
                   seeds=seeds)
        return _caption_loss_np(out, t(ids), t(mask), torch), out

    out, grads = _port_grads(port, run)
    np.testing.assert_allclose(f32(out), ref, rtol=0, atol=LOGIT_TOL)
    _assert_grads(grads, ref_grads, CAP_CFG)
    assert any(n.startswith("visual_encoder.") for n in grads)
    with torch.no_grad():
        assert float((port(t(imgs), t(ids), t(mask)) - out).abs().max()) \
            > 1e-3


def test_blip_base_with_dropout_matches_jax():
    imgs, ids, mask = _caption_inputs()
    params = np_tree(jax.jit(JBase(CAP_CFG).init)(jax.random.key(8), imgs,
                                                  ids, mask))
    jmodel = JBase(dataclasses.replace(CAP_CFG, vit=fused(VIT),
                                       text=fused(TEXT)))
    port = BlipBase(port_cfg(CAP_CFG), device="cpu")
    port.load_state_dict(from_jax_params(params, port_cfg(CAP_CFG)))
    seeds = _seeds(port.visual_encoder, port.text_encoder)
    weights = np.random.default_rng(10).normal(
        size=(2, 5, W)).astype(np.float32)   # the image's 5 tokens
    for mode in ("image", "text", "multimodal"):
        def loss(p, mode=mode):
            out = jmodel.apply(p, imgs, ids, mask, mode=mode,
                               deterministic=False,
                               rngs={"dropout": jax.random.key(11)})
            return (out[:, :5] * weights).mean(), out

        def run(mode=mode):
            out = port(t(imgs), t(ids), t(mask), mode=mode,
                       deterministic=False, seeds=seeds)
            return (out[:, :5] * t(weights)).mean(), out

        if mode != "multimodal":
            with torch.no_grad():
                out = run()[1]
            ref = np.asarray(jax.jit(lambda p: loss(p)[1])(params))
        else:
            ref, ref_grads = _jax_grads(loss, params)
            out, grads = _port_grads(port, run)
            _assert_grads(grads, ref_grads, CAP_CFG)
        np.testing.assert_allclose(f32(out), ref, rtol=0, atol=BASE_TOL,
                                   err_msg=mode)
