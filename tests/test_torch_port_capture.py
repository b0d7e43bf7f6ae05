"""Attention capture and perturbation (the config's ``capture_attention``
and ``perturb_attention``) in the port, against the JAX package on the
CPU with the same weights and inputs (numpy, from a seed).

JAX sows the pre-dropout probabilities into its 'intermediates'
collection and adds its 'perturbations' collection to them; the port
records into the caller's dict and adds the caller's zero tensors, whose
gradient is dLoss/dProbs. Tolerances: fp32 probabilities and outputs
2e-5, gradients 3e-5 (tests/test_pallas_attention*'s); bf16 2e-2 of the
reference's largest magnitude (bf16's tolerance); the captured output
against the uncaptured path 1e-6 (tests/test_attention_capture.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import TINY_TEXT, f32, np_tree, port_cfg, t
from candidate_reranking_cir_tpu.models import layers as jl
from candidate_reranking_cir_tpu.models.med import TextEncoder as JText
from candidate_reranking_cir_tpu.ops.attention import (
    make_additive_mask as jmask,
)
from candidate_reranking_cir_tpu_torch.models import layers as tl
from candidate_reranking_cir_tpu_torch.models import med as tmed
from candidate_reranking_cir_tpu_torch.ops.attention import (
    make_additive_mask as tmask,
)
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    jax_tree_to_state,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROB_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
INTRO = dict(capture_attention=True, perturb_attention=True)


def _load(module, tree):
    tree = tree.get("params", tree)
    module.load_state_dict(jax_tree_to_state(np_tree(tree)), strict=True)
    return module.eval()


def _close(a, b, tol, rel=False):
    """|a - b| <= tol (times b's largest magnitude where ``rel``)."""
    a, b = f32(a), f32(b)
    scale = float(np.abs(b).max()) if rel else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _mask(rng, b, n):
    lens = rng.integers(2, n + 1, size=b)
    return (np.arange(n)[None] < lens[:, None]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_capture_and_perturbation(dtype, cross):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    h, hd, width = 2, 8, 16
    x = rng.normal(size=(2, 5, width)).astype(np.float32)
    y = rng.normal(size=(2, 7, 12)).astype(np.float32) if cross else None
    m = 7 if cross else 5
    mask = _mask(rng, 2, m)
    w = rng.normal(size=(2, 5, width)).astype(np.float32)
    jm = jl.MultiHeadAttention(h, hd, width, jd, **INTRO)
    jargs = (jnp.asarray(x), None if y is None else jnp.asarray(y),
             jmask(jnp.asarray(mask)))
    variables = jm.init(jax.random.key(1), *jargs)
    params, perts = variables["params"], variables["perturbations"]
    out_j, st = jm.apply(variables, *jargs, mutable=["intermediates"])
    probs_j = st["intermediates"]["attn_probs"][0]

    def loss(p):
        out = jm.apply({"params": params, "perturbations": p}, *jargs)
        return jnp.sum(out.astype(jnp.float32) * w)

    grad_j = jax.grad(loss)(perts)["attn_probs"]

    kv = 12 if cross else None
    tm = _load(tl.MultiHeadAttention(h, hd, width, kv, td, "cpu", **INTRO),
               params)
    plain = _load(tl.MultiHeadAttention(h, hd, width, kv, td, "cpu"),
                  params)
    targs = (t(x), None if y is None else t(y), tmask(t(mask)))
    records = []
    pert = torch.zeros(2, h, 5, m, requires_grad=True)
    out = tm(*targs, record=records.append, perturbation=pert)
    (grad,) = torch.autograd.grad((out.float() * t(w)).sum(), pert)

    assert len(records) == 1 and records[0].shape == (2, h, 5, m)
    assert records[0].dtype == torch.float32
    _close(records[0], probs_j, PROB_TOL[dtype])
    _close(out, out_j, PROB_TOL[dtype], rel=dtype == "bfloat16")
    _close(grad, grad_j, GRAD_TOL[dtype], rel=dtype == "bfloat16")
    with torch.no_grad():
        _close(out, plain(*targs), 1e-6)


def _med(cfg, rng, g, q, l, m):
    ids = rng.integers(1, cfg.vocab_size, size=(g * q, l)).astype(np.int32)
    mask = _mask(rng, g * q, l)
    img = rng.normal(size=(g, m, cfg.encoder_width)).astype(np.float32)
    return ids, mask, img


def _jax_paths(tree):
    layers = tree["layers"]
    return {tmed.SELF_PROBS: layers["self_attn"]["attn"]["attn_probs"],
            tmed.CROSS_PROBS: layers["cross_attn"]["attn"]["attn_probs"]}


@pytest.mark.parametrize("q", [2, 3])
def test_med_capture_and_perturbation_with_query_group(q):
    """The MED stacks each layer's records as JAX's scan does; with
    query_group > 1 both unfold to per-query records; the perturbations'
    gradients equal JAX's."""
    cfg = dataclasses.replace(TINY_TEXT, **INTRO)
    rng = np.random.default_rng(q)
    g, l, m = 2, 5, 7
    ids, mask, img = _med(cfg, rng, g, q, l, m)
    w = rng.normal(size=(g * q, l, cfg.hidden_size)).astype(np.float32)
    jenc = JText(cfg, "multimodal")
    jargs = (jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(img))
    variables = jenc.init(jax.random.key(2), *jargs, query_group=q)
    out_j, st = jenc.apply(variables, *jargs, query_group=q,
                           mutable=["intermediates"])
    probs_j = {k: v[0] for k, v in _jax_paths(st["intermediates"]).items()}

    def loss(p):
        out = jenc.apply({"params": variables["params"], "perturbations": p},
                         *jargs, query_group=q)
        return jnp.sum(out * w)

    grads_j = _jax_paths(jax.grad(loss)(variables["perturbations"]))

    enc = _load(tmed.TextEncoder(port_cfg(cfg), device="cpu"),
                variables["params"])
    inter = {}
    perts = enc.zero_perturbations(g * q, l, m)
    out = enc(t(ids), t(mask), t(img), query_group=q, intermediates=inter,
              perturbations=perts)
    grads = torch.autograd.grad((out * t(w)).sum(), list(perts.values()))

    n, h = cfg.num_layers, cfg.num_heads
    assert inter[tmed.SELF_PROBS].shape == (n, g * q, h, l, l)
    assert inter[tmed.CROSS_PROBS].shape == (n, g * q, h, l, m)
    _close(out, out_j, PROB_TOL["float32"])
    for path, grad in zip(perts, grads):
        _close(inter[path], probs_j[path], PROB_TOL["float32"])
        _close(grad, grads_j[path], GRAD_TOL["float32"])
    # the records are the per-query ones: the same as each query against
    # its own repeated image
    ref = {}
    with torch.no_grad():
        enc(t(ids), t(mask), t(np.repeat(img, q, axis=0)), intermediates=ref)
    for path in ref:
        _close(inter[path], ref[path], 1e-6)


def test_capture_records_probabilities_before_dropout():
    """The record is pre-dropout (rows sum to 1), and the dropout after it
    changes the context (JAX's capture-branch dropout order)."""
    rng = np.random.default_rng(3)
    x = t(rng.normal(size=(2, 6, 16)).astype(np.float32))
    tm = tl.MultiHeadAttention(2, 8, 16, device="cpu", dropout_rate=0.5,
                               capture_attention=True)
    records = []
    with torch.no_grad():
        det = tm(x, record=records.append)
        gen = torch.Generator().manual_seed(4)
        train = tm(x, deterministic=False, generator=gen,
                   record=records.append)
    assert len(records) == 2
    torch.testing.assert_close(records[1], records[0], rtol=0, atol=0)
    torch.testing.assert_close(records[1].sum(-1),
                               torch.ones(2, 2, 6), rtol=0, atol=1e-6)
    assert (det - train).abs().max() > 1e-6


@pytest.mark.parametrize("policy", ["", "dots"])
def test_remat_records_each_layer_once(policy, monkeypatch):
    """Under remat the capture branch runs again when the backward
    recomputes a layer, but the records are the forward pass's only: the
    same tensors, the same values as without remat, and the perturbations'
    gradients equal."""
    rng = np.random.default_rng(5)
    g, l, m = 2, 5, 7
    cfg = dataclasses.replace(TINY_TEXT, **INTRO)
    ids, mask, img = _med(cfg, rng, g, 1, l, m)
    variables = JText(cfg, "multimodal").init(
        jax.random.key(6), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(img))
    calls = []
    introspect = tl.MultiHeadAttention._introspect

    def counted(self, *args):
        calls.append(1)
        return introspect(self, *args)

    monkeypatch.setattr(tl.MultiHeadAttention, "_introspect", counted)
    runs = {}
    for remat in (False, True):
        pcfg = port_cfg(dataclasses.replace(cfg, remat=remat,
                                            remat_policy=policy))
        enc = _load(tmed.TextEncoder(pcfg, device="cpu"), variables["params"])
        enc.train()
        inter, perts = {}, enc.zero_perturbations(g, l, m)
        calls.clear()
        out = enc(t(ids), t(mask), t(img), intermediates=inter,
                  perturbations=perts)
        recorded = {k: v.clone() for k, v in inter.items()}
        grads = torch.autograd.grad(out.sum(), list(perts.values()))
        runs[remat] = (len(calls), inter, recorded, grads)
    n = cfg.num_layers
    assert runs[False][0] == 2 * n              # self and cross, once
    assert runs[True][0] == 4 * n               # ... and the recomputation
    for remat in (False, True):
        _, inter, recorded, _ = runs[remat]
        for path in (tmed.SELF_PROBS, tmed.CROSS_PROBS):
            assert inter[path].shape[0] == n
            assert torch.equal(inter[path], recorded[path])
            assert torch.equal(inter[path], runs[False][1][path])
    for a, b in zip(runs[True][3], runs[False][3]):
        assert torch.equal(a, b)


def test_cached_decode_step_captures_like_jax():
    """A caption decode step (one token over the self-attention cache and
    the precomputed image K/V) records [n_layers, B, H, 1, T] and
    [n_layers, B, H, 1, M], as JAX's scan stacks them."""
    cfg = dataclasses.replace(TINY_TEXT, **INTRO)
    rng = np.random.default_rng(7)
    b, slots, m, idx = 2, 6, 7, 3
    ids, mask, img = _med(cfg, rng, b, 1, slots, m)
    jenc = JText(cfg, "multimodal")
    variables = jenc.init(jax.random.key(8), jnp.asarray(ids),
                          jnp.asarray(mask), jnp.asarray(img))
    params = {"params": variables["params"]}
    k_img, v_img = jenc.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(img), precompute_image_kv=True)
    n, h, d = cfg.num_layers, cfg.num_heads, cfg.head_dim
    cache = rng.normal(size=(2, n, b, slots, h, d)).astype(np.float32)
    step = ids[:, idx:idx + 1]
    cache_mask = (np.arange(slots)[None] <= idx).astype(np.int32) \
        .repeat(b, 0)
    (x_j, _), st = jenc.apply(
        params, jnp.asarray(step), jnp.asarray(cache_mask),
        decode_cache=(jnp.asarray(cache[0]), jnp.asarray(cache[1]), k_img,
                      v_img), cache_index=idx, mutable=["intermediates"])
    probs_j = {k: v[0] for k, v in _jax_paths(st["intermediates"]).items()}

    enc = _load(tmed.TextEncoder(port_cfg(cfg), device="cpu"),
                variables["params"])
    inter = {}
    with torch.no_grad():
        kv = enc(t(ids), t(mask), t(img), precompute_image_kv=True)
        x, _ = enc(t(step), t(cache_mask),
                   decode_cache=(t(cache[0]), t(cache[1]), *kv),
                   cache_index=idx, intermediates=inter)
    assert inter[tmed.SELF_PROBS].shape == (n, b, h, 1, slots)
    assert inter[tmed.CROSS_PROBS].shape == (n, b, h, 1, m)
    _close(x, x_j, PROB_TOL["float32"])
    for path, ref in probs_j.items():
        _close(inter[path], ref, PROB_TOL["float32"])
