"""The port's stage-I train step against the JAX package's, on the CPU.

A tiny configuration (ViT 1 layer, MED 2 layers, width 32, head width 16)
with the same weights (``runtime/weights.py::from_jax_params``) and the same
numpy batch. The JAX side runs ``make_stage1_train_step`` with its Pallas
kernels interpreted; its gradients are read off AdamW's first moment after
one step (mu = 0.1 g). Tolerances: loss 1e-5, gradients 3e-5; parameters
after two steps within 2 * lr * steps (Adam's first update is about
lr * sign(g)).

- each ``stage1_loss`` branch (cached ``target_pooled``, ``finetune_vit``,
  frozen ViT with target images) at dropout 0;
- the cached-target branch at attention dropout 0.1 with the kernel
  thresholds at 0 and the JAX seed pinned: the MED's self- and
  cross-attention take the folded in-kernel-dropout route on both sides
  (K8/K9 on the card, their plain versions here) with the K5 hash;
- remat on and off give identical losses and gradients (port only);
- the chunked frozen embed, the pooled corpus index and the text-bucket
  helpers against their JAX counterparts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32, fused, np_tree, port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.cli import common as jcommon
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu.retrieval.index import (
    build_index as j_build_index,
)
from candidate_reranking_cir_tpu.runtime import optim as joptim
from candidate_reranking_cir_tpu.runtime import train_steps as jsteps
from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.cli import common as tcommon
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.runtime import train_steps as tsteps
from candidate_reranking_cir_tpu_torch.runtime.optim import make_optimizer
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
    jax_tree_to_state,
)

VIT = jcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=32,
                     num_layers=1, num_heads=2)
TEXT = jcfg.TextEncoderConfig(vocab_size=64, hidden_size=32, num_layers=2,
                              num_heads=2, intermediate_size=48,
                              encoder_width=32, hidden_dropout=0.0,
                              attention_dropout=0.0)
B, L, E, LR, SEED = 4, 6, 8, 1e-3, 424242
BRANCHES = ("target_pooled", "finetune_vit", "frozen_targets")


def _cfg(text=TEXT):
    return jcfg.RetrievalModelConfig(vit=VIT, text=text, embed_dim=E,
                                     text_len=L)


def _batch(branch: str, params):
    """A numpy batch for ``branch``; its cached targets are the pooled
    features of its target images under ``params``, as the trainer's
    cache holds them."""
    rng = np.random.default_rng(0)
    mask = np.ones((B, L), np.int32)
    mask[1, 4:] = 0
    mask[3, 2:] = 0
    batch = {"ref_images": rng.normal(size=(B, 16, 16, 3)).astype(
                 np.float32),
             "input_ids": rng.integers(1, 64, size=(B, L)).astype(np.int32),
             "attention_mask": mask,
             "target_images": rng.normal(size=(B, 16, 16, 3)).astype(
                 np.float32)}
    if branch == "target_pooled":
        _, pooled = JRetrieval(_cfg()).apply(
            params, batch.pop("target_images"), pool_and_normalize=True,
            method=JRetrieval.embed_images)
        batch["target_pooled"] = np.array(pooled, np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_params():
    """JAX stage-I parameters, made once. The MED gets larger weights than
    the 0.02 init, so that the logits, the loss and the gradients are far
    from their trivial values."""
    rng = np.random.default_rng(1)
    p = jax.jit(JRetrieval(_cfg()).init)(
        jax.random.key(1), rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
        np.ones((2, L), np.int32), np.ones((2, L), np.int32))
    p = dict(p["params"])
    p["text_encoder"] = jax.tree_util.tree_map(
        lambda a: a * 4.0 if a.ndim >= 2 else a, p["text_encoder"])
    return {"params": p}


def _freeze(finetune_vit: bool):
    return () if finetune_vit else ("visual_encoder",)


def _run_jax(cfg, params, batch, finetune_vit, steps=2):
    """(losses, grads as port names, params after ``steps`` steps)."""
    model = JRetrieval(dataclasses.replace(cfg, vit=fused(cfg.vit),
                                           text=fused(cfg.text)))
    tx, _ = joptim.make_optimizer(
        jcfg.TrainConfig(learning_rate=LR), params, 10,
        freeze_prefixes=tuple(f"params/{p}" for p in _freeze(finetune_vit)))
    state = jsteps.TrainState.create(params, tx)
    step = jsteps.make_stage1_train_step(model, finetune_vit=finetune_vit,
                                         donate=False)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    losses, grads = [], None
    for i in range(steps):
        state, loss = step(state, jbatch, jax.random.key(3))
        losses.append(float(loss))
        if i == 0:
            adam = (state.opt_state[0] if finetune_vit
                    else state.opt_state.inner_state[0])
            mu = dict(adam.mu["params"])
            if not finetune_vit:
                del mu["visual_encoder"]             # frozen: no state
            grads = jax_tree_to_state(
                np_tree(jax.tree_util.tree_map(lambda m: m / 0.1, mu)))
    return losses, grads, from_jax_params(np_tree(state.params),
                                          port_cfg(cfg))


def _port_model(cfg, params, remat=False):
    pcfg = port_cfg(cfg)
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text,
                                                              remat=remat))
    model = RetrievalModel(pcfg, device="cpu")
    model.load_state_dict(from_jax_params(np_tree(params), port_cfg(cfg)))
    return model


def _run_port(model, batch, finetune_vit, steps=2):
    opt, _ = make_optimizer(tcfg.TrainConfig(learning_rate=LR), model, 10,
                            freeze_prefixes=_freeze(finetune_vit))
    step = tsteps.make_stage1_train_step(model, opt,
                                         finetune_vit=finetune_vit)
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(batch, 0)))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
    return losses, grads, model


@pytest.fixture(scope="module", params=BRANCHES)
def no_dropout(request, jax_params):
    branch = request.param
    finetune = branch == "finetune_vit"
    batch = _batch(branch, jax_params)
    ref = _run_jax(_cfg(), jax_params, batch, finetune)
    model = _port_model(_cfg(), jax_params)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    out = _run_port(model, batch, finetune)
    return branch, ref, out, init


def test_step_loss_matches_jax(no_dropout):
    _, (jl, _, _), (tl, _, _), _ = no_dropout
    assert abs(jl[0] - np.log(B)) > 1e-2         # not the trivial loss
    np.testing.assert_allclose(tl, jl, atol=1e-5)


def test_step_gradients_match_jax(no_dropout):
    branch, (_, jg, _), (_, tg, _), _ = no_dropout
    assert set(tg) == set(jg)
    assert any(n.startswith("visual_encoder.") for n in tg) == \
        (branch == "finetune_vit")
    assert max(float(g.abs().max()) for g in tg.values()) > 1e-2
    for name, g in tg.items():
        np.testing.assert_allclose(f32(g), f32(jg[name]), atol=3e-5,
                                   err_msg=name)
    # vision_proj gets a gradient only through embedded targets
    reaches = float(tg["vision_proj.weight"].abs().max()) > 0
    assert reaches == (branch == "finetune_vit")


def test_step_params_match_jax(no_dropout):
    branch, (_, _, jp), (_, _, model), init = no_dropout
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(f32(p), f32(jp[name]), atol=2 * LR * 2,
                                   err_msg=name)
        if name.startswith("visual_encoder.") and branch != "finetune_vit":
            assert torch.equal(p, init[name]), name
        elif name != "vision_proj.bias" or branch == "finetune_vit":
            # vision_proj without a gradient moves by weight decay only,
            # so its zero bias stays put
            assert not torch.equal(p, init[name]), name


def test_cached_targets_refuse_a_trained_vit(jax_params):
    model = _port_model(_cfg(), jax_params)
    with pytest.raises(ValueError, match="frozen ViT"):
        tsteps.stage1_loss(model, {"target_pooled": torch.zeros(B, E)},
                           finetune_vit=True)


@pytest.fixture(scope="module")
def kernel_dropout(jax_params):
    """Attention dropout 0.1 through the K5 hash at every MED attention
    site: thresholds 0 and one pinned seed on both sides."""
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jpat, tat):
            mp.setattr(mod, "MIN_KV", 0)
            mp.setattr(mod, "MIN_ROWS", 0)
        mp.setattr(jpat, "seed_from_rng",
                   lambda rng: jnp.array([SEED], jnp.int32))
        mp.setattr(tsteps, "draw_seeds",
                   lambda gen, shape: [[SEED] * shape[1]] * shape[0])
        batch = _batch("target_pooled", jax_params)
        cfg = _cfg(dataclasses.replace(TEXT, attention_dropout=0.1))
        ref = _run_jax(cfg, jax_params, batch, False, steps=1)
        out = _run_port(_port_model(cfg, jax_params), batch, False, steps=1)
        det = _run_port(_port_model(_cfg(), jax_params), batch, False,
                        steps=1)
    finally:
        mp.undo()
    return ref, out, det


def test_kernel_dropout_step_loss_matches_jax(kernel_dropout):
    (jl, _, _), (tl, _, _), (dl, _, _) = kernel_dropout
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert abs(tl[0] - dl[0]) > 1e-4             # the masks were applied


def test_kernel_dropout_step_gradients_match_jax(kernel_dropout):
    (_, jg, _), (_, tg, _), _ = kernel_dropout
    assert set(tg) == set(jg)
    for name, g in tg.items():
        np.testing.assert_allclose(f32(g), f32(jg[name]), atol=3e-5,
                                   err_msg=name)


@pytest.mark.parametrize("kernel_route", [False, True])
def test_remat_on_and_off_identical(kernel_route, jax_params, monkeypatch):
    """Hidden and attention dropout 0.1: with the default thresholds every
    dropout draws from a layer's generator; with the thresholds at 0 the
    attention sites use the K5 hash."""
    if kernel_route:
        monkeypatch.setattr(tat, "MIN_KV", 0)
        monkeypatch.setattr(tat, "MIN_ROWS", 0)
    cfg = _cfg(dataclasses.replace(TEXT, hidden_dropout=0.1,
                                   attention_dropout=0.1))
    batch = _batch("target_pooled", jax_params)
    runs = [_run_port(_port_model(cfg, jax_params, remat=remat), batch,
                      False, steps=1) for remat in (False, True)]
    (l0, g0, _), (l1, g1, _) = runs
    assert l0 == l1
    assert set(g0) == set(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_cpu_stage1_step_launches_no_kernel(jax_params, monkeypatch):
    """On CPU tensors the folded train route (K8/K9's) and the eval routes
    run their plain versions."""
    monkeypatch.setattr(tat, "MIN_KV", 0)
    monkeypatch.setattr(tat, "MIN_ROWS", 0)
    ck.reset_launch_counts()
    tat.reset_launch_counts()
    cfg = _cfg(dataclasses.replace(TEXT, attention_dropout=0.1))
    losses, grads, _ = _run_port(_port_model(cfg, jax_params),
                                 _batch("frozen_targets", jax_params), False,
                                 steps=1)
    assert np.isfinite(losses[0]) and grads
    assert set(ck.LAUNCHES.values()) == {0}
    assert set(tat.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# the frozen embed, the pooled index and the text buckets


@pytest.mark.parametrize("pooled", [False, True])
def test_frozen_embed_chunked_equals_unchunked(pooled, jax_params,
                                               monkeypatch):
    model = _port_model(_cfg(), jax_params)
    images = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2 * tsteps._VIT_CHUNK, 16, 16, 3)).astype(np.float32))
    calls = []
    embed = model.embed_images

    def counted(x, **kw):
        calls.append(x.shape[0])
        return embed(x, **kw)

    monkeypatch.setattr(model, "embed_images", counted)
    chunked = tsteps._frozen_embed(model, images, pooled=pooled)
    assert calls == [tsteps._VIT_CHUNK] * 2
    whole = tsteps._frozen_embed(model, images[:-1], pooled=pooled)
    assert calls[-1] == len(images) - 1          # not a multiple: one call
    with torch.no_grad():
        ref = embed(images, pool_and_normalize=pooled)
    outs = chunked if pooled else (chunked,)
    refs = ref if pooled else (ref,)
    for out, r in zip(outs, refs):
        assert not out.requires_grad
        torch.testing.assert_close(out, r, rtol=0, atol=1e-6)
    first = whole[0] if pooled else whole
    torch.testing.assert_close(first, refs[0][:-1], rtol=0, atol=1e-6)


class _Corpus:
    def __init__(self, n):
        rng = np.random.default_rng(6)
        self.index_names = [f"img{i}" for i in range(n)]
        self.images = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)

    def __len__(self):
        return len(self.index_names)

    def __getitem__(self, i):
        return {"name": self.index_names[i], "image": self.images[i]}


def test_build_index_pooled_matches_jax(jax_params):
    """The trainer's target-feature cache: pooled-only output, batches with
    a short tail."""
    corpus = _Corpus(5)
    jmodel = JRetrieval(_cfg())
    embed = jax.jit(lambda x: jmodel.apply(
        jax_params, x, pool_and_normalize=True,
        method=JRetrieval.embed_images))
    _, jpooled, jnames = j_build_index(corpus, embed, 2, pooled=True,
                                       keep_raw=False)
    model = _port_model(_cfg(), jax_params)

    def pooled_embed(x):
        return model.embed_images(x, pool_and_normalize=True)

    bank, pooled, names = build_index(corpus, pooled_embed, 2, pooled=True,
                                      keep_raw=False, device="cpu")
    assert bank is None and names == jnames
    assert pooled.dtype == torch.float32 and pooled.shape == (5, E)
    np.testing.assert_allclose(f32(pooled), f32(jpooled), atol=1e-5)
    # with the raw bank too; and the eval callers' default is unchanged
    bank, pooled2, _ = build_index(corpus, pooled_embed, 2, pooled=True,
                                   device="cpu")
    assert bank.shape == (5, VIT.num_tokens, 32) and torch.equal(pooled2,
                                                                 pooled)
    raw, names = build_index(corpus, model.embed_images, 2, device="cpu")
    assert torch.equal(raw, bank) and names == jnames
    with pytest.raises(ValueError, match="neither pooled nor keep_raw"):
        build_index(corpus, model.embed_images, 2, keep_raw=False,
                    device="cpu")


@pytest.mark.parametrize("spec,text_len", [
    ("auto", 40), ("auto", 30), ("off", 40), ("none", 24), ("24,32", 40),
    ("16,64", 40), ("8", 12)])
def test_text_buckets_match_jax(spec, text_len):
    buckets = tcommon.parse_text_buckets(spec, text_len)
    assert buckets == jcommon.parse_text_buckets(spec, text_len)
    rng = np.random.default_rng(text_len)
    ids = rng.integers(1, 64, size=(3, text_len)).astype(np.int32)
    for longest in (1, text_len // 2, text_len - 1, text_len):
        mask = np.zeros((3, text_len), np.int32)
        mask[:, :1] = 1
        mask[1, :longest] = 1
        ref = jcommon.text_bucket_slice(ids, mask, buckets)
        for conv in (np.asarray, t):
            out = tcommon.text_bucket_slice(conv(ids), conv(mask), buckets)
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(np.asarray(a), b)
