"""The port's stage-II train step against the JAX package's, on the CPU.

A tiny configuration (ViT 1 layer, dual encoder 2 layers, width 32, head
width 16) with the same weights (``runtime/weights.py::from_jax_params``)
and the same numpy batch. The JAX side runs ``make_stage2_train_step``
with its Pallas kernels interpreted; its gradients are read off AdamW's
first moment after one step (mu = 0.1 g). Tolerances: loss 1e-5,
gradients 3e-5; parameters after two steps within 2 * lr * steps (Adam's
first update is about lr * sign(g), so a gradient that agrees with 0
within tolerance may still flip an update).

- all dropout 0: every attention site takes the eval kernels' routes;
- attention dropout 0.1 with the kernel thresholds at 0 and the JAX seed
  pinned: every attention site takes the in-kernel-dropout route and the
  K5 hash on both sides (the dual encoder's self-attention the folded
  route, K8, which the port runs on the CPU through its plain version);
- remat on and off give identical losses and gradients (port only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32, fused, np_tree, port_cfg
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu.runtime import optim as joptim
from candidate_reranking_cir_tpu.runtime import train_steps as jsteps
from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.data.loader import BatchLoader, prefetch
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
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
                              encoder_width=32, merge_mlp_from=1,
                              hidden_dropout=0.0, attention_dropout=0.0)
B, L, LR, SEED = 3, 6, 1e-3, 424242


def _batch():
    rng = np.random.default_rng(0)
    mask = np.ones((B, L), np.int32)
    mask[1, 4:] = 0
    return {"ref_images": rng.normal(size=(B, 16, 16, 3)).astype(np.float32),
            "target_images": rng.normal(size=(B, 16, 16, 3)).astype(
                np.float32),
            "input_ids": rng.integers(1, 64, size=(B, L)).astype(np.int32),
            "attention_mask": mask}


def _configs(text):
    s1 = jcfg.RetrievalModelConfig(vit=VIT, text=TEXT, embed_dim=8,
                                   text_len=L)
    s2 = jcfg.RerankerModelConfig(vit=VIT, text=text, text_len=L)
    return s1, s2


@pytest.fixture(scope="module")
def jax_params():
    """JAX stage-I and stage-II parameters, made once (the dropout rates do
    not change them). The trained part gets larger weights than the 0.02
    init, so that the logits, the loss and the gradients are far from
    their trivial values."""
    batch = _batch()
    s1_cfg, s2_cfg = _configs(TEXT)
    s1p = jax.jit(JRetrieval(s1_cfg).init)(
        jax.random.key(1), batch["ref_images"][:2], batch["input_ids"][:2],
        batch["attention_mask"][:2])
    s2p = jax.jit(JReranker(s2_cfg).init)(
        jax.random.key(2), batch["target_images"][:2],
        batch["input_ids"][:2], batch["attention_mask"][:2],
        np.zeros((2, L, 32), np.float32))
    p = dict(s2p["params"])
    for key in ("text_encoder", "cls_dense1", "cls_dense2"):
        p[key] = jax.tree_util.tree_map(
            lambda a: a * 8.0 if a.ndim >= 2 else a, p[key])
    return s1p, {"params": p}


def _run_jax(s1_cfg, s2_cfg, s1p, s2p, batch, steps=2):
    """(losses, grads as port names, params after ``steps`` steps)."""
    s1 = JRetrieval(dataclasses.replace(s1_cfg, vit=fused(s1_cfg.vit),
                                        text=fused(s1_cfg.text)))
    s2 = JReranker(dataclasses.replace(s2_cfg, vit=fused(s2_cfg.vit),
                                       text=fused(s2_cfg.text)))
    tx, _ = joptim.make_optimizer(jcfg.TrainConfig(learning_rate=LR), s2p,
                                  10,
                                  freeze_prefixes=("params/visual_encoder",))
    state = jsteps.TrainState.create(s2p, tx)
    step = jsteps.make_stage2_train_step(s1, s2, donate=False)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    losses, grads = [], None
    for i in range(steps):
        state, loss = step(state, s1p, jbatch, jax.random.key(3))
        losses.append(float(loss))
        if i == 0:
            adam = state.opt_state.inner_state[0]
            mu = dict(adam.mu["params"])
            del mu["visual_encoder"]                 # frozen: no state
            grads = jax_tree_to_state(
                np_tree(jax.tree_util.tree_map(lambda m: m / 0.1, mu)),
                mlp_offset=TEXT.merge_mlp_from)
    params = from_jax_params(np_tree(state.params), port_cfg(s2_cfg))
    return losses, grads, params


def _port_models(s1_cfg, s2_cfg, s1p, s2p, remat=False):
    s1 = RetrievalModel(port_cfg(s1_cfg), device="cpu")
    s1.load_state_dict(from_jax_params(np_tree(s1p), port_cfg(s1_cfg)))
    cfg2 = port_cfg(s2_cfg)
    cfg2 = dataclasses.replace(cfg2, text=dataclasses.replace(cfg2.text,
                                                              remat=remat))
    s2 = RerankerModel(cfg2, device="cpu")
    s2.load_state_dict(from_jax_params(np_tree(s2p), port_cfg(s2_cfg)))
    return s1, s2


def _run_port(s1, s2, batch, steps=2):
    opt, _ = make_optimizer(tcfg.TrainConfig(learning_rate=LR), s2, 10,
                            freeze_prefixes=("visual_encoder",))
    step = tsteps.make_stage2_train_step(s1, s2, opt)
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(batch, 0)))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in s2.named_parameters()
                     if p.grad is not None}
    return losses, grads, s2


@pytest.fixture(scope="module")
def no_dropout(jax_params):
    batch = _batch()
    s1_cfg, s2_cfg = _configs(TEXT)
    s1p, s2p = jax_params
    ref = _run_jax(s1_cfg, s2_cfg, s1p, s2p, batch)
    s1, s2 = _port_models(s1_cfg, s2_cfg, s1p, s2p)
    init = {k: v.clone() for k, v in s2.state_dict().items()}
    out = _run_port(s1, s2, batch)
    return ref, out, init


def test_step_loss_matches_jax(no_dropout):
    (jl, _, _), (tl, _, _), _ = no_dropout
    assert abs(jl[0] - np.log(B)) > 1e-2         # not the trivial loss
    np.testing.assert_allclose(tl, jl, atol=1e-5)


def test_step_gradients_match_jax(no_dropout):
    (_, jg, _), (_, tg, _), _ = no_dropout
    assert set(tg) == set(jg)                     # no ViT gradients
    assert max(float(g.abs().max()) for g in tg.values()) > 1e-2
    for name, g in tg.items():
        np.testing.assert_allclose(f32(g), f32(jg[name]), atol=3e-5,
                                   err_msg=name)


def test_step_params_match_jax_and_vit_stays_frozen(no_dropout):
    (_, _, jp), (_, _, s2), init = no_dropout
    for name, p in s2.state_dict().items():
        np.testing.assert_allclose(f32(p), f32(jp[name]), atol=2 * LR * 2,
                                   err_msg=name)
        if name.startswith("visual_encoder."):
            assert torch.equal(p, init[name]), name
            assert torch.equal(p, jp[name]), name
        else:
            assert not torch.equal(p, init[name]), name


@pytest.fixture(scope="module")
def kernel_dropout(jax_params):
    """Attention dropout 0.1 everywhere through the K5 hash: thresholds 0
    and one pinned seed on both sides."""
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jpat, tat):
            mp.setattr(mod, "MIN_KV", 0)
            mp.setattr(mod, "MIN_ROWS", 0)
        mp.setattr(jpat, "seed_from_rng",
                   lambda rng: jnp.array([SEED], jnp.int32))
        mp.setattr(tsteps, "draw_seeds",
                   lambda gen, shape: [[SEED] * shape[1]] * shape[0])
        batch = _batch()
        s1_cfg, s2_cfg = _configs(dataclasses.replace(TEXT,
                                                      attention_dropout=0.1))
        s1p, s2p = jax_params
        ref = _run_jax(s1_cfg, s2_cfg, s1p, s2p, batch, steps=1)
        s1, s2 = _port_models(s1_cfg, s2_cfg, s1p, s2p)
        out = _run_port(s1, s2, batch, steps=1)
        # the same step without dropout, to show the mask was applied
        s1, s2 = _port_models(*_configs(TEXT), s1p, s2p)
        det = _run_port(s1, s2, batch, steps=1)
    finally:
        mp.undo()
    return ref, out, det


def test_kernel_dropout_step_loss_matches_jax(kernel_dropout):
    (jl, _, _), (tl, _, _), (dl, _, _) = kernel_dropout
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert abs(tl[0] - dl[0]) > 1e-4


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
    batch = _batch()
    text = dataclasses.replace(TEXT, hidden_dropout=0.1,
                               attention_dropout=0.1)
    s1_cfg, s2_cfg = _configs(text)
    s1p, s2p = jax_params
    runs = []
    for remat in (False, True):
        s1, s2 = _port_models(s1_cfg, s2_cfg, s1p, s2p, remat=remat)
        runs.append(_run_port(s1, s2, batch, steps=1))
    (l0, g0, _), (l1, g1, _) = runs
    assert l0 == l1
    assert set(g0) == set(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


class _Triplets:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 3:
            return None                              # a decode error
        return {"i": np.asarray(i), "caption": f"c{i}"}


def test_batch_loader_backfills_and_drops_the_tail():
    loader = BatchLoader(_Triplets(11), 4, workers=2)
    batches = list(prefetch(iter(loader), 2))
    assert len(loader) == 2 and len(batches) == 2
    assert batches[0]["i"].tolist() == [0, 1, 2, 4]
    assert batches[1]["caption"] == ["c5", "c6", "c7", "c8"]
    shuffled = BatchLoader(_Triplets(11), 4, shuffle=True, seed=1, workers=2)
    first = [b["i"].tolist() for b in shuffled]
    second = [b["i"].tolist() for b in shuffled]      # next epoch's order
    assert first != second and len(first) == 2


def test_prefetch_reraises_the_producer_error():
    def broken():
        yield 1
        raise KeyError("boom")

    it = prefetch(broken(), 1)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


def test_cpu_train_step_launches_no_kernel():
    """On CPU tensors every train route (the eval kernels' routes, the
    pair grid through K6/K7's route, plain dropout) runs plain versions."""
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

    ck.reset_launch_counts()
    tat.reset_launch_counts()
    torch.manual_seed(0)
    s1_cfg, s2_cfg = _configs(dataclasses.replace(TEXT, hidden_dropout=0.1,
                                                  attention_dropout=0.1))
    s1 = RetrievalModel(port_cfg(s1_cfg), device="cpu")
    s2 = RerankerModel(port_cfg(s2_cfg), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tat, "MIN_KV", 0)          # make the pair grid eligible
        losses, grads, _ = _run_port(s1, s2, _batch(), steps=1)
    assert np.isfinite(losses[0]) and grads
    assert set(ck.LAUNCHES.values()) == {0}
    assert set(tat.LAUNCHES.values()) == {0}


def test_finetune_vit_step_trains_the_vit():
    """finetune_vit: the ViT embeds in train mode (stochastic depth from
    the seed table) under autograd and is updated; the step is a pure
    function of the weights, the batch and the run's seed."""
    s1_cfg, s2_cfg = _configs(TEXT)
    s2_cfg = dataclasses.replace(
        s2_cfg, vit=dataclasses.replace(VIT, num_layers=2,
                                        drop_path_rate=0.5))
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        s1 = RetrievalModel(port_cfg(s1_cfg), device="cpu")
        s2 = RerankerModel(port_cfg(s2_cfg), device="cpu")
        vit0 = {k: v.clone() for k, v in s2.visual_encoder.state_dict().items()}
        opt, _ = make_optimizer(tcfg.TrainConfig(learning_rate=LR), s2, 10)
        step = tsteps.make_stage2_train_step(s1, s2, opt, finetune_vit=True)
        loss = float(step(_batch(), 5))
        vit_grads = [p.grad for p in s2.visual_encoder.parameters()]
        assert all(g is not None and torch.isfinite(g).all()
                   for g in vit_grads)
        assert any(float(g.abs().max()) > 0 for g in vit_grads)
        assert all(not torch.equal(v, vit0[k]) for k, v in
                   s2.visual_encoder.state_dict().items())
        runs.append(loss)
    assert np.isfinite(runs[0]) and runs[0] == runs[1]
