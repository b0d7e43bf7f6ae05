"""The port's data-parallel and ZeRO-sharded train steps, on four gloo
ranks on the CPU, against the JAX package's steps on a four-device
virtual mesh and against the port's own one-process steps.

Tiny models (the JAX package's tests/test_parallel.py configs: ViT 16 px,
width 16, 2 layers; text length 6) at dropout 0, one world of four ranks
running every case (``_torch_port_mesh_worker.train_cases``):
- one stage-I and one stage-II step, replicated and with ``fsdp``: losses
  1e-5 and parameters after the AdamW update 3e-5 against JAX's step on
  the mesh with its state FSDP-sharded (JAX's own tests hold that to its
  replicated step), and AdamW's first moments (0.1 x the gradient) 3e-6
  plus 5e-4 of the largest;
- ``fsdp_param_spec`` equal to JAX's on every parameter shape of both
  models, and each rank's moments a quarter of the replicated bytes for
  every sharded parameter;
- the frozen-ViT mask and two-step accumulation (stage I, ``fsdp``)
  against the one-process run;
- world-size independence at dropout 0.1 (ViT 32 px: 17 image tokens):
  four ranks against one process, losses 1e-5, at the default kernel
  thresholds (every dropout from a generator) and with MIN_KV 10,
  MIN_ROWS 0 (the image cross-attention through the K5-keyed kernels'
  plain versions; the 6-token self-attention still a generator);
- the collective audit: a stage-I step all-gathers the targets and
  all-reduces the gradients; an ``fsdp`` step reduce-scatters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_mesh_worker as worker
from _torch_port_utils import f32, np_tree, port_cfg
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.parallel import mesh as jmesh
from candidate_reranking_cir_tpu.runtime import optim as joptim
from candidate_reranking_cir_tpu.runtime import train_steps as jsteps
from candidate_reranking_cir_tpu_torch.parallel import mesh as tmesh
from candidate_reranking_cir_tpu_torch.parallel.launch import run_world
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
    jax_tree_to_state,
)

WORLD, B, L, LR, SEED = 4, 8, 6, 1e-5, 7
VIT = jcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                     num_layers=2, num_heads=2)
TEXT = jcfg.TextEncoderConfig(vocab_size=64, hidden_size=16, num_layers=2,
                              num_heads=2, intermediate_size=32,
                              encoder_width=16, merge_mlp_from=1,
                              hidden_dropout=0.0, attention_dropout=0.0)
S1 = jcfg.RetrievalModelConfig(vit=VIT, text=TEXT, embed_dim=8, text_len=L)
S2 = jcfg.RerankerModelConfig(vit=dataclasses.replace(VIT,
                                                      drop_path_rate=0.0),
                              text=TEXT, text_len=L)
# the dropout cases: 17 image tokens, so that MIN_KV 10 routes the image
# cross-attention, and not the 6-token self-attention, to the kernels
DVIT = dataclasses.replace(VIT, image_size=32)
DTEXT = dataclasses.replace(TEXT, hidden_dropout=0.1, attention_dropout=0.1)
DS1 = dataclasses.replace(S1, vit=DVIT, text=DTEXT)
DS2 = dataclasses.replace(S2, vit=dataclasses.replace(S2.vit,
                                                      image_size=32),
                          text=DTEXT)
KERNEL_THRESHOLDS = (10, 0)
# AdamW's first moment (0.1 x the gradient): 3e-6, plus 5e-4 of the
# largest, since the x12 dual encoder's gradients reach ~8 and fp32 sums
# in another order (four ranks' blocks, or JAX) move them by up to 2.7e-4
# of that
TOL = dict(loss=1e-5, params=3e-5, mu=3e-6, mu_rel=5e-4)


def _batch(size: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 4:] = 0
    mask[6, 5:] = 0
    return {"ref_images": rng.normal(size=(B, size, size, 3)).astype(
                np.float32),
            "target_images": rng.normal(size=(B, size, size, 3)).astype(
                np.float32),
            "input_ids": rng.integers(4, 60, size=(B, L)).astype(np.int32),
            "attention_mask": mask}


def _jax_params(batch):
    """JAX stage-I and stage-II params; the trained parts scaled up, so
    that losses and gradients are far from their trivial values."""
    s1p = jax.jit(JRetrieval(S1).init)(
        jax.random.key(1), batch["ref_images"][:2], batch["input_ids"][:2],
        batch["attention_mask"][:2])
    s2p = jax.jit(JReranker(S2).init)(
        jax.random.key(2), batch["target_images"][:2],
        batch["input_ids"][:2], batch["attention_mask"][:2],
        np.zeros((2, L, TEXT.hidden_size), np.float32))

    def scale(tree, keys, factor):
        p = dict(tree["params"])
        for key in keys:
            p[key] = jax.tree_util.tree_map(
                lambda a: a * factor if a.ndim >= 2 else a, p[key])
        return {"params": p}

    return (scale(s1p, ("text_encoder", "text_proj"), 6.0),
            scale(s2p, ("text_encoder", "cls_dense1", "cls_dense2"), 12.0))


def _port_params(seed: int):
    """The dropout cases' weights: the port's own initialization (the
    world-size comparison is port against port), scaled as JAX's."""
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    torch.manual_seed(seed)
    out = []
    for cls, cfg, keys, factor in (
            (RetrievalModel, DS1, ("text_encoder", "text_proj"), 6.0),
            (RerankerModel, DS2, ("text_encoder", "cls_dense"), 12.0)):
        state = cls(port_cfg(cfg), device="cpu").state_dict()
        out.append({k: v * factor if v.ndim >= 2 and k.startswith(keys)
                    else v for k, v in state.items()})
    return out


def _jax_step(stage: int, s1p, s2p, batch):
    """One JAX step on a four-device mesh, the state FSDP-sharded (JAX's
    own tests hold it to the replicated step): (loss, params as port
    names, AdamW's mu as port names)."""
    params = s1p if stage == 1 else s2p
    tx, _ = joptim.make_optimizer(jcfg.TrainConfig(learning_rate=LR), params,
                                  10,
                                  freeze_prefixes=("params/visual_encoder",))
    state = jsteps.TrainState.create(params, tx)
    mesh = jmesh.make_mesh(jax.devices()[:WORLD])
    with jax.set_mesh(mesh):
        state = jmesh.shard_state(mesh, state, True)
        sharded = jmesh.shard_batch(mesh, jax.tree_util.tree_map(
            jnp.asarray, batch))
        if stage == 1:
            step = jsteps.make_stage1_train_step(JRetrieval(S1), donate=False)
            state, loss = step(state, sharded, jax.random.key(3))
        else:
            s1 = jax.device_put(s1p, jmesh.replicated(mesh))
            step = jsteps.make_stage2_train_step(JRetrieval(S1), JReranker(S2),
                                                 donate=False)
            state, loss = step(state, s1, sharded, jax.random.key(3))
    cfg = port_cfg(S1 if stage == 1 else S2)
    mu = dict(state.opt_state.inner_state[0].mu["params"])
    del mu["visual_encoder"]                          # frozen: no moments
    return (float(loss), from_jax_params(np_tree(state.params), cfg),
            jax_tree_to_state(np_tree(mu), mlp_offset=TEXT.merge_mlp_from))


def _case(stage, s1_state, s2_state, batch, s1_cfg=S1, s2_cfg=S2, **kw):
    return {"stage": stage, "s1_cfg": port_cfg(s1_cfg),
            "s2_cfg": port_cfg(s2_cfg), "s1_state": s1_state,
            "s2_state": s2_state, "batch": batch, "lr": LR, "seed": SEED,
            "steps": 1, **kw}


@pytest.fixture(scope="module")
def runs():
    """Every case: JAX's four-device steps, the port's four-rank world
    (one spawn) and the port's one-process steps."""
    batch, dbatch = _batch(16), _batch(32, seed=1)
    s1p, s2p = _jax_params(batch)
    s1_state = from_jax_params(np_tree(s1p), port_cfg(S1))
    s2_state = from_jax_params(np_tree(s2p), port_cfg(S2))
    d1_state, d2_state = _port_params(11)
    cases = {}
    for stage in (1, 2):
        for fsdp in (False, True):
            cases[("dp", stage, fsdp)] = _case(stage, s1_state, s2_state,
                                               batch, fsdp=fsdp)
        for thr in (None, KERNEL_THRESHOLDS):
            cases[("dropout", stage, thr)] = _case(
                stage, d1_state, d2_state, dbatch, DS1, DS2, fsdp=True,
                thresholds=thr)
    cases["accumulation"] = _case(1, s1_state, s2_state, batch, fsdp=True,
                                  accumulation=2, steps=2)
    keys = list(cases)
    ranks = run_world(worker.train_cases, WORLD, device="cpu",
                      args=([cases[k] for k in keys],), timeout_s=120)
    port4 = {k: [r[i] for r in ranks] for i, k in enumerate(keys)}
    port1 = {k: worker.train_case(cases[k], None) for k in keys
             if k[0] != "dp" or not k[2]}
    for stage in (1, 2):  # the dropout cases' weights at dropout 0
        port1[("no_dropout", stage)] = worker.train_case(_case(
            stage, d1_state, d2_state, dbatch,
            dataclasses.replace(DS1, text=TEXT),
            dataclasses.replace(DS2, text=TEXT)), None)
    jax4 = {stage: _jax_step(stage, s1p, s2p, batch) for stage in (1, 2)}
    return {"port4": port4, "port1": port1, "jax4": jax4,
            "s1_state": s1_state, "s2_state": s2_state}


def _close(got: dict, want: dict, atol: float, names=None):
    for name in names or want:
        np.testing.assert_allclose(f32(got[name]), f32(want[name]),
                                   atol=atol, rtol=0, err_msg=name)


def _close_mu(got: dict, want: dict, names=None):
    biggest = max(float(np.abs(f32(want[n])).max()) for n in names or want)
    _close(got, want, TOL["mu"] + TOL["mu_rel"] * biggest, names)


@pytest.mark.parametrize("stage,fsdp", [(1, False), (1, True), (2, False),
                                        (2, True)])
def test_step_matches_jax_mesh(runs, stage, fsdp):
    jloss, jparams, jmu = runs["jax4"][stage]
    rank0 = runs["port4"][("dp", stage, fsdp)][0]
    assert abs(jloss - np.log(B)) > 1e-2           # not the trivial loss
    assert abs(rank0["losses"][0] - jloss) <= TOL["loss"]
    for r in runs["port4"][("dp", stage, fsdp)]:    # every rank's loss
        assert r["losses"] == rank0["losses"]
    _close(rank0["params"], jparams, TOL["params"])
    trained = [n for n, p in rank0["params"].items()
               if not n.startswith("visual_encoder.")]
    mu = dict(zip(trained, rank0["mu"]))
    assert max(float(m.abs().max()) for m in mu.values()) > 1e-4
    _close_mu(mu, jmu, names=trained)


@pytest.mark.parametrize("stage", [1, 2])
def test_fsdp_step_matches_replicated_and_one_process(runs, stage):
    rep = runs["port4"][("dp", stage, False)][0]
    one = runs["port1"][("dp", stage, False)]
    for other in (runs["port4"][("dp", stage, True)][0], one):
        assert abs(other["losses"][0] - rep["losses"][0]) <= TOL["loss"]
        _close(other["params"], rep["params"], TOL["params"])
        _close_mu(dict(enumerate(other["mu"])), dict(enumerate(rep["mu"])))


def test_fsdp_param_spec_and_sharded_moments(runs):
    shapes = set()
    for state in (runs["s1_state"], runs["s2_state"]):
        shapes |= {tuple(v.shape) for v in state.values()}
    shapes |= {(), (3,), (4, 6), (6, 4), (8, 8), (5, 12, 3), (2, 2)}
    for shape in shapes:
        for size in (1, 2, 4, 8):
            spec = jmesh.fsdp_param_spec(shape, size)
            want = spec.index("data") if "data" in tuple(spec) else None
            assert tmesh.fsdp_param_spec(shape, size) == want, (shape, size)
    for stage in (1, 2):
        ranks = runs["port4"][("dp", stage, True)]
        rep = runs["port4"][("dp", stage, False)][0]
        dims, shapes = ranks[0]["shard_dims"], ranks[0]["param_shapes"]
        assert dims == [tmesh.fsdp_param_spec(sh, WORLD) for sh in shapes]
        assert any(d is not None for d in dims)
        for r in ranks:  # every sharded moment is a quarter, on every rank
            for sh, d, m in zip(shapes, dims, r["moment_shapes"]):
                want = list(sh)
                if d is not None:
                    want[d] //= WORLD
                assert list(m) == want, (sh, d, m)
        assert rep["moment_shapes"] == shapes
        whole = [sh for sh, d in zip(shapes, dims) if d is None]
        # only parameters with no dimension divisible by 4 stay whole
        assert all(all(s % WORLD for s in sh) for sh in whole)
        full = 2 * 4 * sum(int(np.prod(sh)) for sh in shapes)
        kept = 2 * 4 * sum(int(np.prod(sh)) for sh in whole)
        assert rep["moment_bytes"] == full
        assert ranks[0]["moment_bytes"] == (full - kept) // WORLD + kept


def test_accumulation_and_frozen_vit_as_one_process(runs):
    four = runs["port4"]["accumulation"][0]
    one = runs["port1"]["accumulation"]
    np.testing.assert_allclose(four["losses"], one["losses"], atol=1e-5)
    _close(four["params"], one["params"], TOL["params"])
    for name, p in four["params"].items():
        if name.startswith("visual_encoder."):
            assert torch.equal(p, runs["s1_state"][name]), name
    # two micro-steps make one update: the trained part moved
    assert not torch.equal(four["params"]["text_proj.weight"],
                           runs["s1_state"]["text_proj.weight"])


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("thresholds", [None, KERNEL_THRESHOLDS])
def test_dropout_does_not_depend_on_the_world_size(runs, stage, thresholds):
    four = runs["port4"][("dropout", stage, thresholds)]
    one = runs["port1"][("dropout", stage, thresholds)]
    deterministic = runs["port1"][("no_dropout", stage)]["losses"][0]
    assert abs(one["losses"][0] - four[0]["losses"][0]) <= TOL["loss"]
    assert abs(one["losses"][0] - deterministic) > 1e-3  # dropout acted
    _close_mu(dict(enumerate(four[0]["mu"])), dict(enumerate(one["mu"])))


def test_collective_audit(runs):
    s1_rep = runs["port4"][("dp", 1, False)][0]["counts"]
    s1_fsdp = runs["port4"][("dp", 1, True)][0]["counts"]
    s2_rep = runs["port4"][("dp", 2, False)][0]["counts"]
    # stage I: the targets' gather, the gradients' one flat all-reduce and
    # the loss's (the frozen ViT's targets take no gradient back)
    assert s1_rep == {"all_gather": 1, "all_reduce": 2, "reduce_scatter": 0,
                      "broadcast": 0, "barrier": 0}
    # stage II: z_t, ids and mask gathered, the score columns gathered
    assert s2_rep["all_gather"] == 4 and s2_rep["reduce_scatter"] == 0
    # fsdp: every sharded gradient reduce-scattered, its block gathered back
    n_sharded = sum(d is not None for d in
                    runs["port4"][("dp", 1, True)][0]["shard_dims"])
    assert s1_fsdp["reduce_scatter"] == n_sharded
    assert s1_fsdp["all_gather"] == 1 + n_sharded
