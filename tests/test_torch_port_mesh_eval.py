"""The port's mesh-sharded evaluation paths on four gloo ranks on the CPU,
against the JAX package on a four-device virtual mesh and against the
port's one-process calls.

One world of four ranks runs every call (``_torch_port_mesh_worker``),
with the collectives each issued; fp32 throughout:
- ``global_contrastive_loss``: each rank's loss and the [B, B] logits
  against JAX's under ``shard_map``, 1e-5;
- ``sharded_cosine_topk``: indices equal to JAX's (``shard_map``) and to
  the unsharded top-k, with ties planted across the shard boundaries;
- ``full_ranking`` / ``ranked_slices`` (12 queries over 4 ranks and 10,
  so padded) equal to JAX's on its mesh;
- ``predict_queries`` image-major under the mesh (q_batch 16: the Q = 8
  bucket's 2 images do not split over 4 ranks and run query-major) against
  JAX's query-major features, 1e-5, and the port's one process;
- ``build_index(shard_index=True)``: the blocks are the replicated bank's
  rows (10 images padded to 12), at batch 4 and at batch 6, where the
  mesh shrinks to 3 ranks and the fourth receives the result;
- ``rerank`` (query-major, with and without dedup) and
  ``rerank_candidate_major`` over a replicated, a block-sharded and an
  int8 bank: logits within 1e-4 of the one-process calls (held to JAX by
  the one-process tests);
- ``evaluate_cirr_stage1`` and ``evaluate_cirr_stage2`` (candidate-major
  over a sharded bank, and query-major) on a synthetic CIRR tree: metrics
  equal to the one-process run's;
- the audit: ``full_ranking`` issues one all-gather and nothing else, the
  sharded bank's z_t fetch one all-reduce;
- ``dryrun_multichip(4, device="cpu")`` prints its ok line;
- the configs: the port's ``load_config`` equals JAX's field by field.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_port_mesh_worker as worker
from _torch_port_train_data import write_cirr
from _torch_port_utils import np_tree, port_cfg
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.models.tokenizer import (
    WordPieceTokenizer as JTokenizer,
    build_test_vocab as j_build_test_vocab,
)
from candidate_reranking_cir_tpu.ops import topk as jtopk
from candidate_reranking_cir_tpu.parallel import mesh as jmesh
from candidate_reranking_cir_tpu.parallel.contrastive import (
    global_contrastive_loss as j_global_contrastive_loss,
)
from candidate_reranking_cir_tpu.retrieval import validate_engine as jv
from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.data.topk_io import save_topk_file
from candidate_reranking_cir_tpu_torch.entry import dryrun_multichip
from candidate_reranking_cir_tpu_torch.parallel.contrastive import (
    global_contrastive_loss,
)
from candidate_reranking_cir_tpu_torch.parallel.launch import run_world
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
)

WORLD, L, TEMP = 4, 6, 0.07
VIT = jcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                     num_layers=2, num_heads=2)
TEXT = jcfg.TextEncoderConfig(vocab_size=256, hidden_size=16, num_layers=2,
                              num_heads=2, intermediate_size=32,
                              encoder_width=16, merge_mlp_from=1,
                              hidden_dropout=0.0, attention_dropout=0.0)
S1 = jcfg.RetrievalModelConfig(vit=VIT, text=TEXT, embed_dim=8, text_len=L)
S2 = jcfg.RerankerModelConfig(vit=VIT, text=TEXT, text_len=L)
N_IDX, M, N_Q, K = 10, 5, 12, 4
N_IMAGES, N_VAL = 12, 10


def _jax_params():
    imgs = np.zeros((2, 16, 16, 3), np.float32)
    ids = np.ones((2, L), np.int32)
    s1p = jax.jit(JRetrieval(S1).init)(jax.random.key(1), imgs, ids, ids)
    s2p = jax.jit(JReranker(S2).init)(
        jax.random.key(2), imgs, ids, ids,
        np.zeros((2, L, TEXT.hidden_size), np.float32))
    return s1p, s2p


def _rerank_kw(rng, names):
    """Re-rank queries: captions of 1-5 words (two text buckets), K
    candidates each, CIRR groups, two skipped queries."""
    skip = np.zeros(N_Q, bool)
    skip[[3, 7]] = True
    return dict(
        captions=[" ".join(["red"] * (1 + i % 5)) for i in range(N_Q)],
        reference_names=[names[i % N_IDX] for i in range(N_Q)],
        topk_names=np.asarray([[names[(i + 2 * j + 1) % N_IDX]
                                for j in range(K)] for i in range(N_Q)]),
        index_names=names, text_len=L, skip_mask=skip,
        group_members=[[names[(i + j) % N_IDX] for j in range(6)]
                       for i in range(N_Q)])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    s1p, s2p = _jax_params()
    # the re-ranker's trained parts scaled up, so that its scores spread
    # far beyond the tolerance (at the 0.02 init they sit within 1e-4)
    s2_state = {k: v * 12.0 if v.ndim >= 2 and k.startswith(
                    ("text_encoder", "cls_dense")) else v
                for k, v in from_jax_params(np_tree(s2p),
                                            port_cfg(S2)).items()}
    spec = {"s1_cfg": port_cfg(S1), "s2_cfg": port_cfg(S2),
            "s1_state": from_jax_params(np_tree(s1p), port_cfg(S1)),
            "s2_state": s2_state}
    names = [f"im{i}" for i in range(N_IDX)]
    # contrastive and top-k inputs; the top-k corpus has rows equal across
    # the shard boundaries (rows 4..6 and 8..10 of the 16)
    emb = rng.normal(size=(8, 6)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    tgt = rng.normal(size=(8, 6)).astype(np.float32)
    tgt /= np.linalg.norm(tgt, axis=1, keepdims=True)
    corpus = rng.normal(size=(16, 6)).astype(np.float32)
    corpus[4] = corpus[3]
    corpus[5] = corpus[3]
    corpus[8] = corpus[7] = corpus[11]
    queries = rng.normal(size=(5, 6)).astype(np.float32)
    queries[0], queries[1] = corpus[3], corpus[7]  # the ties rank first
    # ranking: 12 queries, 10 corpus rows with ties
    pred = rng.normal(size=(N_Q, 6)).astype(np.float32)
    pooled = rng.normal(size=(N_IDX, 6)).astype(np.float32)
    pooled[6] = pooled[2]
    ent = rng.integers(0, N_IDX, size=(N_Q, 3)).astype(np.int32)
    # image-major fusion: 18 queries over 5 reference images
    feats = rng.normal(size=(6, M, 16)).astype(np.float32)
    ref_rows = [0] * 9 + [1] * 4 + [2] * 2 + [3] * 2 + [4]
    fnames = [f"im{i}" for i in range(6)]
    fuse_args = ([f"q {i}" for i in range(len(ref_rows))],
                 [fnames[r] for r in ref_rows], feats, fnames)
    images = rng.normal(size=(N_IDX, 16, 16, 3)).astype(np.float32)
    bank = (rng.normal(size=(N_IDX + 2, M, 16)) * 0.5).astype(np.float32)
    bank[N_IDX:] = 0.0  # the padding rows of a sharded bank
    rkw = _rerank_kw(rng, names)
    cm_kw = dict(rkw, pairs_per_call=8, q_buckets=(2, 4), zt_batch=6)
    qm_kw = dict(rkw, q_batch=4)
    qm_kw.pop("skip_mask")

    # the synthetic CIRR tree and its stage-I top-K file (one process)
    root = write_cirr(tmp_path_factory.mktemp("mesh_cirr"),
                      n_images=N_IMAGES, n_train=4, n_val=N_VAL)
    _, payload = worker.stage1_eval(None, spec, str(root), K)
    topk_path = str(root / "top.npz")
    save_topk_file(topk_path, payload)

    w = worker
    calls = {
        "contrastive": (w.contrastive, (emb, tgt, TEMP)),
        "topk": (w.sharded_topk, (queries, corpus, 4)),
        "ranking": (w.ranking, (pred, pooled, 7, ent)),
        "full_ranking": (w.full_ranking, (pred, pooled)),
        "predict": (w.predict, (spec, *fuse_args, 16, True)),
        "index4": (w.index, (spec, images, 4, False)),
        "index4_sharded": (w.index, (spec, images, 4, True)),
        "index6_sharded": (w.index, (spec, images, 6, True)),
        "qm": (w.rerank, (spec, qm_kw, "query_major", bank[:N_IDX])),
        "qm_dedup": (w.rerank, (spec, dict(qm_kw, dedup=True,
                                           dedup_cap=0.9),
                                "query_major", bank[:N_IDX])),
        "cm": (w.rerank, (spec, cm_kw, "candidate_major", bank[:N_IDX])),
        "cm_sharded": (w.rerank, (spec, cm_kw, "candidate_major", bank,
                                  True)),
        "cm_int8": (w.rerank, (spec, cm_kw, "candidate_major", bank[:N_IDX],
                               False, True)),
        "fetch": (w.fetch_rows, (bank, np.asarray([0, 5, 9, 11, 2, 7]))),
        "stage1_eval": (w.stage1_eval, (spec, str(root), K)),
        "stage2_eval": (w.stage2_eval, (spec, str(root), topk_path, K, True,
                                        "candidate_major")),
        "stage2_eval_qm": (w.stage2_eval, (spec, str(root), topk_path, K,
                                           False, "query_major")),
    }
    keys = list(calls)
    out = run_world(worker.call_each, WORLD, device="cpu",
                    args=([calls[k] for k in keys],), timeout_s=120)[0]
    port4 = dict(zip(keys, out))
    one = {k: calls[k][0](None, *calls[k][1]) for k in (
        "predict", "index4", "qm", "qm_dedup", "cm", "stage1_eval")}
    one["cm_int8"] = w.rerank(None, spec, cm_kw, "candidate_major",
                              bank[:N_IDX], False, True)
    one["stage2_eval"] = w.stage2_eval(None, spec, str(root), topk_path, K,
                                       False, "candidate_major")
    one["stage2_eval_qm"] = w.stage2_eval(None, spec, str(root), topk_path,
                                          K, False, "query_major")
    return dict(port4=port4, one=one, s1p=s1p, emb=emb, tgt=tgt,
                corpus=corpus, queries=queries, pred=pred, pooled=pooled,
                ent=ent, fuse_args=fuse_args, images=images)


def _jax_mesh():
    return jmesh.make_mesh(jax.devices()[:WORLD])


def test_global_contrastive_loss_matches_jax(setup):
    (losses, logits), counts = setup["port4"]["contrastive"]
    fn = jax.shard_map(
        lambda p, t: (lambda lo, lg: (lo[None], lg))(
            *j_global_contrastive_loss(p, t, TEMP, "data")),
        mesh=_jax_mesh(), in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False)
    jl, jlog = fn(setup["emb"], setup["tgt"])
    np.testing.assert_allclose(losses, np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(logits, np.asarray(jlog), atol=1e-5)
    # one process: the in-batch contrast over the whole batch
    loss1, logits1 = global_contrastive_loss(
        torch.from_numpy(setup["emb"]), torch.from_numpy(setup["tgt"]),
        torch.tensor(TEMP))
    np.testing.assert_allclose(float(loss1), losses.mean(), atol=1e-5)
    np.testing.assert_allclose(logits1.numpy(), logits, atol=1e-5)
    assert counts["all_gather"] >= 1 and counts["reduce_scatter"] == 0


def test_sharded_topk_matches_jax_with_ties(setup):
    (scores, idx), _ = setup["port4"]["topk"]
    shard_n = 16 // WORLD

    def shard_fn(pred, index_shard):
        dev = jax.lax.axis_index("data")
        return jtopk.sharded_cosine_topk(pred, index_shard, 4, "data",
                                         dev * shard_n)

    js, ji = jax.shard_map(shard_fn, mesh=_jax_mesh(),
                           in_specs=(P(), P("data", None)),
                           out_specs=(P(), P()), check_vma=False)(
        setup["queries"], setup["corpus"])
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_allclose(scores, np.asarray(js), atol=1e-6)
    _, ref_idx = jtopk.cosine_topk(setup["queries"], setup["corpus"], 4)
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    # the planted ties, split over shards, in global index order
    assert idx[0, :3].tolist() == [3, 4, 5]
    assert idx[1, :3].tolist() == [7, 8, 11]


def test_ranking_matches_jax_mesh(setup):
    (order, topk, ranks), _ = setup["port4"]["ranking"]
    mesh = _jax_mesh()
    pooled = jax.numpy.asarray(setup["pooled"])
    np.testing.assert_array_equal(
        order, jv.full_ranking(setup["pred"], pooled, mesh=mesh))
    jtopk_, jranks = jv.ranked_slices(setup["pred"], pooled, 7, setup["ent"],
                                      mesh=mesh)
    np.testing.assert_array_equal(topk, jtopk_)
    np.testing.assert_array_equal(ranks, jranks)
    np.testing.assert_array_equal(order[:, :7], topk)


def test_predict_queries_image_major_under_the_mesh(setup):
    (pred4, _), one = setup["port4"]["predict"], setup["one"]["predict"]
    caps, refs, feats, names = setup["fuse_args"]
    _, fuse = jv.make_stage1_fns(JRetrieval(S1), setup["s1p"])
    ref = np.asarray(jv.predict_queries(
        fuse, JTokenizer(j_build_test_vocab()), caps, refs,
        jax.numpy.asarray(feats), names, L, q_batch=16, image_major=False))
    np.testing.assert_allclose(pred4, ref, atol=1e-5)
    np.testing.assert_allclose(pred4, one, atol=1e-5)


def test_build_index_shards_are_the_replicated_rows(setup):
    (bank, pooled, names), _ = setup["port4"]["index4"]
    one_bank, one_pooled, one_names = setup["one"]["index4"]
    assert names == one_names == [f"im{i}" for i in range(N_IDX)]
    np.testing.assert_allclose(bank, one_bank, atol=1e-5)
    np.testing.assert_allclose(pooled, one_pooled, atol=1e-5)
    for key in ("index4_sharded", "index6_sharded"):
        (blocks, pooled_s, names_s), _ = setup["port4"][key]
        assert blocks.shape == (WORLD, 3, *bank.shape[1:]) and \
            names_s == names
        flat = blocks.reshape(-1, *bank.shape[1:])
        np.testing.assert_allclose(flat[:N_IDX], bank, atol=1e-5)
        assert not flat[N_IDX:].any()            # the padding rows
        np.testing.assert_allclose(pooled_s, pooled, atol=1e-5)


@pytest.mark.parametrize("key", ["qm", "qm_dedup", "cm", "cm_sharded",
                                 "cm_int8"])
def test_rerank_matches_one_process(setup, key):
    (logits, glogits, order), _ = setup["port4"][key]
    ref = setup["one"]["cm" if key == "cm_sharded" else key]
    live = logits > -99999.0
    assert np.ptp(logits[live]) > 0.1       # scores far apart
    np.testing.assert_allclose(logits, ref[0], atol=1e-4)
    np.testing.assert_allclose(glogits, ref[1], atol=1e-4)
    if key != "cm_int8":  # the schedules agree on the scored pairs
        cm = setup["one"]["cm"]
        live &= cm[0] > -99999.0
        np.testing.assert_allclose(logits[live], cm[0][live], atol=1e-4)


@pytest.mark.parametrize("key", ["stage1_eval", "stage2_eval",
                                 "stage2_eval_qm"])
def test_evaluations_match_one_process(setup, key):
    got, _ = setup["port4"][key]
    want = setup["one"][key]
    if key == "stage1_eval":
        got, payload = got
        want, want_payload = want
        assert json.dumps(payload, default=str) == json.dumps(
            want_payload, default=str)
    assert got == want and got


def test_collective_audit(setup):
    _, counts = setup["port4"]["full_ranking"]
    assert counts == {"all_gather": 1, "all_reduce": 0, "reduce_scatter": 0,
                      "broadcast": 0, "barrier": 0}
    _, counts = setup["port4"]["fetch"]
    assert counts == {"all_gather": 0, "all_reduce": 1, "reduce_scatter": 0,
                      "broadcast": 0, "barrier": 0}


def test_dryrun_multichip_on_four_gloo_ranks(capfd):
    out = dryrun_multichip(WORLD, device="cpu")
    assert f"dryrun_multichip({WORLD}): ok, loss=" in capfd.readouterr().out
    assert np.isfinite(out["loss"]) and np.isfinite(out["stage1_loss"])
    assert out["sharded_gap"] <= 1e-4


@pytest.mark.parametrize("name", ["cirr", "fashioniq"])
def test_config_matches_jax(name, tmp_path):
    from pathlib import Path

    import candidate_reranking_cir_tpu
    import candidate_reranking_cir_tpu_torch

    jdir = Path(candidate_reranking_cir_tpu.__file__).parent / "configs"
    tdir = Path(candidate_reranking_cir_tpu_torch.__file__).parent / "configs"
    jaxc = jcfg.load_config(jdir / f"{name}.yaml")
    port = tcfg.load_config(tdir / f"{name}.yaml")
    # the JAX-only fields: the attention-kernel switches, the ViT's scan
    # unroll and the text encoder's pad id; the port-only ones: the ViT
    # keys of BLIP-2's EVA ViT-g tower, at their defaults here (off)
    only_jax = {"fused_attention", "scan_unroll", "pad_token_id"}
    only_port = {"qkv_bias": "qkv", "final_norm_eps": None}

    def same(a: dict, b: dict):
        assert set(b) - set(a) <= only_jax
        assert set(a) - set(b) <= set(only_port)
        for key in set(a) - set(b):
            assert a[key] == only_port[key], key
        for key, val in a.items():
            if key not in b:
                continue
            if isinstance(val, dict):
                same(val, b[key])
            else:
                assert val == b[key], key

    same(tcfg.to_dict(port), jcfg.to_dict(jaxc))
    # JSON round trips: the port's own, and a file the JAX package wrote
    tcfg.save_config(port, tmp_path / "port.json")
    assert tcfg.load_config(tmp_path / "port.json") == port
    jcfg.save_config(jaxc, tmp_path / "jax.json")
    assert tcfg.load_config(tmp_path / "jax.json") == port
    changed = dataclasses.replace(port, mesh=tcfg.MeshConfig(fsdp=True))
    tcfg.save_config(changed, tmp_path / "fsdp.json")
    assert jcfg.load_config(tmp_path / "fsdp.json").mesh.fsdp is True
