"""The port's single-program stage-I eval on the CPU, against its own
multi-launch executor and against the JAX package's stage-I eval.

On the CPU the program runs eagerly (a CUDA graph exists only on the
card; ``tests/test_torch_port_cuda.py`` replays one). Checked:

- ``build_fusion_plan`` gives JAX's families and inverse permutation
  exactly, and refuses a plan that drops a query;
- ``make_embed_scan`` equals ``build_index`` bit for bit;
- ``single_program=True`` against the multi-launch path on the tiny CIRR
  and Fashion-IQ trees (``tests/test_torch_port_stage1_eval.py``'s):
  metrics, ranking names, labels, the device ranking and the top-K
  payload all equal;
- against JAX's (multi-launch) stage-I eval on the same tree and weights:
  predictions 1e-5, metrics and the top-K payload equal;
- ``make_single_program_eval`` keeps one program a model, held weakly.
"""
import gc

import jax
import numpy as np
import pytest
import torch

from _torch_port_utils import TINY_TEXT, TINY_VIT, f32, fused, np_tree, \
    port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.data.datasets import CIRRDataset as JCIRR
from candidate_reranking_cir_tpu.data.preprocessing import (
    make_transform as j_make_transform,
)
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.retrieval import validate_engine as jv
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    make_transform,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.retrieval import validate_engine as tv
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.runtime.weights import from_jax_params
from test_torch_port_stage1_eval import (  # noqa: F401 (fixtures)
    FIQ_DRESSES,
    IMG,
    TEXT_LEN,
    cirr_root,
    fiq_root,
    tokenizers,
)

ATOL = 1e-5
KW = dict(text_len=TEXT_LEN, batch_size=5, save_topk_k=6, q_batch=8)


@pytest.fixture(scope="module")
def models():
    """The JAX stage-I model (Pallas switch on) with its params, and the
    port's holding the same weights."""
    cfg = jcfg.RetrievalModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                    embed_dim=16, text_len=TEXT_LEN)
    imgs = np.zeros((2, IMG, IMG, 3), np.float32)
    ids = np.ones((2, TEXT_LEN), np.int32)
    params = np_tree(jax.jit(JRetrieval(cfg).init)(jax.random.key(3), imgs,
                                                   ids, ids))
    j1 = JRetrieval(jcfg.RetrievalModelConfig(
        vit=fused(TINY_VIT), text=fused(TINY_TEXT), embed_dim=16,
        text_len=TEXT_LEN))
    t1 = RetrievalModel(port_cfg(cfg), device="cpu").eval()
    t1.load_state_dict(from_jax_params(params, port_cfg(cfg)))
    return j1, params, t1


def _cirr(root, dataset=CIRRDataset, transform=make_transform):
    return [dataset(root, "val", mode, transform("targetpad", IMG))
            for mode in ("classic", "relative")]


@pytest.mark.parametrize("q_batch,image_major", [(8, True), (4, True),
                                                 (8, False)])
@pytest.mark.parametrize("seed", range(3))
def test_build_fusion_plan_matches_jax(seed, q_batch, image_major):
    rng = np.random.default_rng(seed)
    n = 37
    ref_idx = rng.integers(0, 9, n).astype(np.int32)
    bucket_of = rng.choice([8, 12, 16], n)
    ids = rng.integers(1, 90, (n, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < rng.integers(2, 17, (n, 1))).astype(
        np.int32)
    batches = tv.schedule_fusion_batches(ref_idx, bucket_of, q_batch,
                                         image_major)
    fams, inv = tv.build_fusion_plan(batches, ids, mask, device="cpu")
    ref_fams, ref_inv = jv.build_fusion_plan(
        jv.schedule_fusion_batches(ref_idx, bucket_of, q_batch, image_major),
        ids, mask)
    assert len(fams) == len(ref_fams)
    for fam, ref in zip(fams, ref_fams):
        for a, b in zip(fam, ref):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(inv, ref_inv)


def test_build_fusion_plan_refuses_a_dropped_query():
    ids = np.ones((3, 4), np.int32)
    batches = [(1, 4, np.asarray([0, 1]), np.asarray([0, 0], np.int32), 2)]
    with pytest.raises(AssertionError, match="dropped 1"):
        tv.build_fusion_plan(batches, ids, ids, device="cpu")


def test_embed_scan_equals_build_index(cirr_root, models):
    """The whole corpus in one program, chunk by chunk, equals the per-batch
    index bit for bit."""
    t1 = models[2]
    classic = _cirr(cirr_root)[0]
    embed, _ = tv.make_stage1_fns(t1, None, "cpu")
    raw, pooled, _ = build_index(classic, embed, 4, pooled=True,
                                 device="cpu", feature_dtype=torch.float32)
    images = torch.from_numpy(np.stack(
        [classic[i]["image"] for i in range(len(classic))]))
    scan = tv.make_embed_scan(t1, None, "cpu")
    raw_s, pooled_s = scan(images.reshape(3, 4, *images.shape[1:]))
    assert raw_s.shape[:2] == (3, 4) and pooled_s.shape == (3, 4, 16)
    assert torch.equal(raw_s.flatten(0, 1), raw)
    assert torch.equal(pooled_s.flatten(0, 1), pooled)


def _same_eval(a, b):
    (res_a, pay_a), (res_b, pay_b) = a, b
    assert res_a.metrics == res_b.metrics
    assert res_a.index_names == res_b.index_names
    for key in ("sorted_index_names", "labels", "group_labels"):
        np.testing.assert_array_equal(getattr(res_a.ranking, key),
                                      getattr(res_b.ranking, key))
    np.testing.assert_array_equal(res_a.topk, res_b.topk)
    np.testing.assert_array_equal(res_a.ranks, res_b.ranks)
    assert pay_a.keys() == pay_b.keys()
    for key in pay_a:
        np.testing.assert_array_equal(pay_a[key], pay_b[key])


@pytest.fixture(scope="module")
def cirr_runs(cirr_root, models, tokenizers):
    """Both executors' results, and the program's predictions."""
    t1 = models[2]
    tt = tokenizers[1]
    runs = {flag: tv.evaluate_cirr_stage1(t1, None, *_cirr(cirr_root), tt,
                                          device="cpu", single_program=flag,
                                          **KW)
            for flag in (False, True)}
    return runs, tv.make_single_program_eval(t1).pred


def test_single_program_equals_multi_launch_cirr(cirr_runs):
    runs, _ = cirr_runs
    _same_eval(runs[True], runs[False])
    assert set(runs[True][0].seconds) == {
        "load", "copy", "plan", "program", "total", "index.load",
        "index.upload", "copy.wait", "fusion.plan", "plan.upload",
        "plan.wait", "stage1.labels", "stage1.metrics"}


def test_single_program_equals_multi_launch_fiq(fiq_root, models,
                                                tokenizers):
    t1 = models[2]
    tt = tokenizers[1]
    for dress in FIQ_DRESSES:
        sets = [FashionIQDataset(fiq_root, "val", [dress], mode,
                                 make_transform("targetpad", IMG))
                for mode in ("classic", "relative")]
        runs = [tv.evaluate_fiq_stage1(t1, None, *sets, tt, device="cpu",
                                       dress_types=[dress], text_len=TEXT_LEN,
                                       batch_size=3, save_topk_k=5,
                                       q_batch=4, single_program=flag)
                for flag in (False, True)]
        _same_eval(*runs)


def test_single_program_matches_jax(cirr_root, models, tokenizers,
                                    cirr_runs, monkeypatch):
    """JAX's multi-launch eval (its own tests hold its two executors
    equal): metrics and payload equal; the program's predictions within
    1e-5 of those JAX's eval fused (read off its ``predict_queries``)."""
    j1, p1, _ = models
    seen = []

    def predict_queries(*args, **kwargs):
        seen.append(np.asarray(jv_predict(*args, **kwargs)))
        return seen[-1]

    jv_predict = jv.predict_queries
    monkeypatch.setattr(jv, "predict_queries", predict_queries)
    ref, ref_payload = jv.evaluate_cirr_stage1(
        j1, p1, *_cirr(cirr_root, JCIRR, j_make_transform), tokenizers[0],
        **KW)
    runs, pred = cirr_runs
    out, payload = runs[True]
    assert out.metrics == ref.metrics
    np.testing.assert_array_equal(out.ranking.sorted_index_names,
                                  ref.ranking.sorted_index_names)
    for key in ref_payload:
        np.testing.assert_array_equal(payload[key], ref_payload[key])
    assert pred.shape == seen[0].shape
    np.testing.assert_allclose(f32(pred), seen[0], rtol=0, atol=ATOL)


def test_program_cache_holds_one_program_a_model_weakly(models):
    cfg = models[2].cfg
    a = type(models[2])(cfg, device="cpu")
    b = type(models[2])(cfg, device="cpu")
    run = tv.make_single_program_eval(a)
    assert tv.make_single_program_eval(a) is run
    assert tv.make_single_program_eval(b) is not run
    n = len(tv._SINGLE_PROGRAM_CACHE)
    del a, run
    gc.collect()
    assert len(tv._SINGLE_PROGRAM_CACHE) == n - 1


def test_program_refuses_a_short_corpus(models):
    run = tv.make_single_program_eval(models[2])
    with pytest.raises(ValueError, match="n_idx"):
        run(None, t(np.zeros((2, IMG, IMG, 3), np.float32)), (),
            np.zeros(0, np.int64), np.zeros((0, 1), np.int64), n_idx=3,
            width=2)
