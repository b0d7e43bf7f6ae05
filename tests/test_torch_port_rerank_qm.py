"""The port's query-major re-rank (``retrieval/rerank.rerank``), the dual
encoder's per-pair and indexed layouts, and the stage-II engine's
``schedule='query_major'`` and ``index_int8`` options, against the JAX
package.

- ``rerank`` against JAX's on the same bank, with and without ``dedup``,
  with and without CIRR groups and a skip mask, with a padded tail chunk:
  logits within 1e-4, orders equal. A synthetic bank of 200 rows makes
  some chunks compress under ``dedup`` and others fall back to the
  per-pair scorer.
- ``score_indexed`` against ``score_per_query`` on the gathered pairs
  and against JAX's ``score_indexed`` (1e-5).
- The port's query-major against its candidate-major (1e-4).
- ``evaluate_{cirr,fiq}_stage2`` with ``schedule='query_major'`` and
  ``index_int8=True`` against JAX: metrics equal.

The CIRR tree, the models (JAX with its Pallas kernels interpreted on the
CPU, the port holding the same weights) and the scheduler inputs are
tests/test_torch_port_e2e.py's fixtures."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32
from candidate_reranking_cir_tpu.data.preprocessing import (
    make_transform as j_make_transform,
)
from candidate_reranking_cir_tpu.data.topk_io import save_topk_file
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.ops import quant as jq
from candidate_reranking_cir_tpu.retrieval import rerank as jrerank
from candidate_reranking_cir_tpu.retrieval import validate2_engine as jv2
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    make_transform,
)
from candidate_reranking_cir_tpu_torch.ops import quant as tq
from candidate_reranking_cir_tpu_torch.retrieval import rerank as trerank
from candidate_reranking_cir_tpu_torch.retrieval import (
    validate2_engine as tv2,
)
from test_torch_port_e2e import (  # noqa: F401  (fixtures)
    IMG,
    K,
    TEXT_LEN,
    WORDS,
    cirr_root,
    models,
    rerank_inputs,
    tokenizers,
)

ATOL = 1e-4
M_TOKENS, WIDTH = (IMG // 8) ** 2 + 1, 24


def _jax_bank(raw, int8: bool):
    return jq.quantize_bank(raw) if int8 else raw


def _port_bank(raw, int8: bool):
    bank = torch.from_numpy(f32(raw)).to(torch.bfloat16)
    return tq.quantize_bank(bank) if int8 else bank


def _assert_same(out, ref):
    np.testing.assert_allclose(out.logits, ref.logits, atol=ATOL)
    np.testing.assert_array_equal(out.order, ref.order)
    if ref.group_logits is None:
        assert out.group_logits is None and out.group_order is None
    else:
        np.testing.assert_allclose(out.group_logits, ref.group_logits,
                                   atol=ATOL)
        np.testing.assert_array_equal(out.group_order, ref.group_order)


@pytest.mark.parametrize("dedup,groups,skip,int8", [
    (False, True, True, False),
    (True, True, True, False),
    (True, False, True, True),
], ids=["groups_skip", "dedup_groups_skip", "dedup_int8"])
def test_rerank_matches_jax(models, tokenizers, rerank_inputs, dedup, groups,
                            skip, int8):
    """8 queries at q_batch 3: two full chunks and a tail of 2 padded with
    repeats."""
    j1, p1, j2, p2, t1, t2 = models
    jt, tt = tokenizers
    raw, kw = rerank_inputs
    kw = dict(kw, q_batch=3, dedup=dedup)
    if not groups:
        kw.pop("group_members")
    if not skip:
        kw.pop("skip_mask")
    ref = jrerank.rerank(j1, p1, j2, p2, jt, index_feats=_jax_bank(raw, int8),
                         **kw)
    out = trerank.rerank(t1, None, t2, None, tt,
                         index_feats=_port_bank(raw, int8), device="cpu",
                         **kw)
    _assert_same(out, ref)
    if skip:
        rows = kw["skip_mask"]
        assert rows.any() and (out.logits[rows] == trerank.SKIP_LOGIT).all()


@pytest.fixture(scope="module")
def wide_bank():
    """A random bank of 200 rows and 16 queries of 20 candidates: the
    first 8 draw from 30 rows (a chunk of 8 has at most 30 unique
    candidates: it compresses into the 64-row bucket), the last 8 from all
    200 (about 110 unique: the chunk falls back to the per-pair scorer)."""
    rng = np.random.default_rng(5)
    n, nq, k = 200, 16, 20
    bank = (rng.normal(size=(n, M_TOKENS, WIDTH)) * 0.5).astype(np.float32)
    names = [f"w{i}" for i in range(n)]
    cand = np.stack([rng.choice(30 if q < 8 else n, k, replace=False)
                     for q in range(nq)])
    kw = dict(captions=[" ".join(rng.choice(WORDS, 1 + q % 6))
                        for q in range(nq)],
              reference_names=[names[int(rng.integers(0, n))]
                               for _ in range(nq)],
              topk_names=np.asarray(names, dtype=object)[cand],
              index_names=names, text_len=TEXT_LEN, q_batch=8,
              dedup=True)
    return bank, cand, kw


def test_rerank_dedup_fallback_matches_jax(models, tokenizers, wide_bank):
    j1, p1, j2, p2, t1, t2 = models
    jt, tt = tokenizers
    bank, cand, kw = wide_bank
    order = trerank.cluster_queries(cand, 8)
    np.testing.assert_array_equal(order, jrerank.cluster_queries(cand, 8))
    uniq = [len(np.unique(cand[order[s:s + 8]])) for s in (0, 8)]
    assert min(uniq) <= 64 < max(uniq)  # one chunk each way
    ref = jrerank.rerank(j1, p1, j2, p2, jt, index_feats=jnp.asarray(bank),
                         **kw)
    out = trerank.rerank(t1, None, t2, None, tt,
                         index_feats=torch.from_numpy(bank), device="cpu",
                         **kw)
    _assert_same(out, ref)
    plain = trerank.rerank(t1, None, t2, None, tt,
                           index_feats=torch.from_numpy(bank), device="cpu",
                           **dict(kw, dedup=False))
    np.testing.assert_allclose(out.logits, plain.logits, atol=1e-5)


def test_score_indexed_equals_score_per_query(models):
    """The indexed mode projects each unique candidate's K/V once and
    gathers them per pair: the same scores as the per-pair mode on the
    gathered candidates (1e-5), and both as JAX's."""
    j1, p1, j2, p2, t1, t2 = models
    rng = np.random.default_rng(7)
    nq, c, u = 3, 5, 6
    unique = (rng.normal(size=(u, M_TOKENS, WIDTH)) * 0.5).astype(np.float32)
    pair_map = rng.integers(0, u, size=(nq, c)).astype(np.int32)
    z_t = rng.normal(size=(nq, TEXT_LEN, WIDTH)).astype(np.float32)
    ids = rng.integers(1, 200, size=(nq, TEXT_LEN)).astype(np.int32)
    mask = (np.arange(TEXT_LEN)[None] < np.asarray([[4], [9], [16]])) \
        .astype(np.int32)
    tz, tids, tmask = (torch.from_numpy(a) for a in (z_t, ids, mask))
    with torch.inference_mode():
        indexed = t2.score_indexed(tz, tids, tmask, torch.from_numpy(unique),
                                   torch.from_numpy(pair_map).long())
        per_pair = t2.score_per_query(tz, tids, tmask,
                                      torch.from_numpy(unique[pair_map]))
    assert indexed.shape == (nq, c)
    np.testing.assert_allclose(f32(indexed), f32(per_pair), atol=1e-5)
    ref = jax.jit(functools.partial(j2.apply, method=JReranker.score_indexed))(
        p2, z_t, ids, mask, unique, pair_map)
    np.testing.assert_allclose(f32(indexed), f32(ref), atol=1e-5)
    # the per-pair layout also runs with dropout (this model's rates are
    # 0, so a seed table gives the eval scores; the rates at 0.1 are held
    # to JAX in tests/test_torch_port_dropout_layouts.py)
    seeds = np.zeros(t2.text_encoder.seed_shape, np.int64).tolist()
    with torch.no_grad():
        train = t2.score_per_query(tz, tids, tmask,
                                   torch.from_numpy(unique[pair_map]),
                                   deterministic=False, seeds=seeds)
    np.testing.assert_allclose(f32(train), f32(per_pair), atol=1e-6)


@pytest.mark.parametrize("dedup", [False, True])
def test_query_major_matches_candidate_major(models, tokenizers,
                                             rerank_inputs, dedup):
    *_, t1, t2 = models
    _, tt = tokenizers
    raw, kw = rerank_inputs
    bank = _port_bank(raw, False)
    cm = trerank.rerank_candidate_major(t1, None, t2, None, tt,
                                        index_feats=bank, device="cpu", **kw)
    qm = trerank.rerank(t1, None, t2, None, tt, index_feats=bank,
                        device="cpu", q_batch=3, dedup=dedup, **kw)
    _assert_same(qm, cm)


def test_rerank_refuses_a_mesh(models, tokenizers, rerank_inputs, tmp_path):
    """Both schedules take a mesh; a mesh of one rank (a gloo group of
    this process) gives the results without one. What stays
    refused is what the JAX package refuses: a block-sharded bank without
    a mesh, or as an int8 bank. A ``zt_batch`` the mesh size does not
    divide is rounded up, as in JAX (4-rank runs:
    tests/test_torch_port_mesh_eval.py)."""
    from _torch_port_mesh_worker import one_rank_mesh

    *_, t1, t2 = models
    _, tt = tokenizers
    raw, kw = rerank_inputs
    # the first four queries (the one-rank comparisons' cost)
    kw = {k: v[:4] if k not in ("index_names", "text_len") else v
          for k, v in kw.items()}
    bank = _port_bank(raw, False)
    with pytest.raises(ValueError, match="requires a mesh"):
        trerank.rerank_candidate_major(t1, None, t2, None, tt,
                                       index_feats=bank, index_sharded=True,
                                       device="cpu", **kw)
    with pytest.raises(ValueError, match="int8"):
        trerank.rerank_candidate_major(t1, None, t2, None, tt,
                                       index_feats=_port_bank(raw, True),
                                       index_sharded=True, mesh=object(),
                                       device="cpu", **kw)
    plain = (trerank.rerank(t1, None, t2, None, tt, index_feats=bank,
                            device="cpu", q_batch=3, **kw),
             trerank.rerank_candidate_major(t1, None, t2, None, tt,
                                            index_feats=bank, device="cpu",
                                            zt_batch=3, **kw))
    with one_rank_mesh(tmp_path) as mesh:
        meshed = (trerank.rerank(t1, None, t2, None, tt, index_feats=bank,
                                 device="cpu", q_batch=3, mesh=mesh, **kw),
                  trerank.rerank_candidate_major(
                      t1, None, t2, None, tt, index_feats=bank, device="cpu",
                      zt_batch=3, mesh=mesh, index_sharded=True, **kw))
    np.testing.assert_array_equal(meshed[0].logits, plain[0].logits)
    np.testing.assert_array_equal(meshed[0].group_logits,
                                  plain[0].group_logits)
    # the sharded bank's reference rows come through a masked copy, which
    # the CPU's BLAS may round an ulp differently (on the card: bit-equal,
    # chip_smoke.py's [mesh] phase)
    for got, want in ((meshed[1].logits, plain[1].logits),
                      (meshed[1].group_logits, plain[1].group_logits)):
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("schedule,int8", [
    ("query_major", False), ("query_major", True),
])
def test_evaluate_cirr_stage2_options_match_jax(cirr_root, models, tokenizers,
                                                schedule, int8):
    j1, p1, j2, p2, t1, t2 = models
    jt, tt = tokenizers
    common = dict(data_root=cirr_root, top_k_path=cirr_root / "topk.npz",
                  k=K, text_len=TEXT_LEN, schedule=schedule, q_batch=3,
                  index_int8=int8)
    ref = jv2.evaluate_cirr_stage2(
        j1, p1, j2, p2, jt, transform=j_make_transform("targetpad", IMG),
        **common)
    out = tv2.evaluate_cirr_stage2(
        t1, None, t2, None, tt, transform=make_transform("targetpad", IMG),
        device="cpu", **common)
    assert out == ref


FIQ_DRESSES = ("dress", "shirt")


@pytest.fixture(scope="module")
def fiq_root(tmp_path_factory):
    """A Fashion-IQ val split of two dress types (7 queries over 8 images
    each) and a top-5 file per type; the target is missing from one
    query's list, so that query is skipped."""
    import PIL.Image

    root = tmp_path_factory.mktemp("fiq")
    base = root / "fashionIQ_dataset"
    for sub in ("captions", "image_splits", "images"):
        (base / sub).mkdir(parents=True)
    rng = np.random.default_rng(2)
    for dress in FIQ_DRESSES:
        names = [f"{dress}{i}" for i in range(8)]
        for n in names:
            PIL.Image.fromarray(rng.integers(0, 255, size=(40, 30, 3),
                                             dtype=np.uint8)).save(
                base / "images" / f"{n}.jpg", quality=92)
        caps, rows = [], []
        for q in range(7):
            ref, tgt = names[q // 2], names[(q + 3) % 8]
            caps.append({"candidate": ref, "target": tgt, "captions": [
                f"is the {dress}.", " ".join(rng.choice(WORDS, 1 + q % 4))]})
            row = list(rng.permutation([n for n in names
                                        if n not in (ref, tgt)])[:5])
            if q != 4:
                row[int(rng.integers(0, 5))] = tgt
            rows.append(row)
        with open(base / "captions" / f"cap.{dress}.val.json", "w") as f:
            json.dump(caps, f)
        with open(base / "image_splits" / f"split.{dress}.val.json",
                  "w") as f:
            json.dump(names, f)
        save_topk_file(root / f"top_{dress}.npz", {
            "sorted_index_names": np.asarray(rows, dtype=object),
            "labels": np.asarray([[n == c["target"] for n in row]
                                  for c, row in zip(caps, rows)]),
            "index_names": names,
            "target_names": [c["target"] for c in caps],
            "split": "val", "dress_types": dress})
    return root


@pytest.mark.parametrize("schedule,int8", [
    ("query_major", False), ("candidate_major", True),
])
def test_evaluate_fiq_stage2_options_match_jax(fiq_root, models, tokenizers,
                                               schedule, int8):
    j1, p1, j2, p2, t1, t2 = models
    jt, tt = tokenizers
    common = dict(data_root=fiq_root, top_k_path=fiq_root / "top_DTYPE.npz",
                  k=5, text_len=TEXT_LEN, dress_types=FIQ_DRESSES,
                  schedule=schedule, q_batch=3, index_int8=int8)
    ref = jv2.evaluate_fiq_stage2(
        j1, p1, j2, p2, jt, transform=j_make_transform("targetpad", IMG),
        **common)
    out = tv2.evaluate_fiq_stage2(
        t1, None, t2, None, tt, transform=make_transform("targetpad", IMG),
        device="cpu", **common)
    assert out == ref
    assert set(out) >= {"dress_recall_at10", "average_recall"}
