"""The port's stage-I evaluation against the JAX package's, on the CPU.

Tiny models (``_torch_port_utils``) with the same weights
(``runtime/weights.py::from_jax_params``) and numpy-seeded inputs; the JAX
side with its Pallas switch on (interpreted on the CPU where a kernel
engages). Checked:

- image-major fusion (``RetrievalModel.fuse(query_group=)``) against JAX's
  (fp32 1e-5) and against the port's own query-major fusion;
- ``schedule_fusion_batches`` and ``resolve_buckets`` identical to JAX's;
- ``ranked_slices`` / ``full_ranking`` identical to JAX's, on seeded
  inputs and with planted ties (exactly representable products, so equal
  distances are equal on both sides whatever the summation order);
- ``evaluate_cirr_stage1`` / ``evaluate_fiq_stage1`` on synthetic CIRR and
  Fashion-IQ directories: metrics equal, top-K payload names and labels
  equal, predictions within 1e-5; ``evaluate_fiq_stage2`` on the per-dress
  top-K files: metrics equal;
- the metric engine, payload writers, submissions and captions against
  JAX's; the export to reference keys against JAX's ``export_stage1/2``
  and back through the port's loader, bit for bit.
"""
import json

import jax
import numpy as np
import pytest
import torch

from _torch_port_utils import TINY_TEXT, TINY_VIT, f32, fused, np_tree, \
    port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.data import captions as jcaptions
from candidate_reranking_cir_tpu.data.datasets import (
    CIRRDataset as JCIRR,
    FashionIQDataset as JFIQ,
)
from candidate_reranking_cir_tpu.data.preprocessing import (
    make_transform as j_make_transform,
)
from candidate_reranking_cir_tpu.data.topk_io import (
    resolve_fiq_topk_path as j_resolve_fiq_topk_path,
)
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
from candidate_reranking_cir_tpu.retrieval import metrics as jmetrics
from candidate_reranking_cir_tpu.retrieval import submission as jsub
from candidate_reranking_cir_tpu.retrieval import topk_writer as jwriter
from candidate_reranking_cir_tpu.retrieval import validate2_engine as jv2
from candidate_reranking_cir_tpu.retrieval import validate_engine as jv
from candidate_reranking_cir_tpu.runtime import convert as jconvert
from candidate_reranking_cir_tpu_torch.data import captions as tcaptions
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    make_transform,
)
from candidate_reranking_cir_tpu_torch.data.topk_io import (
    resolve_fiq_topk_path,
    save_topk_file,
)
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.models.tokenizer import (
    WordPieceTokenizer,
    build_test_vocab,
)
from candidate_reranking_cir_tpu_torch.ops import topk as ttopk
from candidate_reranking_cir_tpu_torch.retrieval import metrics as tmetrics
from candidate_reranking_cir_tpu_torch.retrieval import submission as tsub
from candidate_reranking_cir_tpu_torch.retrieval import topk_writer as twriter
from candidate_reranking_cir_tpu_torch.retrieval import validate2_engine as tv2
from candidate_reranking_cir_tpu_torch.retrieval import validate_engine as tv
from candidate_reranking_cir_tpu_torch.runtime import convert as tconvert
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
    load_reference_state_dict,
    read_reference_file,
)

IMG, TEXT_LEN, D = 32, 16, 24
ATOL = 1e-5
N_CIRR_IMAGES = 12
# reference image of each CIRR val query: shared by 1-5 queries, so the
# image-major scheduler makes chunks of 4, 2 and 1
CIRR_REFS = (0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 4, 4, 5, 6, 7)
FIQ_DRESSES = ("dress", "shirt")
WORDS = ("the", "a", "red", "blue", "dog", "cat", "dress", "shirt", "with",
         "and", "same", "image")


def _jax_models():
    """JAX stage-I and stage-II models (Pallas switch on) with their
    params, and the port's models holding the same weights."""
    s1_cfg = jcfg.RetrievalModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                       embed_dim=16, text_len=TEXT_LEN)
    s2_cfg = jcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                      text_len=TEXT_LEN)
    imgs = np.zeros((2, IMG, IMG, 3), np.float32)
    ids = np.ones((2, TEXT_LEN), np.int32)
    z = np.zeros((2, TEXT_LEN, D), np.float32)
    # jitted init: a third of the eager init's time on the CPU
    p1 = np_tree(jax.jit(JRetrieval(s1_cfg).init)(jax.random.key(3), imgs,
                                                  ids, ids))
    p2 = np_tree(jax.jit(JReranker(s2_cfg).init)(jax.random.key(4), imgs,
                                                 ids, ids, z))
    j1 = JRetrieval(jcfg.RetrievalModelConfig(
        vit=fused(TINY_VIT), text=fused(TINY_TEXT), embed_dim=16,
        text_len=TEXT_LEN))
    j2 = JReranker(jcfg.RerankerModelConfig(
        vit=fused(TINY_VIT), text=fused(TINY_TEXT), text_len=TEXT_LEN))
    t1 = RetrievalModel(port_cfg(s1_cfg), device="cpu").eval()
    t1.load_state_dict(from_jax_params(p1, port_cfg(s1_cfg)))
    t2 = RerankerModel(port_cfg(s2_cfg), device="cpu").eval()
    t2.load_state_dict(from_jax_params(p2, port_cfg(s2_cfg)))
    return j1, p1, j2, p2, t1, t2, s1_cfg, s2_cfg


@pytest.fixture(scope="module")
def models():
    return _jax_models()


@pytest.fixture(scope="module")
def tokenizers():
    return JTokenizer(j_build_test_vocab()), WordPieceTokenizer(
        build_test_vocab())


def _jpg(path, rng, shape):
    import PIL.Image

    PIL.Image.fromarray(rng.integers(0, 255, size=shape, dtype=np.uint8)) \
        .save(path, quality=92)


def _caption(rng, i, lengths=(2, 3, 3, 4, 9, 12)):
    # mostly short captions with a long tail, so 'auto' makes two buckets
    n_words = lengths[i % len(lengths)]
    return " ".join(rng.choice(WORDS, size=n_words))


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    """A synthetic CIRR val split (as tests/test_cli.py builds one)."""
    root = tmp_path_factory.mktemp("cirr")
    base = root / "cirr_dataset"
    (base / "cirr" / "captions").mkdir(parents=True)
    (base / "cirr" / "image_splits").mkdir(parents=True)
    (base / "img").mkdir()
    rng = np.random.default_rng(0)
    names = [f"im{i}" for i in range(N_CIRR_IMAGES)]
    for i, name in enumerate(names):
        _jpg(base / "img" / f"{name}.jpg", rng, (40 + i, 30 + 2 * i, 3))
    triplets = []
    for q, r in enumerate(CIRR_REFS):
        ref = names[r]
        tgt = names[(r + 1 + q % (N_CIRR_IMAGES - 1)) % N_CIRR_IMAGES]
        others = [n for n in names if n not in (ref, tgt)]
        members = [ref, tgt] + list(rng.choice(others, 4, replace=False))
        triplets.append({"pairid": q, "reference": ref, "target_hard": tgt,
                         "caption": _caption(rng, q),
                         "img_set": {"members": members}})
    with open(base / "cirr" / "captions" / "cap.rc2.val.json", "w") as f:
        json.dump(triplets, f)
    with open(base / "cirr" / "image_splits" / "split.rc2.val.json",
              "w") as f:
        json.dump({n: f"img/{n}.jpg" for n in names}, f)
    return root


@pytest.fixture(scope="module")
def fiq_root(tmp_path_factory):
    """A synthetic Fashion-IQ val split of two dress types (as
    tests/test_fashioniq_e2e.py builds one)."""
    root = tmp_path_factory.mktemp("fiq")
    base = root / "fashionIQ_dataset"
    for sub in ("captions", "image_splits", "images"):
        (base / sub).mkdir(parents=True)
    rng = np.random.default_rng(1)
    for dress in FIQ_DRESSES:
        names = [f"{dress}{i}" for i in range(8)]
        for n in names:
            _jpg(base / "images" / f"{n}.jpg", rng, (40, 30, 3))
        caps = [{"candidate": names[q // 2], "target": names[(q + 3) % 8],
                 "captions": [f"is the {dress}.",
                              _caption(rng, q, (1, 2, 2, 3, 8))]}
                for q in range(7)]
        with open(base / "captions" / f"cap.{dress}.val.json", "w") as f:
            json.dump(caps, f)
        with open(base / "image_splits" / f"split.{dress}.val.json",
                  "w") as f:
            json.dump(names, f)
    return root


# ---------------------------------------------------------------------------
# image-major fusion

def _fuse_inputs(g, q, seed):
    rng = np.random.default_rng(seed)
    refs = rng.normal(size=(g, 17, D)).astype(np.float32)
    ids = rng.integers(5, 100, size=(g * q, TEXT_LEN)).astype(np.int32)
    lens = rng.integers(3, TEXT_LEN + 1, size=g * q)
    mask = (np.arange(TEXT_LEN)[None] < lens[:, None]).astype(np.int32)
    return refs, ids, mask


@pytest.mark.parametrize("return_raw", [False, True])
@pytest.mark.parametrize("g,q", [(3, 2), (2, 4), (1, 8)])
def test_query_group_fuse_matches_jax(models, g, q, return_raw):
    j1, p1, _, _, t1, *_ = models
    refs, ids, mask = _fuse_inputs(g, q, seed=g * 10 + q)
    ref = j1.apply(p1, refs, ids, mask, query_group=q, return_raw=return_raw,
                   method=JRetrieval.fuse)
    with torch.no_grad():
        out = t1.fuse(t(refs), t(ids), t(mask), query_group=q,
                      return_raw=return_raw)
        # the port's own query-major fusion: each image repeated per query
        qm = t1.fuse(t(refs).repeat_interleave(q, 0), t(ids), t(mask),
                     return_raw=return_raw)
    np.testing.assert_allclose(f32(out), f32(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(f32(out), f32(qm), rtol=0, atol=ATOL)


def test_query_group_needs_matching_batch(models):
    t1 = models[4]
    refs, ids, mask = _fuse_inputs(2, 2, seed=0)
    with pytest.raises(ValueError, match="query_group"):
        t1.fuse(t(refs), t(ids), t(mask), query_group=3)


# ---------------------------------------------------------------------------
# the scheduler and the text buckets (pure numpy on both sides)

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("q_batch,image_major", [(8, True), (32, True),
                                                 (256, True), (8, False),
                                                 (3, True)])
def test_schedule_fusion_batches_matches_jax(seed, q_batch, image_major):
    rng = np.random.default_rng(seed)
    n_q, n_img = int(rng.integers(1, 120)), int(rng.integers(1, 40))
    ref_idx = rng.integers(0, n_img, size=n_q).astype(np.int32)
    bucket_of = rng.choice([8, 16, 24, 40], size=n_q)
    ref = jv.schedule_fusion_batches(ref_idx, bucket_of, q_batch, image_major)
    out = tv.schedule_fusion_batches(ref_idx, bucket_of, q_batch, image_major)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert (a[0], a[1], a[4]) == (b[0], b[1], b[4])
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
        assert a[2].dtype == b[2].dtype and a[3].dtype == b[3].dtype


@pytest.mark.parametrize("l_buckets", ["auto", None, (16, 24)])
@pytest.mark.parametrize("seed", range(3))
def test_resolve_buckets_matches_jax(tokenizers, seed, l_buckets):
    jt, tt = tokenizers
    rng = np.random.default_rng(seed)
    caps = [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 30))))
            for _ in range(int(rng.integers(1, 40)))]
    ref = jv.resolve_buckets(jt, caps, 40, l_buckets)
    out = tv.resolve_buckets(tt, caps, 40, l_buckets)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# exact ranking

def _rank_inputs(seed, ties: bool):
    """pred [Q, E], pooled index [N, E], entity columns [Q, 7]. With
    ``ties``: entries in {-2..2}/4, so every product is exact (equal
    distances on both sides whatever the summation order), plus
    duplicated index rows and queries equal to index rows."""
    rng = np.random.default_rng(seed)
    n_q, n, e = 9, 23, 6
    if ties:
        idx = rng.integers(-2, 3, size=(n, e)).astype(np.float32) / 4
        idx[5], idx[17], idx[11] = idx[2], idx[2], idx[20]
        pred = rng.integers(-2, 3, size=(n_q, e)).astype(np.float32) / 4
        pred[0], pred[3] = idx[2], idx[20]
    else:
        idx = rng.normal(size=(n, e)).astype(np.float32)
        pred = rng.normal(size=(n_q, e)).astype(np.float32)
    ent = np.stack([rng.choice(n, 7, replace=False) for _ in range(n_q)])
    ent[0, :3] = (2, 5, 17)      # tied entities, in and out of corpus order
    ent[3, :2] = (20, 11)
    return pred, idx, ent.astype(np.int32)


@pytest.mark.parametrize("width", [1, 5, 23, 40])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_ranked_slices_match_jax(seed, ties, width):
    pred, idx, ent = _rank_inputs(seed, ties)
    ref_topk, ref_ranks = jv.ranked_slices(pred, idx, width, ent)
    topk, ranks = tv.ranked_slices(t(pred), t(idx), width, ent)
    np.testing.assert_array_equal(topk, ref_topk)
    np.testing.assert_array_equal(ranks, ref_ranks)
    assert topk.dtype == np.int32
    # the entity ranks are positions in the full stable order
    full = tv.full_ranking(pred, t(idx))
    np.testing.assert_array_equal(
        ranks, np.argsort(full, axis=1)[np.arange(len(ent))[:, None], ent])
    topk2, none = tv.ranked_slices(pred, t(idx), width)
    np.testing.assert_array_equal(topk2, topk)
    assert none is None


@pytest.mark.parametrize("ties", [False, True])
def test_full_ranking_and_topk_match_jax(ties):
    from candidate_reranking_cir_tpu.ops import topk as jtopk

    pred, idx, _ = _rank_inputs(7, ties)
    np.testing.assert_array_equal(tv.full_ranking(t(pred), t(idx)),
                                  jv.full_ranking(pred, idx))
    np.testing.assert_array_equal(
        ttopk.cosine_rank(t(pred), t(idx)).numpy(),
        np.asarray(jtopk.cosine_rank(pred, idx)))
    scores, ind = ttopk.cosine_topk(t(pred), t(idx), 8)
    ref_scores, ref_ind = jtopk.cosine_topk(pred, idx, 8)
    np.testing.assert_array_equal(ind.numpy(), np.asarray(ref_ind))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               rtol=0, atol=1e-6)


def test_unported_options_raise(cirr_root, models, tokenizers, tmp_path):
    """The mesh paths are ported. What stays refused is what the JAX
    package refuses: the single-program eval with a mesh. A mesh of one
    rank (a gloo group of this process) gives ``ranked_slices``,
    ``full_ranking`` and ``predict_queries`` bit for bit the results
    without a mesh."""
    from _torch_port_mesh_worker import one_rank_mesh

    for fn in (tv.evaluate_cirr_stage1, tv.evaluate_fiq_stage1):
        with pytest.raises(ValueError, match="single-device"):
            fn(None, None, [], [], None, text_len=8, device="cpu",
               mesh=object(), single_program=True)
    # the single-program eval is ported: it runs, and ranks as the
    # multi-launch path does (tests/test_torch_port_single_program.py
    # holds the two executors equal in full)
    t1, tt = models[4], tokenizers[1]
    sets = [CIRRDataset(cirr_root, "val", mode,
                        make_transform("targetpad", IMG))
            for mode in ("classic", "relative")]
    kw = dict(text_len=TEXT_LEN, batch_size=5, q_batch=8, device="cpu")
    single, _ = tv.evaluate_cirr_stage1(t1, None, *sets, tt,
                                        single_program=True, **kw)
    multi, _ = tv.evaluate_cirr_stage1(t1, None, *sets, tt, **kw)
    assert single.metrics == multi.metrics
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(5, 4)).astype(np.float32)
    index = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    ent = rng.integers(0, 7, size=(5, 2))
    _, fuse = tv.make_stage1_fns(t1, None, "cpu")
    caps = ["a red dress", "a dog", "blue", "two red cars", "it"]
    refs = ["x", "x", "y", "x", "y"]
    feats = torch.from_numpy(rng.normal(size=(2, 5, TINY_VIT.hidden_size))
                             .astype(np.float32))
    with one_rank_mesh(tmp_path) as mesh:
        meshed = (tv.ranked_slices(pred, index, 3, ent, mesh=mesh),
                  tv.full_ranking(pred, index, mesh=mesh),
                  tv.predict_queries(fuse, tt, caps, refs, feats, ["x", "y"],
                                     TEXT_LEN, 4, mesh=mesh))
    plain = (tv.ranked_slices(pred, index, 3, ent),
             tv.full_ranking(pred, index),
             tv.predict_queries(fuse, tt, caps, refs, feats, ["x", "y"],
                                TEXT_LEN, 4))
    for a, b in zip(meshed[0], plain[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(meshed[1], plain[1])
    assert torch.equal(meshed[2], plain[2])


# ---------------------------------------------------------------------------
# the metric engine, payloads, submissions, captions

def _random_rankings(seed):
    """A stable-argsort ranking of 14 names for 6 queries, with CIRR
    references, targets and 5 non-reference members."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(14)]
    order = np.stack([rng.permutation(14) for _ in range(6)])
    refs, targets, members = [], [], []
    for row in order:
        ref, tgt = names[row[int(rng.integers(0, 14))]], None
        while tgt in (None, ref):
            tgt = names[int(rng.integers(0, 14))]
        others = [n for n in names if n not in (ref, tgt)]
        refs.append(ref)
        targets.append(tgt)
        members.append([tgt] + list(rng.choice(others, 4, replace=False)))
    place = np.argsort(order, axis=1)
    pos = {n: i for i, n in enumerate(names)}

    def ranks(col):
        return np.asarray([place[q, pos[n]] for q, n in enumerate(col)])

    m_ranks = np.stack([ranks([m[j] for m in members]) for j in range(5)], 1)
    return (names, order, refs, targets, members, ranks(targets), ranks(refs),
            m_ranks)


@pytest.mark.parametrize("width", [4, 14])
@pytest.mark.parametrize("seed", range(3))
def test_rankings_from_ranks_match_jax(seed, width):
    names, order, refs, targets, members, t_r, r_r, m_r = \
        _random_rankings(seed)
    topk = order[:, :width]
    for mod in (jmetrics, tmetrics):
        assert mod.CIRR_RECALL_KS == jmetrics.CIRR_RECALL_KS
    ref = jmetrics.cirr_ranking_from_ranks(topk, names, targets, members,
                                           t_r, r_r, m_r)
    out = tmetrics.cirr_ranking_from_ranks(topk, names, targets, members,
                                           t_r, r_r, m_r)
    np.testing.assert_array_equal(out.sorted_index_names,
                                  ref.sorted_index_names)
    np.testing.assert_array_equal(out.labels, ref.labels)
    np.testing.assert_array_equal(out.group_labels, ref.group_labels)
    if width == 14:  # full width: the name-level path agrees too
        full = tmetrics.cirr_ranking(tmetrics.rank_names(order, names), refs,
                                     targets, members)
        np.testing.assert_array_equal(full.labels, out.labels)
        assert tmetrics.cirr_metrics(full) == jmetrics.cirr_metrics(ref)
    f_ref = jmetrics.fiq_ranking_from_ranks(topk, names, targets, t_r)
    f_out = tmetrics.fiq_ranking_from_ranks(topk, names, targets, t_r)
    np.testing.assert_array_equal(f_out.labels, f_ref.labels)
    if width == 14:
        assert tmetrics.fiq_metrics(f_out) == jmetrics.fiq_metrics(f_ref)
        assert tmetrics.fiq_ranking(f_out.sorted_index_names,
                                    targets).recall_at(5) \
            == f_ref.recall_at(5)
    p_ref = jwriter.topk_payload(ref, names, targets, "val", k=3,
                                 dress_types=["dress"])
    p_out = twriter.topk_payload(out, names, targets, "val", k=3,
                                 dress_types=["dress"])
    assert p_out.keys() == p_ref.keys()
    for key in p_ref:
        np.testing.assert_array_equal(p_out[key], p_ref[key])
    t1_ref = jwriter.test1_topk_payload(ref.sorted_index_names, names, 3)
    t1_out = twriter.test1_topk_payload(out.sorted_index_names, names, 3)
    np.testing.assert_array_equal(t1_out["sorted_index_names"],
                                  t1_ref["sorted_index_names"])
    assert t1_out["split"] == t1_ref["split"] == "test1"


def test_rankings_reject_bad_inputs():
    names = ["a", "b", "a"]
    with pytest.raises(AssertionError, match="duplicate"):
        tmetrics.fiq_ranking_from_ranks(np.zeros((1, 3), int), names, ["a"],
                                        np.zeros(1, int))
    with pytest.raises(AssertionError, match="one ground-truth"):
        tmetrics.fiq_ranking(np.asarray([["a", "b"]], object), ["c"])


def test_submissions_and_captions_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    names = np.asarray([[f"x{j}" for j in rng.permutation(60)]
                        for _ in range(3)], object)
    groups = names[:, :5]
    sub = tsub.build_submissions([3, 1, 2], names, groups)
    assert sub == jsub.build_submissions([3, 1, 2], names, groups)
    p1, p2 = tsub.write_submissions(tmp_path / "t", "s", *sub)
    r1, r2 = jsub.write_submissions(tmp_path / "j", "s", *sub)
    assert p1.read_bytes() == r1.read_bytes()
    assert p2.read_bytes() == r2.read_bytes()
    caps = [["is red.", "Has sleeves?"], [" longer, ", "darker"]]
    assert tcaptions.compose_fiq_eval(caps) == jcaptions.compose_fiq_eval(caps)
    assert tcaptions.fiq_longest_compositions(caps) == \
        jcaptions.fiq_longest_compositions(caps)
    assert tcaptions.compose_fiq_train(caps * 4, np.random.default_rng(0)) \
        == jcaptions.compose_fiq_train(caps * 4, np.random.default_rng(0))
    for path in ("top_{dress}.npz", "top_DTYPE.npz"):
        assert resolve_fiq_topk_path(path, "shirt") == \
            j_resolve_fiq_topk_path(path, "shirt")


# ---------------------------------------------------------------------------
# the engines end to end

def test_predict_queries_matches_jax(cirr_root, models, tokenizers):
    """The fused predictions of every query, image-major (q_batch 8: chunks
    of 4 and 2 and query-major leftovers, padded tails) and query-major,
    from the same bank on both sides."""
    j1, p1, _, _, t1, *_ = models
    jt, tt = tokenizers
    relative = JCIRR(cirr_root, "val", "relative")
    classic = JCIRR(cirr_root, "val", "classic",
                    j_make_transform("targetpad", IMG))
    embed, jfuse = jv.make_stage1_fns(j1, p1)
    from candidate_reranking_cir_tpu.retrieval.index import (
        build_index as j_build_index,
    )

    raw, _, names = j_build_index(classic, embed, 5, pooled=True)
    samples = [relative[i] for i in range(len(relative))]
    caps = [s["caption"] for s in samples]
    refs = [s["reference_name"] for s in samples]
    bank = t(f32(raw)).to(torch.bfloat16)   # the same bf16 values
    _, fuse = tv.make_stage1_fns(t1, None, "cpu")
    out = {}
    for image_major in (True, False):
        ref = jv.predict_queries(jfuse, jt, caps, refs, raw, names, TEXT_LEN,
                                 8, image_major=image_major)
        out[image_major] = tv.predict_queries(
            fuse, tt, caps, refs, bank, names, TEXT_LEN, 8,
            image_major=image_major)
        assert out[image_major].dtype == torch.float32
        np.testing.assert_allclose(f32(out[image_major]), f32(ref), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(f32(out[True]), f32(out[False]), rtol=0,
                               atol=ATOL)


def test_evaluate_cirr_stage1_matches_jax(cirr_root, models, tokenizers):
    j1, p1, _, _, t1, *_ = models
    jt, tt = tokenizers
    kw = dict(text_len=TEXT_LEN, batch_size=5, save_topk_k=6, q_batch=8)
    jset = [JCIRR(cirr_root, "val", mode, j_make_transform("targetpad", IMG))
            for mode in ("classic", "relative")]
    ref, ref_payload = jv.evaluate_cirr_stage1(j1, p1, *jset, jt, **kw)
    tset = [CIRRDataset(cirr_root, "val", mode,
                        make_transform("targetpad", IMG))
            for mode in ("classic", "relative")]
    out, payload = tv.evaluate_cirr_stage1(t1, None, *tset, tt,
                                           device="cpu", **kw)
    assert out.metrics == ref.metrics
    assert out.index_names == ref.index_names
    assert out.target_names == ref.target_names
    np.testing.assert_array_equal(out.ranking.sorted_index_names,
                                  ref.ranking.sorted_index_names)
    np.testing.assert_array_equal(out.ranking.group_labels,
                                  ref.ranking.group_labels)
    assert payload.keys() == ref_payload.keys()
    for key in ref_payload:
        np.testing.assert_array_equal(payload[key], ref_payload[key])
    assert set(out.seconds) == {
        "index", "fusion", "ranking", "total", "index.load", "index.upload",
        "index.wait", "fusion.plan", "fusion.wait", "ranking.plan",
        "ranking.wait", "stage1.labels", "stage1.metrics"}
    # image-major and query-major rank alike
    qm, _ = tv.evaluate_cirr_stage1(t1, None, *tset, tt, device="cpu",
                                    image_major=False, **kw)
    assert qm.metrics == out.metrics


@pytest.fixture(scope="module")
def fiq_stage1(fiq_root, models, tokenizers):
    """Both sides' stage-I results per dress type, and the port's top-K
    files (one per type, written as the validate CLI names them)."""
    j1, p1, _, _, t1, *_ = models
    jt, tt = tokenizers
    kw = dict(text_len=TEXT_LEN, batch_size=3, save_topk_k=5, q_batch=4)
    res = {}
    for dress in FIQ_DRESSES:
        jset = [JFIQ(fiq_root, "val", [dress], mode,
                     j_make_transform("targetpad", IMG))
                for mode in ("classic", "relative")]
        tset = [FashionIQDataset(fiq_root, "val", [dress], mode,
                                 make_transform("targetpad", IMG))
                for mode in ("classic", "relative")]
        res[dress] = (
            jv.evaluate_fiq_stage1(j1, p1, *jset, jt, dress_types=[dress],
                                   **kw),
            tv.evaluate_fiq_stage1(t1, None, *tset, tt, dress_types=[dress],
                                   device="cpu", **kw))
        save_topk_file(fiq_root / f"top_{dress}.npz", res[dress][1][1])
    return res


def test_evaluate_fiq_stage1_matches_jax(fiq_stage1):
    for dress, ((ref, ref_payload), (out, payload)) in fiq_stage1.items():
        assert out.metrics == ref.metrics, dress
        assert payload.keys() == ref_payload.keys()
        for key in ref_payload:
            np.testing.assert_array_equal(payload[key], ref_payload[key])
        assert payload["dress_types"] == dress


def test_evaluate_fiq_stage2_matches_jax(fiq_root, fiq_stage1, models,
                                         tokenizers):
    j1, p1, j2, p2, t1, t2, *_ = models
    jt, tt = tokenizers
    common = dict(data_root=fiq_root, top_k_path=fiq_root / "top_DTYPE.npz",
                  k=4, text_len=TEXT_LEN, dress_types=FIQ_DRESSES)
    ref = jv2.evaluate_fiq_stage2(
        j1, p1, j2, p2, jt, transform=j_make_transform("targetpad", IMG),
        **common)
    out = tv2.evaluate_fiq_stage2(
        t1, None, t2, None, tt, transform=make_transform("targetpad", IMG),
        device="cpu", **common)
    assert out == ref
    assert set(out) >= {"dress_recall_at10", "shirt_recall_at50",
                        "average_recall"}


# ---------------------------------------------------------------------------
# export to the reference's keys

@pytest.mark.parametrize("stage", [1, 2])
def test_export_matches_jax_and_round_trips(models, stage, tmp_path):
    j1, p1, j2, p2, t1, t2, c1, c2 = models
    params, cfg, jexport, texport, model, cls = {
        1: (p1, c1, jconvert.export_stage1, tconvert.export_stage1, t1,
            "BLIP_Retrieval"),
        2: (p2, c2, jconvert.export_stage2, tconvert.export_stage2, t2,
            "BLIP_NLVR")}[stage]
    sd = model.state_dict()
    ref = jexport(params, cfg)
    out = texport(sd)
    assert out.keys() == ref.keys()
    for key, val in ref.items():
        val = np.asarray(val, np.float32)
        assert out[key].shape == val.shape, key
        np.testing.assert_array_equal(out[key], val, err_msg=key)
    back = load_reference_state_dict(out, port_cfg(cfg))
    assert back.keys() == sd.keys()
    for key, val in sd.items():
        assert torch.equal(back[key], val), key
    path = tmp_path / "ckpt.pt"
    tconvert.save_torch_checkpoint(path, out, cls, epoch=3)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert raw["epoch"] == 3 and cls in raw
    read = read_reference_file(path)
    assert read.keys() == out.keys()
    assert all(np.array_equal(read[k], out[k]) for k in out)
