"""The port's stage-II slice end to end against the JAX package.

A synthetic CIRR val split (jpegs, triplets with 6-member groups; built as
in tests/test_end_to_end.py) and a top-K file written by the JAX
``save_topk_file`` go through the JAX ``evaluate_cirr_stage2`` (Pallas
kernels interpreted on the CPU) and the port's ``evaluate_cirr_stage2(
device='cpu')`` with the same weights: the metrics must be equal. The
candidate-major scheduler is also called directly on both sides, at its
defaults and with knobs small enough for several candidate chunks, padded
tail rows and two text-length buckets: the re-rank order must be identical
and the logits within atol 1e-4."""
import json

import jax
import numpy as np
import pytest
import torch

from _torch_port_utils import TINY_TEXT, TINY_VIT, f32, fused, np_tree, \
    port_cfg
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.data.datasets import CIRRDataset as JCIRR
from candidate_reranking_cir_tpu.data.preprocessing import (
    make_transform as j_make_transform,
)
from candidate_reranking_cir_tpu.data.topk_io import save_topk_file
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
from candidate_reranking_cir_tpu.retrieval import rerank as jrerank
from candidate_reranking_cir_tpu.retrieval import validate2_engine as jv2
from candidate_reranking_cir_tpu_torch.data.datasets import CIRRDataset
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    make_transform,
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
from candidate_reranking_cir_tpu_torch.retrieval import rerank as trerank
from candidate_reranking_cir_tpu_torch.retrieval import (
    validate2_engine as tv2,
)
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.runtime.weights import from_jax_params

N_IMAGES, N_QUERIES, K, TOPK_FILE_K, IMG, TEXT_LEN = 12, 8, 6, 8, 32, 16
ATOL = 1e-4
# words per caption: most short, a long tail, so 'auto' cuts two buckets
CAPTION_WORDS = (2, 2, 3, 3, 4, 5, 11, 14)
WORDS = ("the", "a", "red", "blue", "dog", "cat", "dress", "shirt", "with",
         "and", "same", "image")


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    """Fake CIRR val split plus a stage-I top-K file (target missing from
    query 5's list, so that query is skipped)."""
    import PIL.Image

    root = tmp_path_factory.mktemp("data")
    base = root / "cirr_dataset"
    (base / "cirr" / "captions").mkdir(parents=True)
    (base / "cirr" / "image_splits").mkdir(parents=True)
    (base / "img").mkdir()
    rng = np.random.default_rng(0)
    names = [f"im{i}" for i in range(N_IMAGES)]
    relpath = {}
    for i, name in enumerate(names):
        arr = rng.integers(0, 255, size=(40 + i, 30 + 2 * i, 3),
                           dtype=np.uint8)
        PIL.Image.fromarray(arr).save(base / "img" / f"{name}.jpg",
                                      quality=92)
        relpath[name] = f"img/{name}.jpg"

    triplets, sorted_names, labels, group_labels = [], [], [], []
    for q in range(N_QUERIES):
        ref, tgt = names[q], names[(q + 3) % N_IMAGES]
        members = [ref, tgt] + [names[(q + 5 + j) % N_IMAGES]
                                for j in range(4)]
        words = rng.choice(WORDS, size=CAPTION_WORDS[q])
        triplets.append({"pairid": q, "reference": ref, "target_hard": tgt,
                         "caption": " ".join(words),
                         "img_set": {"members": members}})
        others = [n for n in names if n not in (ref, tgt)]
        row = list(rng.permutation(others)[:TOPK_FILE_K])
        if q != 5:
            row[int(rng.integers(0, K))] = tgt
        sorted_names.append(row)
        labels.append([n == tgt for n in row])
        group_labels.append([m == tgt for m in members if m != ref][:5])
    with open(base / "cirr" / "captions" / "cap.rc2.val.json", "w") as f:
        json.dump(triplets, f)
    with open(base / "cirr" / "image_splits" / "split.rc2.val.json", "w") as f:
        json.dump(relpath, f)
    save_topk_file(root / "topk.npz", {
        "sorted_index_names": np.asarray(sorted_names, dtype=object),
        "labels": np.asarray(labels, bool),
        "group_labels": np.asarray(group_labels, bool),
        "index_names": names,
        "target_names": [tr["target_hard"] for tr in triplets],
        "split": "val"})
    return root


@pytest.fixture(scope="module")
def models():
    """JAX models (fused attention) with their params, and the port's
    models holding the same weights."""
    s1_cfg = jcfg.RetrievalModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                       embed_dim=16, text_len=TEXT_LEN)
    s2_cfg = jcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                      text_len=TEXT_LEN)
    imgs = np.zeros((2, IMG, IMG, 3), np.float32)
    ids = np.ones((2, TEXT_LEN), np.int32)
    z = np.zeros((2, TEXT_LEN, 24), np.float32)
    p1 = np_tree(JRetrieval(s1_cfg).init(jax.random.key(0), imgs, ids, ids))
    p2 = np_tree(JReranker(s2_cfg).init(jax.random.key(1), imgs, ids, ids,
                                        z))
    j1 = JRetrieval(jcfg.RetrievalModelConfig(
        vit=fused(TINY_VIT), text=fused(TINY_TEXT), embed_dim=16,
        text_len=TEXT_LEN))
    j2 = JReranker(jcfg.RerankerModelConfig(
        vit=fused(TINY_VIT), text=fused(TINY_TEXT), text_len=TEXT_LEN))
    t1 = RetrievalModel(port_cfg(s1_cfg), device="cpu")
    t1.load_state_dict(from_jax_params(p1, port_cfg(s1_cfg)))
    t2 = RerankerModel(port_cfg(s2_cfg), device="cpu")
    t2.load_state_dict(from_jax_params(p2, port_cfg(s2_cfg)))
    return j1, p1, j2, p2, t1, t2


@pytest.fixture(scope="module")
def tokenizers():
    jt, tt = JTokenizer(j_build_test_vocab()), WordPieceTokenizer(
        build_test_vocab())
    return jt, tt


def test_evaluate_cirr_stage2_matches_jax(cirr_root, models, tokenizers):
    j1, p1, j2, p2, t1, t2 = models
    jt, tt = tokenizers
    common = dict(data_root=cirr_root, top_k_path=cirr_root / "topk.npz",
                  k=K, text_len=TEXT_LEN)
    ref = jv2.evaluate_cirr_stage2(
        j1, p1, j2, p2, jt, transform=j_make_transform("targetpad", IMG),
        **common)
    out = tv2.evaluate_cirr_stage2(
        t1, None, t2, None, tt, transform=make_transform("targetpad", IMG),
        device="cpu", **common)
    assert out == ref
    assert set(out) >= {"recall_at1", "recall_at5", "group_recall_at1",
                        "mean_r5_rs1"}


@pytest.fixture(scope="module")
def rerank_inputs(cirr_root, models):
    """Shared inputs of the direct scheduler calls: the val samples and the
    JAX stage-II bank (fed to both sides, so the comparison isolates the
    scheduler and the models)."""
    _, _, j2, p2, _, t2 = models
    transform = j_make_transform("targetpad", IMG)
    classic = JCIRR(cirr_root, "val", "classic", transform)
    relative = JCIRR(cirr_root, "val", "relative", transform,
                     load_topk=cirr_root / "topk.npz", k=K)
    raw, _, index_names = jv2._build_stage2_index(j2, p2, classic, 16)
    samples = [relative[i] for i in range(len(relative))]
    labels = np.stack([s["topk_labels"] for s in samples])
    kw = dict(captions=[s["caption"] for s in samples],
              reference_names=[s["reference_name"] for s in samples],
              topk_names=np.stack([np.asarray(s["topk_names"])
                                   for s in samples]),
              index_names=index_names, text_len=TEXT_LEN,
              skip_mask=~labels.any(axis=1),
              group_members=[s["group_members"] for s in samples])
    return raw, kw


def test_port_bank_matches_jax_bank(cirr_root, models, rerank_inputs):
    """The port's index (its own dataset copy and ViT) against the JAX
    bank: both are bf16 roundings of fp32 values that differ in the last
    bits, so they agree to one bf16 ulp (rtol 2^-7)."""
    *_, t2 = models
    raw, kw = rerank_inputs
    classic = CIRRDataset(cirr_root, "val", "classic",
                          make_transform("targetpad", IMG))
    bank, names = build_index(classic, t2.embed_images, 5, device="cpu")
    assert names == kw["index_names"] and bank.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(bank), f32(raw), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("knobs", [
    {},
    {"pairs_per_call": 16, "q_buckets": (2, 8), "zt_batch": 4},
], ids=["defaults", "small_chunks"])
def test_rerank_candidate_major_matches_jax(models, tokenizers, rerank_inputs,
                                            knobs):
    j1, p1, j2, p2, t1, t2 = models
    jt, tt = tokenizers
    raw, kw = rerank_inputs
    lengths = jt.encode(kw["captions"], TEXT_LEN)[1].sum(1)
    assert len(trerank.resolve_l_buckets("auto", lengths, TEXT_LEN)) >= 2
    ref = jrerank.rerank_candidate_major(j1, p1, j2, p2, jt, index_feats=raw,
                                         **kw, **knobs)
    bank = torch.from_numpy(f32(raw)).to(torch.bfloat16)
    out = trerank.rerank_candidate_major(t1, None, t2, None, tt,
                                         index_feats=bank, device="cpu",
                                         **kw, **knobs)
    np.testing.assert_allclose(out.logits, ref.logits, atol=ATOL)
    np.testing.assert_allclose(out.group_logits, ref.group_logits, atol=ATOL)
    np.testing.assert_array_equal(out.order, ref.order)
    np.testing.assert_array_equal(out.group_order, ref.group_order)
    skipped = kw["skip_mask"]
    assert skipped.any() and (out.logits[skipped] == trerank.SKIP_LOGIT).all()
