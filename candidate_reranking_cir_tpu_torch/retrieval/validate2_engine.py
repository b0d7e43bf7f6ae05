"""Stage-II CIRR validation (port of the JAX package's
``retrieval/validate2_engine.py``, candidate-major schedule, one device).

Builds the stage-II ViT index over the val corpus, re-ranks each query's
top-K candidates with the candidate-major scorer, and computes the re-ranked
recalls plus the CIRR subset recalls from the re-scored 5-member groups.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from candidate_reranking_cir_tpu_torch.data.datasets import CIRRDataset
from candidate_reranking_cir_tpu_torch.retrieval import metrics as M
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
    RerankOutput,
    bind_module,
    cirr_group_labels,
    rerank_candidate_major,
)
from candidate_reranking_cir_tpu_torch.runtime.device import (
    resolve_device,
    sync_device,
)


@dataclass
class Stage2Result:
    metrics: dict
    rerank: RerankOutput
    seconds: dict   # wall seconds: 'index', 'zt', 'score', 'total'


def evaluate_cirr_stage2_datasets(stage1, s1_params, reranker, s2_params,
                                  tokenizer, classic, relative, *, k: int,
                                  text_len: int, batch_size: int = 16,
                                  l_buckets="auto",
                                  device=None) -> Stage2Result:
    """The evaluation on ready-made datasets: ``classic`` yields
    {'name', 'image' [H, W, 3]} corpus rows, ``relative`` the val triplets
    with their top-K names and labels (``CIRRDataset`` with ``load_topk``,
    or any object with the same items)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    stage1 = bind_module(stage1, s1_params, device)
    reranker = bind_module(reranker, s2_params, device)
    raw, index_names = build_index(classic, reranker.embed_images, batch_size,
                                   device=device)
    sync_device(device)
    t_index = time.perf_counter() - t0

    samples = [relative[i] for i in range(len(relative))]
    refs = [s["reference_name"] for s in samples]
    targets = [s["target_name"] for s in samples]
    groups = [s["group_members"] for s in samples]
    topk_names = np.stack([np.asarray(s["topk_names"]) for s in samples])
    topk_labels = np.stack([np.asarray(s["topk_labels"], bool)
                            for s in samples])

    hit_rate = 100.0 * topk_labels.any(1).mean()
    print(f"val-split: top-{k} candidate {hit_rate:.2f}%")

    out = rerank_candidate_major(
        stage1, None, reranker, None, tokenizer,
        captions=[s["caption"] for s in samples], reference_names=refs,
        topk_names=topk_names, index_feats=raw, index_names=index_names,
        text_len=text_len, skip_mask=~topk_labels.any(axis=1),
        group_members=groups, l_buckets=l_buckets, device=device)

    labels = M.reranked_labels(topk_labels, out.order)
    members_no_ref = [[m for m in g if m != r][:5]
                      for g, r in zip(groups, refs)]
    glabels = cirr_group_labels(members_no_ref, out.group_order, targets)
    mets = {}
    for kk in (1, 5, 10, 50, 100):
        if kk <= labels.shape[1]:
            mets[f"recall_at{kk}"] = M.recall_at(labels, kk)
    for kk in (1, 2, 3):
        mets[f"group_recall_at{kk}"] = M.recall_at(glabels, kk)
    mets["mean_r5_rs1"] = (mets.get("recall_at5", 0.0)
                           + mets["group_recall_at1"]) / 2
    seconds = {"index": t_index, **out.seconds,
               "total": time.perf_counter() - t0}
    return Stage2Result(mets, out, seconds)


def evaluate_cirr_stage2(stage1, s1_params, reranker, s2_params, tokenizer, *,
                         data_root, transform, top_k_path, k, text_len,
                         q_batch: int = 8, batch_size: int = 16, mesh=None,
                         schedule: str = "candidate_major",
                         shard_index: bool = False, l_buckets="auto",
                         index_int8: bool = False, device=None) -> dict:
    """CIRR val stage-II metrics, with the JAX package's signature.

    stage1 / reranker are the port's models; s1_params / s2_params port
    state dicts to load into them, or None. ``q_batch`` belongs to the
    query-major schedule, which is not ported yet, as are ``mesh``,
    ``shard_index`` and ``index_int8``: those raise."""
    del q_batch  # unused by the candidate-major schedule, as in JAX
    if schedule != "candidate_major":
        raise NotImplementedError("only schedule='candidate_major' is ported")
    if mesh is not None or shard_index or index_int8:
        raise NotImplementedError(
            "mesh, shard_index and index_int8 are not ported yet")
    classic = CIRRDataset(data_root, "val", "classic", transform,
                          load_topk=top_k_path, k=k)
    relative = CIRRDataset(data_root, "val", "relative", transform,
                           load_topk=top_k_path, k=k)
    return evaluate_cirr_stage2_datasets(
        stage1, s1_params, reranker, s2_params, tokenizer, classic, relative,
        k=k, text_len=text_len, batch_size=batch_size, l_buckets=l_buckets,
        device=device).metrics
