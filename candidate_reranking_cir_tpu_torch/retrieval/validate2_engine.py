"""Stage-II CIRR and Fashion-IQ validation (port of the JAX package's
``retrieval/validate2_engine.py``).

Builds the stage-II ViT index over the val corpus (optionally quantized to
an int8 bank), re-ranks each query's top-K candidates with the
candidate-major scheduler (the default) or the query-major one, and
computes the re-ranked recalls, plus for CIRR the subset recalls from the
re-scored 5-member groups. Fashion-IQ runs per dress type, each with its
own top-K file. Over a mesh the index build and the re-rank shard their
work (``retrieval/index.py``, ``retrieval/rerank.py``); ``shard_index``
splits the bank over the ranks, which only the candidate-major schedule
reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from candidate_reranking_cir_tpu_torch.data.captions import compose_fiq_eval
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.data.topk_io import (
    resolve_fiq_topk_path,
)
from candidate_reranking_cir_tpu_torch.ops.quant import quantize_bank
from candidate_reranking_cir_tpu_torch.retrieval import metrics as M
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
    RerankOutput,
    bind_module,
    cirr_group_labels,
    rerank,
    rerank_candidate_major,
    rerank_prefixed,
)
from candidate_reranking_cir_tpu_torch.runtime import tracing
from candidate_reranking_cir_tpu_torch.runtime.device import (
    resolve_device,
    sync_device,
)


@dataclass
class Stage2Result:
    metrics: dict
    rerank: RerankOutput
    # wall seconds of the layer spans 'index', 'zt' and 'score' (or
    # 'rerank' for the query-major schedule), 'total', and the phase
    # spans' totals (``runtime/tracing``)
    seconds: dict


def run_rerank(schedule: str, stage1, reranker, tokenizer, *, q_batch: int,
               l_buckets, device, mesh=None, shard_index: bool = False,
               **kw) -> RerankOutput:
    """The re-rank scheduler ``schedule`` names (the JAX package's
    ``_run_rerank``) over bound models: 'candidate_major' groups pairs by
    candidate, so K/V projections serve the ~90 queries that rank each
    corpus image; 'query_major' runs fixed [q_batch, K] chunks at the
    single ``text_len`` bucket, or for a re-ranker whose class sets
    ``prefix_scorer`` (Kimi-VL) ``rerank_prefixed``'s prefix and suffix
    passes (no stage I). ``shard_index`` (a block-sharded bank) needs
    'candidate_major'."""
    if schedule == "candidate_major":
        if reranker.prefix_scorer:
            raise ValueError("a prefix scorer (Kimi-VL) runs with "
                             "schedule='query_major'")
        return rerank_candidate_major(stage1, None, reranker, None, tokenizer,
                                      l_buckets=l_buckets, device=device,
                                      mesh=mesh, index_sharded=shard_index,
                                      **kw)
    if shard_index:
        raise ValueError("shard_index requires schedule='candidate_major'")
    if schedule == "query_major":
        with tracing.layer_span("rerank"):
            if reranker.prefix_scorer:
                if mesh is not None:
                    raise ValueError("a prefix scorer runs on one device")
                return rerank_prefixed(reranker, None, tokenizer,
                                       q_batch=q_batch, device=device, **kw)
            return rerank(stage1, None, reranker, None, tokenizer,
                          q_batch=q_batch, device=device, mesh=mesh, **kw)
    raise ValueError(f"unknown schedule {schedule!r}")


def stage2_bank(reranker, classic, batch_size: int, index_int8: bool,
                device, mesh=None, shard_index: bool = False):
    """The stage-II ViT bank of ``classic`` and its names; with
    ``index_int8`` quantized to an ``Int8Bank`` (about half the memory;
    scores shift by under 1%); over ``mesh`` with ``shard_index``, this
    rank's block of it."""
    raw, index_names = build_index(classic, reranker.embed_images, batch_size,
                                   device=device, mesh=mesh,
                                   shard_index=shard_index)
    return (quantize_bank(raw) if index_int8 else raw), index_names


def evaluate_cirr_stage2_datasets(stage1, s1_params, reranker, s2_params,
                                  tokenizer, classic, relative, *, k: int,
                                  text_len: int, batch_size: int = 16,
                                  l_buckets="auto",
                                  schedule: str = "candidate_major",
                                  q_batch: int = 8, index_int8: bool = False,
                                  mesh=None, shard_index: bool = False,
                                  device=None) -> Stage2Result:
    """The evaluation on ready-made datasets: ``classic`` yields
    {'name', 'image' [H, W, 3]} corpus rows, ``relative`` the val triplets
    with their top-K names and labels (``CIRRDataset`` with ``load_topk``,
    or any object with the same items). ``mesh`` and ``shard_index`` as
    ``evaluate_cirr_stage2``'s."""
    device = resolve_device(device) if mesh is None else mesh.device
    seconds = {}
    with tracing.collect(seconds), tracing.layer_span("total"):
        with tracing.layer_span("index"):
            stage1 = bind_module(stage1, s1_params, device)
            reranker = bind_module(reranker, s2_params, device)
            raw, index_names = stage2_bank(reranker, classic, batch_size,
                                           index_int8, device, mesh,
                                           shard_index)
            with tracing.trace_phase("index.wait"):
                sync_device(device)

        with tracing.trace_phase("rerank.labels"):
            samples = [relative[i] for i in range(len(relative))]
            refs = [s["reference_name"] for s in samples]
            targets = [s["target_name"] for s in samples]
            groups = [s["group_members"] for s in samples]
            topk_names = np.stack([np.asarray(s["topk_names"])
                                   for s in samples])
            topk_labels = np.stack([np.asarray(s["topk_labels"], bool)
                                    for s in samples])
            hit_rate = 100.0 * topk_labels.any(1).mean()
        if mesh is None or mesh.rank == 0:
            print(f"val-split: top-{k} candidate {hit_rate:.2f}%")

        out = run_rerank(
            schedule, stage1, reranker, tokenizer, q_batch=q_batch,
            l_buckets=l_buckets, device=device, mesh=mesh,
            shard_index=shard_index,
            captions=[s["caption"] for s in samples], reference_names=refs,
            topk_names=topk_names, index_feats=raw, index_names=index_names,
            text_len=text_len, skip_mask=~topk_labels.any(axis=1),
            group_members=groups)
        # candidate-major keeps its own seconds ('zt', 'score', its phases)
        seconds.update(out.seconds)

        with tracing.trace_phase("rerank.metrics"):
            labels = M.reranked_labels(topk_labels, out.order)
            members_no_ref = [[m for m in g if m != r][:5]
                              for g, r in zip(groups, refs)]
            glabels = cirr_group_labels(members_no_ref, out.group_order,
                                        targets)
            mets = {}
            for kk in (1, 5, 10, 50, 100):
                if kk <= labels.shape[1]:
                    mets[f"recall_at{kk}"] = M.recall_at(labels, kk)
            for kk in (1, 2, 3):
                mets[f"group_recall_at{kk}"] = M.recall_at(glabels, kk)
            mets["mean_r5_rs1"] = (mets.get("recall_at5", 0.0)
                                   + mets["group_recall_at1"]) / 2
    return Stage2Result(mets, out, seconds)


def evaluate_cirr_stage2(stage1, s1_params, reranker, s2_params, tokenizer, *,
                         data_root, transform, top_k_path, k, text_len,
                         q_batch: int = 8, batch_size: int = 16, mesh=None,
                         schedule: str = "candidate_major",
                         shard_index: bool = False, l_buckets="auto",
                         index_int8: bool = False, device=None) -> dict:
    """CIRR val stage-II metrics, with the JAX package's signature.

    stage1 / reranker are the port's models; s1_params / s2_params port
    state dicts to load into them, or None. ``q_batch`` is the query-major
    schedule's chunk (unused by the candidate-major one, as in JAX);
    ``index_int8`` quantizes the stage-II bank. ``mesh``: the index build
    and the re-rank shard their work over it; ``shard_index`` (with a
    mesh and the candidate-major schedule) splits the bank over the
    ranks."""
    classic = CIRRDataset(data_root, "val", "classic", transform,
                          load_topk=top_k_path, k=k)
    relative = CIRRDataset(data_root, "val", "relative", transform,
                           load_topk=top_k_path, k=k)
    return evaluate_cirr_stage2_datasets(
        stage1, s1_params, reranker, s2_params, tokenizer, classic, relative,
        k=k, text_len=text_len, batch_size=batch_size, l_buckets=l_buckets,
        schedule=schedule, q_batch=q_batch, index_int8=index_int8,
        mesh=mesh, shard_index=shard_index, device=device).metrics


def evaluate_fiq_stage2(stage1, s1_params, reranker, s2_params, tokenizer, *,
                        data_root, transform, top_k_path, k, text_len,
                        dress_types=("shirt", "dress", "toptee"),
                        q_batch: int = 8, batch_size: int = 16, mesh=None,
                        schedule: str = "candidate_major",
                        shard_index: bool = False, l_buckets="auto",
                        index_int8: bool = False, device=None) -> dict:
    """Fashion-IQ val stage-II metrics per dress type and averaged, with the
    JAX package's signature. ``top_k_path`` holds '{dress}' or the
    reference's 'DTYPE' placeholder, substituted per category (the
    reference stores one file per type, utils.py:195). Options as
    ``evaluate_cirr_stage2``."""
    device = resolve_device(device) if mesh is None else mesh.device
    stage1 = bind_module(stage1, s1_params, device)
    reranker = bind_module(reranker, s2_params, device)
    mets = {}
    r10s, r50s = [], []
    for dress in dress_types:
        path = resolve_fiq_topk_path(top_k_path, dress)
        classic = FashionIQDataset(data_root, "val", [dress], "classic",
                                   transform, load_topk=path, k=k)
        relative = FashionIQDataset(data_root, "val", [dress], "relative",
                                    transform, load_topk=path, k=k)
        raw, index_names = stage2_bank(reranker, classic, batch_size,
                                       index_int8, device, mesh, shard_index)
        samples = [relative[i] for i in range(len(relative))]
        topk_labels = np.stack([np.asarray(s["topk_labels"], bool)
                                for s in samples])
        out = run_rerank(
            schedule, stage1, reranker, tokenizer, q_batch=q_batch,
            l_buckets=l_buckets, device=device, mesh=mesh,
            shard_index=shard_index,
            captions=compose_fiq_eval([s["captions"] for s in samples]),
            reference_names=[s["reference_name"] for s in samples],
            topk_names=np.stack([np.asarray(s["topk_names"])
                                 for s in samples]),
            index_feats=raw, index_names=index_names, text_len=text_len,
            skip_mask=~topk_labels.any(axis=1))
        labels = M.reranked_labels(topk_labels, out.order)
        n = len(labels)
        r10 = 100.0 * labels[:, :10].sum() / n
        r50 = 100.0 * labels[:, :50].sum() / n if labels.shape[1] >= 50 \
            else 100.0 * labels.sum() / n
        mets[f"{dress}_recall_at10"] = r10
        mets[f"{dress}_recall_at50"] = r50
        r10s.append(r10)
        r50s.append(r50)
    mets["average_recall10"] = float(np.mean(r10s))
    mets["average_recall50"] = float(np.mean(r50s))
    mets["average_recall"] = (mets["average_recall10"]
                              + mets["average_recall50"]) / 2
    return mets
