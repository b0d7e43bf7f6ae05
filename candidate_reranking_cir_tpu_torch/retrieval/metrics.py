"""Recall metric engine for CIRR and Fashion-IQ (an own copy of the JAX
package's ``retrieval/metrics.py``).

Reproduces the reference's metric semantics exactly (validate.py:33-99 for
Fashion-IQ, validate.py:176-268 for CIRR):

- full-corpus cosine ranking by ascending distance 1 - sim,
- CIRR: the reference image is removed from each query's ranking
  (validate.py:207-210) before labels are computed,
- labels from name equality with exactly-one-hot sanity asserts
  (validate.py:225-226),
- CIRR subset metrics over each query's 6-image group minus the reference
  (validate.py:216-222),
- Recall@k = mean over queries of "target within top k", as a percentage.

Everything here is name-level numpy on the host; embedding, the similarity
product and the ranking run on the device (``retrieval/validate_engine.py``).
The stage-II re-rank adds ``reranked_labels`` and ``recall_at``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FIQ_RECALL_KS = (10, 50, 60, 70, 80, 90, 100, 150, 200, 300, 400, 500)
CIRR_RECALL_KS = (1, 5, 10, 50, 60, 70, 80, 90, 100, 150, 200, 300, 400, 500)
CIRR_SUBSET_KS = (1, 2, 3)


@dataclass
class RankingResult:
    """Name-level ranking + labels for one query set."""

    sorted_index_names: np.ndarray  # [N_q, N_idx(-1 for CIRR)] str
    labels: np.ndarray              # same shape, bool
    group_labels: np.ndarray | None = None  # [N_q, 5] bool (CIRR only)

    def recall_at(self, k: int) -> float:
        return float(self.labels[:, :k].sum() / len(self.labels)) * 100.0

    def subset_recall_at(self, k: int) -> float:
        assert self.group_labels is not None
        return float(self.group_labels[:, :k].sum() /
                     len(self.group_labels)) * 100.0


def rank_names(sorted_indices: np.ndarray, index_names: list[str]) -> np.ndarray:
    """Device argsort result -> [N_q, N_idx] array of names."""
    return np.asarray(index_names, dtype=object)[np.asarray(sorted_indices)]


def fiq_ranking(sorted_index_names: np.ndarray,
                target_names: list[str]) -> RankingResult:
    """Fashion-IQ labels: name equality against the target (validate.py:61-64)."""
    targets = np.asarray(target_names, dtype=object)[:, None]
    labels = sorted_index_names == targets
    _assert_one_hot(labels, "fiq")
    return RankingResult(sorted_index_names, labels)


def cirr_ranking(sorted_index_names: np.ndarray, reference_names: list[str],
                 target_names: list[str],
                 group_members: list[list[str]]) -> RankingResult:
    """CIRR labels: drop the reference image from each row, then name-equality
    labels and group-subset labels (validate.py:207-222)."""
    refs = np.asarray(reference_names, dtype=object)[:, None]
    keep = sorted_index_names != refs
    n_q, n_idx = sorted_index_names.shape
    sorted_wo_ref = sorted_index_names[keep].reshape(n_q, n_idx - 1)

    targets = np.asarray(target_names, dtype=object)[:, None]
    labels = sorted_wo_ref == targets
    _assert_one_hot(labels, "cirr")

    members = np.asarray(group_members, dtype=object)
    group_mask = (sorted_wo_ref[..., None] == members[:, None, :]).sum(-1) > 0
    group_labels = labels[group_mask].reshape(n_q, -1)
    _assert_one_hot(group_labels, "cirr-subset")
    return RankingResult(sorted_wo_ref, labels, group_labels)


def _check_unique_index(index_names) -> None:
    if len(set(index_names)) != len(index_names):
        raise AssertionError("duplicate image names in the index — rankings "
                             "and labels would be ambiguous")


def remove_reference_column(names: np.ndarray,
                            ref_ranks: np.ndarray) -> np.ndarray:
    """Drop the reference from each row's [width] slice (or the last column
    when the reference ranks beyond the slice) — either way width-1
    survivors, equal to the full order-without-reference truncated at
    width-1 (validate.py:207-210 applied to a truncated ranking)."""
    n_q, width = names.shape
    drop = np.minimum(ref_ranks, width - 1)
    keep = np.arange(width)[None, :] != drop[:, None]
    return names[keep].reshape(n_q, width - 1)


def fiq_ranking_from_ranks(topk_idx: np.ndarray, index_names: list[str],
                           target_names: list[str],
                           target_ranks: np.ndarray) -> RankingResult:
    """Fashion-IQ RankingResult from the device-side truncated ranking
    (validate_engine.ranked_slices): topk_idx [N_q, width] is the stable
    argsort's first width columns; target_ranks the exact global ranks.
    Identical semantics to fiq_ranking at every consumed depth
    (width must exceed the deepest recall K unless the corpus is smaller)."""
    _check_unique_index(index_names)
    n_q, width = topk_idx.shape
    names = np.asarray(index_names, dtype=object)[topk_idx]
    labels = np.zeros((n_q, width), bool)
    rows = target_ranks < width
    labels[np.nonzero(rows)[0], target_ranks[rows]] = True
    # cross-check the rank computation against the top-k contents; also
    # catches a target name absent from the slice it should be in
    tgt = np.asarray(target_names, dtype=object)
    if not (names[rows, target_ranks[rows]] == tgt[rows]).all():
        raise AssertionError("device rank disagrees with top-k contents")
    if width >= len(index_names) and not rows.all():
        raise AssertionError("target missing from a full-width ranking")
    return RankingResult(names, labels)


def cirr_ranking_from_ranks(topk_idx: np.ndarray, index_names: list[str],
                            target_names: list[str],
                            group_members: list[list[str]],
                            target_ranks: np.ndarray, ref_ranks: np.ndarray,
                            member_ranks: np.ndarray) -> RankingResult:
    """CIRR RankingResult from the device-side truncated ranking — the
    reference-image removal (validate.py:207-210) applied arithmetically:
    post-removal rank r' = r - (rank(ref) < r). member_ranks: [N_q, 5]
    global ranks of the non-reference group members."""
    _check_unique_index(index_names)
    n_q, width = topk_idx.shape
    names = np.asarray(index_names, dtype=object)[topk_idx]

    names_wo_ref = remove_reference_column(names, ref_ranks)

    t_adj = target_ranks - (ref_ranks < target_ranks)
    labels = np.zeros((n_q, width - 1), bool)
    rows = t_adj < width - 1
    labels[np.nonzero(rows)[0], t_adj[rows]] = True
    tgt = np.asarray(target_names, dtype=object)
    if not (names_wo_ref[rows, t_adj[rows]] == tgt[rows]).all():
        raise AssertionError("device rank disagrees with top-k contents")
    if width >= len(index_names) and not rows.all():
        raise AssertionError("target missing from a full-width ranking")

    # subset: the 5 members ordered by global rank (ref removal preserves
    # relative order); one-hot of the target among them
    order = np.argsort(member_ranks, axis=1, kind="stable")
    members = np.asarray(group_members, dtype=object)
    if members.shape[1] != member_ranks.shape[1]:
        raise AssertionError("member_ranks must cover the non-ref members")
    group_sorted = np.take_along_axis(members, order, axis=1)
    group_labels = group_sorted == tgt[:, None]
    _assert_one_hot(group_labels, "cirr-subset")
    return RankingResult(names_wo_ref, labels, group_labels)


def reranked_labels(base_labels: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Stage-II: re-index stored top-K labels by the re-ranker's descending-score
    order (validate_stage2.py:174-179 np.take_along_axis semantics)."""
    return np.take_along_axis(base_labels, order, axis=-1)


def recall_at(labels: np.ndarray, k: int) -> float:
    """Percentage of rows whose positive lies in the first k columns."""
    return 100.0 * labels[:, :k].sum() / len(labels)


def _assert_one_hot(labels: np.ndarray, what: str) -> None:
    sums = labels.sum(axis=-1)
    if not (sums == 1).all():
        bad = int((sums != 1).sum())
        raise AssertionError(
            f"{what}: expected exactly one ground-truth per ranking row, "
            f"{bad} rows violate this")


def fiq_metrics(result: RankingResult) -> dict[str, float]:
    return {f"recall_at{k}": result.recall_at(k) for k in FIQ_RECALL_KS}


def cirr_metrics(result: RankingResult) -> dict[str, float]:
    out = {f"recall_at{k}": result.recall_at(k) for k in CIRR_RECALL_KS}
    for k in CIRR_SUBSET_KS:
        out[f"group_recall_at{k}"] = result.subset_recall_at(k)
    # headline selection metric (stage1_train.py:497-499)
    out["mean_r5_rs1"] = (out["recall_at5"] + out["group_recall_at1"]) / 2.0
    return out
