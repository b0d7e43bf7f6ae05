"""Top-k payload assembly, the stage-I -> stage-II artifact (an own copy of
the JAX package's ``retrieval/topk_writer.py``).

Field layout parity with reference validate.py:254-264 (CIRR) and :86-94 (FIQ).
"""
from __future__ import annotations

import numpy as np

from candidate_reranking_cir_tpu_torch.retrieval.metrics import RankingResult


def topk_payload(ranking: RankingResult, index_names: list[str],
                 target_names: list[str], split: str, *, k: int,
                 dress_types: list[str] | None = None) -> dict:
    payload = {
        "sorted_index_names": ranking.sorted_index_names[:, :k],
        "target_names": list(target_names),
        "index_names": list(index_names),
        "labels": np.asarray(ranking.labels[:, :k], bool),
        "split": split,
    }
    if ranking.group_labels is not None:
        payload["group_labels"] = np.asarray(ranking.group_labels, bool)
    if dress_types is not None:
        payload["dress_types"] = ",".join(dress_types)
    return payload


def test1_topk_payload(sorted_index_names: np.ndarray,
                       index_names: list[str], k: int) -> dict:
    """test1 variant (cirr_test_submission.py:121-128): no labels."""
    return {
        "sorted_index_names": sorted_index_names[:, :k],
        "index_names": list(index_names),
        "split": "test1",
    }
