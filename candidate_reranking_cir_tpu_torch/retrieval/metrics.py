"""Stage-II recall helpers (own copy of the parts of the JAX package's
``retrieval/metrics.py`` that the re-rank evaluation uses)."""
from __future__ import annotations

import numpy as np


def reranked_labels(base_labels: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Re-index stored top-K labels by the re-ranker's descending-score
    order (validate_stage2.py:174-179 np.take_along_axis semantics)."""
    return np.take_along_axis(base_labels, order, axis=-1)


def recall_at(labels: np.ndarray, k: int) -> float:
    """Percentage of rows whose positive lies in the first k columns."""
    return 100.0 * labels[:, :k].sum() / len(labels)
