"""The numbers that decide ``correct``: how far what the timed path
produced lies from the plain reference. Each is scale-free and the worst
over the sample; a limit for each is in the cell's workload file."""
from __future__ import annotations

import numpy as np


def rel_err(got, want) -> float:
    """The worst row's ||got - want|| / ||want|| (rows along axis 0)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    num = np.linalg.norm(got - want, axis=1)
    den = np.maximum(np.linalg.norm(want, axis=1), 1e-30)
    return float((num / den).max())


def value_err(got, want, spread: float) -> float:
    """The widest |got - want| over the reference's spread."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(spread, 1e-30))


def order_gap(order, ref_scores, spread: float) -> float:
    """How far a ranking strays from the reference's, in reference scores:
    the widest gap, over the positions of ``order`` (indices into
    ``ref_scores``, best first), between the reference's score at that
    position of its own ranking and its score of the item placed there,
    over the reference's spread. Near ties swapped read as their small
    gap; an item ranked far from its place reads large."""
    ref_scores = np.asarray(ref_scores, np.float64)
    order = np.asarray(order, np.int64)
    best = np.sort(ref_scores)[::-1][:len(order)]
    return float(np.abs(best - ref_scores[order]).max()
                 / max(spread, 1e-30))


def rank_gap(ranks, items, ref_scores, spread: float) -> float:
    """For entities ``items`` that the program put at positions ``ranks``
    (0 = best) of its full ranking: the widest gap between the reference's
    score at that position of its own ranking and its score of the entity,
    over the spread."""
    ref_scores = np.asarray(ref_scores, np.float64)
    best = np.sort(ref_scores)[::-1]
    ranks = np.asarray(ranks, np.int64)
    return float(np.abs(best[ranks] - ref_scores[np.asarray(items)]).max()
                 / max(spread, 1e-30))
