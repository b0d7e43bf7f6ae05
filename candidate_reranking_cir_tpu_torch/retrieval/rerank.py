"""Stage-II candidate-major re-rank scheduling on one device (port of the
JAX package's ``retrieval/rerank.py::rerank_candidate_major``).

Pairs (query, candidate) are grouped by candidate, so each candidate's
cross-attention K/V run once and serve every query that ranks it. Queries
are grouped into text-length buckets; each bucket computes its z_t in
``zt_batch`` chunks (the tail chunk repeats row 0), then its pairs in
calls of A candidates x B queries, where each candidate's pair list is cut
greedily into the ``q_buckets`` sizes. Skipped queries' top-K pairs are
never scheduled and keep ``SKIP_LOGIT``; their CIRR groups are scored.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.runtime.device import (
    resolve_device,
    sync_device,
)

SKIP_LOGIT = -99999.99  # validate_stage2.py:257


@dataclass
class RerankOutput:
    logits: np.ndarray                 # [N, K]
    group_logits: np.ndarray | None    # [N, 5] (CIRR) or None
    order: np.ndarray                  # [N, K] descending-score argsort
    group_order: np.ndarray | None
    # wall seconds per stage ('zt', 'score'), each ending in a device sync
    seconds: dict = field(default_factory=dict)


def bind_module(module, params, device: torch.device):
    """Load ``params`` (a port state dict, or None to keep the module's own
    weights) into ``module``, move it to ``device`` and set eval mode."""
    if params is not None:
        module.load_state_dict(params, strict=True)
    return module.to(device).eval()


def resolve_l_buckets(l_buckets, lengths: np.ndarray,
                      text_len: int) -> list[int]:
    """Static text-length buckets, smallest-sufficient assignment. 'auto'
    cuts at the 50th/90th length percentiles (rounded up to multiples of
    8); None keeps the single text_len bucket."""
    max_len = int(lengths.max()) if len(lengths) else text_len
    if l_buckets is None:
        return [text_len]
    if l_buckets == "auto":
        cand = {min(-(-int(np.percentile(lengths, p)) // 8) * 8, text_len)
                for p in (50, 90)}
        cand.add(min(-(-max_len // 8) * 8, text_len))
    else:
        cand = {int(b) for b in l_buckets if int(b) <= text_len}
    cand = {max(b, 8) for b in cand}
    if not cand or max(cand) < max_len:  # always one bucket fits every query
        cand.add(min(-(-max_len // 8) * 8, text_len))
    return sorted(cand)


def _chunk_by_candidate(per_cand: dict, buckets: list[int]) -> dict:
    """Greedy largest-bucket-first cut of each candidate's pair list, so the
    padding per candidate is bounded by the smallest bucket."""
    chunks_by_b: dict[int, list] = {b: [] for b in buckets}
    for cid, entries in per_cand.items():
        s, remaining = 0, len(entries)
        for b in reversed(buckets):
            while remaining >= b:
                chunks_by_b[b].append((cid, entries[s:s + b]))
                s += b
                remaining -= b
        if remaining:
            b = next(bb for bb in buckets if bb >= remaining)
            chunks_by_b[b].append((cid, entries[s:]))
    return chunks_by_b


@torch.inference_mode()
def rerank_candidate_major(stage1, s1_params, reranker, s2_params, tokenizer,
                           *, captions: list[str], reference_names: list[str],
                           topk_names: np.ndarray, index_feats,
                           index_names: list[str], text_len: int,
                           skip_mask: np.ndarray | None = None,
                           group_members: list[list[str]] | None = None,
                           pairs_per_call: int = 256,
                           q_buckets: tuple[int, ...] = (4, 8, 16, 32, 64,
                                                         128),
                           l_buckets="auto", zt_batch: int = 32,
                           device=None) -> RerankOutput:
    """Score every query's top-K candidates (and CIRR 5-member groups).

    stage1 / reranker: the port's ``RetrievalModel`` / ``RerankerModel``;
    s1_params / s2_params: port state dicts to load into them, or None.
    index_feats: [N_idx, M, W] bank (``retrieval.index.build_index``).
    Same outputs as the JAX function of the same name."""
    device = resolve_device(device)
    stage1 = bind_module(stage1, s1_params, device)
    reranker = bind_module(reranker, s2_params, device)
    feats = index_feats.to(device)

    n = len(captions)
    k = topk_names.shape[1]
    pos = {name: i for i, name in enumerate(index_names)}
    ref_idx = np.asarray([pos[r] for r in reference_names], np.int64)
    cand_idx = np.asarray(
        [[pos[nm] for nm in row] for row in topk_names], np.int64)
    ids_all, mask_all = tokenizer.encode(captions, text_len,
                                         set_enc_token=True)
    skip = (np.zeros(n, bool) if skip_mask is None
            else np.asarray(skip_mask, bool))
    do_groups = group_members is not None
    if do_groups:
        members_no_ref = [[m for m in g if m != r][:5]
                          for g, r in zip(group_members, reference_names)]
        grp_idx = np.asarray([[pos[m] for m in row] for row in members_no_ref],
                             np.int64)

    logits = np.full((n, k), SKIP_LOGIT, np.float32)
    grp_logits = np.zeros((n, 5), np.float32) if do_groups else None
    seconds = {"zt": 0.0, "score": 0.0}
    pending: list[tuple] = []  # (device scores, valid, qrow, kind, col)

    lengths = mask_all.sum(axis=1).astype(np.int32)
    lbs = resolve_l_buckets(l_buckets, lengths, text_len)
    assign = np.searchsorted(np.asarray(lbs), lengths)
    buckets = sorted(q_buckets)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for lbi, lb in enumerate(lbs):
        qsel = np.nonzero(assign == lbi)[0]
        n_lb = len(qsel)
        if n_lb == 0:
            continue
        t0 = time.perf_counter()
        ids_dev = to_dev(ids_all[qsel][:, :lb])
        mask_dev = to_dev(mask_all[qsel][:, :lb])
        ref_dev = to_dev(ref_idx[qsel])

        # z_t for every bucket query, zt_batch rows at a time
        zs = []
        for start in range(0, n_lb, zt_batch):
            rows = np.zeros(zt_batch, np.int64)  # tail padding repeats row 0
            real = np.arange(start, min(start + zt_batch, n_lb))
            rows[:len(real)] = real
            r = to_dev(rows)
            zs.append(stage1.fuse(feats[ref_dev[r]], ids_dev[r], mask_dev[r],
                                  return_raw=True))
        zt_all = torch.cat(zs)[:n_lb]
        sync_device(device)
        t1 = time.perf_counter()
        seconds["zt"] += t1 - t0

        # pair lists per candidate; entry (local_row, query, kind, col),
        # kind 0 = top-K slot, kind 1 = group slot
        per_cand: dict[int, list[tuple[int, int, int, int]]] = {}
        for li, qi in enumerate(qsel):
            qi = int(qi)
            if not skip[qi]:
                for j in range(k):
                    per_cand.setdefault(int(cand_idx[qi, j]), []).append(
                        (li, qi, 0, j))
            if do_groups:
                for j in range(grp_idx.shape[1]):
                    per_cand.setdefault(int(grp_idx[qi, j]), []).append(
                        (li, qi, 1, j))
        chunks_by_b = _chunk_by_candidate(per_cand, buckets)

        # constant work per call: narrower text buckets take more pairs
        ppc = max(64, pairs_per_call * text_len // lb)
        for b in buckets:
            chunks = chunks_by_b[b]
            if not chunks:
                continue
            a = max(1, ppc // b)
            n_calls = (len(chunks) + a - 1) // a
            chunks = chunks + [(chunks[0][0], [])] * (n_calls * a
                                                      - len(chunks))
            rows = np.zeros((n_calls, a, b), np.int64)
            valid = np.zeros((n_calls, a, b), bool)
            qrow = np.zeros((n_calls, a, b), np.int64)
            kind = np.zeros((n_calls, a, b), np.int64)
            col = np.zeros((n_calls, a, b), np.int64)
            cands = np.zeros((n_calls, a), np.int64)
            for idx, (cid, entries) in enumerate(chunks):
                ci, ai = divmod(idx, a)
                cands[ci, ai] = cid
                for bi, (li, qi, kd, cl) in enumerate(entries):
                    rows[ci, ai, bi] = li
                    valid[ci, ai, bi] = True
                    qrow[ci, ai, bi], kind[ci, ai, bi], col[ci, ai, bi] = \
                        qi, kd, cl
            rows_dev, cands_dev = to_dev(rows), to_dev(cands)
            scores = []
            for ci in range(n_calls):
                flat = rows_dev[ci].reshape(-1)
                scores.append(reranker.score_grid(
                    zt_all[flat].reshape(a, b, lb, -1),
                    ids_dev[flat].reshape(a, b, lb),
                    mask_dev[flat].reshape(a, b, lb),
                    feats[cands_dev[ci]]))
            pending.append((torch.stack(scores), valid, qrow, kind, col))
        sync_device(device)
        seconds["score"] += time.perf_counter() - t1

    for scores_dev, valid, qrow, kind, col in pending:
        scores = scores_dev.float().cpu().numpy()
        tk = valid & (kind == 0)
        logits[qrow[tk], col[tk]] = scores[tk]
        if do_groups:
            gp = valid & (kind == 1)
            grp_logits[qrow[gp], col[gp]] = scores[gp]

    rank_order = np.argsort(-logits, axis=-1, kind="stable")
    group_order = (np.argsort(-grp_logits, axis=-1, kind="stable")
                   if do_groups else None)
    return RerankOutput(logits, grp_logits, rank_order, group_order, seconds)


def cirr_group_labels(members_no_ref: list[list[str]], group_order: np.ndarray,
                      target_names: list[str]) -> np.ndarray:
    """Re-sorted 5-member group -> boolean labels by target-name equality
    (validate_stage2.py:186-193)."""
    members = np.asarray(members_no_ref, dtype=object)
    sorted_names = np.take_along_axis(members, group_order, axis=1)
    targets = np.asarray(target_names, dtype=object)[:, None]
    return sorted_names == targets
