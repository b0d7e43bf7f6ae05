"""Stage-II re-rank scheduling (port of the JAX package's
``retrieval/rerank.py``: ``rerank`` and ``rerank_candidate_major``).

Candidate-major (``rerank_candidate_major``, the eval default): pairs
(query, candidate) are grouped by candidate, so each candidate's
cross-attention K/V run once and serve every query that ranks it. Queries
are grouped into text-length buckets; each bucket computes its z_t in
``zt_batch`` chunks (the tail chunk repeats row 0), then its pairs in
calls of A candidates x B queries, where each candidate's pair list is cut
greedily into the ``q_buckets`` sizes. Skipped queries' top-K pairs are
never scheduled and keep ``SKIP_LOGIT``; their CIRR groups are scored.

Query-major (``rerank``, serving and ``schedule='query_major'``): fixed
[q_batch, K(+5)] pair grids, one per chunk of queries, each pair with its
own K/V (``RerankerModel.score_per_query``), or with ``dedup`` the K/V of
the chunk's unique candidates gathered per pair (``score_indexed``).

Prefix-scored (``rerank_prefixed``, the query-major schedule of a
re-ranker whose class sets ``prefix_scorer``, Kimi-VL's): no z_t and no stage-I
model; each chunk of ``q_batch`` queries is one prefix pass over their
reference images and captions (the layer span 'prefix') and one suffix pass
over their K(+5) candidates, which attend to the prefixes' kept latents
(the layer span 'score').

All gather bank rows through ``ops/quant.take_rows``, so the bank may be
an ``Int8Bank``.

Over a mesh (``parallel/mesh.py``), as in the JAX package:
- ``rerank``: each chunk's queries are split over ``fit_mesh(mesh,
  q_batch)`` (the dedup's unique candidates whole on every rank); the
  ranks' scores are gathered once at the end;
- ``rerank_candidate_major`` over a whole bank: each rank fuses its block
  of every z_t chunk (``zt_batch`` rounded up to a multiple of the mesh
  size) and the z_t are gathered; each call's A candidates (rounded up to
  a multiple of the mesh size) are split over the ranks;
- ``rerank_candidate_major(index_sharded=True)`` over the block-sharded
  bank of ``build_index(shard_index=True)``: every rank fuses every z_t,
  fetching reference rows with a masked take from its block and an
  all-reduce sum (JAX's ``zt_body``), and scores the candidates whose
  rows it owns; calls are laid out as the ranks' owner blocks.
Every rank returns the global ``RerankOutput``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.ops.quant import (
    Int8Bank,
    bank_len,
    take_rows,
)
from candidate_reranking_cir_tpu_torch.parallel import mesh as pmesh
from candidate_reranking_cir_tpu_torch.runtime import tracing
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
    # candidate-major: wall seconds per stage ('zt', 'score'), each ending
    # in a device sync, and its phase spans' totals (``runtime/tracing``)
    seconds: dict = field(default_factory=dict)


def bind_module(module, params, device: torch.device):
    """Load ``params`` (a port state dict, or None to keep the module's own
    weights) into ``module``, move it to ``device`` and set eval mode; no
    module (a prefix scorer's absent stage I) stays None."""
    if module is None:
        return None
    if params is not None:
        module.load_state_dict(params, strict=True)
    return module.to(device).eval()


def make_rerank_fns(stage1, reranker):
    """(z_t producer, [Qb, K] scorer, indexed scorer) over the port's
    models, as the JAX function's triple of jitted programs (whose cache
    exists for XLA's compiles; PyTorch runs eagerly, so nothing is
    cached). The models must already be on their device."""

    def produce_zt(ref_feats, ids, mask):
        return stage1.fuse(ref_feats, ids, mask, return_raw=True)

    def score(z_t, ids, mask, cand_feats):
        return reranker.score_per_query(z_t, ids, mask, cand_feats)

    def score_indexed(z_t, ids, mask, unique_cand, pair_map):
        return reranker.score_indexed(z_t, ids, mask, unique_cand, pair_map)

    return produce_zt, score, score_indexed


def cluster_queries(cand_idx: np.ndarray, q_batch: int) -> np.ndarray:
    """Order queries so chunks of q_batch share candidates (the dedup
    scorer's win): a stable sort by the top-1 candidate, since queries
    whose best candidate is the same share much of their top-K tail."""
    return np.argsort(cand_idx[:, 0], kind="stable")


@torch.inference_mode()
def rerank(stage1, s1_params, reranker, s2_params, tokenizer, *,
           captions: list[str], reference_names: list[str],
           topk_names: np.ndarray, index_feats, index_names: list[str],
           text_len: int, q_batch: int = 8,
           skip_mask: np.ndarray | None = None,
           group_members: list[list[str]] | None = None,
           dedup: bool = False, dedup_cap: float = 0.625,
           mesh=None, device=None, trace_as: str = "rerank") -> RerankOutput:
    """Score every query's K candidates (and CIRR 5-member groups) in
    query-major [q_batch, K(+5)] chunks.

    stage1 / reranker: the port's models; s1_params / s2_params: port
    state dicts to load into them, or None. index_feats: [N_idx, M, W]
    stage-II bank, or an ``Int8Bank``. topk_names: [N, K] candidate names.
    skip_mask: [N] bool, True rows get SKIP_LOGIT (computed, then
    overwritten, as in JAX). The tail chunk is padded with repeats of its
    first query. CIRR group members ride in the same call as the top-K
    candidates.

    dedup=True: queries run in ``cluster_queries`` order, and a chunk whose
    unique candidates fit the ``dedup_cap`` bucket (a multiple of 64) is
    scored by ``score_indexed``; a chunk that does not compress falls back
    to the per-pair scorer. Output order is the input's.

    mesh: each chunk's q_batch queries are split over ``fit_mesh(mesh,
    q_batch)``, on the mesh's device. Same outputs as the JAX function.

    trace_as: the prefix of its phase spans (``runtime/tracing``):
    ``<trace_as>.plan`` (host work before each chunk's launches),
    ``.wait`` (the scores' readback) and ``.finish`` (scatter and sort)."""
    mesh = pmesh.fit_mesh(mesh, q_batch)
    if mesh is not None and not mesh.member:
        return pmesh.share(mesh)
    plan = f"{trace_as}.plan"
    with tracing.trace_phase(plan):
        device = resolve_device(device) if mesh is None else mesh.device
        stage1 = bind_module(stage1, s1_params, device)
        reranker = bind_module(reranker, s2_params, device)
        produce_zt, score, score_indexed = make_rerank_fns(stage1, reranker)
        feats = index_feats.to(device)

        n = len(captions)
        k = topk_names.shape[1]
        pos = {name: i for i, name in enumerate(index_names)}
        ref_idx = np.asarray([pos[r] for r in reference_names], np.int64)
        cand_idx = np.asarray(
            [[pos[nm] for nm in row] for row in topk_names], np.int64)
        ids_all, mask_all = tokenizer.encode(captions, text_len,
                                             set_enc_token=True)

        do_groups = group_members is not None
        if do_groups:
            members_no_ref = [[m for m in g if m != r][:5]
                              for g, r in zip(group_members, reference_names)]
            grp_idx = np.asarray([[pos[m] for m in row]
                                  for row in members_no_ref], np.int64)
            cand_idx_all = np.concatenate([cand_idx, grp_idx], axis=1)
        else:
            cand_idx_all = cand_idx

        logits = np.empty((n, k), np.float32)
        grp_logits = np.empty((n, 5), np.float32) if do_groups else None
        order = (cluster_queries(cand_idx, q_batch) if dedup and n > q_batch
                 else np.arange(n))
        width = cand_idx_all.shape[1]
        u_cap = max(int(q_batch * width * dedup_cap) // 64 * 64, 64)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    chunks = []  # (rows, count, device scores of this rank's rows)
    for start in range(0, n, q_batch):
        with tracing.trace_phase(plan):
            rows = order[start:start + q_batch]
            count = len(rows)
            if count < q_batch:  # pad the tail chunk with repeats
                rows = np.concatenate(
                    [rows, np.repeat(rows[:1], q_batch - count)])
            chunk_cand = cand_idx_all[rows]
            uniq, inv = np.unique(chunk_cand, return_inverse=True)
            pair_map = inv.reshape(chunk_cand.shape)
            mine = rows  # this rank's queries of the chunk
            if mesh is not None:
                block = pmesh.shard_rows(mesh, q_batch)
                mine, chunk_cand, pair_map = (a[block] for a in (
                    rows, chunk_cand, pair_map))
        ids, msk = to_dev(ids_all[mine]), to_dev(mask_all[mine])
        z_t = produce_zt(take_rows(feats, to_dev(ref_idx[mine])), ids, msk)
        if dedup and len(uniq) <= u_cap:
            pad_uniq = np.pad(uniq, (0, u_cap - len(uniq)))
            out = score_indexed(z_t, ids, msk,
                                take_rows(feats, to_dev(pad_uniq)),
                                to_dev(pair_map))
        else:
            out = score(z_t, ids, msk, take_rows(feats, to_dev(chunk_cand)))
        chunks.append((rows, count, out.float()))

    if chunks:
        scores = torch.stack([c[2] for c in chunks])   # [chunks, rows, K']
        if mesh is not None:
            scores = pmesh.all_gather(mesh, scores, dim=1)
        with tracing.trace_phase(f"{trace_as}.wait"):
            scores = scores.cpu().numpy()
    with tracing.trace_phase(f"{trace_as}.finish"):
        for (rows, count, _), out in zip(chunks, scores if chunks else []):
            logits[rows[:count]] = out[:count, :k]
            if do_groups:
                grp_logits[rows[:count]] = out[:count, k:]

        rank_order, group_order = _finish(logits, grp_logits, skip_mask)
    return pmesh.share(mesh, RerankOutput(logits, grp_logits, rank_order,
                                          group_order))


def _finish(logits, grp_logits, skip_mask) -> tuple:
    """The SKIP_LOGIT rows set, then both descending orders (stable on the
    negated scores, for deterministic ties)."""
    if skip_mask is not None:
        logits[np.asarray(skip_mask, bool)] = SKIP_LOGIT
    order = np.argsort(-logits, axis=-1, kind="stable")
    group_order = (np.argsort(-grp_logits, axis=-1, kind="stable")
                   if grp_logits is not None else None)
    return order, group_order


@torch.inference_mode()
def rerank_prefixed(reranker, s2_params, tokenizer, *, captions: list[str],
                    reference_names: list[str], topk_names: np.ndarray,
                    index_feats, index_names: list[str], text_len: int,
                    q_batch: int = 4,
                    skip_mask: np.ndarray | None = None,
                    group_members: list[list[str]] | None = None,
                    device=None, trace_as: str = "rerank") -> RerankOutput:
    """``rerank``'s outputs from a prefix scorer (``reranker.prefix``,
    ``reranker.score``): chunks of ``q_batch`` queries (the tail padded with
    repeats of its first), each a prefix pass over the queries' reference
    rows of the bank and captions (layer span 'prefix'), then a suffix pass
    over their K top-K candidates and 5 group members (layer span 'score');
    captions of at most ``text_len`` tokens as the tokenizer counts them;
    each span ends in a device sync (phase ``<trace_as>.wait``), so that
    it times its work. Skipped queries are scored, then set to SKIP_LOGIT,
    as in ``rerank``."""
    plan = f"{trace_as}.plan"
    with tracing.trace_phase(plan):
        device = resolve_device(device)
        reranker = bind_module(reranker, s2_params, device)
        feats = index_feats.to(device)
        n, k = len(captions), topk_names.shape[1]
        pos = {name: i for i, name in enumerate(index_names)}
        ref_idx = np.asarray([pos[r] for r in reference_names], np.int64)
        cand_idx = np.asarray([[pos[nm] for nm in row] for row in topk_names],
                              np.int64)
        do_groups = group_members is not None
        if do_groups:
            grp_idx = np.asarray(
                [[pos[m] for m in g if m != r][:5]
                 for g, r in zip(group_members, reference_names)], np.int64)
            cand_idx = np.concatenate([cand_idx, grp_idx], axis=1)
        caption_ids = reranker.caption_ids(tokenizer, captions, text_len)
        width = cand_idx.shape[1]

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    chunks = []  # (rows, count, device scores [q_batch, width])
    for start in range(0, n, q_batch):
        with tracing.trace_phase(plan):
            rows = np.arange(start, min(start + q_batch, n))
            count = len(rows)
            rows = np.concatenate([rows, np.repeat(rows[:1],
                                                   q_batch - count)])
        with tracing.layer_span("prefix"):
            cache = reranker.prefix(take_rows(feats, to_dev(ref_idx[rows])),
                                    [caption_ids[r] for r in rows])
            with tracing.trace_phase(f"{trace_as}.wait"):
                sync_device(device)
        with tracing.layer_span("score"):
            cands = take_rows(feats, to_dev(cand_idx[rows].ravel()))
            out = reranker.score(cache, cands.unflatten(0, (q_batch, width)))
            del cache, cands
            with tracing.trace_phase(f"{trace_as}.wait"):
                sync_device(device)
        chunks.append((rows, count, out))

    logits = np.empty((n, k), np.float32)
    grp_logits = np.empty((n, width - k), np.float32) if do_groups else None
    with tracing.trace_phase(f"{trace_as}.wait"):
        scores = torch.stack([c[2] for c in chunks]).cpu().numpy() \
            if chunks else []
    with tracing.trace_phase(f"{trace_as}.finish"):
        for (rows, count, _), out in zip(chunks, scores):
            logits[rows[:count]] = out[:count, :k]
            if do_groups:
                grp_logits[rows[:count]] = out[:count, k:]
        order, group_order = _finish(logits, grp_logits, skip_mask)
    return RerankOutput(logits, grp_logits, order, group_order)


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


def _fetch_rows(mesh, block, rows, shard_size: int):
    """Rows ``rows`` (global indices) of a bank split over ``mesh`` in
    blocks of ``shard_size``: each rank takes the rows it owns from its
    ``block`` (zeros elsewhere) and an all-reduce sums them (JAX's
    ``zt_body``)."""
    local = rows - mesh.rank * shard_size
    ok = (local >= 0) & (local < shard_size)
    got = take_rows(block, local.clamp(0, shard_size - 1))
    got = torch.where(ok[:, None, None], got, torch.zeros_like(got))
    return pmesh.all_reduce(mesh, got)


def _pack_calls(chunks: list, a: int, b: int, n_dev: int,
                shard_size: int) -> tuple:
    """Lay ``chunks`` [(candidate, entries)] out as calls of ``a``
    candidates x ``b`` query slots: (rows, valid, qrow, kind, col [n_calls,
    a, b], cands [n_calls, a]). With ``shard_size`` (a block-sharded
    bank) the a axis is ``n_dev`` blocks of a // n_dev, block d holding
    candidates that rank d owns, by their local index."""
    if shard_size:
        a_dev = a // n_dev
        by_owner: list[list] = [[] for _ in range(n_dev)]
        for cid, entries in chunks:
            by_owner[cid // shard_size].append((cid, entries))
        n_calls = max((len(lst) + a_dev - 1) // a_dev for lst in by_owner)
        placed = []
        for d, lst in enumerate(by_owner):
            lst = lst + [(d * shard_size, [])] * (n_calls * a_dev - len(lst))
            for idx, item in enumerate(lst):
                ci, ai = divmod(idx, a_dev)
                placed.append((ci, d * a_dev + ai, item))
    else:
        n_calls = (len(chunks) + a - 1) // a
        chunks = chunks + [(chunks[0][0], [])] * (n_calls * a - len(chunks))
        placed = [(*divmod(idx, a), item) for idx, item in enumerate(chunks)]
    rows = np.zeros((n_calls, a, b), np.int64)
    valid = np.zeros((n_calls, a, b), bool)
    qrow = np.zeros((n_calls, a, b), np.int64)
    kind = np.zeros((n_calls, a, b), np.int64)
    col = np.zeros((n_calls, a, b), np.int64)
    cands = np.zeros((n_calls, a), np.int64)
    for ci, ai, (cid, entries) in placed:
        cands[ci, ai] = cid % shard_size if shard_size else cid
        for bi, (li, qi, kd, cl) in enumerate(entries):
            rows[ci, ai, bi] = li
            valid[ci, ai, bi] = True
            qrow[ci, ai, bi], kind[ci, ai, bi], col[ci, ai, bi] = qi, kd, cl
    return rows, valid, qrow, kind, col, cands


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
                           mesh=None, index_sharded: bool = False,
                           device=None) -> RerankOutput:
    """Score every query's top-K candidates (and CIRR 5-member groups).

    stage1 / reranker: the port's ``RetrievalModel`` / ``RerankerModel``;
    s1_params / s2_params: port state dicts to load into them, or None.
    index_feats: [N_idx, M, W] bank (``retrieval.index.build_index``), or
    an ``Int8Bank``. Same outputs as the JAX function of the same name.

    mesh: the z_t chunks and each call's candidates are split over the
    ranks (the module's docstring), on the mesh's device; ``zt_batch`` is
    rounded up to a multiple of the mesh size, as in JAX.
    index_sharded (needs a mesh; not with an ``Int8Bank``):
    ``index_feats`` is this rank's block of the bank that
    ``build_index(shard_index=True)`` made.

    ``seconds`` of the output: the layer spans 'zt' and 'score' (each
    bucket's, ending in a device sync) and the phase spans' totals
    (``runtime/tracing``): 'rerank.prep' (tokenize, index lookups),
    'rerank.zt.wait', 'rerank.plan' (pair lists, chunking, packing and
    the packed arrays' uploads), 'rerank.score.wait' and 'rerank.finish'
    (readback, scatter, sort)."""
    if index_sharded and mesh is None:
        raise ValueError("index_sharded=True requires a mesh")
    if index_sharded and isinstance(index_feats, Int8Bank):
        raise ValueError("int8 banks are not supported with index_sharded "
                         "(quantize halves the bank instead of sharding it)")
    seconds = {"zt": 0.0, "score": 0.0}
    with tracing.collect(seconds):
        with tracing.trace_phase("rerank.prep"):
            n_dev = 1 if mesh is None else mesh.size
            if mesh is not None and zt_batch % n_dev != 0:
                zt_batch = ((zt_batch + n_dev - 1) // n_dev) * n_dev
            device = resolve_device(device) if mesh is None else mesh.device
            stage1 = bind_module(stage1, s1_params, device)
            reranker = bind_module(reranker, s2_params, device)
            feats = index_feats.to(device)
            shard_size = bank_len(feats) if index_sharded else 0

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
                                  for g, r in zip(group_members,
                                                  reference_names)]
                grp_idx = np.asarray([[pos[m] for m in row]
                                      for row in members_no_ref], np.int64)

            logits = np.full((n, k), SKIP_LOGIT, np.float32)
            grp_logits = np.zeros((n, 5), np.float32) if do_groups else None
            # (device scores, valid, qrow, kind, col) of every packed bucket
            pending: list[tuple] = []

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
            with tracing.layer_span("zt"):
                ids_dev = to_dev(ids_all[qsel][:, :lb])
                mask_dev = to_dev(mask_all[qsel][:, :lb])
                ref_dev = to_dev(ref_idx[qsel])

                # z_t for every bucket query, zt_batch rows at a time: on a
                # whole bank each rank fuses its block of a chunk; on a
                # sharded one every rank fuses every row, its references
                # fetched across the ranks
                zs = []
                for start in range(0, n_lb, zt_batch):
                    # tail padding repeats row 0
                    rows = np.zeros(zt_batch, np.int64)
                    real = np.arange(start, min(start + zt_batch, n_lb))
                    rows[:len(real)] = real
                    if mesh is not None and not index_sharded:
                        rows = rows[pmesh.shard_rows(mesh, zt_batch)]
                    r = to_dev(rows)
                    refs = _fetch_rows(mesh, feats, ref_dev[r], shard_size) \
                        if index_sharded else take_rows(feats, ref_dev[r])
                    zs.append(stage1.fuse(refs, ids_dev[r], mask_dev[r],
                                          return_raw=True))
                zt_all = torch.cat(zs)
                if mesh is not None and not index_sharded:
                    # [ranks x (chunks x block)] -> chunk by chunk, ranks in
                    # order
                    zt_all = pmesh.all_gather(mesh, zt_all[None]).unflatten(
                        1, (len(zs), -1)).transpose(0, 1).flatten(0, 2)
                zt_all = zt_all[:n_lb]
                with tracing.trace_phase("rerank.zt.wait"):
                    sync_device(device)

            with tracing.layer_span("score"):
                with tracing.trace_phase("rerank.plan"):
                    # pair lists per candidate; entry (local_row, query,
                    # kind, col), kind 0 = top-K slot, kind 1 = group slot
                    per_cand: dict[int, list[tuple[int, int, int, int]]] = {}
                    for li, qi in enumerate(qsel):
                        qi = int(qi)
                        if not skip[qi]:
                            for j in range(k):
                                per_cand.setdefault(
                                    int(cand_idx[qi, j]), []).append(
                                    (li, qi, 0, j))
                        if do_groups:
                            for j in range(grp_idx.shape[1]):
                                per_cand.setdefault(
                                    int(grp_idx[qi, j]), []).append(
                                    (li, qi, 1, j))
                    chunks_by_b = _chunk_by_candidate(per_cand, buckets)

                # constant work per call: narrower text buckets take more
                # pairs
                ppc = max(64, pairs_per_call * text_len // lb)
                for b in buckets:
                    chunks = chunks_by_b[b]
                    if not chunks:
                        continue
                    with tracing.trace_phase("rerank.plan"):
                        if index_sharded:
                            a = max(1, ppc // b // n_dev) * n_dev
                        else:  # a candidate axis the mesh divides
                            a = (max(1, ppc // b) + n_dev - 1) // n_dev \
                                * n_dev
                        rows, valid, qrow, kind, col, cands = _pack_calls(
                            chunks, a, b, n_dev, shard_size)
                        mine = slice(None) if mesh is None \
                            else pmesh.shard_rows(mesh, a)
                        rows_dev = to_dev(rows[:, mine])
                        cands_dev = to_dev(cands[:, mine])
                    a_loc = rows_dev.shape[1]
                    scores = []
                    for ci in range(len(rows)):
                        flat = rows_dev[ci].reshape(-1)
                        # widths from the tensors: a bucket wider than
                        # text_len holds text_len columns (as JAX's
                        # reshape(a, b, -1))
                        scores.append(reranker.score_grid(
                            zt_all[flat].reshape(a_loc, b,
                                                 *zt_all.shape[1:]),
                            ids_dev[flat].reshape(a_loc, b, -1),
                            mask_dev[flat].reshape(a_loc, b, -1),
                            take_rows(feats, cands_dev[ci])))
                    pending.append((torch.stack(scores), valid, qrow, kind,
                                    col))
                with tracing.trace_phase("rerank.score.wait"):
                    sync_device(device)

        with tracing.trace_phase("rerank.finish"):
            for scores_dev, valid, qrow, kind, col in pending:
                if mesh is not None:
                    scores_dev = pmesh.all_gather(mesh, scores_dev, dim=1)
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
