"""Stage-I validation and top-k extraction (port of the JAX
package's ``retrieval/validate_engine.py``).

Mirrors the reference validate.py flows (cirr_val_retrieval :319-339,
fashioniq_val_retrieval :152-173):

1. embed the 'classic' corpus -> raw [N, M, D] bank + pooled-normalized
   [N, E] (``retrieval/index.py``),
2. per fusion batch: gather the reference features from the bank (no
   recompute, reference validate.py:142-143) and fuse them with the
   captions; queries that share a reference image fuse image-major
   (``RetrievalModel.fuse(query_group=)``),
3. rank the whole corpus by cosine distance, exactly and stably, keeping
   only the top ``width`` indices and each entity column's exact rank,
4. labels, recalls, and optionally the top-k artifact stage II reads.

Two executors compute the same function. The multi-launch one (the
default) streams the corpus batch by batch through ``build_index`` and
runs one launch sequence a fusion batch (``predict_queries``). The
single-program one (``single_program=True``, ``run_single_program_eval``)
puts the whole corpus and the fusion plan on the device first and runs
steps 1-3 as one program (``make_single_program_eval``): on the card one
CUDA graph, captured once for a model, a plan's shapes and its weights'
addresses, and replayed; on the CPU the same program eagerly. Every chunk,
batch and product has the multi-launch path's shape, so the two agree bit
for bit.

BLIP-2 (``models/blip2_retrieval.Blip2RetrievalModel``) runs the
multi-launch executor on one device: the index holds its image tokens,
a layer span 'targets' runs the Q-Former's query pass over them (32
vectors an image), fusion is image-major as for BLIP, and the ranking
scores each image by its best vector (``ops/topk.cosine_scores``).

Over a mesh (``parallel/mesh.py``) the multi-launch executor shards its
work as the JAX package's does: each rank embeds its rows of every corpus
batch, fuses its rows of every fusion batch (a Q-bucket runs image-major
only where the mesh divides its image count; ``schedule_fusion_batches``),
and ranks its block of the queries against the whole pooled index; the
predictions and rankings are all-gathered, so every rank returns the
global result. The single-program executor is single-device, as in JAX.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.data.captions import compose_fiq_eval
from candidate_reranking_cir_tpu_torch.models.layers import kept_casts
from candidate_reranking_cir_tpu_torch.ops import registry
from candidate_reranking_cir_tpu_torch.ops.topk import cosine_rank, \
    cosine_scores
from candidate_reranking_cir_tpu_torch.parallel import mesh as pmesh
from candidate_reranking_cir_tpu_torch.retrieval import metrics as M
from candidate_reranking_cir_tpu_torch.retrieval.index import (
    build_index,
    iter_batches,
)
from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
    bind_module,
    resolve_l_buckets,
)
from candidate_reranking_cir_tpu_torch.retrieval.topk_writer import (
    topk_payload,
)
from candidate_reranking_cir_tpu_torch.runtime import tracing
from candidate_reranking_cir_tpu_torch.runtime.device import (
    resolve_device,
    sync_device,
)


@dataclass
class Stage1EvalResult:
    metrics: dict
    ranking: M.RankingResult
    index_names: list[str]
    target_names: list[str]
    # wall seconds of the layer spans, each stage ending in a device sync:
    # 'index', 'fusion', 'ranking', 'total' (multi-launch); 'load' (the
    # dataset's batches on the host), 'copy' (host to device), 'plan'
    # (tokenize, schedule, upload), 'program', 'total' (single-program);
    # and the phase spans' totals (``runtime/tracing``)
    seconds: dict = field(default_factory=dict)
    # the device ranking the metrics were read from: the top-width corpus
    # indices [N_q, width] and the entity columns' exact ranks [N_q, E]
    topk: np.ndarray | None = None
    ranks: np.ndarray | None = None


def _check_single_program(mesh, single_program: bool) -> None:
    if single_program and mesh is not None:
        raise ValueError("single_program eval is single-device (no mesh), "
                         "as in the JAX package")


def make_stage1_fns(model, params=None, device=None):
    """(embed, fuse) closures over the port's ``RetrievalModel`` (or
    ``Blip2RetrievalModel``) on ``device`` (default 'cuda'), with
    ``params`` (a port state dict, or None to keep the model's weights)
    loaded: embed(images [B, H, W, 3]) -> (raw [B, M, D], pooled [B, E]),
    or raw alone for a ``multi_vector`` model; fuse(ref_feats [G, M, D],
    ids [G*Q, L], mask [G*Q, L], query_group=1) -> normalized predictions
    [G*Q, E]."""
    model = bind_module(model, params, resolve_device(device))
    pooled = not model.multi_vector

    @torch.inference_mode()
    def embed(images):
        return model.embed_images(images, pool_and_normalize=pooled)

    @torch.inference_mode()
    def fuse(ref_feats, ids, mask, query_group=1):
        return model.fuse(ref_feats, ids, mask, query_group=query_group)

    return embed, fuse


def schedule_fusion_batches(ref_idx: np.ndarray, bucket_of: np.ndarray,
                            q_batch: int, image_major: bool,
                            n_dev: int = 1) -> list[tuple]:
    """Decompose the query set into fixed-shape fusion batches.

    Returns a list of (query_group, width, rows, refs_rows, count):
    rows [G*Q] original query rows (image-contiguous; the tail may repeat
    rows already in the batch), refs_rows [G] corpus indices, count = number
    of REAL rows.

    image_major: queries sharing a reference image are grouped with
    ``query_group`` in (8, 4, 2) via power-of-2 chunk decomposition
    (5 queries -> 4 + 1; never a padding query); leftovers go query-major.
    Batches within a family are ordered by padded width so narrow ones can
    run narrow. Over ``n_dev`` ranks a group size runs image-major only
    when n_dev divides its image count q_batch // Q (rows are
    image-contiguous, so a rank's block of the G images and of the G*Q
    rows cut at the same boundaries).
    """
    batches: list[tuple] = []

    def emit_batch(rows, refs_rows, width, query_group, count):
        if __debug__ and count < len(rows):
            # correctness rests on every padded row being an exact
            # duplicate (same row, same ref) of a REAL row in this batch:
            # guard it at the one point every caller shares
            real = {(int(rows[j]), int(refs_rows[j // query_group]))
                    for j in range(count)}
            pad = {(int(rows[j]), int(refs_rows[j // query_group]))
                   for j in range(count, len(rows))}
            assert pad <= real, (
                "padded tail rows are not duplicates of real rows: "
                f"{sorted(pad - real)[:4]}")
        batches.append((query_group, width, np.asarray(rows, np.int64),
                        np.asarray(refs_rows, np.int32), count))

    if image_major:
        group_sizes = [q for q in (8, 4, 2)
                       if q <= q_batch and (q_batch // q) % n_dev == 0]
    if image_major and group_sizes:
        by_img: dict[int, list[int]] = {}
        for row, r in enumerate(ref_idx):
            by_img.setdefault(int(r), []).append(row)
        chunks: dict[int, list[tuple[int, list[int]]]] = {}
        leftover = []
        for r, rows in by_img.items():
            rows.sort(key=lambda i: bucket_of[i])  # L-homogeneous chunks
            i, c = 0, len(rows)
            for q in group_sizes:
                while c >= q:
                    chunks.setdefault(q, []).append((r, rows[i:i + q]))
                    i += q
                    c -= q
            leftover.extend(rows[i:])
        singles = np.asarray(sorted(leftover, key=lambda i: bucket_of[i]),
                             np.int64)

        for q, chs in sorted(chunks.items(), reverse=True):
            # narrow batches: order chunks by their padded width
            chs.sort(key=lambda ch: int(bucket_of[ch[1]].max()))
            g = max(q_batch // q, 1)
            for start in range(0, len(chs), g):
                batch = chs[start:start + g]
                count = len(batch) * q
                if len(batch) < g:  # pad with repeats of the first chunk
                    batch = batch + [batch[0]] * (g - len(batch))
                rows = np.asarray([i for _, ch in batch for i in ch],
                                  np.int64)
                refs_rows = np.asarray([r for r, _ in batch], np.int32)
                width = int(bucket_of[rows[:count]].max())
                emit_batch(rows, refs_rows, width, q, count)
    else:
        singles = np.argsort(bucket_of, kind="stable")

    for start in range(0, len(singles), q_batch):
        rows = singles[start:start + q_batch]
        count = len(rows)
        width = int(bucket_of[rows].max())
        if count < q_batch:  # pad the tail with repeats
            rows = np.concatenate(
                [rows, np.repeat(rows[:1], q_batch - count)])
        emit_batch(rows, ref_idx[rows], width, 1, count)
    return batches


def resolve_buckets(tokenizer, captions, text_len: int, l_buckets,
                    set_enc_token: bool = True):
    """Tokenize and assign each caption to its static L-bucket (its first
    token BLIP's [ENC], or with ``set_enc_token`` False BERT's [CLS], as
    BLIP-2 takes it). Returns (ids_all [N, text_len], mask_all [N,
    text_len], bucket_of [N])."""
    ids_all, mask_all = tokenizer.encode(captions, text_len,
                                         set_enc_token=set_enc_token)
    lens = mask_all.sum(axis=1)
    lbs = resolve_l_buckets(l_buckets, lens, text_len)
    bucket_of = np.asarray([next(b for b in lbs if b >= ln) for ln in lens])
    return ids_all, mask_all, bucket_of


@torch.inference_mode()
def predict_queries(fuse_fn, tokenizer, captions: list[str], ref_names,
                    index_feats, index_names, text_len: int,
                    q_batch: int = 32, mesh=None,
                    l_buckets="auto", image_major: bool = True,
                    set_enc_token: bool = True) -> torch.Tensor:
    """Fused query features [N_q, E] (float32, on the bank's device) via
    index-feature reuse.

    l_buckets: queries are grouped into static text-length buckets
    (``rerank.resolve_l_buckets``) and each group's batches run at the
    narrower padded width; the additive -10000 pad mask makes the features
    the same at every pad width. 'auto' cuts at the 50th/90th length
    percentiles; None keeps the single text_len bucket.

    image_major=True: queries that share a reference image are scheduled
    together and fused with ``query_group > 1``, so each layer's image K/V
    projections run once per image instead of once per query
    (``schedule_fusion_batches``); the leftovers run query-major. The same
    function as query-major fusion.

    set_enc_token: the captions' first token is [ENC] (BLIP), or [CLS]
    (False: BLIP-2).

    One launch sequence per scheduled batch. A batch's padded tail rows are
    duplicates of its real rows and are sliced off; the inverse permutation
    resolves a row to any copy and fails if the scheduler dropped one.

    mesh: each fusion batch's rows are split over ``fit_mesh(mesh,
    q_batch)`` (the bank is whole on every rank); each rank keeps its
    blocks' predictions, whole batches with their padding, and they are
    all-gathered once at the end. Every rank returns the [N_q, E]
    predictions.
    """
    mesh = pmesh.fit_mesh(mesh, q_batch)
    if mesh is not None and not mesh.member:
        return pmesh.share(mesh)
    device = index_feats.device
    n = len(captions)
    if n == 0:
        return pmesh.share(mesh, torch.empty((0, 0), dtype=torch.float32,
                                             device=device))
    with tracing.trace_phase("fusion.plan"):
        pos = {n: i for i, n in enumerate(index_names)}
        ref_idx = np.asarray([pos[r] for r in ref_names], np.int32)
        ids_all, mask_all, bucket_of = resolve_buckets(
            tokenizer, captions, text_len, l_buckets, set_enc_token)
        batches = schedule_fusion_batches(ref_idx, bucket_of, q_batch,
                                          image_major,
                                          1 if mesh is None else mesh.size)

    preds = []       # device tensors, scheduling order
    sched_rows = []  # original row index of each kept pred row
    for q, width, rows, refs_rows, count in batches:
        if mesh is not None:  # this rank's block of the batch
            refs_rows = refs_rows[pmesh.shard_rows(mesh, len(refs_rows))]
            rows = rows[pmesh.shard_rows(mesh, len(rows))]
        refs = index_feats[torch.from_numpy(refs_rows.astype(np.int64))
                           .to(device)]
        ids = torch.from_numpy(ids_all[rows][:, :width]).to(device)
        msk = torch.from_numpy(mask_all[rows][:, :width]).to(device)
        pred = fuse_fn(refs, ids, msk, q) if q > 1 \
            else fuse_fn(refs, ids, msk)
        if mesh is None:
            preds.append(pred[:count].float())
            sched_rows.extend(rows[:count].tolist())
        else:
            preds.append(pred.float())

    if mesh is None:
        grouped = torch.cat(preds) if len(preds) > 1 else preds[0]
    else:
        # every rank's blocks, one gather; a batch's rows are its ranks'
        # blocks in mesh order, its real rows first
        sizes = [len(p) for p in preds]
        parts = [g.split(sizes) for g in
                 pmesh.all_gather(mesh, torch.cat(preds)[None])]
        grouped = torch.cat([
            torch.cat([part[i] for part in parts])[:count]
            for i, (_, _, _, _, count) in enumerate(batches)])
        sched_rows = [r for _, _, rows, _, count in batches
                      for r in rows[:count].tolist()]
    inv = np.full(n, -1, np.int64)
    inv[np.asarray(sched_rows, np.int64)] = np.arange(len(sched_rows))
    missing = np.flatnonzero(inv < 0)
    if missing.size:
        # a dropped row would leave a garbage index here and corrupt every
        # downstream ranking
        raise AssertionError(
            f"fusion scheduler dropped {missing.size} quer(ies): "
            f"rows {missing[:8].tolist()}...")
    return pmesh.share(mesh, grouped[torch.from_numpy(inv).to(device)])


def _on_index_device(pred, pooled_index) -> tuple[torch.Tensor, torch.Tensor]:
    index = torch.as_tensor(pooled_index)
    return torch.as_tensor(pred, device=index.device), index


def _query_block(mesh, pred, ent=None):
    """This rank's block of the queries (and entity columns), padded with
    zero rows to a multiple of the mesh size."""
    pred, _ = pmesh.pad_rows(pred, mesh.size)
    rows = pmesh.shard_rows(mesh, len(pred))
    if ent is not None:
        ent = pmesh.pad_rows(ent, mesh.size)[0][rows]
    return pred[rows], ent


@torch.inference_mode()
def full_ranking(pred, pooled_index, mesh=None) -> np.ndarray:
    """Ascending-distance stable argsort over the whole corpus, on the
    index's device: [N_q, N_idx] corpus indices.

    mesh: the queries are padded to a multiple of the mesh size, each rank
    ranks its block against the whole (replicated) pooled index on the
    mesh's device, and one all-gather returns every rank the ranking."""
    pred, index = _on_index_device(pred, pooled_index)
    if mesh is None:
        return cosine_rank(pred, index).cpu().numpy()
    n = len(pred)
    block, _ = _query_block(mesh, pred.to(mesh.device))
    order = cosine_rank(block, index.to(mesh.device))
    return pmesh.all_gather(mesh, order)[:n].cpu().numpy()


@torch.inference_mode()
def ranked_slices(pred, pooled_index, width: int,
                  entity_idx: np.ndarray | None = None,
                  mesh=None) -> tuple[np.ndarray, np.ndarray | None]:
    """What the metrics and submission layers consume of the ranking,
    computed on the index's device from one distance matrix:

    - the top-``width`` corpus indices of each query (the stable
      ascending-distance argsort truncated at width: equal distances keep
      corpus order, as JAX's ``lax.top_k`` on -distance does),
    - the EXACT rank of each requested entity column (entity_idx [N_q, E]:
      target / reference / group members), its position in the full stable
      argsort, which is #(d < d_e) + #(d == d_e at a lower corpus index).

    Distances are 1 - pred @ index.T as float32 products. The full argsort
    is a stable sort on the device (``torch.topk`` promises no order among
    equal values there); only the top-width columns and the entity ranks
    leave it. Returns (topk [N_q, width] int32, ranks [N_q, E] int32 or
    None).

    mesh: the queries (and entity rows) are padded to a multiple of the
    mesh size and each rank ranks its block against the whole pooled
    index on the mesh's device; topk and ranks are gathered."""
    pred, index = _on_index_device(pred, pooled_index)
    ent = None if entity_idx is None else torch.as_tensor(
        np.asarray(entity_idx, np.int64), device=index.device)
    if mesh is None:
        topk, ranks = _ranked_body(pred, index, ent, width)
        with tracing.trace_phase("ranking.wait"):
            return topk.cpu().numpy(), \
                None if ranks is None else ranks.cpu().numpy()
    n = len(pred)
    dev = mesh.device
    block, ent_block = _query_block(
        mesh, pred.to(dev), None if ent is None else ent.to(dev))
    topk, ranks = _ranked_body(block, index.to(dev), ent_block, width)
    topk = pmesh.all_gather(mesh, topk)[:n]
    ranks = None if ranks is None else pmesh.all_gather(mesh, ranks)[:n]
    with tracing.trace_phase("ranking.wait"):
        return topk.cpu().numpy(), \
            None if ranks is None else ranks.cpu().numpy()


def _ranked_body(pred, index, ent, width: int):
    """``ranked_slices`` on the device, shared by both executors: (topk
    [N_q, min(width, N_idx)] int32, ranks [N_q, E] int32 or None for
    ``ent`` None), device tensors."""
    dist = 1.0 - cosine_scores(pred, index)
    order = torch.sort(dist, dim=1, stable=True).indices
    topk = order[:, :min(width, index.shape[0])].to(torch.int32)
    if ent is None:
        return topk, None
    # each corpus column's position in its row's order, read at the entities
    place = torch.empty_like(order)
    place.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                   .expand_as(order))
    return topk, place.gather(1, ent).to(torch.int32)


# ---------------------------------------------------------------------------
# the single-program executor

def _weight_ptrs(model) -> tuple:
    """The addresses a captured graph reads the weights at, ``Dense``'s
    compute-dtype copies among them, which this brings up to date first
    (``layers.kept_casts``): a model moved off the device and back has new
    ones, a ``load_state_dict`` keeps them."""
    return tuple(t.data_ptr() for t in (*model.parameters(),
                                        *model.buffers(), *kept_casts(model)))


class _CapturedGraph:
    """``fn(*inputs)`` captured once as a CUDA graph, after one eager pass
    on a side stream (which builds and configures the kernels and cuBLAS's
    handles). The graph reads its own static inputs: copies of ``inputs``,
    or with ``donate`` the tensors themselves, which the caller then
    leaves to it. ``replay(inputs)`` copies each tensor that is not
    already one of them into it and replays, so a caller's tensors are
    read and never written. A failed capture raises. ``seconds``: the
    capture (the eager pass not included); ``pool_bytes``: the memory the
    capture reserved, the graph's private pool; ``launches``: the kernel
    launches the capture recorded, by kernel id (``registry.counts()``;
    a replay adds none to the wrappers' counters)."""

    def __init__(self, fn, inputs: tuple, key, donate: bool = False):
        if not donate:
            inputs = tuple(x.clone() for x in inputs)
        self.key, self.inputs = key, inputs
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        # the capture empties the allocator's cache first; empty it before
        # the baseline, so that the growth is the graph's pool alone
        torch.cuda.empty_cache()
        before, reserved = registry.counts(), torch.cuda.memory_reserved()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*inputs)
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.launches = {k: v - before[k]
                         for k, v in registry.counts().items()}

    def replay(self, inputs: tuple):
        for static, new in zip(self.inputs, inputs):
            if new.data_ptr() != static.data_ptr():
                static.copy_(new)
        self.graph.replay()
        return self.outputs


def _embed_corpus(model, imgs, chunk: int, raw_dtype=None,
                  pooled_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The corpus ``imgs`` [n, H, W, 3] embedded ``chunk`` images at a time
    (the last chunk at its true size, so every product has the
    multi-launch path's shape): (raw [n, M, D], pooled [n, E]), in
    ``raw_dtype``/``pooled_dtype`` (default: the model's outputs')."""
    n = imgs.shape[0]
    raw_all = pooled_all = None
    for i in range(0, n, chunk):
        raw, pooled = model.embed_images(imgs[i:i + chunk],
                                         pool_and_normalize=True)
        if raw_all is None:
            raw_all = raw.new_empty((n, *raw.shape[1:]),
                                    dtype=raw_dtype or raw.dtype)
            pooled_all = pooled.new_empty((n, pooled.shape[1]),
                                          dtype=pooled_dtype or pooled.dtype)
        raw_all[i:i + chunk].copy_(raw)
        pooled_all[i:i + chunk].copy_(pooled)
    return raw_all, pooled_all


def make_embed_scan(model, params=None, device=None):
    """The whole corpus embedded in one program (JAX's ``make_embed_scan``):
    embed_scan(images [n_chunks, chunk, H, W, 3] on ``device``, default
    'cuda') -> (raw [n_chunks, chunk, M, D], pooled [n_chunks, chunk, E])
    in the model's compute dtype, each chunk as ``make_stage1_fns``' embed
    computes it (the single program's embed, ``_embed_corpus``). On the
    card one CUDA-graph replay, captured on the first call and again when
    the images' shape or the weights' addresses change; on the CPU the
    chunks eagerly."""
    model = bind_module(model, params, resolve_device(device))
    captured = None

    def body(images):
        raw, pooled = _embed_corpus(model, images.flatten(0, 1),
                                    images.shape[1])
        return (raw.unflatten(0, images.shape[:2]),
                pooled.unflatten(0, images.shape[:2]))

    @torch.inference_mode()
    def embed_scan(images):
        nonlocal captured
        if images.device.type == "cpu":
            return body(images)
        key = (images.shape, images.dtype, _weight_ptrs(model))
        if captured is None or captured.key != key:
            captured = None
            captured = _CapturedGraph(body, (images,), key)
        raw, pooled = captured.replay((images,))
        return raw.clone(), pooled.clone()

    return embed_scan


def build_fusion_plan(batches: list[tuple], ids_all: np.ndarray,
                      mask_all: np.ndarray, device=None
                      ) -> tuple[tuple, np.ndarray]:
    """Stack ``schedule_fusion_batches``' batches into one family a
    (query_group, width), as JAX's function does, on ``device`` (default
    'cuda'): (fams, inv). fams is a tuple of (refs [nb, G], ids [nb, B, w],
    mask [nb, B, w]) int32 tensors, the query group recovered as B // G;
    inv [N_q] int64 maps each query row to its place in the families'
    outputs flattened family by family and batch by batch (a padded
    duplicate row resolves to any of its copies). Raises if a query row is
    in no batch."""
    device = resolve_device(device)
    fam: dict[tuple[int, int], list] = {}
    for q, width, rows, refs_rows, _ in batches:
        fam.setdefault((q, width), []).append((rows, refs_rows))
    fams, sched_rows = [], []
    for (_, width), entries in fam.items():
        rows_m = np.stack([e[0] for e in entries])          # [nb, B]
        refs_m = np.stack([e[1] for e in entries])          # [nb, G]
        fams.append(tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in (refs_m, ids_all[rows_m][..., :width],
                      mask_all[rows_m][..., :width])))
        sched_rows.extend(rows_m.reshape(-1).tolist())
    inv = np.full(ids_all.shape[0], -1, np.int64)
    inv[np.asarray(sched_rows, np.int64)] = np.arange(len(sched_rows))
    missing = np.flatnonzero(inv < 0)
    if missing.size:
        raise AssertionError(
            f"fusion scheduler dropped {missing.size} quer(ies): "
            f"rows {missing[:8].tolist()}...")
    return tuple(fams), inv


def _program_body(model, chunk: int, width: int, n_fams: int, imgs, inv,
                  ent, *flat_fams):
    """The single program: the corpus embedded chunk by chunk into a bf16
    bank (``build_index``'s feature_dtype) and fp32 pooled features, every
    fusion batch of the plan at its own width and query group, the
    gather by ``inv``, and the ranking (``_ranked_body``). Returns (topk,
    ranks, pred), device tensors."""
    bank, pooled = _embed_corpus(model, imgs, chunk, torch.bfloat16,
                                 torch.float32)
    preds = []
    for f in range(n_fams):
        refs, ids, mask = flat_fams[3 * f:3 * f + 3]
        q = ids.shape[1] // refs.shape[1]
        for b in range(refs.shape[0]):
            preds.append(model.fuse(bank.index_select(0, refs[b]), ids[b],
                                    mask[b], query_group=q).float())
    pred = torch.cat(preds).index_select(0, inv)
    topk, ranks = _ranked_body(pred, pooled, ent, width)
    return topk, ranks, pred


class SingleProgramEval:
    """The whole stage-I eval as one program (JAX's
    ``make_single_program_eval``; made and cached by that function):

        run(params, imgs, fams, inv, ent, n_idx, width, chunk=32,
            donate=False)
            -> (topk [N_q, width] int32, ranks [N_q, E] int32), numpy

    imgs [n_idx, H, W, 3] float32, the corpus on the device; fams and inv
    from ``build_fusion_plan``; ent [N_q, E] the entity columns; ``chunk``
    the embed batch (the last chunk keeps its true size, so every product
    has the multi-launch path's shape); ``params`` a port state dict
    loaded into the model in place, or None. The inputs are read, never
    written: a capture copies them into static inputs of its own, unless
    ``donate`` gives it the tensors themselves (the caller's to give away,
    as ``run_single_program_eval``'s are; ``buffer`` hands out the cached
    graph's own, so that a call with them copies nothing).

    On the card the program is one CUDA graph, captured on the first call
    and replayed by every call with the same device, dtype, plan shapes,
    n_idx, width, chunk and weight addresses (so a checkpoint loaded with
    ``load_state_dict`` replays the same graph, and a model moved off the
    card and back is captured again). One graph is kept, and a new key
    releases it first. Only topk and ranks leave the device, after the
    replay (``replay()`` runs the cached graph again on the last call's
    inputs). ``capture`` is the current graph (its seconds, pool bytes,
    static inputs and recorded launches), ``captures`` the number of
    captures so far, ``pred`` the last run's predictions [N_q, E] on the
    device. The graph holds its pool and its static inputs until
    ``release()`` or the model's end. On the CPU the same program runs
    eagerly."""

    def __init__(self, model):
        self._model = weakref.ref(model)
        self.capture: _CapturedGraph | None = None
        self.captures = 0
        self.pred = None

    def release(self) -> None:
        """Drop the cached graph and return its pool to the device."""
        if self.capture is not None:
            self.capture = None
            torch.cuda.empty_cache()

    def buffer(self, i: int, shape, dtype, device) -> torch.Tensor:
        """Where a caller puts the ``i``-th input of its next call (imgs,
        inv, ent, then each family's refs, ids and mask): the cached
        graph's own static input when it has this shape, dtype and device,
        else a new tensor."""
        device = torch.device(device)
        if self.capture is not None and i < len(self.capture.inputs):
            x = self.capture.inputs[i]
            if (tuple(x.shape) == tuple(shape) and x.dtype == dtype
                    and x.device.type == device.type
                    and device.index in (None, x.device.index)):
                return x
        return torch.empty(shape, dtype=dtype, device=device)

    @torch.inference_mode()
    def __call__(self, params, imgs, fams, inv, ent, n_idx: int, width: int,
                 chunk: int = 32, donate: bool = False
                 ) -> tuple[np.ndarray, np.ndarray]:
        device = imgs.device
        model = bind_module(self._model(), params, device)
        if imgs.shape[0] != n_idx:
            raise ValueError(f"imgs holds {imgs.shape[0]} images, n_idx is "
                             f"{n_idx}")
        inv, ent = (torch.as_tensor(a, device=device).long()
                    for a in (inv, ent))
        flat = tuple(t for fam in fams for t in fam)
        inputs = (imgs, inv, ent, *flat)

        def fn(*xs):
            return _program_body(model, chunk, min(width, n_idx), len(fams),
                                 *xs)

        if device.type == "cpu":
            topk, ranks, self.pred = fn(*inputs)
        else:
            key = (str(device), getattr(model, "dtype", None),
                   *(tuple(x.shape) for x in inputs), n_idx, width, chunk,
                   _weight_ptrs(model))
            if self.capture is None or self.capture.key != key:
                self.release()
                self.capture = _CapturedGraph(fn, inputs, key, donate)
                self.captures += 1
            topk, ranks, self.pred = self.capture.replay(inputs)
        return topk.cpu().numpy(), ranks.cpu().numpy()

    def replay(self) -> tuple[np.ndarray, np.ndarray]:
        """The cached graph replayed on the last call's inputs: (topk,
        ranks) as a call returns them."""
        topk, ranks, self.pred = self.capture.replay(self.capture.inputs)
        return topk.cpu().numpy(), ranks.cpu().numpy()


_SINGLE_PROGRAM_CACHE: "weakref.WeakKeyDictionary" = \
    weakref.WeakKeyDictionary()


def make_single_program_eval(model) -> SingleProgramEval:
    """The model's ``SingleProgramEval``, one a model, made on first use
    and kept while the model lives."""
    run = _SINGLE_PROGRAM_CACHE.get(model)
    if run is None:
        run = _SINGLE_PROGRAM_CACHE[model] = SingleProgramEval(model)
    return run


def run_single_program_eval(model, params, dataset_classic, tokenizer,
                            captions: list[str], ref_names: list[str],
                            ent_names: list[list[str]], *, text_len: int,
                            batch_size: int = 32, q_batch: int = 256,
                            image_major: bool = True, width: int = 501,
                            l_buckets="auto", device=None) -> tuple:
    """The single-program executor on ``device`` (default 'cuda'): the
    classic corpus copied batch by batch into one device tensor, the
    fusion plan built and uploaded, then the whole eval as one program
    (``make_single_program_eval``). When the model's cached graph takes
    inputs of these shapes, the corpus and the plan are written straight
    into its static inputs, so no second copy of the corpus is made.
    Returns (topk [N_q, w] int32, ranks [N_q, E] int32, index_names).
    Its spans go to the caller's ``tracing.collect``: the layers 'load',
    'copy', 'plan', 'program' and the phases 'index.load',
    'index.upload', 'copy.wait', 'fusion.plan', 'plan.upload',
    'plan.wait'."""
    device = resolve_device(device)
    run = make_single_program_eval(model)
    imgs, names_all = None, []
    batches = iter_batches(dataset_classic, batch_size)
    while True:
        with tracing.layer_span("load"), tracing.trace_phase("index.load"):
            batch = next(batches, None)
        if batch is None:
            break
        names, images = batch
        with tracing.layer_span("copy"), \
                tracing.trace_phase("index.upload"):
            if imgs is None:
                imgs = run.buffer(
                    0, (len(dataset_classic), *images.shape[1:]),
                    torch.float32, device)
            start = len(names_all)
            imgs[start:start + len(names)].copy_(torch.from_numpy(
                np.ascontiguousarray(images, np.float32)))
            names_all.extend(names)
    with tracing.layer_span("copy"), tracing.trace_phase("copy.wait"):
        sync_device(device)
    n_idx = len(names_all)
    imgs = imgs[:n_idx]

    with tracing.layer_span("plan"):
        with tracing.trace_phase("fusion.plan"):
            pos = {nm: i for i, nm in enumerate(names_all)}
            ref_idx = np.asarray([pos[r] for r in ref_names], np.int32)
            ids_all, mask_all, bucket_of = resolve_buckets(
                tokenizer, captions, text_len, l_buckets)
            batches = schedule_fusion_batches(ref_idx, bucket_of,
                                              q_batch, image_major)
            fams, inv = build_fusion_plan(batches, ids_all, mask_all,
                                          "cpu")
            ent = np.asarray([[pos[nm] for nm in row]
                              for row in ent_names], np.int64)
        with tracing.trace_phase("plan.upload"):
            plan = [torch.from_numpy(inv), torch.from_numpy(ent),
                    *(t for fam in fams for t in fam)]
            inv, ent, *flat = (
                run.buffer(i, x.shape, x.dtype, device).copy_(x)
                for i, x in enumerate(plan, start=1))
            fams = tuple(tuple(flat[i:i + 3])
                         for i in range(0, len(flat), 3))
        with tracing.trace_phase("plan.wait"):
            sync_device(device)

    with tracing.layer_span("program"):
        topk, ranks = run(params, imgs, fams, inv, ent, n_idx=n_idx,
                          width=min(width, n_idx), chunk=batch_size,
                          donate=True)
    return topk, ranks, names_all


@torch.inference_mode()
def target_index(model, bank, batch_size: int) -> torch.Tensor:
    """A multi-vector model's targets of the image tokens ``bank``
    [N, M, W], ``batch_size`` images a launch sequence: [N, T, E]
    float32 on the bank's device."""
    return torch.cat([model.target_features(bank[i:i + batch_size]).float()
                      for i in range(0, len(bank), batch_size)])


def _index_and_fuse(model, params, dataset_classic, tokenizer, captions,
                    refs, *, text_len: int, batch_size: int, q_batch: int,
                    image_major: bool, device, mesh=None) -> tuple:
    """Corpus embed and query fusion, the layer spans 'index' and
    'fusion': (pooled [N, E], pred [N_q, E], index_names). A multi-vector
    model (BLIP-2) embeds the corpus's tokens alone in 'index', and its
    targets ([N, T, E] in pooled's place) in a layer span 'targets'."""
    multi = model.multi_vector
    with tracing.layer_span("index"):
        embed, fuse = make_stage1_fns(model, params, device)
        if multi:
            raw, index_names = build_index(dataset_classic, embed,
                                           batch_size, device=device)
        else:
            raw, pooled, index_names = build_index(
                dataset_classic, embed, batch_size, pooled=True,
                device=device, mesh=mesh)
        with tracing.trace_phase("index.wait"):
            sync_device(device)
    if multi:
        with tracing.layer_span("targets"):
            pooled = target_index(model, raw, batch_size)
            with tracing.trace_phase("targets.wait"):
                sync_device(device)
    with tracing.layer_span("fusion"):
        pred = predict_queries(fuse, tokenizer, captions, refs, raw,
                               index_names, text_len, q_batch,
                               image_major=image_major, mesh=mesh,
                               set_enc_token=model.enc_token)
        with tracing.trace_phase("fusion.wait"):
            sync_device(device)
    return pooled, pred, index_names


def _stage1_ranks(model, params, dataset_classic, tokenizer, captions,
                  refs, ent_names, *, text_len: int, batch_size: int,
                  q_batch: int, image_major: bool, width: int,
                  single_program: bool, device, mesh=None) -> tuple:
    """(topk [N_q, width], ranks [N_q, E], index_names) by either
    executor; ``ent_names`` [N_q][E] the entity columns' names. Its spans
    go to the caller's ``tracing.collect``."""
    _check_single_program(mesh, single_program)
    if model.multi_vector and (single_program or mesh is not None):
        raise ValueError("a model of several target vectors an image "
                         "(BLIP-2) runs the multi-launch executor on one "
                         "device")
    if single_program:
        return run_single_program_eval(
            model, params, dataset_classic, tokenizer, captions, refs,
            ent_names, text_len=text_len, batch_size=batch_size,
            q_batch=q_batch, image_major=image_major, width=width,
            device=device)
    pooled, pred, index_names = _index_and_fuse(
        model, params, dataset_classic, tokenizer, captions, refs,
        text_len=text_len, batch_size=batch_size, q_batch=q_batch,
        image_major=image_major, device=device, mesh=mesh)
    with tracing.layer_span("ranking"):
        with tracing.trace_phase("ranking.plan"):
            pos = {name: i for i, name in enumerate(index_names)}
            ent = np.asarray([[pos[nm] for nm in row] for row in ent_names],
                             np.int32)
        topk_idx, ranks = ranked_slices(pred, pooled, width, ent, mesh=mesh)
    return topk_idx, ranks, index_names


def evaluate_cirr_stage1(model, params, dataset_classic, dataset_relative,
                         tokenizer, *, text_len: int, batch_size: int = 32,
                         save_topk_k: int | None = None, mesh=None,
                         image_major: bool = True,
                         q_batch: int = 256,
                         single_program: bool = False,
                         device=None) -> tuple:
    """CIRR stage-I metrics, and the top-k payload when ``save_topk_k``.

    model: the port's ``RetrievalModel``, or ``Blip2RetrievalModel`` (the
    multi-launch executor on one device; its ``seconds`` add the layer
    span 'targets'); params: a port state dict to load into it, or
    None. batch_size drives the ViT index embed, q_batch the
    fusion scheduler. Runs on ``device`` (default 'cuda'). single_program:
    the whole eval as one program (``run_single_program_eval``; on the
    card one CUDA-graph replay, and the corpus on the card at once; the
    model's cached graph keeps the corpus and its pool on the card until
    ``make_single_program_eval(model).release()``).
    mesh: the multi-launch executor over a mesh (the module's docstring),
    on the mesh's device; with ``single_program`` refused, as in JAX.
    Returns (Stage1EvalResult, payload or None)."""
    _check_single_program(mesh, single_program)
    device = resolve_device(device) if mesh is None else mesh.device
    seconds = {}
    with tracing.collect(seconds), tracing.layer_span("total"):
        with tracing.trace_phase("stage1.labels"):
            captions, refs, targets, groups = [], [], [], []
            for i in range(len(dataset_relative)):
                s = dataset_relative[i]
                captions.append(s["caption"])
                refs.append(s["reference_name"])
                targets.append(s["target_name"])
                groups.append(s["group_members"])
            members = [[m for m in g if m != r][:5]
                       for g, r in zip(groups, refs)]
            width = max(501, (save_topk_k or 0) + 1)
            ent_names = [[t, r, *row]
                         for t, r, row in zip(targets, refs, members)]

        topk_idx, ranks, index_names = _stage1_ranks(
            model, params, dataset_classic, tokenizer, captions, refs,
            ent_names, text_len=text_len, batch_size=batch_size,
            q_batch=q_batch, image_major=image_major, width=width,
            single_program=single_program, device=device, mesh=mesh)
        with tracing.trace_phase("stage1.metrics"):
            ranking = M.cirr_ranking_from_ranks(
                topk_idx, index_names, targets, members,
                target_ranks=ranks[:, 0], ref_ranks=ranks[:, 1],
                member_ranks=ranks[:, 2:])
            mets = M.cirr_metrics(ranking)
            payload = None
            if save_topk_k:
                payload = topk_payload(
                    ranking, index_names, targets, "val", k=save_topk_k)
    return Stage1EvalResult(mets, ranking, index_names, targets, seconds,
                            topk_idx, ranks), payload


def evaluate_fiq_stage1(model, params, dataset_classic, dataset_relative,
                        tokenizer, *, text_len: int, batch_size: int = 32,
                        save_topk_k: int | None = None,
                        dress_types: list[str] | None = None,
                        mesh=None, image_major: bool = True,
                        q_batch: int = 256,
                        single_program: bool = False,
                        device=None) -> tuple:
    """Fashion-IQ stage-I metrics of one corpus (one or more dress types),
    and the top-k payload when ``save_topk_k``; as
    ``evaluate_cirr_stage1``."""
    _check_single_program(mesh, single_program)
    device = resolve_device(device) if mesh is None else mesh.device
    seconds = {}
    with tracing.collect(seconds), tracing.layer_span("total"):
        with tracing.trace_phase("stage1.labels"):
            captions_pairs, refs, targets = [], [], []
            for i in range(len(dataset_relative)):
                s = dataset_relative[i]
                captions_pairs.append(s["captions"])
                refs.append(s["reference_name"])
                targets.append(s["target_name"])
            captions = compose_fiq_eval(captions_pairs)
            width = max(501, (save_topk_k or 0) + 1)

        topk_idx, ranks, index_names = _stage1_ranks(
            model, params, dataset_classic, tokenizer, captions, refs,
            [[t] for t in targets], text_len=text_len,
            batch_size=batch_size, q_batch=q_batch, image_major=image_major,
            width=width, single_program=single_program, device=device,
            mesh=mesh)
        with tracing.trace_phase("stage1.metrics"):
            ranking = M.fiq_ranking_from_ranks(topk_idx, index_names,
                                               targets,
                                               target_ranks=ranks[:, 0])
            mets = M.fiq_metrics(ranking)
            payload = None
            if save_topk_k:
                payload = topk_payload(ranking, index_names, targets,
                                       dataset_relative.split,
                                       k=save_topk_k,
                                       dress_types=dress_types)
    return Stage1EvalResult(mets, ranking, index_names, targets, seconds,
                            topk_idx, ranks), payload
