"""Online CIR serving: stage-I ranking and an optional stage-II re-rank
(port of the JAX package's ``runtime/serve.py``).

Load the trained two-stage stack once, embed the corpus once (or load a
cached index), then answer (reference image, modification text) queries.
Requests are handled in waves of ``q_pad`` (a short wave is padded with
repeats of its first request and its results trimmed); the corpus banks
stay on the device; ranking is a stable top-k over the pooled bank
(``ops/topk.cosine_topk``, tombstoned slots at -inf), never a full sort
per request; re-ranking runs the query-major scheduler
(``retrieval/rerank.rerank``) at [q_pad, rerank_k].

Semantics match the offline engines: the reference image is removed from
its own ranking, stage II re-sorts only the top ``rerank_k`` candidates and
leaves the tail in stage-I order, and z_t fusion for re-ranking runs over
the stage-II ViT's features.

Grad mode is thread-local, so every entry point that computes
(``CIRServingEngine.handle``, ``add_images``, ``build_serving_index``)
enters ``torch.inference_mode()`` itself: the micro-batcher's worker
thread does not inherit its caller's mode.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.ops.quant import (
    Int8Bank,
    quantize_bank,
    take_rows,
)
from candidate_reranking_cir_tpu_torch.ops.topk import cosine_topk
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
    bind_module,
    rerank,
)
from candidate_reranking_cir_tpu_torch.runtime import tracing
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


@dataclass
class ServeRequest:
    caption: str
    reference: str | None = None       # corpus image name
    reference_image: np.ndarray | None = None  # preprocessed [H, W, 3] fp32
    k: int = 50


@dataclass
class ServeResult:
    ranking: list[str]
    scores: list[float]
    reranked: int = 0   # how many head entries were stage-II re-scored


def params_fingerprint(params) -> str:
    """Cheap content fingerprint of a port state dict (leaf count, total
    size, float64 checksum): guards index caches against serving rankings
    from stale weights.

    It runs over the port's state dict, whose leaves differ in number from
    the JAX package's stacked scan tree, so the two packages' fingerprints
    of the same weights differ: a cache written by the JAX server loads
    here when no fingerprint is expected, and is refused when one is."""
    leaves = list(params.values())
    total, size = 0.0, 0
    for leaf in leaves:
        size += leaf.numel()
        if leaf.is_floating_point():
            total += float(leaf.detach().double().sum())
    return f"{len(leaves)}:{size}:{total:.6e}"


def _to_numpy(bank: torch.Tensor) -> np.ndarray:
    """A bank as numpy for the npz cache: bf16 as its uint16 bit view (npz
    has no bf16; the JAX package's layout), other dtypes as they are."""
    if bank.dtype == torch.bfloat16:
        return bank.view(torch.int16).cpu().numpy().view(np.uint16)
    return bank.cpu().numpy()


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Inverse of ``_to_numpy``: a uint16 array is a bf16 bank."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


@dataclass
class ServingIndex:
    """Corpus banks on one device. ``raw_s2`` only when stage II serves.

    ``fingerprint`` records what produced the index (checkpoint checksums,
    dataset, split, transform); the cache loader refuses a mismatched
    cache instead of ranking against stale embeddings.

    Incremental updates without a rebuild: the banks grow to a power-of-two
    ``capacity`` and a ``valid`` mask tombstones removed rows, whose slots
    later additions reuse. Rows are written in place (the JAX package
    copies the banks on every update; in place, an update of a 2 GB bank
    needs no second copy)."""
    names: list[str]
    pooled_s1: torch.Tensor              # [capacity, E] fp32
    raw_s1: torch.Tensor                 # [capacity, M, W] (reference fusion)
    raw_s2: torch.Tensor | None = None   # [capacity, M, W] (stage-II ViT)
    fingerprint: dict | None = None
    valid: torch.Tensor | None = None    # [capacity] bool; None = all valid
    pos: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.pos:
            self.pos = {nm: i for i, nm in enumerate(self.names)}
        if self.valid is None:
            self.valid = torch.ones(self.capacity, dtype=torch.bool,
                                    device=self.device)

    @property
    def capacity(self) -> int:
        return self.pooled_s1.shape[0]

    @property
    def n_valid(self) -> int:
        return len(self.pos)

    @property
    def device(self) -> torch.device:
        return self.pooled_s1.device

    def to(self, device) -> "ServingIndex":
        """Move every bank to ``device`` (in place); returns the index."""
        device = torch.device(device)
        self.pooled_s1 = self.pooled_s1.to(device)
        self.raw_s1 = self.raw_s1.to(device)
        if self.raw_s2 is not None:
            self.raw_s2 = self.raw_s2.to(device)
        self.valid = self.valid.to(device)
        return self

    def _assert_mutable(self):
        if isinstance(self.raw_s1, Int8Bank) or \
                isinstance(self.raw_s2, Int8Bank):
            raise ValueError("a quantized index is immutable — apply "
                             "add/remove before quantize(), or rebuild")

    def _grow_to(self, capacity: int):
        pad = capacity - self.capacity
        if pad <= 0:
            return

        def grow(a):
            if a is None:
                return None
            return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])

        self.pooled_s1 = grow(self.pooled_s1)
        self.raw_s1 = grow(self.raw_s1)
        self.raw_s2 = grow(self.raw_s2)
        self.valid = grow(self.valid)
        self.names = self.names + [f"__free_{i}__"
                                   for i in range(self.capacity - pad,
                                                  self.capacity)]

    @torch.inference_mode()
    def add_rows(self, names: list[str], pooled, raw1, raw2=None):
        """Write embedded rows, reusing tombstoned slots first; grows the
        banks to the next power of two when full."""
        self._assert_mutable()
        for nm in names:
            if nm in self.pos:
                raise ValueError(f"{nm!r} is already indexed")
        if (raw2 is None) != (self.raw_s2 is None):
            raise ValueError("stage-II features must match the index")
        used = set(self.pos.values())
        free = [i for i in range(self.capacity) if i not in used]
        need = len(names) - len(free)
        if need > 0:
            new_cap = max(2 * self.capacity, self.capacity + need)
            new_cap = 1 << (new_cap - 1).bit_length()  # next power of two
            start = self.capacity
            self._grow_to(new_cap)
            free = free + list(range(start, self.capacity))
        rows = torch.as_tensor(free[:len(names)], device=self.device)
        self.pooled_s1[rows] = pooled.to(self.device, self.pooled_s1.dtype)
        self.raw_s1[rows] = raw1.to(self.device, self.raw_s1.dtype)
        if raw2 is not None:
            self.raw_s2[rows] = raw2.to(self.device, self.raw_s2.dtype)
        self.valid[rows] = True
        for nm, row in zip(names, free):
            self.names[row] = nm
            self.pos[nm] = row

    @torch.inference_mode()
    def remove_rows(self, names: list[str]):
        """Tombstone rows: the valid mask sinks them below every real
        candidate (-inf similarity); ``add_rows`` reuses their slots."""
        self._assert_mutable()
        rows = []
        for nm in names:
            if nm not in self.pos:
                raise ValueError(f"{nm!r} is not indexed")
            rows.append(self.pos.pop(nm))
        for row in rows:
            self.names[row] = f"__tombstone_{row}__"
        self.valid[torch.as_tensor(rows, device=self.device)] = False

    def quantize(self):
        """Convert the raw token banks to symmetric per-token int8 (about
        half the memory; ``ops/quant.py`` says what it costs in accuracy).
        The pooled ranking bank stays fp32: [N, 256] is small."""
        if not isinstance(self.raw_s1, Int8Bank):
            self.raw_s1 = quantize_bank(self.raw_s1)
        if self.raw_s2 is not None and not isinstance(self.raw_s2, Int8Bank):
            self.raw_s2 = quantize_bank(self.raw_s2)
        return self

    def save(self, path):
        """npz cache; bf16 stored as a uint16 bit view (npz has no bf16).
        Caches hold the full-precision banks (quantize after loading, so
        one cache serves both modes) and the live rows only: tombstoned
        and free slots are compacted out. The JAX package reads and writes
        the same layout."""
        if isinstance(self.raw_s1, Int8Bank) or \
                isinstance(self.raw_s2, Int8Bank):
            raise ValueError("save the index before quantize(): caches store "
                             "full-precision banks")
        live = sorted(self.pos.values())
        rows = torch.as_tensor(live, dtype=torch.long, device=self.device)
        arrs = {
            # str dtype (not object): load() stays allow_pickle=False, so a
            # tampered cache can never execute code
            "names": np.asarray([str(self.names[i]) for i in live]),
            "pooled_s1": self.pooled_s1[rows].float().cpu().numpy(),
            "raw_s1": _to_numpy(self.raw_s1[rows]),
            "fingerprint": np.asarray(json.dumps(self.fingerprint or {})),
        }
        if self.raw_s2 is not None:
            arrs["raw_s2"] = _to_numpy(self.raw_s2[rows])
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path, expect_fingerprint: dict | None = None,
             device=None) -> "ServingIndex":
        """Read a cache onto ``device`` (default 'cuda'). With
        ``expect_fingerprint``, every key present in both dicts must match
        and the cache must hold a fingerprint, else ValueError: a cache
        built from other weights, split or preprocessing never serves."""
        device = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            stored = (json.loads(str(z["fingerprint"]))
                      if "fingerprint" in z else {})
            if expect_fingerprint:
                bad = {k: (stored.get(k), v) for k, v in
                       expect_fingerprint.items()
                       if k in stored and stored[k] != v}
                if bad or not stored:
                    raise ValueError(
                        f"index cache {path} does not match the current "
                        f"configuration (mismatched: {sorted(bad)} or no "
                        "fingerprint recorded) — delete it or point "
                        "--index-cache elsewhere to rebuild")
            return cls(names=[str(n) for n in z["names"]],
                       pooled_s1=torch.from_numpy(z["pooled_s1"]).to(device),
                       raw_s1=_from_numpy(z["raw_s1"], device),
                       raw_s2=(_from_numpy(z["raw_s2"], device)
                               if "raw_s2" in z else None),
                       fingerprint=stored or None)


@torch.inference_mode()
def build_serving_index(stage1, s1_params, classic_dataset, *,
                        reranker=None, s2_params=None, batch_size: int = 16,
                        device=None) -> ServingIndex:
    """Embed the whole corpus with the stage-I ViT (raw + pooled) and, when
    a re-ranker is given, the stage-II ViT (raw), through
    ``retrieval/index.build_index``. ``s1_params`` / ``s2_params``: port
    state dicts to load into the models, or None."""
    device = resolve_device(device)
    stage1 = bind_module(stage1, s1_params, device)
    raw1, pooled, names = build_index(
        classic_dataset,
        lambda im: stage1.embed_images(im, pool_and_normalize=True),
        batch_size, pooled=True, device=device)
    raw2 = None
    if reranker is not None:
        reranker = bind_module(reranker, s2_params, device)
        raw2, names2 = build_index(classic_dataset, reranker.embed_images,
                                   batch_size, device=device)
        if names2 != names:
            raise ValueError("the two index passes saw different images")
    return ServingIndex(names=names, pooled_s1=pooled, raw_s1=raw1,
                        raw_s2=raw2)


class CIRServingEngine:
    """Batched request handler.

    q_pad: the wave width; requests beyond it are handled in successive
    waves. ``s1_params`` / ``s2_params``: port state dicts to load into the
    models, or None to keep their weights. The models and the index move
    to ``device`` (default 'cuda'). ``transform``: PIL image -> [H, W, 3]
    float32, for requests that upload their reference image
    (``cli/serve.py``)."""

    def __init__(self, stage1, s1_params, tokenizer, index: ServingIndex, *,
                 text_len: int = 40, q_pad: int = 4,
                 reranker=None, s2_params=None, rerank_k: int = 50,
                 max_k: int = 100, transform=None, device=None):
        self.device = resolve_device(device)
        self.stage1 = bind_module(stage1, s1_params, self.device)
        self.reranker = (None if reranker is None
                         else bind_module(reranker, s2_params, self.device))
        self.tokenizer = tokenizer
        self.index = index.to(self.device)
        self.text_len = text_len
        self.q_pad = q_pad
        self.transform = transform
        # one re-rank depth for every wave, whichever requests share it
        # (per-request k only trims the output); recomputed on corpus
        # updates, so a corpus grown past its first size re-ranks at the
        # full requested depth
        self._req_rerank_k = rerank_k
        self.rerank_k = min(rerank_k, max(1, index.n_valid - 1))
        # +1 head-room so removing the reference still leaves max_k
        # results; bounded by capacity (not n_valid) so that additions
        # never shrink the ranking depth
        self._req_max_k = max_k
        self.max_k = min(max_k + 1, index.capacity)

    def warmup(self):
        """One request before traffic arrives, at the serving shapes (the
        full-depth ranking and the [q_pad, rerank_k] stage-II grid): on
        the card its first launch builds the attention kernels
        (``ops/build.py``), so the first real request pays no nvcc time."""
        first = next(iter(self.index.pos))
        req = ServeRequest(caption="warm up", reference=first,
                           k=max(1, min(self.index.n_valid - 1,
                                        self._req_max_k)))
        self.handle([req])

    # ---- incremental corpus updates ----------------------------------------

    @torch.inference_mode()
    def add_images(self, names: list[str], images) -> None:
        """Index new corpus images without a rebuild: embed them with the
        stage-I (and stage-II) ViT, one image at a time as an uploaded
        reference is, and write them into free bank slots. Visible to the
        next request."""
        images = np.asarray(images, np.float32)
        if images.ndim != 4 or len(names) != images.shape[0]:
            raise ValueError("images must be [len(names), H, W, 3] "
                             "preprocessed float32")
        pooled, raw1, raw2 = [], [], []
        for i in range(len(names)):
            img = torch.from_numpy(images[i:i + 1]).to(self.device)
            r1, pl = self.stage1.embed_images(img, pool_and_normalize=True)
            raw1.append(r1[0])
            pooled.append(pl[0])
            if self.reranker is not None:
                raw2.append(self.reranker.embed_images(img)[0])
        self.index.add_rows(names, torch.stack(pooled), torch.stack(raw1),
                            torch.stack(raw2) if raw2 else None)
        self.max_k = min(self._req_max_k + 1, self.index.capacity)
        self.rerank_k = min(self._req_rerank_k,
                            max(1, self.index.n_valid - 1))

    def remove_images(self, names: list[str]) -> None:
        """Tombstone corpus images: absent from rankings at once; later
        additions reuse their slots."""
        self.index.remove_rows(names)
        self.rerank_k = min(self._req_rerank_k,
                            max(1, self.index.n_valid - 1))

    # ---- internals ---------------------------------------------------------

    def _validate(self, r: ServeRequest):
        """Fail fast with actionable messages (one bad request must not cost
        its wave-mates anything: see MicroBatcher's per-request retry)."""
        if not r.caption or not isinstance(r.caption, str):
            raise ValueError("caption (non-empty string) is required")
        if r.reference is None and r.reference_image is None:
            raise ValueError("either reference (a corpus image name) or "
                             "reference_path/reference_image is required")
        if r.reference is not None and r.reference not in self.index.pos:
            raise ValueError(f"unknown reference {r.reference!r}: not in the "
                             f"indexed corpus ({len(self.index.names)} "
                             "images)")
        if r.k < 1:
            raise ValueError(f"k must be >= 1, got {r.k}")
        if r.k > self._req_max_k:
            raise ValueError(
                f"k={r.k} exceeds this server's compiled ranking depth "
                f"max_k={self._req_max_k}; restart with a larger --max-k")

    def _ref_feats(self, requests, bank, embed_fn):
        """[B, M, W] reference features: corpus rows by name, or embeds of
        the requests' own images (once a request, so a wave's padding
        repeats never run the ViT again)."""
        dtype = (torch.bfloat16 if isinstance(bank, Int8Bank)
                 else bank.dtype)
        rows = [0 if r.reference_image is not None else self.index.pos[
            r.reference] for r in requests]
        feats = take_rows(bank, torch.as_tensor(rows, device=self.device),
                          dtype=dtype)
        embedded: dict[int, torch.Tensor] = {}
        for i, r in enumerate(requests):
            if r.reference_image is not None:
                if id(r) not in embedded:
                    img = torch.from_numpy(np.asarray(
                        r.reference_image, np.float32))[None]
                    embedded[id(r)] = embed_fn(img.to(self.device))[0].to(
                        dtype)
                feats[i] = embedded[id(r)]
        return feats

    @torch.inference_mode()
    def handle(self, requests: list[ServeRequest]) -> list[ServeResult]:
        for r in requests:
            self._validate(r)
        out: list[ServeResult] = []
        for start in range(0, len(requests), self.q_pad):
            out.extend(self._handle_wave(requests[start:start + self.q_pad]))
        return out

    def _handle_wave(self, requests) -> list[ServeResult]:
        """One wave; its host work and its waits on the device are the
        phase spans 'serve.tokenize', 'serve.stage1.wait',
        'serve.assemble', 'serve.rerank.plan', 'serve.rerank.wait',
        'serve.rerank.finish' and 'serve.merge' (``runtime/tracing``)."""
        n = len(requests)
        with tracing.trace_phase("serve.tokenize"):
            padded = list(requests) + [requests[0]] * (self.q_pad - n)
            ids, mask = self.tokenizer.encode([r.caption for r in padded],
                                              self.text_len,
                                              set_enc_token=True)
        ref1 = self._ref_feats(padded, self.index.raw_s1,
                               self.stage1.embed_images)
        preds = self.stage1.fuse(ref1, torch.from_numpy(ids).to(self.device),
                                 torch.from_numpy(mask).to(self.device))
        sims, idx = cosine_topk(preds, self.index.pooled_s1, self.max_k,
                                self.index.valid)
        sims, idx = sims[:n].float(), idx[:n]
        with tracing.trace_phase("serve.stage1.wait"):
            sims = sims.cpu().numpy()
            idx = idx.cpu().numpy()

        with tracing.trace_phase("serve.assemble"):
            results = []
            names = self.index.names
            for qi, r in enumerate(requests):
                ranked = [(names[j], float(s))
                          for j, s in zip(idx[qi], sims[qi])
                          if np.isfinite(s)  # skip tombstoned/free slots
                          and (r.reference is None
                               or names[j] != r.reference)]
                ranked = ranked[:r.k]
                results.append(ServeResult(ranking=[nm for nm, _ in ranked],
                                           scores=[s for _, s in ranked]))

        if self.reranker is not None:
            self._rerank_wave(requests, results)
        return results

    def _rerank_wave(self, requests, results):
        """Stage II re-scores each query's head in one [q_pad, rerank_k]
        pair grid (a co-batched small-k request never changes another
        request's re-rank depth); the tail keeps stage-I order. Per-request
        depth is min(rerank_k, len(ranking)); shorter rows are padded with
        their last candidate and the padded scores discarded. Requests
        whose reference is an uploaded image keep their stage-I order: z_t
        fusion needs the reference's corpus features."""
        with tracing.trace_phase("serve.assemble"):
            rows = [qi for qi, r in enumerate(requests)
                    if r.reference is not None and results[qi].ranking]
            kk = self.rerank_k
            depths = [min(kk, len(results[qi].ranking)) for qi in rows]
            topk_names = np.asarray(
                [[results[qi].ranking[min(j, d - 1)] for j in range(kk)]
                 for qi, d in zip(rows, depths)], dtype=object)
        if not rows:
            return
        out = rerank(
            self.stage1, None, self.reranker, None, self.tokenizer,
            captions=[requests[qi].caption for qi in rows],
            reference_names=[requests[qi].reference for qi in rows],
            topk_names=topk_names,
            index_feats=self.index.raw_s2, index_names=self.index.names,
            text_len=self.text_len, q_batch=self.q_pad, device=self.device,
            trace_as="serve.rerank")
        with tracing.trace_phase("serve.merge"):
            for oi, (qi, d) in enumerate(zip(rows, depths)):
                res = results[qi]
                order = [j for j in out.order[oi] if j < d]
                head = [res.ranking[j] for j in order]
                head_scores = [float(out.logits[oi, j]) for j in order]
                res.ranking = head + res.ranking[d:]
                res.scores = head_scores + res.scores[d:]
                res.reranked = d


class _AdminOp:
    """Queue marker: a corpus mutation to run on the worker between waves."""

    def __init__(self, fn):
        self.fn = fn


class MicroBatcher:
    """Thread-safe request coalescing: concurrent callers block on their own
    event while one worker thread drains the queue in waves of up to
    q_pad. The worker's phase spans (``runtime/tracing``) are
    'batcher.idle' (blocked on an empty queue) and 'batcher.gather' (the
    straggler window); each wave is the layer span 'serve.wave'."""

    def __init__(self, engine: CIRServingEngine, window_ms: float = 3.0):
        self.engine = engine
        self.window = window_ms / 1000.0
        self.q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # taken around every (check _stop, enqueue) pair and by close()
        # around _stop.set(): once close() holds it, no new item can slip
        # into the queue after the worker's final drain, so no caller is
        # ever left blocked on ev.wait()
        self._submit_lock = threading.Lock()
        self._requests = 0
        self._waves = 0
        self._errors = 0
        self._queue_wait_s = 0.0
        self._wave_s = 0.0
        self._device_wait_s = 0.0
        self._worker_s: dict = {}  # the worker's phase totals
        self._latencies: list[float] = []  # rolling, last 1024
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def stats(self) -> dict:
        """Serving counters: totals, wave occupancy, latency percentiles
        (seconds, over the last 1024 requests), and cumulative seconds:
        ``queue_wait_s`` (each request, from its enqueue to the start of
        its wave), ``wave_s`` (each wave's ``engine.handle``),
        ``device_wait_s`` (the waves' ``serve.*.wait`` spans, the host
        blocked on the device) and ``idle_s`` (the worker blocked on an
        empty queue)."""
        with self._lock:
            lats = sorted(self._latencies)
            n = len(lats)
            pct = (lambda p: lats[min(int(p * n), n - 1)]) if n else \
                (lambda p: 0.0)
            return {
                "requests": self._requests,
                "waves": self._waves,
                "errors": self._errors,
                "mean_wave_occupancy": round(
                    self._requests / self._waves, 3) if self._waves else 0.0,
                "latency_p50_s": round(pct(0.50), 4),
                "latency_p95_s": round(pct(0.95), 4),
                "latency_p99_s": round(pct(0.99), 4),
                "queue_wait_s": self._queue_wait_s,
                "wave_s": self._wave_s,
                "device_wait_s": self._device_wait_s,
                "idle_s": self._worker_s.get("batcher.idle", 0.0),
            }

    def submit(self, request: ServeRequest) -> ServeResult:
        t0 = time.perf_counter()
        ev = threading.Event()
        slot: dict = {}
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("server is shutting down")
            slot["enqueued"] = time.perf_counter()
            self.q.put((request, ev, slot))
        ev.wait()
        with self._lock:
            self._latencies.append(time.perf_counter() - t0)
            if len(self._latencies) > 1024:
                del self._latencies[:512]
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def submit_admin(self, fn):
        """Run a corpus mutation on the worker thread, strictly between
        waves: index updates never interleave with a wave's result
        assembly."""
        ev = threading.Event()
        slot: dict = {}
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("server is shutting down")
            self.q.put((_AdminOp(fn), ev, slot))
        ev.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _run(self):
        with tracing.collect(self._worker_s):
            while not self._stop.is_set():
                try:
                    with tracing.trace_phase("batcher.idle"):
                        first = self.q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if isinstance(first[0], _AdminOp):
                    self._run_admin(first)
                    continue
                batch = [first]
                admin_item = None
                with tracing.trace_phase("batcher.gather"):
                    # absolute deadline: the first request waits at most
                    # one window however many stragglers trickle in
                    # behind it
                    deadline = time.monotonic() + self.window
                    while len(batch) < self.engine.q_pad:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            item = self.q.get(timeout=remaining)
                        except queue.Empty:
                            break
                        if isinstance(item[0], _AdminOp):
                            # flush the wave first, then mutate
                            admin_item = item
                            break
                        batch.append(item)
                self._serve_batch(batch)
                if admin_item is not None:
                    self._run_admin(admin_item)
        self._fail_queued()

    def _fail_queued(self):
        """Fail anything still queued instead of leaving its caller
        blocked on ev.wait() forever."""
        while True:
            try:
                _, ev, slot = self.q.get_nowait()
            except queue.Empty:
                break
            slot["error"] = RuntimeError("server is shutting down")
            ev.set()

    def _run_admin(self, item):
        op, ev, slot = item
        try:
            slot["result"] = op.fn()
        except Exception as e:  # reported to the admin caller
            slot["error"] = e
        ev.set()

    def _serve_batch(self, batch):
        start = time.perf_counter()
        reqs = [b[0] for b in batch]
        with self._lock:
            self._requests += len(reqs)
            self._waves += 1
            self._queue_wait_s += sum(start - slot["enqueued"]
                                      for _, _, slot in batch)
        wave: dict = {}
        with tracing.collect(wave), tracing.layer_span("serve.wave"):
            try:
                outcomes = [("result", res)
                            for res in self.engine.handle(reqs)]
            except Exception:
                # one bad request must not fail its wave-mates: retry each
                # request alone, so only the offender errors
                outcomes = []
                for req in reqs:
                    try:
                        outcomes.append(("result",
                                         self.engine.handle([req])[0]))
                    except Exception as e:  # reported to its caller
                        outcomes.append(("error", e))
        with self._lock:
            self._errors += sum(key == "error" for key, _ in outcomes)
            self._wave_s += wave["serve.wave"]
            self._device_wait_s += sum(
                v for name, v in wave.items()
                if name.startswith("serve.") and name.endswith(".wait"))
        for (_, ev, slot), (key, value) in zip(batch, outcomes):
            slot[key] = value
            ev.set()

    def close(self):
        with self._submit_lock:
            self._stop.set()
        self.worker.join(timeout=5)
        # items enqueued before _stop became visible but after the worker's
        # final drain (or if the worker died)
        self._fail_queued()
