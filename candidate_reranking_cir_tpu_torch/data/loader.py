"""Host-side batch loading with background workers and prefetch (an own
copy of the JAX package's ``data/loader.py``).

A thread-pool sample loader and a small prefetch queue, so image decoding
overlaps the card's work. The trailing partial batch is dropped in
training, as in the JAX package, so every step sees the same batch shape.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def _collate(samples: list[dict], keys: list[str]) -> dict:
    out = {}
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


class BatchLoader:
    """Iterates dict samples from a dataset in fixed-size batches.

    skip_errors datasets may return None; those are dropped and backfilled
    from subsequent indices so every batch stays full (the reference instead
    shrinks the batch, utils.py:99-106).

    ``shard=(rank, size)``: the loader of one rank of a data-parallel mesh.
    The batches are the one-process loader's, in its order (the same
    permutation from ``seed`` and the epoch), and this rank loads only its
    contiguous block of batch_size / size samples of each. A sample the
    dataset drops would shift the other ranks' blocks, so under a shard
    it raises.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, workers: int = 8, drop_last: bool = True,
                 shard: tuple[int, int] | None = None):
        if shard is not None and (batch_size % shard[1] or not drop_last):
            raise ValueError(f"a sharded loader drops the last batch and "
                             f"splits each of {batch_size} samples over "
                             f"{shard[1]} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.workers = workers
        self.drop_last = drop_last
        self.shard = shard
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        if self.shard is not None:
            yield from self._iter_shard(order)
            return

        keys = None
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            it = pool.map(self.dataset.__getitem__, order, chunksize=4)
            batch: list[dict] = []
            for sample in it:
                if sample is None:
                    continue
                if keys is None:
                    keys = list(sample.keys())
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield _collate(batch, keys)
                    batch = []
            if batch and not self.drop_last:
                yield _collate(batch, keys)

    def _iter_shard(self, order) -> Iterator[dict]:
        rank, size = self.shard
        local = self.batch_size // size
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for i in range(len(self)):
                lo = i * self.batch_size + rank * local
                samples = list(pool.map(self.dataset.__getitem__,
                                        order[lo:lo + local]))
                if any(s is None for s in samples):
                    raise ValueError("a sharded loader cannot backfill a "
                                     "dropped sample")
                yield _collate(samples, list(samples[0].keys()))


def prefetch(iterator, size: int = 2):
    """Run the upstream iterator in a thread, keeping `size` batches ready."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
