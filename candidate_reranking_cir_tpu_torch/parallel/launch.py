"""Starting a world of ranks from one process.

``run_world(fn, world, device=...)`` spawns ``world`` processes (the
'spawn' start method: each imports ``fn``'s module afresh), joins them to
one process group through a ``file://`` store in a fresh temporary
directory (no TCP port, so concurrent worlds never collide), runs
``fn(*args)`` in each and returns the ranks' results in rank order.
'cuda' runs one NCCL rank a card; 'cpu' runs gloo ranks with one thread
each. A rank that raises fails the world with its traceback; a world that
does not finish within ``timeout_s`` (a mismatched collective hangs) is
killed and fails, as does one whose rank dies. Arguments and results
travel pickled by value (tensors included), not through shared memory.

This is the port's form of the JAX package's re-exec onto virtual CPU
devices (``__graft_entry__.dryrun_multichip``), of ``--mesh auto``'s one
rank a card, and of the tests' four-rank gloo worlds.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from candidate_reranking_cir_tpu_torch.parallel.mesh import (
    init_process_group,
)


def _rank_main(rank, world, device, init_method, timeout_s, payload,
               results):
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        fn, args = pickle.loads(payload)
        init_process_group(rank, world, device=device,
                           init_method=init_method, timeout_s=timeout_s)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except SystemExit as e:  # a CLI's exit: its code is the rank's result
        ok = e.code in (None, 0)
        results.put((rank, ok, None if ok else f"exit code {e.code}"))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world: int, *, device: str = "cpu", args: tuple = (),
              timeout_s: float = 60.0) -> list:
    """Run ``fn(*args)`` on each of ``world`` spawned ranks; returns their
    results in rank order. ``fn`` must be importable by module path, and
    its arguments and results picklable."""
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} cards; "
                           f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        payload = pickle.dumps((fn, args))
        procs = [ctx.Process(target=_rank_main, args=(
            rank, world, device, init_method, timeout_s, payload, results))
            for rank in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {world} did not finish in {timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks died: exit codes {dead}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = pickle.loads(out) if out is not None else None
        finally:
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]
