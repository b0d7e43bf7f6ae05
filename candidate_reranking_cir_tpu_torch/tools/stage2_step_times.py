"""Per-step times of the stage-II training path, to look for stalls.

    python -m candidate_reranking_cir_tpu_torch.tools.stage2_step_times \
        [--steps N] [--profiled M] [--tag TEXT]

Runs on one CUDA card, from the repository root: it takes the path's
set-up from ``chip_smoke.py``'s training phase (``make_stage2_train_step``
at full width, bf16, remat, B = 16, fed by ``BatchLoader`` over in-memory
CIRR-shaped triplets). One warm-up step, then N counted steps; for each it
prints the wall seconds, the seconds spent waiting on the loader (outside
the step), the process's CPU seconds, its minor and major page faults, and
the caching allocator's new device segments and allocation retries over
the step. Then M more steps, each under ``torch.profiler``: wall, device
busy and idle milliseconds, and, for a step over twice the median wall
time of the counted steps, the host operations that took the most time.
The last line is one JSON object of it all.
"""
from __future__ import annotations

import argparse
import json
import resource
import statistics
import sys
import time

import torch


def _allocator() -> tuple[int, int]:
    stats = torch.cuda.memory_stats()
    return (stats.get("segment.all.allocated", 0),
            stats.get("num_alloc_retries", 0))


def _profiled_step(run) -> dict:
    """One step under torch.profiler: wall, device-busy and idle ms, and
    the ten host operations with the most self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, host = 0.0, []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            busy_us += us if us is not None else evt.self_cuda_time_total
        else:
            host.append((evt.self_cpu_time_total / 1e3, evt.key))
    host.sort(reverse=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
            "idle_ms": wall_ms - busy_us / 1e3,
            "top_host_ms": [[round(ms, 3), key] for ms, key in host[:10]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--profiled", type=int, default=4)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage2_step_times: CUDA is not available")

    import chip_smoke as cs
    from candidate_reranking_cir_tpu_torch.config import TrainConfig
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage2_train_step,
    )

    tag = f"[steps{' ' + args.tag if args.tag else ''}]"
    vocab = build_test_vocab()
    words = [w for w in vocab if w.isalpha() and len(w) > 1]
    tok = WordPieceTokenizer(vocab)
    cfg1, cfg2 = cs.train_configs(dropout=True)
    torch.manual_seed(cs.SEED + 3)
    s1 = RetrievalModel(cfg1, dtype=torch.bfloat16, device="cuda")
    s2 = RerankerModel(cfg2, dtype=torch.bfloat16, device="cuda")
    opt, _ = make_optimizer(TrainConfig(), s2, 1000,
                            freeze_prefixes=("visual_encoder",))
    step = make_stage2_train_step(s1, s2, opt)
    gen = torch.Generator().manual_seed(cs.SEED)
    batches = cs.train_batches(tok, words, 1 + args.steps + args.profiled,
                               cs.TRAIN_B)
    t0 = time.perf_counter()
    step(next(batches), gen)
    torch.cuda.synchronize()
    print(f"{tag} warm-up step {time.perf_counter() - t0:.4f} s", flush=True)

    counted = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        r0, c0, a0 = (resource.getrusage(resource.RUSAGE_SELF),
                      time.process_time(), _allocator())
        step(batch, gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r1, c1, a1 = (resource.getrusage(resource.RUSAGE_SELF),
                      time.process_time(), _allocator())
        row = {"wall_s": t2 - t1, "loader_wait_s": t1 - t0,
               "cpu_s": c1 - c0, "minflt": r1.ru_minflt - r0.ru_minflt,
               "majflt": r1.ru_majflt - r0.ru_majflt,
               "new_segments": a1[0] - a0[0], "alloc_retries": a1[1] - a0[1]}
        counted.append(row)
        print(f"{tag} step {i}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    walls = [r["wall_s"] for r in counted]
    median = statistics.median(walls)
    pairs = cs.TRAIN_B * cs.TRAIN_B
    print(f"{tag} counted steps: median {median:.4f} s, min {min(walls):.4f}, "
          f"max {max(walls):.4f}; triplets/s over the mean "
          f"{pairs / statistics.mean(walls):.1f}", flush=True)

    profiled = []
    for i in range(args.profiled):
        batch = next(batches)
        rec = _profiled_step(lambda: step(batch, gen))
        slow = rec["wall_ms"] > 2e3 * median
        if not slow:
            rec.pop("top_host_ms")
        profiled.append(rec)
        print(f"{tag} profiled step {i}: wall {rec['wall_ms']:.1f} ms, busy "
              f"{rec['busy_ms']:.1f} ms, idle {rec['idle_ms']:.1f} ms"
              + (f"; top host ops {rec['top_host_ms']}" if slow else ""),
              flush=True)
    print(json.dumps({"tag": args.tag, "counted": counted,
                      "profiled": profiled}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
