#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            (from the repository root)

Phases, each printing its own lines:
1. device: requires CUDA; prints ``nvidia-smi`` name and power limit.
2. build: compiles the eval (K1-K4) and train (K5-K9) attention libraries
   from ``csrc/`` (one nvcc each, started together; sm_90a) and prints
   ptxas's register and spill lines, and the tensor-core kernels' (eval,
   K6, K8, and K7's and K9's two backward passes) registers, spills and
   shared memory, and the blocks of K8's kernel an SM holds at the
   stage-I widths.
3. kernels K1-K4 at the eval paths' shapes, bf16 and fp32 (bf16 runs the
   tensor-core kernel, with or without a bias, fp32 the fp32-FMA one; K3
   also at the stage-II eval path's narrowest call; K1 also at the stage-I
   eval path's ViT batch and at its most-launched and widest image-major
   MED shapes): max |error| against the plain PyTorch version,
   kernel / plain / SDPA times over back-to-back calls (CUDA events, as
   for every kernel) and the kernel/SDPA ratio (SDPA is a yardstick only;
   the port never calls it), the kernel's and SDPA's device-only times
   (CUDA-graph replays) and their ratio, and the least time the card
   could take (bytes over 3.35 TB/s or operations over the dtype's peak).
4. kernels K5-K7 at the training path's shape ([16, 640, 12, 64] queries
   x 577 keys, rate 0.1), bf16 and fp32 (bf16 K6 and K7 run the
   tensor-core kernels, fp32 the fp32-FMA ones): the K5 mask bit for bit
   against its plain version, K6's output and K7's dq, dk and dv (each
   against its own max) against theirs, times over back-to-back calls and
   device-only times (CUDA-graph replays), bounds, and SDPA with
   dropout_p=0.1 as a yardstick (same work, its own mask: no PyTorch call
   computes the same function).
5. eval path: stage-II re-rank evaluation through the port's
   ``evaluate_cirr_stage2`` entry at full ViT-B/16@384 + MED + dual-encoder
   width in bf16, random weights from a seed, on a synthetic CIRR-shaped
   corpus held in memory; launch counts per kernel (K1-K3 must be > 0);
   then a few hundred pairs re-scored in fp32 on the card and on the CPU,
   and in bf16 on the card and on the CPU (the card's bf16 logits held to
   the CPU's bf16 eager path within a share of the fp32 logits' spread; the
   bf16 re-rank order's top-1 and top-5 agreement with the fp32 order;
   the same check read against planted faults, noise in one K1, K2 or K3
   launch, which it must catch from a stated share of the launch's std);
   a profile of one scoring pass, which fails if any eval attention ran
   on the fp32-FMA kernel, or any K6-K9 on its fp32-FMA body (every
   profile is bf16; the training profiles fail alike).
6. training path: ``make_stage2_train_step`` at full width in bf16 with
   remat, B = 16, fed by the port's ``BatchLoader`` over in-memory
   CIRR-shaped triplets: 1 warm-up and 5 counted steps; step seconds and
   the cyclic garbage collector's seconds inside each (as on the stage-I
   path; every profile ends by collecting its own garbage, so no later
   timed step pays for it), triplets/s, losses, peak memory, launches per
   step (K6 and K7 at the
   counts the configuration implies); the dual encoder must change and the
   frozen ViT stay bit-identical; a profile of one step; then one fp32
   step at B = 2 on the card and on the CPU from the same weights.
7. kernels K8/K9 (head-folded train attention) at the stage-I MED
   cross-attention's shapes ([512, Lq, 768] queries x 577 keys, rate 0.1,
   Lq 32 and 40: the text widths the stage-I batches take), fp32 and
   bf16, with and without a key-mask bias: K8's output and K9's dq, dk
   and dv (each against its own max) against their plain versions, times
   over back-to-back calls, device-only times (CUDA-graph replays) and
   bounds (bf16 without a bias runs the tensor-core kernels).
8. stage-I training: ``make_stage1_train_step`` as the JAX trainer builds
   it (B = 512, frozen ViT-B/16@384, MED with remat, bf16, AdamW lr 2e-5
   and weight decay 0.05, pooled target features cached through
   ``build_index``, text-length buckets 'auto'), fed by ``BatchLoader``
   with the JAX benchmark's CIRR caption-length model (bench.py:223-231):
   1 warm-up and 4 counted steps; step seconds, stage-I train pairs/s,
   losses, peak memory, launches per step (K8 = 2 x layers and K9 =
   layers under remat, K6 = K7 = 0); every trained tensor but
   ``vision_proj`` must change and the ViT stay bit-identical; a profile
   of one step; then one fp32 step at B = 4 on the card and on the CPU
   with attention dropout 0.1 through the kernels' hash mask at every
   MED attention site.
9. stage-I eval path (last, so that its 4 GB corpus is not in the
   training paths' way): ``evaluate_cirr_stage1`` at CIRR-val scale (2,297
   corpus images, 4,181 queries, about 1.8 a reference image) at full
   width in bf16: the corpus embedded at batch 32, every query fused
   image-major (``q_batch`` 256, 'auto' text buckets, caption lengths of
   ``bench.py``'s CIRR model) and ranked over the whole corpus; seconds
   for index, fusion and ranking, stage-I queries/s, launches (K1 and K2
   > 0, K3 = 0), the fusion batches by (query group, width); the top-50
   file saved, read back and re-ranked by the stage-II engine on a few
   hundred queries; a few queries' fp32 predictions and top-50 lists on
   the card against the CPU; a profile of one fusion pass.
10. the trainer CLIs (``cli/stage1_train``, ``cli/validate``,
    ``cli/stage2_train``) on a CIRR tree of jpegs at 384 px, full width,
    bf16, through the entry points a user calls: stage I at B = 512 (two
    steps an epoch, two epochs, validation every epoch) uninterrupted,
    then cut by SIGTERM after its first step and resumed, which must give
    the uninterrupted run's step losses, final parameters and moments bit
    for bit; ``cli/validate`` on its ``blip_mean`` checkpoint to a top-50
    file; stage II at B = 16 (4 steps, remat 'dots') from that checkpoint,
    validating on the file. Prints each run's seconds, step losses and
    validation metrics, the checkpoints' sizes and the launches (K8, K9,
    K5 in the stage-I runs; K6, K7, K5 in stage II; K1-K3 in the
    validations, all must be > 0); then the peak memory and step seconds
    of stage-II steps with remat '' and 'dots'.
11. a JSON line of kernel figures (``launches_by_path`` adds phase 10's
    counts as "train_cli"), then the card's name and power limit, then
    the last line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero without the last line.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
N_IMAGES, N_QUERIES, TOPK, TEXT_LEN = 128, 256, 50, 40
N_CHECK_QUERIES = 4            # queries re-scored in fp32 on card and CPU
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# each of dq, dk, dv: max |error| over the reference's max |value|
GRAD_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-5}
FP32_CARD_VS_CPU_TOL = 1e-3    # summation order through 12+12 layers
BF16_VS_FP32_TOL = 0.1         # bf16 compute vs fp32 on the same weights
# bf16 card vs the bf16 eager path on the CPU (same weights, the pairs of
# the first BF16_CPU_QUERIES scored queries; bf16 on the CPU runs about 3x
# slower than fp32 there): max |logit diff| within this share of the fp32
# logits' std. Two correct bf16 paths differ by about a third of that std
# at these random weights (PERF.md section 6), near the bf16 error itself.
BF16_CARD_VS_CPU_REL_TOL = 0.5
BF16_CPU_QUERIES = 2
# controls for that check: the bf16 card re-score again with Gaussian noise
# of each share of a launch's output std added to the first launch, or to
# every launch, of K1, K2 and K3 (PERF.md section 6). The sound run reads
# 0.28-0.33 of the std; the check must fail the planted faults listed in
# BF16_CONTROL_CAUGHT as (every launch, kernel, share), which read 0.6 or
# more. Smaller faults (a tenth of the std in every K1 launch reads 0.497)
# pass it: it catches gross faults only.
BF16_CONTROL_SHARES_FIRST = (0.1, 0.3, 1.0)
BF16_CONTROL_SHARES_EVERY = (0.01, 0.03, 0.1)
BF16_CONTROL_CAUGHT = ((False, "K1", 1.0), (False, "K2", 1.0),
                       (False, "K3", 1.0), (True, "K2", 0.1),
                       (True, "K3", 0.1))
TRAIN_B, TRAIN_STEPS = 16, 5   # stage-II batch (B x B pairs), counted steps
TRAIN_SHAPE = (16, 640, 577, 12, 64)   # K6/K7 on the path: [E, Lq, M, H, D]
TRAIN_RATE, TRAIN_SEED = 0.1, 20261016
TRAIN_LOSS_TOL = 1e-4          # fp32 train step, card vs CPU
TRAIN_GRAD_REL_TOL = 1e-3      # max |grad diff| / max |grad|, same step
S1_B, S1_STEPS = 512, 4        # stage-I batch (B x B contrast), counted steps
S1_POOL = 256                  # in-memory image pool of the stage-I triplets
S1_SHAPE = (512, 577, 12, 64)          # K8/K9 on the path: [E, M, H, D]
S1_WIDTHS = (32, 40)           # Lq: the 'auto' buckets stage-I batches take
S1_CHECK_B = 4                 # fp32 stage-I step, card vs CPU
# stage-I eval at CIRR-val scale, the JAX benchmark's sizes (bench.py:549)
S1E_IMAGES, S1E_QUERIES = 2297, 4181
S1E_EMBED_BATCH, S1E_Q_BATCH = 32, 256
S1E_WARMUP = (64, 128)         # images, queries of the warm-up run
S1E_STAGE2_QUERIES = 256       # re-ranked by stage II from the top-K file
S1E_CHECK_QUERIES = 8          # fp32 predictions, card vs CPU
S1E_PRED_TOL = 1e-4            # fp32 predictions, card vs CPU
S1E_TIE_GAP = 1e-6             # top-50 lists may differ only at such gaps
# phase 10, the trainer CLIs on a jpeg CIRR tree: stage I at its default
# B = 512 (S1_B), two steps an epoch, two epochs; stage II at B = 16 over
# S2T_TRAIN triplets, re-ranking the stage-I top-S2T_K file
S1T_IMAGE_SIZE, S1T_IMAGES, S1T_TRAIN = 384, 256, 1024
S1T_VAL_IMAGES, S1T_VAL = 128, 256
S2T_TRAIN, S2T_B, S2T_K = 64, 16, 50
# a preempted and resumed stage-I run against the uninterrupted one: no
# kernel on the path accumulates with atomics (K9's row and key passes
# write dq and dk/dv once each), so the two must agree bit for bit
RESUME_TOL = 0.0
CSRC = "candidate_reranking_cir_tpu_torch/csrc"
# the records are bf16: K1-K4 on the tensor-core eval kernel, K6-K9 (no
# bias) on the tensor-core train kernels
SOURCES = {"K1": f"{CSRC}/attention_tc.cuh", "K2": f"{CSRC}/attention_tc.cuh",
           "K3": f"{CSRC}/attention_tc.cuh", "K4": f"{CSRC}/attention_tc.cuh",
           "K5": f"{CSRC}/attention_common.cuh",
           "K6": f"{CSRC}/attention_train_tc.cuh",
           "K7": f"{CSRC}/attention_train_tc.cuh",
           "K8": f"{CSRC}/attention_train_tc.cuh",
           "K9": f"{CSRC}/attention_train_tc.cuh"}
JAX_KERNELS = "candidate_reranking_cir_tpu/ops/pallas_attention.py"
JAX_TRAIN = "candidate_reranking_cir_tpu/ops/pallas_attention_train.py"
REPLACES = {"K1": f"{JAX_KERNELS}:220", "K2": f"{JAX_KERNELS}:132",
            "K3": f"{JAX_KERNELS}:122", "K4": f"{JAX_KERNELS}:236",
            "K5": f"{JAX_TRAIN}:61", "K6": f"{JAX_TRAIN}:114",
            "K7": f"{JAX_TRAIN}:135", "K8": f"{JAX_TRAIN}:382",
            "K9": f"{JAX_TRAIN}:414"}
MAIN_PATH_KERNELS = ("K1", "K2", "K3")
# profiler families of the attention kernels (see kernel_family); a bf16
# profile fails on any time in the FMA families
TC_FAMILY = "eval attention, tensor cores (bf16 K1-K4)"
FMA_EVAL_FAMILY = "eval attention, fp32 FMA (fp32 K1-K4)"
TC_K6_FAMILY = "train attention forward, tensor cores (K6)"
FMA_K6_FAMILY = "train attention forward, fp32 FMA (K6)"
TC_K7_FAMILY = "train attention backward, tensor cores (K7)"
FMA_K7_FAMILY = "train attention backward, fp32 FMA (K7)"
TC_K8_FAMILY = "train attention forward, folded, tensor cores (K8)"
FMA_K8_FAMILY = "train attention forward, folded, fp32 FMA (K8)"
TC_K9_FAMILY = "train attention backward, folded, tensor cores (K9)"
FMA_K9_FAMILY = "train attention backward, folded, fp32 FMA (K9)"
FMA_FAMILIES = (FMA_EVAL_FAMILY, FMA_K6_FAMILY, FMA_K7_FAMILY,
                FMA_K8_FAMILY, FMA_K9_FAMILY)
# K3's narrowest eval call (retrieval/rerank.py): the smallest q-bucket (4
# queries) x the smallest text bucket (8 tokens) = 32 rows per candidate,
# and max(64, pairs_per_call 256 x text_len 40 // 8) // 4 candidates
K3_NARROW = (max(64, 256 * TEXT_LEN // 8) // 4, 4 * 8)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def smi_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def time_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Mean device-only milliseconds per call: ``iters`` calls captured in
    one CUDA graph, replayed once to warm up, then one replay timed with
    CUDA events, so the host's launch time is out of the way. For
    functions that never wait on the host (the eval kernels, SDPA)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def check_grads(kid: str, label: str, grads, refs, dtype) -> float:
    """dq, dk, dv against their plain versions one at a time, each within
    GRAD_REL_TOL of its reference's max |value|; prints each error and
    fails on any; returns the largest absolute error."""
    parts, worst, ok = [], 0.0, True
    for nm, a, b in zip(("dq", "dk", "dv"), grads, refs):
        a, b = a.reshape(b.shape).float(), b.float()
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        ok = ok and bool(torch.isfinite(a).all()) \
            and err <= GRAD_REL_TOL[dtype] * top
        worst = max(worst, err)
        parts.append(f"{nm} {err:.3e} of max {top:.3e}")
    print(f"[kernel] {kid} {label}: max|err| {', '.join(parts)} (tol "
          f"{GRAD_REL_TOL[dtype]} x max)", flush=True)
    if not ok:
        fail(f"{kid} {label}: a gradient is off its plain version")
    return worst


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """The least time the card could take, ms: the bytes moved over the
    memory rate or the operations over the dtype's peak, the larger."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else \
        "operations"


# ---------------------------------------------------------------------------
# phase 3: kernels at the eval paths' shapes

def kernel_cases(stage1_cases: list):
    """(kernel id, label, e, lq, m, heads, folded, with key-mask bias);
    ``stage1_cases``: the stage-I eval path's K1 cases
    (``stage1_k1_cases``)."""
    return [
        ("K1", "ViT self-attention", 16, 577, 577, 12, True, False),
        ("K1", "MED cross-attention", 32, 40, 577, 12, True, False),
        *stage1_cases,
        ("K2", "masked text self-attention", 256, 40, 40, 12, False, True),
        ("K3", "candidate-major cross-attention", 8, 32 * 40, 577, 12,
         False, False),
        ("K3", "candidate-major cross-attention, narrowest call",
         *K3_NARROW, 577, 12, False, False),
        ("K4", "masked folded attention", 8, 160, 160, 12, True, True),
    ]


def run_kernel_case(kid, label, e, lq, m, h, folded, with_bias, dtype):
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
    from candidate_reranking_cir_tpu_torch.ops.attention import (
        make_additive_mask,
    )
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)
    d = 64
    shape_q = (e, lq, h * d) if folded else (e, lq, h, d)
    shape_kv = (e, m, h * d) if folded else (e, m, h, d)
    q = torch.randn(shape_q, generator=g, device="cuda").to(dtype)
    k = torch.randn(shape_kv, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape_kv, generator=g, device="cuda").to(dtype)
    bias = None
    if with_bias:
        lens = torch.randint(1, m + 1, (e,), generator=g, device="cuda")
        mask = (torch.arange(m, device="cuda")[None] < lens[:, None])
        bias = make_additive_mask(mask)                       # [E, 1, 1, M]

    def as4(x):
        return x.unflatten(-1, (h, d)) if folded else x

    if folded:
        kernel = lambda: ck.fused_attention_folded(q, k, v, bias, num_heads=h)
    else:
        kernel = lambda: ck.fused_attention(q, k, v, bias)
    bias3 = None if bias is None else bias[:, 0].expand(e, lq, m)
    plain = lambda: ck.attention_plain(as4(q), as4(k), as4(v), bias3)
    mask4 = None if bias is None else bias.to(dtype)
    library = lambda: F.scaled_dot_product_attention(
        as4(q).transpose(1, 2), as4(k).transpose(1, 2),
        as4(v).transpose(1, 2), attn_mask=mask4)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = (as4(out).float() - ref.float()).abs().max().item()
    if not torch.isfinite(out).all() or err > TOL[dtype]:
        fail(f"{kid} {label} {dtype}: max |err| {err:.3e} > {TOL[dtype]}")
    itemsize = q.element_size()
    n_bytes = (q.numel() * 2 + k.numel() + v.numel()) * itemsize \
        + (0 if bias is None else bias.numel() * 4)
    b_ms, b_by = bound(n_bytes, 4 * e * h * lq * m * d, dtype)
    # ms, plain_ms and library_ms: CUDA events over back-to-back calls, as
    # for every other kernel, the host's launch time included where it
    # exceeds the device's; *device_ms: graph replays, device time only
    rec = {"name": kid, "label": label, "dtype": str(dtype).split(".")[-1],
           "shape": [e, lq, m, h, d], "max_abs_err": err,
           "ms": time_ms(kernel), "plain_ms": time_ms(plain),
           "library_ms": time_ms(library), "device_ms": graph_ms(kernel),
           "library_device_ms": graph_ms(library),
           "bound_ms": b_ms, "bound_by": b_by}
    ratio = rec["ms"] / rec["library_ms"]
    device_ratio = rec["device_ms"] / rec["library_device_ms"]
    route = "tensor cores" if ck.uses_tensor_cores(dtype) else "fp32 FMA"
    print(f"[kernel] {kid} {label} {rec['dtype']} ({route}) q/k/v "
          f"{list(shape_q)} x {m} keys{' +mask' if with_bias else ''}: "
          f"max|err| {err:.3e} (tol {TOL[dtype]}), kernel {rec['ms']:.4f} "
          f"ms, plain {rec['plain_ms']:.4f} ms, sdpa "
          f"{rec['library_ms']:.4f} ms, kernel/sdpa {ratio:.2f}x; device "
          f"only: kernel {rec['device_ms']:.4f} ms, sdpa "
          f"{rec['library_device_ms']:.4f} ms, kernel/sdpa "
          f"{device_ratio:.2f}x; bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the train kernels at the training path's shape
def run_train_kernel_cases(dtype) -> dict:
    """K5, K6, K7 at TRAIN_SHAPE in ``dtype``: error against the plain
    versions, kernel / plain / SDPA-yardstick times and bounds."""
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    import torch.nn.functional as F

    e, lq, m, h, d = TRAIN_SHAPE
    rate, seed = TRAIN_RATE, TRAIN_SEED
    name = str(dtype).split(".")[-1]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q, gout = (torch.randn(e, lq, h, d, generator=g, device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn(e, m, h, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    isz = q.element_size()
    recs = {}

    # K5: the kernel-written mask against the plain hash, bit for bit
    buf = torch.empty(lq, m, dtype=torch.uint8, device="cuda")
    mismatches = 0
    for s_, b_, h_ in ((seed, 0, 0), (seed, e - 1, h - 1),
                       (-2 ** 31, 7, 3), (2 ** 31 - 1, 9_000_000, 5)):
        out = tat.write_keep_mask(buf, s_, b_, h_, rate)
        ref = tat.keep_mask(s_, b_, h_, lq, m, rate, device="cuda")
        mismatches += int((out.bool() != ref).sum())
    torch.cuda.synchronize()
    print(f"[kernel] K5 keep-mask [{lq}, {m}] x 4 (seed, entry, head): "
          f"{mismatches} mismatches", flush=True)
    if mismatches:
        fail(f"K5 mask differs from its plain version in {mismatches} places")
    # one byte written per element; about 14 integer/float operations per
    # element (one lowbias32 hash, the index, the compare), counted against
    # the CUDA cores' fp32 rate, the table's nearest non-tensor peak
    b_ms, b_by = bound(lq * m, 14 * lq * m, torch.float32)
    recs["K5"] = {"name": "K5", "dtype": name, "shape": [lq, m],
                  "max_abs_err": float(mismatches),
                  "ms": time_ms(lambda: tat.write_keep_mask(buf, seed, 0, 0,
                                                            rate)),
                  "plain_ms": time_ms(lambda: tat.keep_mask(
                      seed, 0, 0, lq, m, rate, device="cuda")),
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}

    # K6
    fwd = lambda: tat._kernel_fwd(q, k, v, None, seed, rate)
    plain_fwd = lambda: tat.attention_train_plain(q, k, v, None, seed, rate)
    out = fwd()
    torch.cuda.synchronize()
    err6 = (out.float() - plain_fwd().float()).abs().max().item()
    if not torch.isfinite(out).all() or err6 > TOL[dtype]:
        fail(f"K6 {name}: max |err| {err6:.3e} > {TOL[dtype]}")
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, gout))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  dropout_p=rate)
    b_ms, b_by = bound(2 * (q.numel() + k.numel()) * isz,
                       4 * e * h * lq * m * d, dtype)
    # no PyTorch call computes K6/K7's function (the mask differs), so
    # library_ms is null; SDPA with dropout is kept as a yardstick
    recs["K6"] = {"name": "K6", "dtype": name, "shape": list(TRAIN_SHAPE),
                  "max_abs_err": err6, "ms": time_ms(fwd),
                  "device_ms": graph_ms(fwd),
                  "plain_ms": time_ms(plain_fwd), "library_ms": None,
                  "sdpa_own_mask_ms": time_ms(sdpa),
                  "bound_ms": b_ms, "bound_by": b_by}

    # K7
    bwd = lambda: tat._kernel_bwd(q, k, v, None, seed, gout, rate)
    plain_bwd = lambda: tat.attention_train_bwd_plain(q, k, v, None, seed,
                                                      gout, rate)
    grads = bwd()
    torch.cuda.synchronize()
    err7 = check_grads("K7", f"{name} {list(TRAIN_SHAPE)}", grads,
                       plain_bwd(), dtype)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
        torch.autograd.grad(o, (qg, kg, vg), gt)

    b_ms, b_by = bound((3 * q.numel() + 4 * k.numel()) * isz,
                       10 * e * h * lq * m * d, dtype)
    recs["K7"] = {"name": "K7", "dtype": name, "shape": list(TRAIN_SHAPE),
                  "max_abs_err": err7, "ms": time_ms(bwd),
                  "device_ms": graph_ms(bwd),
                  "plain_ms": time_ms(plain_bwd), "library_ms": None,
                  "sdpa_own_mask_ms": time_ms(sdpa_fwd_bwd),
                  "bound_ms": b_ms, "bound_by": b_by}
    routes = {"K6": tat.fwd_uses_tensor_cores(dtype, None, False),
              "K7": tat.bwd_uses_tensor_cores(dtype, None, False)}
    for kid in ("K6", "K7"):
        r = recs[kid]
        route = "tensor cores" if routes[kid] else "fp32 FMA"
        print(f"[kernel] {kid} {name} ({route}) {list(TRAIN_SHAPE)} rate "
              f"{rate}: max|err| {r['max_abs_err']:.3e}, kernel "
              f"{r['ms']:.4f} ms, device only {r['device_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa(dropout_p={rate}"
              f"{', fwd+bwd' if kid == 'K7' else ''}; same work, its own "
              f"mask) {r['sdpa_own_mask_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    print(f"[kernel] K5 {name}: kernel {recs['K5']['ms']:.4f} ms, plain "
          f"{recs['K5']['plain_ms']:.4f} ms per [{lq}, {m}] mask", flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 5: the eval path

class Corpus:
    """'classic' dataset over in-memory [H, W, 3] images (CLIP-normalised
    scale), made from a seed; ``float32_draw`` draws them in float32
    directly (no float64 copy: the stage-I eval's stack is 4 GB)."""

    def __init__(self, n: int, size: int, rng, float32_draw: bool = False):
        self.index_names = [f"img{i:04d}" for i in range(n)]
        shape = (n, size, size, 3)
        self.images = (rng.standard_normal(shape, dtype=np.float32)
                       if float32_draw
                       else rng.normal(size=shape).astype(np.float32))

    def __len__(self):
        return len(self.index_names)

    def __getitem__(self, i):
        return {"name": self.index_names[i], "image": self.images[i]}


def make_queries(names: list[str], n_q: int, k: int, rng,
                 vocab_words: list[str]) -> list[dict]:
    """CIRR-shaped val triplets: a caption of 3-30 words (mostly short),
    6-member groups holding reference and target, and a stage-I top-K list
    holding the target in about 90% of rows."""
    out = []
    for _ in range(n_q):
        sel = rng.choice(len(names), size=6, replace=False)
        ref, tgt = names[sel[0]], names[sel[1]]
        members = [names[i] for i in sel]
        others = [nm for nm in names if nm not in (ref, tgt)]
        topk = list(rng.choice(others, size=k, replace=False))
        if rng.random() < 0.9:
            topk[int(rng.integers(0, k))] = tgt
        n_words = int(min(30, 3 + rng.geometric(0.12)))
        caption = " ".join(rng.choice(vocab_words, size=n_words))
        out.append({"reference_name": ref, "target_name": tgt,
                    "caption": caption, "group_members": members,
                    "topk_names": np.asarray(topk),
                    "topk_labels": np.asarray([nm == tgt for nm in topk])})
    return out


def eval_models():
    """The eval path's stage-I and stage-II models at full width in bf16
    on the card, random weights from SEED."""
    from candidate_reranking_cir_tpu_torch.config import (
        RerankerModelConfig,
        RetrievalModelConfig,
        TextEncoderConfig,
        vit_config,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    vit, text = vit_config("base", 384), TextEncoderConfig()
    cfg1 = RetrievalModelConfig(vit=vit, text=text, text_len=TEXT_LEN)
    cfg2 = RerankerModelConfig(vit=vit, text=text, text_len=TEXT_LEN)
    torch.manual_seed(SEED)
    return (RetrievalModel(cfg1, dtype=torch.bfloat16, device="cuda"),
            RerankerModel(cfg2, dtype=torch.bfloat16, device="cuda"))


def eval_workload(image_size: int):
    """The eval path's synthetic corpus, queries, tokenizer and the mask of
    queries whose top-K misses the target, made from SEED."""
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )

    rng = np.random.default_rng(SEED)
    corpus = Corpus(N_IMAGES, image_size, rng)
    vocab = build_test_vocab()
    words = [w for w in vocab if w.isalpha() and len(w) > 1]
    queries = make_queries(corpus.index_names, N_QUERIES, TOPK, rng, words)
    skip = np.asarray([not q["topk_labels"].any() for q in queries])
    return corpus, queries, WordPieceTokenizer(vocab), skip


def rescore(s1, s2, tok, bank, names, queries, skip, dtype, device,
            n_queries: int = N_CHECK_QUERIES):
    """The first ``n_queries`` scored queries' pairs re-scored by copies
    of s1 and s2 in ``dtype`` on ``device``: their logits and group
    logits, one row a query."""
    from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
        rerank_candidate_major,
    )

    sel = [i for i in range(len(queries)) if not skip[i]][:n_queries]
    m1 = type(s1)(s1.cfg, dtype=dtype, device=device)
    m1.load_state_dict(s1.state_dict())
    m2 = type(s2)(s2.cfg, dtype=dtype, device=device)
    m2.load_state_dict(s2.state_dict())
    t0 = time.perf_counter()
    r = rerank_candidate_major(
        m1, None, m2, None, tok, device=device, index_feats=bank.to(device),
        captions=[queries[i]["caption"] for i in sel],
        reference_names=[queries[i]["reference_name"] for i in sel],
        topk_names=np.stack([queries[i]["topk_names"] for i in sel]),
        index_names=names, text_len=TEXT_LEN,
        group_members=[queries[i]["group_members"] for i in sel],
        zt_batch=n_queries)
    logits = np.concatenate([r.logits, r.group_logits], axis=1)
    print(f"[check] {str(dtype).split('.')[-1]} {device}: {logits.size} "
          f"pairs in {time.perf_counter() - t0:.1f} s", flush=True)
    return logits


def main_path():
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
    from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
        rerank_candidate_major,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
        evaluate_cirr_stage2_datasets,
    )

    t0 = time.perf_counter()
    s1, s2 = eval_models()
    torch.cuda.synchronize()
    print(f"[main] random weights at full width (seed {SEED}): "
          f"{sum(p.numel() for p in s1.parameters()) / 1e6:.1f}M + "
          f"{sum(p.numel() for p in s2.parameters()) / 1e6:.1f}M params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    corpus, queries, tok, skip = eval_workload(s1.cfg.vit.image_size)
    kw = dict(k=TOPK, text_len=TEXT_LEN, batch_size=16, device="cuda")

    # warm-up on a few queries (cuBLAS handles, allocator), then the
    # counted run on all of them
    evaluate_cirr_stage2_datasets(s1, None, s2, None, tok, corpus,
                                  queries[:8], **kw)
    ck.reset_launch_counts()
    res = evaluate_cirr_stage2_datasets(s1, None, s2, None, tok, corpus,
                                        queries, **kw)
    launches = dict(ck.LAUNCHES)
    out = res.rerank
    n_pairs = int((~skip).sum()) * TOPK + N_QUERIES * 5
    rerank_s = res.seconds["zt"] + res.seconds["score"]
    print(f"[main] metrics {json.dumps(res.metrics)}", flush=True)
    print(f"[main] seconds {json.dumps(res.seconds)}; {n_pairs} scored "
          f"pairs; rerank {n_pairs / rerank_s:.1f} triplets/s "
          f"(z_t + scoring wall time)", flush=True)
    print(f"[main] launches {json.dumps(launches)}", flush=True)
    if not all(launches[kid] > 0 for kid in MAIN_PATH_KERNELS):
        fail(f"a main-path kernel was not launched: {launches}")
    if out.logits.shape != (N_QUERIES, TOPK) or \
            out.group_logits.shape != (N_QUERIES, 5):
        fail("unexpected logits shapes")
    if not np.isfinite(out.logits).all() or \
            not np.isfinite(out.group_logits).all():
        fail("non-finite logits")
    for key, val in res.metrics.items():
        if not 0.0 <= val <= 100.0:
            fail(f"metric {key} = {val} out of range")

    # re-score a few queries' pairs in fp32: card (kernels) vs CPU (plain)
    bank, names = build_index(corpus, s2.embed_images, 16, device="cuda")
    logits = {tag: rescore(s1, s2, tok, bank, names, queries, skip, dtype,
                           device, n)
              for tag, dtype, device, n in (
                  ("bf16 card", torch.bfloat16, "cuda", N_CHECK_QUERIES),
                  ("fp32 card", torch.float32, "cuda", N_CHECK_QUERIES),
                  ("fp32 cpu", torch.float32, "cpu", N_CHECK_QUERIES),
                  ("bf16 cpu", torch.bfloat16, "cpu", BF16_CPU_QUERIES))}
    d_fp32 = float(np.abs(logits["fp32 card"] - logits["fp32 cpu"]).max())
    d_bf16 = float(np.abs(logits["bf16 card"] - logits["fp32 cpu"]).max())
    spread = float(logits["fp32 cpu"].std())
    print(f"[check] max |logit diff| fp32 card vs fp32 cpu {d_fp32:.3e} "
          f"(tol {FP32_CARD_VS_CPU_TOL}); bf16 card vs fp32 cpu "
          f"{d_bf16:.3e} (tol {BF16_VS_FP32_TOL}); logit std {spread:.3e}",
          flush=True)
    if not d_fp32 <= FP32_CARD_VS_CPU_TOL:
        fail("fp32 card logits disagree with the CPU")
    if not d_bf16 <= BF16_VS_FP32_TOL:
        fail("bf16 card logits disagree with fp32 on the CPU")
    bf16_vs_bf16(logits, spread)
    bf16_controls(logits, spread, lambda: rescore(
        s1, s2, tok, bank, names, queries, skip, torch.bfloat16, "cuda",
        BF16_CPU_QUERIES))

    profile_device("scoring pass", lambda: rerank_candidate_major(
        s1, None, s2, None, tok, device="cuda", index_feats=bank,
        captions=[q["caption"] for q in queries],
        reference_names=[q["reference_name"] for q in queries],
        topk_names=np.stack([q["topk_names"] for q in queries]),
        index_names=names, text_len=TEXT_LEN, skip_mask=skip,
        group_members=[q["group_members"] for q in queries]))
    return launches


def bf16_vs_bf16(logits: dict, spread: float) -> None:
    """The bf16 card logits against the port's bf16 eager path on the CPU
    (the same weights, the pairs of the first BF16_CPU_QUERIES queries)
    within BF16_CARD_VS_CPU_REL_TOL of the fp32 logits' std, with the
    max and root-mean-square differences of each bf16 path from fp32 and
    from each other printed beside it; and how far the bf16 re-rank order
    agrees with the fp32 order: per query, the top-1 candidate and the
    top-5 set."""
    n = len(logits["bf16 cpu"])
    rows = {tag: x[:n] for tag, x in logits.items()}

    def diff(a: str, b: str) -> tuple[float, float]:
        d = rows[a] - rows[b]
        return float(np.abs(d).max()), float(np.sqrt(np.mean(d * d)))

    parts = []
    for a, b in (("bf16 card", "bf16 cpu"), ("bf16 card", "fp32 cpu"),
                 ("bf16 cpu", "fp32 cpu")):
        mx, rms = diff(a, b)
        parts.append(f"{a} vs {b} max {mx:.3e} ({mx / spread:.3f} std), "
                     f"rms {rms:.3e} ({rms / spread:.3f} std)")
    d = diff("bf16 card", "bf16 cpu")[0]
    tol = BF16_CARD_VS_CPU_REL_TOL * spread
    print(f"[check] bf16 logits over the first {n} queries' "
          f"{rows['bf16 cpu'].size} pairs: {'; '.join(parts)}; tol on bf16 "
          f"card vs bf16 cpu max "
          f"{BF16_CARD_VS_CPU_REL_TOL} x std = {tol:.3e}", flush=True)
    # the first TOPK columns are each query's re-ranked top-K candidates
    order = {tag: np.argsort(-x[:, :TOPK], axis=1, kind="stable")
             for tag, x in logits.items()}
    for tag in ("bf16 card", "bf16 cpu"):
        ref = order["fp32 cpu"][:len(order[tag])]
        top1 = int((order[tag][:, 0] == ref[:, 0]).sum())
        top5 = [len(set(a[:5]) & set(b[:5])) for a, b in zip(order[tag], ref)]
        print(f"[check] {tag} re-rank order vs fp32 cpu: top-1 equal in "
              f"{top1} of {len(ref)} queries; top-5 sets share "
              f"{top5} of 5", flush=True)
    if not d <= tol:
        fail("bf16 card logits disagree with the bf16 path on the CPU")


@contextlib.contextmanager
def planted_fault(kid: str, share: float, seed: int, every: bool):
    """Inside the block, the first launch of ``kid`` (or, with ``every``,
    each of its launches) returns its output plus Gaussian noise of
    ``share`` x that output's std: a known fault for a check to catch."""
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

    real = ck._kernel_forward
    planted = []

    def faulty(k, q4, k4, v4, bias3):
        out = real(k, q4, k4, v4, bias3)
        if k != kid or (planted and not every):
            return out
        gen = torch.Generator(device=out.device).manual_seed(
            seed + len(planted))
        planted.append(k)
        x = out.float()
        noise = torch.randn(x.shape, generator=gen, device=out.device)
        return (x + share * x.std() * noise).to(out.dtype)

    ck._kernel_forward = faulty
    try:
        yield planted
    finally:
        ck._kernel_forward = real
    if not planted:
        fail(f"planted fault: {kid} was not launched")


def bf16_controls(logits: dict, spread: float, rescore_bf16_card) -> None:
    """The bf16 card-vs-CPU check against planted faults: the bf16 card
    re-score again with noise in the first launch, or in every launch, of
    K1, K2 or K3, read as the check reads the sound run (max |card - CPU|
    in fp32 logit std, the rms beside it); fails unless every fault of
    BF16_CONTROL_CAUGHT reads above the check's tolerance."""
    ref = logits["bf16 cpu"]
    readings = {}
    for every, shares in ((False, BF16_CONTROL_SHARES_FIRST),
                          (True, BF16_CONTROL_SHARES_EVERY)):
        for kid in ("K1", "K2", "K3"):
            for share in shares:
                with planted_fault(kid, share, SEED + 7, every):
                    x = rescore_bf16_card()
                d = x[:len(ref)] - ref
                readings[(every, kid, share)] = (
                    float(np.abs(d).max()) / spread,
                    float(np.sqrt(np.mean(d * d))) / spread)
    for every in (False, True):
        print(f"[check] bf16 card vs bf16 cpu with a planted fault in "
              f"{'every' if every else 'the first'} launch (noise of a "
              f"share of the launch's output std; max, rms |diff| in fp32 "
              f"logit std; tol on the max {BF16_CARD_VS_CPU_REL_TOL}): "
              + "; ".join(
                  f"{kid} x {share}: {mx:.3f}, {rms:.3f}"
                  for (ev, kid, share), (mx, rms) in readings.items()
                  if ev == every), flush=True)
    missed = [key for key in BF16_CONTROL_CAUGHT
              if not readings[key][0] > BF16_CARD_VS_CPU_REL_TOL]
    if missed:
        fail(f"the bf16 check passed planted faults {missed}")


def kernel_family(name: str) -> str:
    if "attn_train_fwd_tc_kernel" in name:
        return TC_K6_FAMILY
    if "attn_train_bwd_tc_rows_kernel" in name \
            or "attn_train_bwd_tc_keys_kernel" in name:
        return TC_K7_FAMILY
    if "attn_train_fwd_folded_tc_kernel" in name:
        return TC_K8_FAMILY
    if "attn_train_fwd_folded_kernel" in name:
        return FMA_K8_FAMILY
    if "attn_bwd_tc_rows_kernel" in name or "attn_bwd_tc_keys_kernel" in name:
        return TC_K9_FAMILY
    if "attn_bwd_rows_folded_kernel" in name \
            or "attn_bwd_keys_folded_kernel" in name:
        return FMA_K9_FAMILY
    if "attn_train_fwd_kernel" in name:
        return FMA_K6_FAMILY
    if "attn_bwd_rows_kernel" in name or "attn_bwd_keys_kernel" in name:
        return FMA_K7_FAMILY
    if "attn_fwd_tc_kernel" in name:
        return TC_FAMILY
    if "attn_fwd_kernel" in name:
        return FMA_EVAL_FAMILY
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if name.startswith("Memcpy"):
        return "copies"
    return "elementwise, norms, gathers, optimizer"


def profile_device(label: str, run):
    """Device time by kernel family over one run of ``run`` (torch.profiler,
    CUPTI), and the device's idle share of its wall time. Every profiled
    run is bf16: it fails if an eval attention ran on the fp32-FMA kernel,
    or a K6, K7, K8 or K9 on its fp32-FMA body, instead of the tensor-core
    ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    families: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue  # host-side ops; their device time is their kernels'
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        name = evt.key
        kernels[name] = kernels.get(name, 0.0) + us
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + us
    busy = sum(families.values())
    if busy == 0.0:
        print(f"[profile] {label}: the profiler reported no device time: "
              "device breakdown not measured", flush=True)
        return
    parts = ", ".join(f"{k} {v / 1e3:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in sorted(families.items(),
                                         key=lambda kv: -kv[1]))
    print(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share "
          f"{100 * max(0.0, 1 - busy / wall_us):.1f}%; {parts}", flush=True)
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {us / 1e3:8.1f} ms  {name[:110]}", flush=True)
    # the profiler's event trees hold reference cycles: collect them here,
    # or the cyclic collector frees them inside a later timed step
    del prof
    t0 = time.perf_counter()
    freed = gc.collect()
    print(f"[profile] {label}: gc.collect() after the profile freed {freed} "
          f"objects in {time.perf_counter() - t0:.3f} s", flush=True)
    for fam in FMA_FAMILIES:
        if families.get(fam, 0.0) > 0.0:
            fail(f"{label}: {families[fam] / 1e3:.1f} ms of bf16 attention "
                 f"ran on an fp32-FMA kernel ({fam})")


# ---------------------------------------------------------------------------
# shared by the training paths

class GcClock:
    """Seconds the cyclic garbage collector has run since it was made,
    while registered in ``gc.callbacks``."""

    def __init__(self):
        self.seconds, self._t0 = 0.0, None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


def timed_steps(tag: str, step, batches, seed: int, n_steps: int):
    """One warm-up step, then ``n_steps`` counted steps with every launch
    count set to 0 just before them and read just after; prints the
    seconds the cyclic garbage collector took inside each counted step.
    Returns (seconds, losses, launches, peak GiB, text widths)."""
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

    gc.collect()  # earlier phases' garbage is not this path's
    loss = step(next(batches), seed)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up step: loss {float(loss):.4f}", flush=True)
    ck.reset_launch_counts()
    tat.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses, widths, gc_seconds = [], [], [], []
    clock = GcClock()
    gc.callbacks.append(clock)
    try:
        for _ in range(n_steps):
            batch = next(batches)
            widths.append(batch["input_ids"].shape[1])
            gc0 = clock.seconds
            t0 = time.perf_counter()
            loss = step(batch, seed)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            gc_seconds.append(clock.seconds - gc0)
            losses.append(float(loss))
    finally:
        gc.callbacks.remove(clock)
    print(f"[{tag}] cyclic gc seconds inside each counted step "
          f"{[round(x, 4) for x in gc_seconds]}", flush=True)
    launches = {**ck.LAUNCHES, **tat.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        fail(f"non-finite {tag} loss")
    return seconds, losses, launches, peak, widths


def check_trained(tag: str, model, trained0: dict, vit0: dict,
                  exempt: str = "") -> None:
    """Every trained tensor (but those under ``exempt``) changed; the frozen
    ViT is bit-identical."""
    unchanged = [n for n, p in model.named_parameters()
                 if p.requires_grad and not (exempt and n.startswith(exempt))
                 and torch.equal(p, trained0[n])]
    if unchanged:
        fail(f"{tag}: {len(unchanged)} trained parameters did not change, "
             f"e.g. {unchanged[0]}")
    if any(not torch.equal(v, vit0[k])
           for k, v in model.visual_encoder.state_dict().items()):
        fail(f"{tag}: the frozen ViT changed")


def card_vs_cpu(label: str, results: dict) -> None:
    """Hold a step's loss and gradients on the card ({"cuda": (loss,
    grads)}) to the CPU's within TRAIN_LOSS_TOL and TRAIN_GRAD_REL_TOL of
    the largest gradient."""
    (lc, gc), (lp, gp) = results["cuda"], results["cpu"]
    d_loss = abs(lc - lp)
    g_max = max(float(g.abs().max()) for g in gp.values())
    d_grad = max(float((gc[n] - gp[n]).abs().max()) for n in gp)
    print(f"[check] {label} card vs cpu: |loss diff| {d_loss:.3e} "
          f"(tol {TRAIN_LOSS_TOL}); max |grad diff| {d_grad:.3e} over "
          f"{len(gp)} tensors, largest |grad| {g_max:.3e} (tol "
          f"{TRAIN_GRAD_REL_TOL} x largest)", flush=True)
    if set(gc) != set(gp) or not d_loss <= TRAIN_LOSS_TOL \
            or not d_grad <= TRAIN_GRAD_REL_TOL * g_max:
        fail(f"the {label} on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 6: the training path

def caption_lengths(n: int, max_len: int, rng) -> np.ndarray:
    """CIRR-like caption token counts, [CLS] and [SEP] included, as the JAX
    package's benchmark models its stage-I traffic (bench.py:223-231):
    modification texts of about 11 words, about 13 wordpieces, drawn as
    clip(round(N(15, 5)), 6, max_len)."""
    return np.clip(np.round(rng.normal(15.0, 5.0, size=n)), 6,
                   max_len).astype(np.int64)


class Triplets:
    """CIRR-shaped 'relative' training triplets (reference image, target
    image and its name, caption of toy-vocabulary words, one token each)
    over an in-memory image pool (a ``Corpus``). Captions have 3 to 30
    words, mostly short, or ``n_words[i]`` words when that is given.
    Without ``target_image`` a sample carries the target's name only, as
    the trainer's datasets do when the target features are cached."""

    def __init__(self, n: int, pool: Corpus, rng, vocab_words: list[str],
                 target_image: bool = True, n_words=None):
        self.pool = pool
        self.target_image = target_image
        self.rows = []
        for i in range(n):
            ref, tgt = rng.choice(len(pool), size=2, replace=False)
            words = int(min(30, 3 + rng.geometric(0.12))) if n_words is None \
                else int(n_words[i])
            self.rows.append((int(ref), int(tgt),
                              " ".join(rng.choice(vocab_words, words))))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        ref, tgt, caption = self.rows[i]
        sample = {"reference_image": self.pool.images[ref],
                  "target_name": self.pool.index_names[tgt],
                  "caption": caption}
        if self.target_image:
            sample["target_image"] = self.pool.images[tgt]
        return sample


def train_configs(dropout: bool):
    from candidate_reranking_cir_tpu_torch.config import (
        RerankerModelConfig,
        RetrievalModelConfig,
        TextEncoderConfig,
        vit_config,
    )

    # as the JAX trainer builds them (cli/common.py::build_stage2 with
    # remat): ViT drop-path 0.1 (frozen here), the dual encoder with remat;
    # remat policy '' here, so that this phase's figures compare with
    # earlier runs' (the trainer CLI of phase 10 runs 'dots')
    rates = {} if dropout else {"hidden_dropout": 0.0,
                                "attention_dropout": 0.0}
    vit = vit_config("base", 384, drop_path_rate=0.1)
    cfg1 = RetrievalModelConfig(vit=vit_config("base", 384),
                                text=TextEncoderConfig(), text_len=TEXT_LEN)
    cfg2 = RerankerModelConfig(
        vit=vit, text=TextEncoderConfig(remat=True, **rates),
        text_len=TEXT_LEN)
    return cfg1, cfg2


def train_batches(tok, words, n_batches: int, batch_size: int):
    """Batches as the trainer feeds them: the port's BatchLoader over the
    triplets, prefetched, captions tokenized with [ENC] at position 0."""
    from candidate_reranking_cir_tpu_torch.data.loader import (
        BatchLoader,
        prefetch,
    )

    rng = np.random.default_rng(SEED + 2)
    data = Triplets(n_batches * batch_size, Corpus(24, 384, rng), rng, words)
    loader = BatchLoader(data, batch_size, shuffle=True, seed=SEED,
                         workers=4)
    for raw in prefetch(iter(loader), 2):
        ids, mask = tok.encode(raw["caption"], TEXT_LEN, set_enc_token=True)
        yield {"ref_images": raw["reference_image"],
               "target_images": raw["target_image"],
               "input_ids": ids, "attention_mask": mask}


def train_path(tok, words) -> dict:
    from candidate_reranking_cir_tpu_torch.config import TrainConfig
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage2_train_step,
    )

    cfg1, cfg2 = train_configs(dropout=True)
    torch.manual_seed(SEED + 3)
    s1 = RetrievalModel(cfg1, dtype=torch.bfloat16, device="cuda")
    s2 = RerankerModel(cfg2, dtype=torch.bfloat16, device="cuda")
    opt, _ = make_optimizer(TrainConfig(), s2, 1000,
                            freeze_prefixes=("visual_encoder",))
    step = make_stage2_train_step(s1, s2, opt)
    vit0 = {k: v.clone() for k, v in s2.visual_encoder.state_dict().items()}
    trained0 = {n: p.detach().clone() for n, p in s2.named_parameters()
                if p.requires_grad}
    batches = train_batches(tok, words, 1 + TRAIN_STEPS + 1, TRAIN_B)

    seconds, losses, launches, peak, _ = timed_steps(
        "train", step, batches, SEED, TRAIN_STEPS)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    mean_s = sum(seconds) / len(seconds)
    pairs = TRAIN_B * TRAIN_B
    print(f"[train] {TRAIN_STEPS} steps at B={TRAIN_B} ({pairs} pairs), "
          f"bf16, remat: seconds {[round(x, 4) for x in seconds]}; mean "
          f"{mean_s:.4f} s; stage-II train triplets/s {pairs / mean_s:.1f} "
          f"({pairs} / step time)", flush=True)
    print(f"[train] losses {[round(x, 5) for x in losses]}; peak "
          f"max_memory_allocated {peak:.2f} GiB", flush=True)
    print(f"[train] launches per step {json.dumps(per_step)}", flush=True)
    n_layers = cfg2.text.num_layers
    expect = {"K7": 2 * n_layers, "K6": 2 * 2 * n_layers}  # remat: twice
    for kid, n in expect.items():
        if per_step[kid] != n:
            fail(f"{kid}: {per_step[kid]} launches per step, expected {n}")
    if not (per_step["K1"] > 0 and per_step["K2"] > 0):
        fail(f"the frozen producers did not run their kernels: {per_step}")
    check_trained("stage-II", s2, trained0, vit0)
    print(f"[train] all {len(trained0)} trained parameter tensors changed; "
          "the frozen ViT is bit-identical", flush=True)
    batch = next(batches)
    profile_device("one train step", lambda: step(batch, SEED))
    return {"launches": launches, "per_step": per_step,
            "triplets_per_s": pairs / mean_s}


def train_fp32_check(tok, words):
    """One fp32 step at B = 2 (4 pairs), full width, on the card and on
    the CPU from the same weights and seeds. Dropout is 0 here: the
    non-kernel dropouts draw from each device's own generator, and at B = 2
    no site is eligible for the kernels' hash mask. So this holds the whole
    step (frozen K1/K2 producers, the K3 pair cross-attention with its
    plain-recompute backward, the loss, remat, AdamW) to the CPU."""
    from candidate_reranking_cir_tpu_torch.config import TrainConfig
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage2_train_step,
    )

    cfg1, cfg2 = train_configs(dropout=False)
    batch = next(train_batches(tok, words, 1, 2))
    torch.manual_seed(SEED + 4)
    s1_cpu = RetrievalModel(cfg1, device="cpu")
    s2_cpu = RerankerModel(cfg2, device="cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        if dev == "cuda":
            s1 = RetrievalModel(cfg1, device="cuda")
            s1.load_state_dict(s1_cpu.state_dict())
            s2 = RerankerModel(cfg2, device="cuda")
            s2.load_state_dict(s2_cpu.state_dict())
        else:
            s1, s2 = s1_cpu, s2_cpu
        opt, _ = make_optimizer(TrainConfig(), s2, 1000,
                                freeze_prefixes=("visual_encoder",))
        step = make_stage2_train_step(s1, s2, opt)
        t0 = time.perf_counter()
        loss = float(step(batch, SEED))
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in s2.named_parameters() if p.grad is not None}
        results[dev] = (loss, grads)
        print(f"[check] fp32 train step at B=2 on {dev}: loss {loss:.6f} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del s1, s2, opt, step
    card_vs_cpu("fp32 train step", results)


# ---------------------------------------------------------------------------
# phase 7: the head-folded train kernels at the stage-I MED shape

def run_folded_kernel_cases(dtype, lq: int) -> dict:
    """K8, K9 at S1_SHAPE with ``lq`` query rows in ``dtype``, rate 0.1:
    error against the plain versions without and with a key-mask bias;
    kernel / plain / SDPA-yardstick times and bounds without the bias (the
    path's case)."""
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    from candidate_reranking_cir_tpu_torch.ops.attention import (
        make_additive_mask,
    )
    import torch.nn.functional as F

    e, m, h, d = S1_SHAPE
    shape = [e, lq, m, h, d]
    rate, seed = TRAIN_RATE, TRAIN_SEED + 1
    name = str(dtype).split(".")[-1]
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, gout = (torch.randn(e, lq, h * d, generator=g, device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn(e, m, h * d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.randint(1, m + 1, (e,), generator=g, device="cuda")
    mask = torch.arange(m, device="cuda")[None] < lens[:, None]
    key_bias = tat._train_bias3(make_additive_mask(mask), e, lq, m)
    heads = [tat._heads(x, h) for x in (q, k, v, gout)]
    isz = q.element_size()
    recs = {}
    errs = {}
    for label, bias in (("", None), (" +mask", key_bias)):
        tag = f"{name} {shape}{label} rate {rate}"
        out = tat._kernel_fwd(*heads[:3], bias, seed, rate, folded=True)
        grads = tat._kernel_bwd(*heads[:3], bias, seed, heads[3], rate,
                                folded=True)
        torch.cuda.synchronize()
        ref = tat.attention_train_folded_plain(q, k, v, bias, seed, rate,
                                               num_heads=h)
        err8 = (out.flatten(-2).float() - ref.float()).abs().max().item()
        del ref
        print(f"[kernel] K8 {tag}: max|err| {err8:.3e} (tol {TOL[dtype]})",
              flush=True)
        if not torch.isfinite(out).all() or err8 > TOL[dtype]:
            fail(f"K8 {tag}: max |err| {err8:.3e}")
        err9 = check_grads("K9", tag, grads,
                           tat.attention_train_folded_bwd_plain(
                               q, k, v, bias, seed, gout, rate, num_heads=h),
                           dtype)
        errs[label] = (err8, err9)
    qt, kt, vt, gt = (x.transpose(1, 2) for x in heads)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
        torch.autograd.grad(o, (qg, kg, vg), gt)

    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    cases = {
        # bytes: q read and out written once, k and v read once
        "K8": (lambda: tat._kernel_fwd(*heads[:3], None, seed, rate,
                                       folded=True),
               lambda: tat.attention_train_folded_plain(
                   q, k, v, None, seed, rate, num_heads=h),
               lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      dropout_p=rate),
               (2 * q.numel() + 2 * k.numel()) * isz, 4),
        # bytes: q, k, v, g read, dq, dk, dv written once
        "K9": (lambda: tat._kernel_bwd(*heads[:3], None, seed, heads[3],
                                       rate, folded=True),
               lambda: tat.attention_train_folded_bwd_plain(
                   q, k, v, None, seed, gout, rate, num_heads=h),
               sdpa_fwd_bwd, (3 * q.numel() + 4 * k.numel()) * isz, 10),
    }
    routes = {"K8": tat.fwd_uses_tensor_cores(dtype, None, True),
              "K9": tat.bwd_uses_tensor_cores(dtype, None, True)}
    for kid, (kernel, plain, sdpa, n_bytes, ops) in cases.items():
        b_ms, b_by = bound(n_bytes, ops * e * h * lq * m * d, dtype)
        recs[kid] = {"name": kid, "dtype": name, "shape": shape,
                     "max_abs_err": max(v[kid == "K9"] for v in errs.values()),
                     "ms": time_ms(kernel), "device_ms": graph_ms(kernel),
                     "plain_ms": time_ms(plain, 3), "library_ms": None,
                     "sdpa_own_mask_ms": time_ms(sdpa),
                     "bound_ms": b_ms, "bound_by": b_by}
        r = recs[kid]
        route = "tensor cores" if routes[kid] else "fp32 FMA"
        print(f"[kernel] {kid} {name} ({route}) {shape} rate {rate}: kernel "
              f"{r['ms']:.4f} ms, device only {r['device_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa(dropout_p={rate}"
              f"{', fwd+bwd' if kid == 'K9' else ''}; same work, its own "
              f"mask) {r['sdpa_own_mask_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 8: stage-I training

def stage1_config(**text_kw):
    from candidate_reranking_cir_tpu_torch.config import (
        RetrievalModelConfig,
        TextEncoderConfig,
        vit_config,
    )

    # as the JAX trainer builds it (cli/common.py::build_stage1 with remat):
    # ViT-B/16 @ 384 (frozen here, so its remat does not matter) and the
    # MED with remat, policy ''
    return RetrievalModelConfig(vit=vit_config("base", 384),
                                text=TextEncoderConfig(remat=True, **text_kw),
                                text_len=TEXT_LEN)


def target_cache(model, pool: Corpus):
    """The trainer's pooled target-feature cache: the pool's normalized
    projected CLS features through ``build_index``, kept on the host as the
    JAX trainer keeps them; (features [N, E] fp32, row of each name)."""
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index

    device = next(model.parameters()).device
    _, pooled, names = build_index(
        pool, lambda x: model.embed_images(x, pool_and_normalize=True), 32,
        pooled=True, keep_raw=False, device=device)
    return pooled.cpu().numpy(), {nm: i for i, nm in enumerate(names)}


def stage1_batches(tok, words, pool: Corpus, cache, n_batches: int,
                   batch_size: int):
    """Batches as the stage-I trainer feeds them: ``BatchLoader`` over
    triplets without target images, captions tokenized with [ENC] and cut
    to the smallest 'auto' text bucket, cached target features gathered
    by name."""
    from candidate_reranking_cir_tpu_torch.cli.common import (
        parse_text_buckets,
        text_bucket_slice,
    )
    from candidate_reranking_cir_tpu_torch.data.loader import (
        BatchLoader,
        prefetch,
    )

    feats, pos = cache
    buckets = parse_text_buckets("auto", TEXT_LEN)
    rng = np.random.default_rng(SEED + 6)
    # caption lengths of the benchmark's stage-I traffic; a word is one
    # token, and [ENC] and [SEP] take two
    n = n_batches * batch_size
    data = Triplets(n, pool, rng, words, target_image=False,
                    n_words=caption_lengths(n, TEXT_LEN, rng) - 2)
    loader = BatchLoader(data, batch_size, shuffle=True, seed=SEED,
                         workers=4)
    for raw in prefetch(iter(loader), 2):
        ids, mask = tok.encode(raw["caption"], TEXT_LEN, set_enc_token=True)
        ids, mask = text_bucket_slice(ids, mask, buckets)
        rows = np.asarray([pos[nm] for nm in raw["target_name"]])
        yield {"ref_images": raw["reference_image"], "input_ids": ids,
               "attention_mask": mask, "target_pooled": feats[rows]}


def stage1_train_path(tok, words) -> dict:
    from candidate_reranking_cir_tpu_torch.config import TrainConfig
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage1_train_step,
    )

    cfg = stage1_config()
    torch.manual_seed(SEED + 7)
    model = RetrievalModel(cfg, dtype=torch.bfloat16, device="cuda")
    opt, _ = make_optimizer(TrainConfig(learning_rate=2e-5,
                                        weight_decay=0.05), model, 1000,
                            freeze_prefixes=("visual_encoder",))
    step = make_stage1_train_step(model, opt)
    pool = Corpus(S1_POOL, cfg.vit.image_size, np.random.default_rng(SEED + 8))
    t0 = time.perf_counter()
    cache = target_cache(model, pool)
    print(f"[stage1] target-feature cache of {S1_POOL} images "
          f"{list(cache[0].shape)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    vit0 = {k: v.clone() for k, v in model.visual_encoder.state_dict().items()}
    trained0 = {n: p.detach().clone() for n, p in model.named_parameters()
                if p.requires_grad}
    batches = stage1_batches(tok, words, pool, cache, 1 + S1_STEPS + 1, S1_B)

    seconds, losses, launches, peak, widths = timed_steps(
        "stage1", step, batches, SEED, S1_STEPS)
    per_step = {k: v / S1_STEPS for k, v in launches.items()}
    mean_s = sum(seconds) / len(seconds)
    if not set(widths) <= set(S1_WIDTHS):
        fail(f"stage-I text widths {widths}: the K8/K9 phase measured "
             f"{S1_WIDTHS} only")
    print(f"[stage1] {S1_STEPS} steps at B={S1_B}, bf16, MED remat, text "
          f"widths {widths}: seconds {[round(x, 4) for x in seconds]}; mean "
          f"{mean_s:.4f} s; stage-I train pairs/s {S1_B / mean_s:.1f} "
          f"({S1_B} / step time)", flush=True)
    print(f"[stage1] losses {[round(x, 5) for x in losses]}; peak "
          f"max_memory_allocated {peak:.2f} GiB", flush=True)
    print(f"[stage1] launches per step {json.dumps(per_step)}", flush=True)
    n_layers = cfg.text.num_layers
    expect = {"K8": 2 * n_layers, "K9": n_layers, "K6": 0, "K7": 0}
    for kid, n in expect.items():
        if per_step[kid] != n:
            fail(f"{kid}: {per_step[kid]} launches per stage-I step, "
                 f"expected {n}")
    if not (per_step["K1"] > 0 and per_step["K5"] > 0):
        fail(f"the frozen ViT or the dropout hash did not run: {per_step}")
    # vision_proj gets no gradient with cached targets: weight decay moves
    # its weight, nothing moves its zero bias
    check_trained("stage-I", model, trained0, vit0, exempt="vision_proj.")
    print(f"[stage1] all {len(trained0) - 2} trained parameter tensors but "
          "vision_proj's changed; the frozen ViT is bit-identical",
          flush=True)
    batch = next(batches)
    profile_device("one stage-I step", lambda: step(batch, SEED))
    return {"launches": launches, "per_step": per_step,
            "pairs_per_s": S1_B / mean_s}


def stage1_fp32_check(tok, words):
    """One fp32 stage-I step at B = 4, full width, on the card and on the
    CPU from the same weights, the same cached targets and the same seeds.
    Hidden dropout 0 and attention dropout 0.1 with the kernels' thresholds
    lowered to 0: every MED attention site (the text self-attention with
    its key mask too) then takes the folded in-kernel-dropout route, whose
    hash mask is the same on both devices."""
    from candidate_reranking_cir_tpu_torch.config import TrainConfig
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage1_train_step,
    )

    cfg = stage1_config(hidden_dropout=0.0, attention_dropout=0.1)
    torch.manual_seed(SEED + 9)
    cpu = RetrievalModel(cfg, device="cpu")
    pool = Corpus(2 * S1_CHECK_B, cfg.vit.image_size,
                  np.random.default_rng(SEED + 10))
    cache = target_cache(cpu, pool)
    batch = next(stage1_batches(tok, words, pool, cache, 1, S1_CHECK_B))
    saved = tat.MIN_KV, tat.MIN_ROWS
    tat.MIN_KV, tat.MIN_ROWS = 0, 0
    results, launches = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                model = RetrievalModel(cfg, device="cuda")
                model.load_state_dict(cpu.state_dict())
            else:
                model = cpu
            opt, _ = make_optimizer(TrainConfig(), model, 1000,
                                    freeze_prefixes=("visual_encoder",))
            step = make_stage1_train_step(model, opt)
            tat.reset_launch_counts()
            t0 = time.perf_counter()
            loss = float(step(batch, SEED))
            grads = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            results[dev] = (loss, grads)
            launches[dev] = dict(tat.LAUNCHES)
            print(f"[check] fp32 stage-I step at B={S1_CHECK_B} on {dev}: "
                  f"loss {loss:.6f} in {time.perf_counter() - t0:.1f} s; "
                  f"launches {json.dumps(launches[dev])}", flush=True)
            del model, opt, step
    finally:
        tat.MIN_KV, tat.MIN_ROWS = saved
    n_layers, nc = cfg.text.num_layers, launches["cuda"]
    if nc["K8"] != 2 * 2 * n_layers or nc["K9"] != 2 * n_layers:
        fail(f"the fp32 check did not run K8/K9 at every MED attention "
             f"site: {nc}")
    card_vs_cpu("fp32 stage-I step", results)


# ---------------------------------------------------------------------------
# phase 9: the stage-I eval path

def stage1_eval_queries(names: list[str], n_q: int, rng,
                        vocab_words: list[str]) -> list[dict]:
    """CIRR-val-shaped queries: the reference drawn uniformly from the
    corpus (4,181 over 2,297 images: about 1.8 queries an image, as in
    CIRR val), a 6-member group of the reference, the target and four
    more, and a caption of ``caption_lengths``' token count (one toy word
    a token; [ENC] and [SEP] take two)."""
    n = len(names)
    refs = rng.integers(0, n, size=n_q)
    n_words = caption_lengths(n_q, TEXT_LEN, rng) - 2
    out = []
    for q in range(n_q):
        others = rng.choice(n - 1, size=5, replace=False)
        others = others + (others >= refs[q])        # never the reference
        members = [names[refs[q]]] + [names[i] for i in others]
        out.append({"reference_name": members[0], "target_name": members[1],
                    "caption": " ".join(rng.choice(vocab_words, n_words[q])),
                    "group_members": members})
    return out


def fusion_families(tok, queries: list[dict], names: list[str]) -> dict:
    """The fusion scheduler's batches of these queries, as the engine makes
    them (image-major, q_batch S1E_Q_BATCH, 'auto' text buckets):
    {(query group Q, width w, images G): batches}. Each batch launches K1
    once a MED layer at [G, Q*w] rows x the image tokens."""
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        resolve_buckets,
        schedule_fusion_batches,
    )

    pos = {nm: i for i, nm in enumerate(names)}
    ref_idx = np.asarray([pos[q["reference_name"]] for q in queries],
                         np.int32)
    _, _, bucket_of = resolve_buckets(tok, [q["caption"] for q in queries],
                                      TEXT_LEN, "auto")
    fams: dict = {}
    for q, w, _, refs_rows, _ in schedule_fusion_batches(
            ref_idx, bucket_of, S1E_Q_BATCH, True):
        key = (q, w, len(refs_rows))
        fams[key] = fams.get(key, 0) + 1
    return fams


def stage1_k1_cases(fams: dict) -> list:
    """K1 at the stage-I eval path's shapes: the ViT at the embed batch,
    the MED cross-attention of the most-launched fusion family, and the
    widest one the scheduler can make (8 queries an image x 40 tokens)."""
    (q, w, g), _ = max(fams.items(), key=lambda kv: kv[1])
    return [
        ("K1", "ViT self-attention, stage-I embed batch", S1E_EMBED_BATCH,
         577, 577, 12, True, False),
        ("K1", f"MED fusion cross-attention, most launched ({q} queries an "
         f"image x {w} tokens)", g, q * w, 577, 12, True, False),
        ("K1", "MED image-major cross-attention, widest (8 queries an image "
         f"x {TEXT_LEN} tokens)", S1E_Q_BATCH // 8, 8 * TEXT_LEN, 577, 12,
         True, False),
    ]


def stage1_eval_path(tok, words, queries: list[dict]) -> dict:
    """``evaluate_cirr_stage1`` at CIRR-val scale in bf16, its top-K file
    handed to the stage-II engine, the fp32 card-vs-CPU check and a
    profile of one fusion pass. Returns the counted run's launches."""
    from candidate_reranking_cir_tpu_torch.data.topk_io import (
        load_topk_file,
        save_topk_file,
    )
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
    from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
        evaluate_cirr_stage2_datasets,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        evaluate_cirr_stage1,
        make_stage1_fns,
        predict_queries,
    )

    s1, s2 = eval_models()
    size = s1.cfg.vit.image_size
    kw = dict(text_len=TEXT_LEN, batch_size=S1E_EMBED_BATCH,
              save_topk_k=TOPK, q_batch=S1E_Q_BATCH, device="cuda")
    # warm-up on a small corpus of its own (allocator, cuBLAS), then the
    # counted run
    rng = np.random.default_rng(SEED + 12)
    small = Corpus(S1E_WARMUP[0], size, rng, float32_draw=True)
    evaluate_cirr_stage1(s1, None, small, stage1_eval_queries(
        small.index_names, S1E_WARMUP[1], rng, words), tok, **kw)
    t0 = time.perf_counter()
    corpus = Corpus(S1E_IMAGES, size, np.random.default_rng(SEED + 13),
                    float32_draw=True)
    print(f"[stage1_eval] {S1E_IMAGES} corpus images "
          f"{list(corpus.images.shape)} float32 "
          f"({corpus.images.nbytes / 2 ** 30:.2f} GiB) made in "
          f"{time.perf_counter() - t0:.1f} s; {len(queries)} queries",
          flush=True)
    gc.collect()
    ck.reset_launch_counts()
    res, payload = evaluate_cirr_stage1(s1, None, corpus, queries, tok, **kw)
    launches = dict(ck.LAUNCHES)
    sec = res.seconds
    print(f"[stage1_eval] seconds {json.dumps(sec)} (index: corpus embed "
          f"at batch {S1E_EMBED_BATCH}, the host-to-card copy of the images "
          f"included; fusion: {len(queries)} queries, image-major, q_batch "
          f"{S1E_Q_BATCH}; ranking: the whole corpus)", flush=True)
    print(f"[stage1_eval] stage-I queries/s {len(queries) / sec['total']:.1f} "
          "(queries over the total wall time, the images' host-to-card copy "
          "included)", flush=True)
    print(f"[stage1_eval] launches {json.dumps(launches)}", flush=True)
    fams = fusion_families(tok, queries, corpus.index_names)
    print("[stage1_eval] fusion batches by (query group Q, width w): "
          + ", ".join(f"Q {q} w {w}: {n} of [{g} images, {q * w} rows]"
                      for (q, w, g), n in sorted(fams.items())), flush=True)
    print(f"[stage1_eval] metrics {json.dumps(res.metrics)}", flush=True)
    if not (launches["K1"] > 0 and launches["K2"] > 0
            and launches["K3"] == 0):
        fail(f"stage-I eval launches {launches}: K1 and K2 must run, K3 not")
    for key, val in res.metrics.items():
        if not 0.0 <= val <= 100.0:
            fail(f"stage-I metric {key} = {val} out of range")
    if payload["sorted_index_names"].shape != (len(queries), TOPK) or \
            payload["labels"].shape != (len(queries), TOPK) or \
            payload["group_labels"].shape != (len(queries), 5):
        fail("unexpected top-K payload shapes")

    # the stage-I -> stage-II handoff: the file written, read back and
    # re-ranked by the stage-II engine on the first queries
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/cirr_top_{TOPK}_val.npz"
        save_topk_file(path, payload)
        saved = load_topk_file(path)
    if saved.keys() != payload.keys() or not all(
            np.array_equal(saved[k], payload[k]) for k in payload):
        fail("the top-K file read back differs from the payload")
    relative = [dict(queries[i], topk_names=saved["sorted_index_names"][i],
                     topk_labels=saved["labels"][i])
                for i in range(S1E_STAGE2_QUERIES)]
    t0 = time.perf_counter()
    res2 = evaluate_cirr_stage2_datasets(
        s1, None, s2, None, tok, corpus, relative, k=TOPK,
        text_len=TEXT_LEN, batch_size=16, device="cuda")
    logits = res2.rerank.logits
    print(f"[stage1_eval] stage II on {S1E_STAGE2_QUERIES} queries of the "
          f"file in {time.perf_counter() - t0:.1f} s: metrics "
          f"{json.dumps(res2.metrics)}", flush=True)
    if logits.shape != (S1E_STAGE2_QUERIES, TOPK) \
            or not np.isfinite(logits).all():
        fail("stage II on the stage-I top-K file gave bad logits")
    del s2, res2

    # a fusion pass over the corpus bank, profiled; then the fp32 check
    embed, fuse = make_stage1_fns(s1, None, "cuda")
    bank, pooled, names = build_index(corpus, embed, S1E_EMBED_BATCH,
                                      pooled=True, device="cuda")
    fuse_args = (tok, [q["caption"] for q in queries],
                 [q["reference_name"] for q in queries], bank, names,
                 TEXT_LEN, S1E_Q_BATCH)
    profile_device("stage-I fusion pass",
                   lambda: predict_queries(fuse, *fuse_args))
    del bank, fuse_args
    stage1_fp32_eval_check(s1, tok, queries, corpus, pooled)
    return launches


def stage1_fp32_eval_check(s1, tok, queries: list[dict], corpus: Corpus,
                           pooled) -> None:
    """S1E_CHECK_QUERIES queries, two from each of the first reference
    images that hold two or more (so they fuse image-major, Q = 2),
    through fp32 copies of ``s1`` on
    the card and on the CPU: reference features, fused predictions (within
    S1E_PRED_TOL) and top-50 lists over the same pooled index (equal
    wherever the two candidates' distances differ by more than
    S1E_TIE_GAP)."""
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        make_stage1_fns,
        predict_queries,
        ranked_slices,
    )

    by_ref: dict = {}
    for q in queries:
        by_ref.setdefault(q["reference_name"], []).append(q)
    sel = [q for rows in by_ref.values() if len(rows) >= 2
           for q in rows[:2]][:S1E_CHECK_QUERIES]
    refs = sorted({q["reference_name"] for q in sel})
    pos = {nm: i for i, nm in enumerate(corpus.index_names)}
    images = torch.from_numpy(corpus.images[[pos[r] for r in refs]])
    preds, tops, index = {}, {}, pooled.float().cpu()
    for dev in ("cuda", "cpu"):
        model = type(s1)(s1.cfg, dtype=torch.float32, device=dev)
        model.load_state_dict(s1.state_dict())
        embed, fuse = make_stage1_fns(model, None, dev)
        t0 = time.perf_counter()
        raw = embed(images.to(dev))[0]
        preds[dev] = predict_queries(
            fuse, tok, [q["caption"] for q in sel],
            [q["reference_name"] for q in sel], raw, refs, TEXT_LEN,
            S1E_CHECK_QUERIES)
        tops[dev], _ = ranked_slices(preds[dev], index.to(dev), TOPK)
        preds[dev] = preds[dev].cpu()
        print(f"[check] fp32 stage-I fusion of {len(sel)} queries over "
              f"{len(refs)} reference images on {dev} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del model
    d_pred = float((preds["cuda"] - preds["cpu"]).abs().max())
    dist = (1.0 - preds["cpu"] @ index.T).numpy()
    rows = np.arange(len(sel))[:, None]
    differ = tops["cuda"] != tops["cpu"]
    gaps = np.abs(dist[rows, tops["cuda"]] - dist[rows, tops["cpu"]])[differ]
    print(f"[check] fp32 stage-I card vs cpu: max |prediction diff| "
          f"{d_pred:.3e} (tol {S1E_PRED_TOL}); top-{TOPK} lists differ at "
          f"{int(differ.sum())} of {differ.size} places, largest distance "
          f"gap there {float(gaps.max()) if gaps.size else 0.0:.3e} (tol "
          f"{S1E_TIE_GAP})", flush=True)
    if not d_pred <= S1E_PRED_TOL:
        fail("fp32 stage-I predictions on the card disagree with the CPU")
    if gaps.size and not gaps.max() <= S1E_TIE_GAP:
        fail("fp32 stage-I top-50 lists on the card disagree with the CPU")


# ---------------------------------------------------------------------------
# phase 10: the training CLIs

def write_cirr_tree(root, n_images: int, n_train: int, n_val_images: int,
                    n_val: int, words: list[str], rng) -> None:
    """A synthetic CIRR tree of jpegs at S1T_IMAGE_SIZE px under ``root``
    (tests/test_trainers.py's layout): train triplets over ``n_images``
    images, val triplets (6-member groups) over ``n_val_images`` others;
    captions of toy-vocabulary words at the lengths of ``bench.py``'s CIRR
    model. The images are smooth (upsampled noise), as photos compress."""
    import PIL.Image

    base = root / "cirr_dataset"
    for sub in ("cirr/captions", "cirr/image_splits", "img"):
        (base / sub).mkdir(parents=True)
    size = S1T_IMAGE_SIZE

    def images(prefix, n):
        names = [f"{prefix}{i:04d}" for i in range(n)]
        for name in names:
            small = rng.integers(0, 255, size=(12, 12, 3), dtype=np.uint8)
            PIL.Image.fromarray(small).resize((size, size)).save(
                base / "img" / f"{name}.jpg", quality=90)
        return names

    def captions(n):
        return [" ".join(rng.choice(words, int(w)))
                for w in caption_lengths(n, TEXT_LEN, rng) - 2]

    def triplets(names, n):
        out = []
        for q, cap in enumerate(captions(n)):
            sel = rng.choice(len(names), size=6, replace=False)
            out.append({"pairid": q, "reference": names[sel[0]],
                        "target_hard": names[sel[1]], "caption": cap,
                        "img_set": {"members": [names[i] for i in sel]}})
        return out

    for split, prefix, n_img, n_q in (("train", "tr", n_images, n_train),
                                      ("val", "va", n_val_images, n_val)):
        names = images(prefix, n_img)
        (base / "cirr" / "captions" / f"cap.rc2.{split}.json").write_text(
            json.dumps(triplets(names, n_q)))
        (base / "cirr" / "image_splits" / f"split.rc2.{split}.json"
         ).write_text(json.dumps({nm: f"img/{nm}.jpg" for nm in names}))


class StepLosses:
    """Stands in for the trainers' Comet experiment: keeps each step's loss
    and, after the ``kill_after``-th step, sends this process SIGTERM, as a
    preemption would."""

    def __init__(self, kill_after: int | None = None):
        self.losses, self.kill_after = [], kill_after

    def log_metric(self, name, value, **kw):
        if name == "step_loss":
            self.losses.append(value)
            if len(self.losses) == self.kill_after:
                import os
                import signal

                os.kill(os.getpid(), signal.SIGTERM)


def run_cli(tag: str, module, argv: list[str], kill_after=None) -> dict:
    """One CLI run with its Comet stand-in; its stdout kept aside (the
    metric lines and messages are picked from it). Returns the losses,
    the printed ``key = value`` metrics, the output and the seconds."""
    import contextlib
    import io

    comet = StepLosses(kill_after)
    saved = getattr(module, "make_comet", None)
    if saved is not None:
        module.make_comet = lambda *a, **k: comet
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            module.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        print(out.getvalue()[-4000:], flush=True)
        raise
    finally:
        if saved is not None:
            module.make_comet = saved
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    metrics = dict(line.split(" = ") for line in text.splitlines()
                   if " = " in line)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train_cli] {tag}: {seconds:.1f} s; step losses "
          f"{[round(x, 6) for x in comet.losses]}", flush=True)
    for line in text.splitlines():
        if line.startswith(("[epoch", "preempted", "resumed", "saved best",
                            "top ")):
            print(f"[train_cli] {tag}: {line}", flush=True)
    return {"losses": comet.losses, "metrics": metrics, "text": text,
            "seconds": seconds}


def shown_metrics(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items()
            if k in ("recall_at1", "recall_at5", "recall_at10", "recall_at50",
                     "group_recall_at1", "mean_r5_rs1")}


def checkpoint_gib(path) -> float:
    return sum(f.stat().st_size for f in path.iterdir()) / 2 ** 30


def compare_train_states(a_dir, b_dir) -> dict:
    """Max |difference| of the parameters and of the optimizer moments of
    two checkpoints, and whether their counters agree."""
    from candidate_reranking_cir_tpu_torch.runtime.checkpoint import (
        read_train_state,
    )

    a, b = read_train_state(a_dir), read_train_state(b_dir)
    if a["params"].keys() != b["params"].keys():
        fail("the resumed run's checkpoint holds other parameters")
    params = max(float((a["params"][k].float() - b["params"][k].float())
                       .abs().max()) for k in a["params"])
    oa, ob = a["opt_state"], b["opt_state"]
    moments = max(float((x - y).abs().max()) for key in ("mu", "nu")
                  for x, y in zip(oa[key], ob[key]))
    same_counters = (a["step"], oa["count"], oa["mini_step"]) == \
        (b["step"], ob["count"], ob["mini_step"])
    return {"params": params, "moments": moments, "counters": same_counters}


def launch_counts() -> dict:
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

    return {**ck.LAUNCHES, **tat.LAUNCHES}


def reset_launch_counts() -> None:
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

    ck.reset_launch_counts()
    tat.reset_launch_counts()


def remat_memory(tok, words) -> dict:
    """Peak memory and step seconds of stage-II steps (B = 16, bf16, text
    width 40) with the dual encoder's remat policy '' and 'dots', from the
    same weights and batches, in turns ('', 'dots', 'dots', ''): 1 warm-up
    and 2 counted steps each; a profile of one step of each policy."""
    import dataclasses

    from candidate_reranking_cir_tpu_torch.config import TrainConfig
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage2_train_step,
    )

    cfg1, cfg2 = train_configs(dropout=True)
    torch.manual_seed(SEED + 12)
    s1 = RetrievalModel(cfg1, dtype=torch.bfloat16, device="cuda")
    weights = RerankerModel(cfg2, dtype=torch.bfloat16,
                            device="cuda").state_dict()
    batches = list(train_batches(tok, words, 3, TRAIN_B))
    out = {}
    for policy in ("", "dots", "dots", ""):
        cfg = dataclasses.replace(cfg2, text=dataclasses.replace(
            cfg2.text, remat_policy=policy))
        s2 = RerankerModel(cfg, dtype=torch.bfloat16, device="cuda")
        s2.load_state_dict(weights)
        opt, _ = make_optimizer(TrainConfig(), s2, 1000,
                                freeze_prefixes=("visual_encoder",))
        step = make_stage2_train_step(s1, s2, opt)
        step(batches[0], SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [float(step(b, SEED)) for b in batches[1:]]
        torch.cuda.synchronize()
        seconds = (time.perf_counter() - t0) / len(batches[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        name = policy or "''"
        print(f"[train_cli] stage-II step, remat {name}: peak "
              f"max_memory_allocated {peak:.2f} GiB, {seconds:.4f} s a step "
              f"(2 steps after a warm-up), losses "
              f"{[round(x, 6) for x in losses]}", flush=True)
        if name not in out:
            profile_device(f"one stage-II step, remat {name}",
                           lambda: step(batches[1], SEED))
        out.setdefault(name, []).append((peak, seconds, losses))
        del s2, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    if out["''"][0][2] != out["dots"][0][2]:
        print("[train_cli] note: the two policies' bf16 losses differ "
              "(they need not be bit-equal on the card)", flush=True)
    return out


def train_cli_path(tok, words) -> dict:
    """The two trainer CLIs on the card at full width in bf16 (phase 10)."""
    import shutil
    from pathlib import Path

    from candidate_reranking_cir_tpu_torch.cli import (
        stage1_train,
        stage2_train,
        validate,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    try:
        root = Path(tmp.name) / "cirr"
        rng = np.random.default_rng(SEED + 13)
        t0 = time.perf_counter()
        write_cirr_tree(root, S1T_IMAGES, S1T_TRAIN, S1T_VAL_IMAGES,
                        S1T_VAL, words, rng)
        # stage II trains on the first S2T_TRAIN triplets, validates on
        # the same val split
        root2 = Path(tmp.name) / "cirr_s2"
        base, base2 = root / "cirr_dataset", root2 / "cirr_dataset"
        (base2 / "cirr").mkdir(parents=True)
        (base2 / "img").symlink_to(base / "img")
        shutil.copytree(base / "cirr" / "image_splits",
                        base2 / "cirr" / "image_splits")
        (base2 / "cirr" / "captions").mkdir()
        train = json.loads(
            (base / "cirr/captions/cap.rc2.train.json").read_text())
        (base2 / "cirr/captions/cap.rc2.train.json").write_text(
            json.dumps(train[:S2T_TRAIN]))
        shutil.copy(base / "cirr/captions/cap.rc2.val.json",
                    base2 / "cirr/captions/cap.rc2.val.json")
        free = shutil.disk_usage(tmp.name).free / 2 ** 30
        print(f"[train_cli] CIRR tree of jpegs at {S1T_IMAGE_SIZE} px: "
              f"{S1T_TRAIN} train triplets over {S1T_IMAGES} images, "
              f"{S1T_VAL} val queries over {S1T_VAL_IMAGES}; stage II on "
              f"the first {S2T_TRAIN}; written in "
              f"{time.perf_counter() - t0:.1f} s; {free:.0f} GiB free",
              flush=True)
        models = Path(tmp.name) / "models"
        flags = ["--dataset", "CIRR", "--data-root", str(root),
                 "--allow-test-vocab", "--device", "cuda"]
        s1 = flags + ["--output-dir", str(models), "--num-epochs", "2",
                      "--batch-size", str(S1_B), "--validation-frequency",
                      "1"]

        reset_launch_counts()
        whole = run_cli("stage I, uninterrupted", stage1_train,
                        s1 + ["--experiment-name", "whole"])
        cut = run_cli("stage I, SIGTERM after step 1", stage1_train,
                      s1 + ["--experiment-name", "cut"], kill_after=1)
        saved = models / "cut" / "saved_models" / "blip_last"
        if "preempted (SIGTERM)" not in cut["text"] or not saved.is_dir():
            fail("the preempted stage-I run saved no resumable blip_last")
        resumed = run_cli("stage I, --resume", stage1_train,
                          s1 + ["--experiment-name", "cut", "--resume"])
        s1_launches = launch_counts()
        print(f"[train_cli] stage-I runs' launches "
              f"{json.dumps(s1_launches)}", flush=True)
        steps = S1T_TRAIN // S1_B
        if len(whole["losses"]) != 2 * steps:
            fail(f"the stage-I run took {len(whole['losses'])} steps, "
                 f"expected {2 * steps}")
        joined = cut["losses"] + resumed["losses"]
        d_loss = max(abs(a - b) for a, b in zip(whole["losses"], joined))
        last = {nm: models / nm / "saved_models" / "blip_last"
                for nm in ("whole", "cut")}
        for path in [*last.values(),
                     models / "whole" / "saved_models" / "blip_mean"]:
            if not path.is_dir():
                fail(f"missing checkpoint {path.name}")
        diff = compare_train_states(last["whole"], last["cut"])
        print(f"[train_cli] resumed vs uninterrupted: step losses "
              f"{len(joined)} vs {len(whole['losses'])}, max |diff| "
              f"{d_loss:.3e}; final parameters max |diff| "
              f"{diff['params']:.3e}, moments {diff['moments']:.3e}, "
              f"counters equal {diff['counters']} (tolerance "
              f"{RESUME_TOL}: bit-equal)", flush=True)
        if len(joined) != len(whole["losses"]) or d_loss > RESUME_TOL \
                or diff["params"] > RESUME_TOL \
                or diff["moments"] > RESUME_TOL or not diff["counters"]:
            fail("the resumed stage-I run differs from the uninterrupted "
                 "one")
        sizes = {nm: checkpoint_gib(path) for nm, path in
                 (("stage-I blip_last", last["whole"]),)}
        for key in ("K1", "K2", "K5", "K8", "K9"):
            if s1_launches[key] <= 0:
                fail(f"{key} was not launched in the stage-I trainer runs")
        print(f"[train_cli] stage-I validation (uninterrupted, epoch 1): "
              f"{json.dumps(shown_metrics(whole['metrics']))}", flush=True)
        shutil.rmtree(models / "cut")

        ckpt1 = models / "whole" / "saved_models" / "blip_mean"
        topk = Path(tmp.name) / "top50.npz"
        reset_launch_counts()
        run_cli("validate (stage-I blip_mean -> top-50 file)", validate,
                flags + ["--stage1-path", str(ckpt1), "--save-topk",
                         "--k", str(S2T_K), "--topk-out", str(topk)])
        s2 = run_cli("stage II", stage2_train, [
            "--dataset", "CIRR", "--data-root", str(root2),
            "--allow-test-vocab", "--device", "cuda", "--output-dir",
            str(models), "--experiment-name", "s2", "--num-epochs", "1",
            "--batch-size", str(S2T_B), "--stage1-path", str(ckpt1),
            "--top-k-path", str(topk), "--K-value", str(S2T_K)])
        s2_launches = launch_counts()
        print(f"[train_cli] validate and stage-II runs' launches "
              f"{json.dumps(s2_launches)}", flush=True)
        if len(s2["losses"]) != S2T_TRAIN // S2T_B:
            fail(f"the stage-II run took {len(s2['losses'])} steps")
        for key in ("K1", "K2", "K3", "K5", "K6", "K7"):
            if s2_launches[key] <= 0:
                fail(f"{key} was not launched in the validate and stage-II "
                     "runs")
        ckpt2 = models / "s2" / "saved_models"
        for name in ("blip_last", "blip_mean"):
            if not (ckpt2 / name / "train_state.pt").is_file():
                fail(f"the stage-II run saved no {name}")
        sizes["stage-I blip_mean"] = checkpoint_gib(ckpt1)
        sizes["stage-II blip_last"] = checkpoint_gib(ckpt2 / "blip_last")
        print(f"[train_cli] stage-II validation: "
              f"{json.dumps(shown_metrics(s2['metrics']))}", flush=True)
        print(f"[train_cli] checkpoint GiB "
              f"{json.dumps({k: round(v, 3) for k, v in sizes.items()})}",
              flush=True)
    finally:
        tmp.cleanup()
    memory = remat_memory(tok, words)
    seconds = {"stage1_whole": whole["seconds"], "stage1_cut": cut["seconds"],
               "stage1_resume": resumed["seconds"],
               "stage2": s2["seconds"],
               "phase": time.perf_counter() - t_phase}
    print("[train_cli] seconds "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}",
          flush=True)
    launches = {k: s1_launches[k] + s2_launches[k] for k in s1_launches}
    return {"launches": launches, "seconds": seconds, "sizes": sizes,
            "memory": memory}


def build_libraries() -> None:
    """Both kernel libraries, one nvcc each, started together; ptxas's
    register and spill lines of every kernel (the tensor-core kernels'
    must be among them when a library was built), and the tensor-core
    kernels' dynamic shared memory."""
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    from candidate_reranking_cir_tpu_torch.ops.build import (
        build,
        load_attention_library,
        load_attention_train_library,
    )

    names = ("attention", "attention_train")
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(build, names))
    for name, (path, seconds, log) in zip(names, built):
        print(f"[build] {path.name}: {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"[build] {line.strip()}", flush=True)
        wanted = {"attention": ("attn_fwd_tc_kernel",),
                  "attention_train": ("attn_train_fwd_tc_kernel",
                                      "attn_train_fwd_folded_tc_kernel",
                                      "attn_train_bwd_tc_rows_kernel",
                                      "attn_train_bwd_tc_keys_kernel",
                                      "attn_bwd_tc_rows_kernel",
                                      "attn_bwd_tc_keys_kernel")}[name]
        for kernel in wanted:
            if log and kernel not in log:
                fail(f"ptxas reported no {kernel}")
    lib = load_attention_library()
    print("[build] attn_fwd_tc_kernel dynamic shared memory: "
          f"{lib.crc_attention_tc_smem_bytes(1, 64)} B with 1 warpgroup "
          f"over one key tile, {lib.crc_attention_tc_smem_bytes(1, 577)} B "
          f"over more, {lib.crc_attention_tc_smem_bytes(2, 577)} B with 2",
          flush=True)
    smem = load_attention_train_library().crc_attention_train_tc_smem_bytes
    print("[build] train tensor-core kernels' dynamic shared memory, over "
          "more than one key tile: K6 attn_train_fwd_tc_kernel "
          f"{smem(2)} B with 1 warpgroup, {smem(3)} B with 2; K8 "
          f"attn_train_fwd_folded_tc_kernel {smem(4)} B with 1, {smem(5)} B "
          "with 2; K7 and K9 row passes (attn_train_bwd_tc_rows_kernel, "
          f"attn_bwd_tc_rows_kernel) {smem(0)} B; key passes "
          f"(attn_train_bwd_tc_keys_kernel, attn_bwd_tc_keys_kernel) "
          f"{smem(1)} B", flush=True)
    m = S1_SHAPE[1]
    print(f"[build] K8 attn_train_fwd_folded_tc_kernel blocks an SM at "
          f"{m} keys: " + ", ".join(
              f"{tat.folded_forward_blocks_per_sm(lq, m)} at {lq} rows"
              for lq in S1_WIDTHS), flush=True)


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = smi_name_and_limit()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    build_libraries()
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )

    vocab = build_test_vocab()
    words = [w for w in vocab if w.isalpha() and len(w) > 1]
    tok = WordPieceTokenizer(vocab)
    s1e_names = [f"img{i:04d}" for i in range(S1E_IMAGES)]
    s1e_queries = stage1_eval_queries(
        s1e_names, S1E_QUERIES, np.random.default_rng(SEED + 11), words)

    records = {}
    cases = kernel_cases(stage1_k1_cases(
        fusion_families(tok, s1e_queries, s1e_names)))
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            rec = run_kernel_case(*case, dtype)
            # the JSON line keeps each kernel's first main-path shape, bf16
            if dtype == torch.bfloat16 and case[0] not in records:
                records[case[0]] = rec
    for dtype in (torch.float32, torch.bfloat16):
        recs = run_train_kernel_cases(dtype)
        if dtype == torch.bfloat16:
            records.update(recs)

    launches = main_path()
    train = train_path(tok, words)
    train_fp32_check(tok, words)

    for lq in S1_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            recs = run_folded_kernel_cases(dtype, lq)
            # the JSON line keeps bf16 at the width most stage-I steps take
            if dtype == torch.bfloat16 and lq == S1_WIDTHS[0]:
                records.update(recs)
    stage1 = stage1_train_path(tok, words)
    stage1_fp32_check(tok, words)
    s1e_launches = stage1_eval_path(tok, words, s1e_queries)
    cli = train_cli_path(tok, words)

    kernels = []
    for kid in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9"):
        rec = records[kid]
        # K1-K4: launches on the two eval paths (stage II, then stage I);
        # K6/K7 on the stage-II training path; K8/K9 on the stage-I one; K5
        # runs inside every K6-K9 launch that applies the mask, on both
        # training paths
        # every kernel also counts its launches in the trainer CLIs' runs
        # (phase 10) under the path key "train_cli"
        if kid in launches:
            by_path = {"stage2_eval": launches[kid],
                       "stage1_eval": s1e_launches[kid]}
        elif kid == "K5":
            by_path = {"stage2_train": train["launches"]["K5"],
                       "stage1_train": stage1["launches"]["K5"]}
        elif kid in ("K8", "K9"):
            by_path = {"stage1_train": stage1["launches"][kid]}
        else:
            by_path = {"stage2_train": train["launches"][kid]}
        by_path["train_cli"] = cli["launches"][kid]
        n = sum(by_path.values())
        kernels.append({
            "name": kid, "route": "cuda", "source": SOURCES[kid],
            "replaces": REPLACES[kid], "launches": n,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"],
            "launches_by_path": by_path,
            **{key: rec[key] for key in ("device_ms", "library_device_ms",
                                         "sdpa_own_mask_ms") if key in rec}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
