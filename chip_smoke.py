#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            (from the repository root)

Phases, each printing its own lines:
1. device: requires CUDA; prints ``nvidia-smi`` name and power limit.
2. build: compiles the eval (K1-K4) and train (K5-K9) attention libraries
   the bias + GELU library (G1) and the residual add + LayerNorm library
   (G2) from ``csrc/`` (one nvcc each, started
   together with ``make -B -C
   native`` for the native host libraries where g++ and the libjpeg
   headers are present, else a ``[native] unavailable: ...`` line; sm_90a)
   and prints
   ptxas's register and spill lines, and the tensor-core kernels' (eval,
   K6, K8, and K7's and K9's two backward passes) registers, spills and
   shared memory, and the blocks of K8's kernel an SM holds at the
   stage-I widths.
3. kernels K1-K4 at the eval paths' shapes, bf16 and fp32 (bf16 runs the
   tensor-core kernel, with or without a bias, fp32 the fp32-FMA one; K3
   also at the stage-II eval path's narrowest call, and per pair, one K/V
   a (query, candidate) pair, at serving's [200, 40, 577] and the
   query-major eval's [440, 40, 577]; K1 also at the stage-I
   eval path's ViT batch and at its most-launched and widest image-major
   MED shapes; K2 and K3 also at the caption decoder's shapes: a cached
   step's one query row over 20 cache slots with their mask and over the
   577 image tokens, a recompute step's causal [E, 1, L, L] bias; and, in
   bf16, heads narrower than the kernels' 64, which the wrappers pad: K2
   and K3 at the demo's 6-wide heads, K1 at 8-wide ones): max
   |error| against the plain PyTorch version,
   kernel / plain / SDPA times over back-to-back calls (CUDA events, as
   for every kernel) and the kernel/SDPA ratio (SDPA is a yardstick only;
   the port never calls it), the kernel's and SDPA's device-only times
   (CUDA-graph replays) and their ratio, and the least time the card
   could take (bytes over 3.35 TB/s or operations over the dtype's peak).
   Then K1 and K3 at EVA ViT-g's 88-wide heads (BLIP-2's vision tower;
   bf16, no bias, read in place by ``attn_fwd_tc_kernel<wg, false, 88>``)
   at the ViT-g's [32, 257, 257, 16, 88] and at a ragged [3, 75, 131, 5,
   88], the same way, each launch counted as "K1_d88" or "K3_d88" too;
   and at MoonViT's 72-wide heads (Kimi-VL's vision tower,
   ``attn_fwd_tc_kernel<wg, false, 72>``) at its bank batch's [16, 784,
   784, 16, 72] and at a ragged [3, 75, 131, 5, 72], counted as "K1_d72"
   or "K3_d72" too.
   Then G1, fc1's bias add and exact GELU (``ops/activation.bias_gelu``),
   at the ViT's fc1 at embed batch 32 ([18464, 3072]), a candidate-major
   dual-encoder chunk's ([8, 1280, 3072]), the caption head's transform
   ([48, 20, 768]) and a ragged [4099, 3071] (the scalar body), bf16:
   bit for bit against its plain version (the eager route), kernel / plain
   / ``F.gelu`` after the bias add (a yardstick the port never calls)
   times over back-to-back calls, the kernel's and ``F.gelu``'s
   device-only times, and its bound (bytes, or instruction issue).
   Then G2, the residual add and LayerNorm (``ops/norm.add_layer_norm``),
   at the EVA ViT-g's [8224, 1408] (``norm2`` with its residual and the
   sum kept, ``norm1`` without), the ViT-B's [18464, 768] (``norm2``), a
   candidate-major dual-encoder chunk's post-LN [10240, 768], the
   Q-Former's query rows [256, 32, 768] and a ragged [4099, 1407] (the
   scalar body), bf16: within bf16's 2e-2 of its plain version (the eager
   route; the fp32 sums run in another order), the share of elements that
   differ, the kept sum bit for bit, kernel / plain / ``F.layer_norm``
   after the add (a yardstick the port never calls) times, the kernel's
   and ``F.layer_norm``'s device-only times, and its bytes bound.
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
   corpus held in memory; launch counts per kernel (K1-K3, G1 and G2 must be
   > 0);
   then a few hundred pairs re-scored in fp32 on the card and on the CPU,
   and in bf16 on the card and on the CPU (the card's bf16 logits held to
   the CPU's bf16 eager path, at the max and at the rms difference, within
   shares of the fp32 logits' spread; the bf16 re-rank order's top-1 and
   top-5 agreement with the fp32 order; the same check read against
   planted faults, noise in one K1, K2 or K3 launch, which it must catch
   from a stated share of the launch's std);
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
15. (run after phase 9, before phase 11) (a) the single-program stage-I
    eval: ``evaluate_cirr_stage1(single_program=True)`` on phase 9's
    corpus, queries and model (the whole eval as one CUDA graph, captured
    once and replayed): the host's and the host-to-card copy's seconds,
    the capture's seconds, the graph pool's and the static inputs' GiB,
    the launches the capture recorded (K1 and K2 > 0, K3 = 0), the median
    and spread of three timed replays, stage-I queries/s over a replay
    beside phase 9's, a profiled replay (its idle share and its eval
    attention kernels by name); the replay's top-K and ranks bit-equal to
    phase 9's multi-launch run's (else the top-50 lists equal but at
    distance gaps under 1e-6, with the predictions' max |diff|), two
    replays bit-equal, weights from SEED + 1 loaded in place replayed from
    the cache and equal to a multi-launch run with them, and the model
    moved to the CPU and back captured again (on phase 9's 64-image
    warm-up corpus). (b) the 12-layer re-ranker at attention dropout 0.1
    in fp32: ``score_per_query`` over 2 queries x 4 candidates and
    ``score_grid`` over 4 candidates x 2 queries, a
    forward and a backward on the card and on the CPU with the kernel
    thresholds ``MIN_KV``/``MIN_ROWS`` at 0 (every dropout from the K5
    hash: logits 1e-3, gradients 1e-3 of the largest), then timed on the
    card at the default thresholds over 4 x 8 and 8 x 4 (score_grid's
    attention must launch K6/K7 there). (c) a ``CaptionDecoder``'s
    teacher-forced caption loss with attention dropout 0.1 over 2 images,
    the same way. The card runs of (b) and (c) must launch K5-K9.
11. serving (run after phases 9 and 15, on phase 9's corpus, before
    phase 10): the
    port's ``build_serving_index`` over the 2,297 images at full width in
    bf16 (both ViTs; seconds and the banks' GiB), the npz cache's round
    trip on 128 of them, then ``cli/serve.make_http_server`` on an
    ephemeral port (q_pad 4, a 3 ms window, rerank_k 50, k 50): 8 client
    threads send 32 /rank requests each (captions at ``bench.py``'s CIRR
    lengths, every 16th with an uploaded jpeg), one /admin/add of 4 jpegs
    and one /admin/remove of 4 images mid-stream; requests/s, the
    batcher's p50/p95/p99 latency and wave occupancy, errors (must be 0),
    launches (K1-K3 > 0, K4-K9 = 0), a profile of one wave; the same
    requests against ``index.quantize()`` (the int8 banks must be at most
    0.55x the bf16 bytes; the re-ranked logits' difference and the top-10
    overlap are printed); fp32 serving on the card against the CPU (a
    16-image index, 4 requests, rerank_k 8) and the fp32 query-major
    ``rerank`` (per pair and with dedup) against
    ``rerank_candidate_major`` over phase 5's first 32 queries.
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
    validations, all must be > 0); the PIL loader's split of one stage-I
    batch (decode plus transform, ``np.stack``, the trainer's cast, the
    host-to-card copy); with the native libraries built, ``[native]``
    lines: the native loader's split and batch decode, native pixels
    against PIL (tests/test_native_pipe.py's bounds), one stage-I epoch
    with ``--native-pipe`` beside the PIL run's, ``cli/validate
    --native-pipe``'s index seconds beside PIL's; then the peak memory and
    step seconds of stage-II steps with remat '' and 'dots'.
13. captioning: a ``CaptionDecoder`` at full width (ViT-B/16 @ 384, the
    12-layer MED with cross-attention, vocab 30,524) in bf16 with random
    weights from the seed over 16 images, through greedy and beam (3
    beams) decoding, recomputed and KV-cached, at max_len 20, cached
    nucleus sampling at max_len 30 (min_len 10, top-p 0.9, penalty 1.1)
    and a greedy decode with a 3-token prompt: seconds, ms a step and
    tokens/s of each, launches (K1-K3 > 0, K4-K9 = 0), bf16 cached vs
    recompute agreement (printed, not gated), one profiled cached step;
    fp32 at 2 images on the card and on the CPU: cached ids equal to
    recompute ids, card ids equal to the CPU's but after a step whose
    top-2 logit gap is under 1e-5 (named), step logits within 1e-3; then
    ``BlipBase`` in each mode, fp32 card vs CPU.
14. attention capture, device preprocessing and the glue modules, at
    full width (a stage-I ``RetrievalModel``: ViT-B/16 @ 384, the
    12-layer MED, ``text_len`` 40, random weights from the seed):
    ``[image_ops]`` 32 uint8 480 x 640 images padded on the host (bit for
    bit the PIL ``target_pad``) and preprocessed on the card (against the
    CPU, and a smooth image against PIL), ms a batch and the bytes a
    loader copies, then the ViT embeds them (K1 > 0); ``[capture]`` 4
    reference images' 4 captions each at query_group 4 with
    ``capture_attention`` and ``perturb_attention``, fp32 and bf16: the
    records' shapes and row sums, the fp32 captured z_t against the kernel
    route, card against CPU (probabilities, z_t, dLoss/dProbs), ms and
    peak GiB of a captured and an uncaptured fusion batch and the
    perturbation backward; ``[trace]`` a captured batch between
    ``start_trace`` and ``stop_trace`` (the phases and a kernel record in
    the trace; the ``PhaseTimer`` summary); ``[export]`` the model and its
    AdamW saved, ``cli/export_checkpoint --stage 1``, the ``.pt`` loaded
    back bit for bit; ``[entry]`` ``entry()`` ([2, 4] finite scores, K1 >
    0); ``[demo]`` ``demo.main --device cuda`` (every artifact of the JAX
    package's demo, K2 and K3 > 0 at 6-wide heads).
17. (run after phase 11, before phase 10) BLIP-2's stage-I eval:
    ``evaluate_cirr_stage1`` with ``Blip2RetrievalModel`` at its published
    widths (EVA ViT-g/14 at 224, 39 blocks of 1408, 16 heads of 88; the
    12-layer Q-Former with 32 queries) in bf16, random weights from the
    seed, on B2_IMAGES images and B2_QUERIES queries: seconds by layer
    span, queries/s, peak GiB, the launches after a reset (one 88-wide K1
    a ViT-g block and embed batch, K1_d88 = 39 x batches; no 88-wide K3;
    K1 above K1_d88 (the Q-Former's cross-attention), K2 (its masked
    self-attention), K3 (its query pass's unmasked one), G1 and G2 > 0) and
    the metrics.
18. (run after phase 17, before phase 10) Kimi-VL-A3B-Instruct as the
    stage-II re-ranker: ``evaluate_cirr_stage2_datasets(stage1=None,
    schedule='query_major')`` with ``KimiVLReranker`` at its published
    widths (MoonViT at 392, 27 blocks of 1152, 16 heads of 72; the
    27-layer MLA + 64-expert decoder) with its parameters held in bf16,
    random weights drawn in place from the seed, on KV_IMAGES images and
    KV_QUERIES queries (top-50, chunks of KV_Q_BATCH), after a warm-up on
    one chunk: seconds by layer span, queries/s, peak GiB, the launches
    after a reset (one 72-wide K1 a MoonViT block and bank batch, K1_d72 =
    27 x batches and K1 = K1_d72; no 72-wide K3; G2 > 0), the routed rows
    and MLA calls, and ``Dense``'s hit share (every parameter held in
    bf16: all hits).
16. the multi-card paths (after phase 14) at full width through NCCL,
    over min(4, cards) ranks: one rank in this process in bf16, where every
    result must be bit-equal to the same call without a mesh; with several
    cards one spawned rank a card in fp32, within MESH_TOL. A stage-I step
    (B = 64, the trainer's model, dropout 0.1, cached targets) and a
    stage-II step (B = 8), each replicated and with ``fsdp``: losses and
    every trained parameter against the step without a mesh, seconds and
    peak GiB of each; ``ranked_slices`` at CIRR-val scale (4,181 x 2,297
    random pooled features); ``build_index(shard_index=True)`` of the
    stage-II bank over 256 images (its bytes per rank); the candidate-major
    re-rank of 64 queries (K = 50, CIRR groups) over the block-sharded and
    the replicated bank; ``sharded_cosine_topk``; ``dryrun_multichip``.
    Prints the seconds, the max |mesh - no mesh| of each comparison and
    the launches of the mesh calls (K1-K3 and K5-K9 must be > 0).
12. a JSON line of kernel figures, K1-K9, G1 and G2 (``launches_by_path`` adds
    phase 10's
    counts as "train_cli", phase 11's as "serve", phase 13's as
    "caption", phase 14's as "glue", phase 15's as "single_program"
    and "dropout_layouts", phase 16's as "mesh" and phase 17's as
    "blip2_stage1_eval", phase 18's as "kimi_vl_rerank"; K1_d88 and
    K1_d72 are K1 at 88- and 72-wide heads, also counted in K1), then ``Dense``'s hit share by path (``[dense]`` lines: the calls
    that took their bf16 weight and bias from the cache, those that cast
    them, on each path's counted run; also printed after each run), then
    the card's name and power limit, then the last line ``{"ok": true,
    "device": {...}}``.

Any failed phase raises, so the script exits non-zero without the last line.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.ops import registry

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
# slower than fp32 there): max |logit diff| within BF16_CARD_VS_CPU_REL_TOL
# of the fp32 logits' std, and the root-mean-square difference within
# BF16_CARD_VS_CPU_RMS_REL_TOL of it. Two correct bf16 paths differ by about
# a third of that std at the max and a tenth at the rms at these random
# weights (PERF.md section 6), near the bf16 error itself. The max sits on
# the bf16 logits' steps (about a fifth of the std), so it moves by a step
# when any rounding on the path moves; the rms, taken over every pair, does
# not.
BF16_CARD_VS_CPU_REL_TOL = 0.5
BF16_CARD_VS_CPU_RMS_REL_TOL = 0.16
BF16_CPU_QUERIES = 2
# controls for that check: the bf16 card re-score again with Gaussian noise
# of each share of a launch's output std added to the first launch, or to
# every launch, of K1, K2 and K3 (PERF.md section 6). The sound run reads
# 0.28-0.33 of the std at the max and 0.10-0.11 at the rms; the check must
# fail the planted faults listed in BF16_CONTROL_CAUGHT as (every launch,
# kernel, share), on the max or on the rms. Smaller faults (three
# hundredths of the std in every K1 launch reads 0.388 and 0.150) pass it:
# it catches gross faults only.
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
# phase 17: BLIP-2's stage-I eval at full width on a corpus of B2_IMAGES
# images at 224 px and B2_QUERIES queries (after a warm-up on B2_WARMUP)
B2_IMAGES, B2_QUERIES, B2_WARMUP = 256, 512, (32, 64)
# phase 18: Kimi-VL's stage-II re-rank at full width: a corpus of
# KV_IMAGES images, KV_QUERIES queries in chunks of KV_Q_BATCH, the bank
# in batches of KV_BANK_BATCH (the benchmark cell's engine settings)
KV_IMAGES, KV_QUERIES, KV_Q_BATCH, KV_BANK_BATCH = 64, 8, 4, 16
# phase 15: the single-program stage-I eval on phase 9's corpus and
# queries, SP_REPLAYS replays timed (the recapture of a moved model on the
# warm-up's small corpus); the dropout layouts at full width in fp32 with
# attention dropout DL_RATE: score_per_query over DL_PQ (queries,
# candidates), score_grid over DL_GRID (candidates, queries), a
# teacher-forced caption loss over DL_CAP_B images, card vs CPU within
# DL_LOGIT_TOL and DL_GRAD_REL_TOL of the largest gradient (as the fp32
# train steps); the sizes keep the CPU legs, whose plain attention
# computes the K5 hash on int64 tensors, to a few seconds each. The card
# alone is then timed at the default thresholds at DL_PQ_TIMED and
# DL_GRID_TIMED, where score_grid's B*Lq rows (160) reach MIN_ROWS, so
# its attention takes K6/K7 on the [A, B*Lq] fold
SP_REPLAYS = 3
DL_RATE, DL_PQ, DL_GRID, DL_CAP_B = 0.1, (2, 4), (4, 2), 2
DL_PQ_TIMED, DL_GRID_TIMED = (4, 8), (8, 4)
DL_LOGIT_TOL, DL_GRAD_REL_TOL = FP32_CARD_VS_CPU_TOL, TRAIN_GRAD_REL_TOL
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
# phase 11, serving over the stage-I eval's corpus (CIRR-val scale): the
# HTTP server at q_pad 4, a 3 ms window, rerank_k 50 and k 50; 8 clients
# of 32 requests, every 16th with an uploaded jpeg; 4 images added and 4
# removed mid-stream; then the same requests against the int8 index,
# whose banks must be at most 0.55x the bf16 ones (int8 + an fp32 scale a
# 768-wide row: 0.503x)
SRV_Q_PAD, SRV_WINDOW_MS, SRV_RERANK_K, SRV_K = 4, 3.0, 50, 50
SRV_CLIENTS, SRV_PER_CLIENT, SRV_UPLOAD_EVERY, SRV_ADMIN = 8, 32, 16, 4
SRV_CACHE_IMAGES = 128         # the index cache's round trip
SRV_INT8_BYTES_RATIO = 0.55
SRV_INT8_COMPARE = 64          # requests re-answered on both indexes
# fp32 serving, card vs CPU (PERF.md section 2's tolerances): stage-I
# scores as S1E_PRED_TOL, re-ranked logits as FP32_CARD_VS_CPU_TOL
SRV_CHECK_IMAGES, SRV_CHECK_REQUESTS, SRV_CHECK_RERANK_K = 16, 4, 8
SRV_STAGE1_TOL, SRV_TIE_GAP = S1E_PRED_TOL, S1E_TIE_GAP
SRV_STAGE2_TOL = FP32_CARD_VS_CPU_TOL
SRV_QM_QUERIES = 32            # fp32 query-major vs candidate-major
# K3 per pair (one K/V per query-candidate pair): serving's wave and the
# query-major eval's chunk (q_batch 8 x K + 5 group members)
K3_PER_PAIR = ((SRV_Q_PAD * SRV_RERANK_K, "serving, q_pad 4 x rerank_k 50"),
               (8 * (TOPK + 5), "query-major eval, q_batch 8 x (K 50 + 5)"))
# phase 13, captioning at full width (ViT-B/16 @ 384, the 12-layer MED
# with cross-attention, vocab 30,524) in bf16 over CAP_B images, at the
# reference's decoding defaults (blip.py:119-151): max_len 20 and 3 beams;
# sampling at max_len 30, min_len 10, top-p 0.9, penalty 1.1; a 3-token
# prompt. fp32 checks at CAP_CHECK_B images, card vs CPU: ids equal but
# after a step whose top-2 logit gap is under CAP_TIE_GAP, step logits
# within FP32_CARD_VS_CPU_TOL
CAP_B, CAP_MAX_LEN, CAP_BEAMS = 16, 20, 3
CAP_SAMPLE = {"max_len": 30, "min_len": 10, "top_p": 0.9,
              "repetition_penalty": 1.1}
CAP_PROMPT = "a dog with"      # three words of the toy vocabulary
CAP_CHECK_B, CAP_TIE_GAP = 2, 1e-5
# phase 14: device preprocessing of IMG_B uint8 images of IMG_HW (H, W)
# against the CPU (fp32) and, on a smooth image, PIL
# (tests/test_image_ops.py's bound); capture over CAP_G reference images'
# CAP_Q captions each (query_group CAP_Q): fp32 card vs CPU probabilities
# CAP_PROB_TOL, z_t CAP_Z_TOL, dLoss/dProbs CAP_GRAD_REL_TOL of the
# largest; bf16 probabilities gated at bf16's tolerance; the captured
# fp32 fusion against the kernel route CAP_ROUTE_TOL
IMG_B, IMG_HW = 32, (480, 640)
IMAGE_OPS_TOL, IMAGE_OPS_PIL_MEAN = 1e-4, 0.12
CAP_G, CAP_Q = 4, 4
CAP_PROB_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CAP_Z_TOL, CAP_GRAD_REL_TOL, CAP_ROUTE_TOL = 1e-3, 1e-3, 1e-4
# phase 16, the multi-card paths: a world of min(MESH_WORLD_MAX, cards)
# NCCL ranks; stage-I and stage-II steps at B = MESH_S1_B and MESH_S2_B,
# replicated and FSDP; ranked_slices at CIRR-val scale; the stage-II bank
# of MESH_INDEX_IMAGES images block-sharded; the candidate-major re-rank
# of MESH_RERANK_Q queries over it; the per-shard top-k; the dry run. One
# rank: bit-equal to the calls without a mesh; several: fp32 within
# MESH_TOL (the CPU tests' tolerances; index arrays MESH_INDEX_SHARE
# equal). The phase aims at MESH_PHASE_S
# seconds; every eval and train kernel but K4 must launch in it
MESH_WORLD_MAX, MESH_PHASE_S = 4, 60.0
MESH_S1_B, MESH_S2_B, MESH_INDEX_IMAGES, MESH_RERANK_Q = 64, 8, 256, 64
MESH_TOL = {"loss": 1e-5, "params": 3e-5, "logits": 1e-4, "bank": 1e-5}
# the steps' learning rate: an Adam update is at most ~lr an element, so
# 1e-5 keeps a sign flip of a near-zero gradient inside MESH_TOL["params"]
MESH_LR = 1e-5
# several ranks: the rankings' and top-k's indices equal in at least this
# share of entries (each rank's distance products have another shape, so
# cuBLAS may round them an ulp apart and swap near ties)
MESH_INDEX_SHARE = 0.999
MESH_KERNELS = ("K1", "K2", "K3", "K5", "K6", "K7", "K8", "K9")
# phase 10's native lines: native pixels against PIL within
# tests/test_native_pipe.py's bounds (8-bit units), on a few jpegs
NATIVE_MEAN_TOL, NATIVE_MAX_TOL, NATIVE_PIXEL_IMAGES = 0.5, 10.0, 8
NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native")
CSRC = "candidate_reranking_cir_tpu_torch/csrc"
# the records are bf16: K1-K4 on the tensor-core eval kernel, K6-K9 (no
# bias) on the tensor-core train kernels
SOURCES = {"K1": f"{CSRC}/attention_tc.cuh", "K2": f"{CSRC}/attention_tc.cuh",
           "K3": f"{CSRC}/attention_tc.cuh", "K4": f"{CSRC}/attention_tc.cuh",
           "K5": f"{CSRC}/attention_common.cuh",
           "K6": f"{CSRC}/attention_train_tc.cuh",
           "K7": f"{CSRC}/attention_train_tc.cuh",
           "K8": f"{CSRC}/attention_train_tc.cuh",
           "K9": f"{CSRC}/attention_train_tc.cuh",
           "G1": f"{CSRC}/activation.cu",
           "G2": f"{CSRC}/layer_norm.cu",
           # K1 at 88-wide heads: attn_fwd_tc_kernel<wg, false, 88>
           "K1_d88": f"{CSRC}/attention_tc.cuh",
           # and at 72-wide heads: attn_fwd_tc_kernel<wg, false, 72>
           "K1_d72": f"{CSRC}/attention_tc.cuh"}
JAX_KERNELS = "candidate_reranking_cir_tpu/ops/pallas_attention.py"
JAX_TRAIN = "candidate_reranking_cir_tpu/ops/pallas_attention_train.py"
REPLACES = {"K1": f"{JAX_KERNELS}:220", "K2": f"{JAX_KERNELS}:132",
            "K3": f"{JAX_KERNELS}:122", "K4": f"{JAX_KERNELS}:236",
            "K5": f"{JAX_TRAIN}:61", "K6": f"{JAX_TRAIN}:114",
            "K7": f"{JAX_TRAIN}:135", "K8": f"{JAX_TRAIN}:382",
            "K9": f"{JAX_TRAIN}:414", "K1_d88": f"{JAX_KERNELS}:220",
            "K1_d72": f"{JAX_KERNELS}:220",
            # G1 replaces no TPU kernel: XLA fuses the same formula into
            # fc1's epilogue
            "G1": "none (candidate_reranking_cir_tpu/models/layers.py: "
                  "Dense, exact_gelu, fused by XLA)",
            # G2 neither: XLA fuses the residual add and LayerNorm
            "G2": "none (candidate_reranking_cir_tpu/models/layers.py: "
                  "LayerNorm and the blocks' residual adds, fused by XLA)"}
MAIN_PATH_KERNELS = ("K1", "K2", "K3", "G1", "G2")
EVAL_KERNELS = ("K1", "K2", "K3", "K4")
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
        *(("K3", f"per-pair cross-attention, {label}", e, TEXT_LEN, 577, 12,
           False, False) for e, label in K3_PER_PAIR),
        ("K4", "masked folded attention", 8, 160, 160, 12, True, True),
        # the caption decoder (phase 13): a cached beam step's one query
        # row over its 20 cache slots (the slots not yet written masked)
        # and over one layer's precomputed image K/V; a recompute step's
        # causal self-attention
        ("K2", "caption cached step, self-attention over the cache slots",
         CAP_B * CAP_BEAMS, 1, CAP_MAX_LEN, 12, False, True),
        ("K2", "caption recompute step, causal self-attention", CAP_B,
         CAP_MAX_LEN, CAP_MAX_LEN, 12, False, "causal"),
        ("K3", "caption cached step, cross-attention over the image K/V",
         CAP_B * CAP_BEAMS, 1, 577, 12, False, False),
    ]


# heads narrower than the kernels' 64, which the wrappers zero-pad: the
# demo's (hidden 24 over 4 heads: 6 wide) at the MED's self-attention and
# the candidate-major cross-attention, and the one-card entry's tiny
# config's (32 over 4: 8 wide) at the ViT's 577 tokens; bf16, each a
# (case, head width)
NARROW_CASES = (
    (("K2", "masked text self-attention, the demo's 6-wide heads", 256, 40,
      40, 4, False, True), 6),
    (("K3", "candidate-major cross-attention, the demo's 6-wide heads", 8,
      32 * 40, 577, 4, False, False), 6),
    (("K1", "ViT self-attention, 8-wide heads", 16, 577, 577, 4, True,
      False), 8),
)


# K1 and K3 at heads wider than 64, bf16 and no bias, which the tensor-core
# kernel reads in place: EVA ViT-g's 88-wide heads (BLIP-2's vision tower)
# at its embed batch and MoonViT's 72-wide ones (Kimi-VL's) at its bank
# batch, folded (K1, the paths') and unfolded (K3), and a ragged shape of
# each width (rows and keys no multiple of the tiles, 5 heads); the last
# item is the head width
WIDE_CASES = (
    ("K1", "ViT-g self-attention, 88-wide heads", S1E_EMBED_BATCH, 257, 257,
     16, True, False, 88),
    ("K3", "ViT-g self-attention unfolded, 88-wide heads", S1E_EMBED_BATCH,
     257, 257, 16, False, False, 88),
    ("K1", "ragged, 88-wide heads", 3, 75, 131, 5, True, False, 88),
    ("K3", "ragged, 88-wide heads", 3, 75, 131, 5, False, False, 88),
    ("K1", "MoonViT self-attention, 72-wide heads", KV_BANK_BATCH, 784, 784,
     16, True, False, 72),
    ("K3", "MoonViT self-attention unfolded, 72-wide heads", KV_BANK_BATCH,
     784, 784, 16, False, False, 72),
    ("K1", "ragged, 72-wide heads", 3, 75, 131, 5, True, False, 72),
    ("K3", "ragged, 72-wide heads", 3, 75, 131, 5, False, False, 72),
)


def run_wide_cases() -> dict:
    """WIDE_CASES through ``run_kernel_case``; fails unless each one
    launched its width's instantiation ("K1_d88", "K3_d72", ...). Returns
    each width's first K1 case's record under "K1_d88" and "K1_d72"."""
    records = {}
    for *case, d in WIDE_CASES:
        kid = f"{case[0]}_d{d}"
        n0 = registry.WIDE[kid]
        rec = run_kernel_case(*case, torch.bfloat16, d=d)
        if registry.WIDE[kid] == n0:
            fail(f"{case[0]} {case[1]}: no {d}-wide launch counted")
        if case[0] == "K1":
            records.setdefault(kid, rec)
    return records


def run_kernel_case(kid, label, e, lq, m, h, folded, with_bias, dtype,
                    d: int = 64):
    """``with_bias``: False, True (a key mask [E, 1, 1, M], row stride 0
    in the kernel) or 'causal' (the key mask plus (1 - tril) * -10000,
    [E, 1, Lq, M] with row stride M, as the caption decoder's recompute
    step builds it). ``d``: the head width (below 64 the wrapper pads the
    heads to the kernels' 64; the bound counts the true width)."""
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
    from candidate_reranking_cir_tpu_torch.ops.attention import (
        make_additive_mask,
    )
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)
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
        if with_bias == "causal":
            tri = torch.tril(torch.ones(lq, m, device="cuda"))
            bias = bias + (1.0 - tri) * -10000.0              # [E, 1, Lq, M]

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
    bias_tag = {False: "", True: " +mask", "causal": " +causal mask"}[
        with_bias]
    print(f"[kernel] {kid} {label} {rec['dtype']} ({route}) q/k/v "
          f"{list(shape_q)} x {m} keys{bias_tag}: "
          f"max|err| {err:.3e} (tol {TOL[dtype]}), kernel {rec['ms']:.4f} "
          f"ms, plain {rec['plain_ms']:.4f} ms, sdpa "
          f"{rec['library_ms']:.4f} ms, kernel/sdpa {ratio:.2f}x; device "
          f"only: kernel {rec['device_ms']:.4f} ms, sdpa "
          f"{rec['library_device_ms']:.4f} ms, kernel/sdpa "
          f"{device_ratio:.2f}x; bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


# G1 at the paths' shapes (label, product shape): the ViT's fc1 at embed
# batch 32, a candidate-major dual-encoder chunk's fc1 (8 candidates x 32
# queries x 40 tokens), the caption head's transform over the beams at
# full length, and a ragged row count at a width that is no multiple of 8
# (the scalar body)
G1_CASES = (
    ("ViT fc1, embed batch 32", (32 * 577, 3072)),
    ("candidate-major dual-encoder chunk fc1", (8, 32 * TEXT_LEN, 3072)),
    ("caption LM head transform", (CAP_B * CAP_BEAMS, CAP_MAX_LEN, 768)),
    ("ragged rows, odd width (scalar body)", (4099, 3071)),
)
# G1's instruction-issue bound: the 8-wide loop's SASS (sm_90a build)
# issues about this many instructions an element (the IEEE divide's and
# expf's sequences, ~22 fp32 operations, the bf16 conversions), at 4 warp
# instructions a clock an SM
G1_INSTR_PER_ELEMENT = 55
SM_CLOCK_HZ = 1.98e9           # H100 SXM boost clock (NVIDIA data sheet)


def run_bias_gelu_cases() -> list:
    """G1 at G1_CASES in bf16 with an fp32 bias: bit for bit against
    ``bias_gelu_plain`` (fails on any differing bit), kernel / plain /
    ``F.gelu`` + bias times, device-only times and the bound."""
    import torch.nn.functional as F

    from candidate_reranking_cir_tpu_torch.ops import activation as act

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    recs = []
    for label, shape in G1_CASES:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        p = (torch.randn(shape, generator=g, device="cuda") * 3).bfloat16()
        b = torch.randn(shape[-1], generator=g, device="cuda") * 0.5
        kernel = lambda: act.bias_gelu(p, b)
        plain = lambda: act.bias_gelu_plain(p, b)
        library = lambda: F.gelu(p + b.to(p.dtype))
        n0 = registry.FUSED["G1"]
        got = kernel()
        torch.cuda.synchronize()
        launched = registry.FUSED["G1"] - n0
        ref = plain()
        differ = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
        err = (got.float() - ref.float()).abs().max().item()
        if differ or launched != 1:
            fail(f"G1 {label} {list(shape)}: {differ} elements differ from "
                 f"the plain version (max |err| {err:.3e}); {launched} "
                 "launches")
        t_mem = (4 * p.numel() + 4 * b.numel()) / HBM_BYTES_PER_S
        t_issue = p.numel() * G1_INSTR_PER_ELEMENT / 32 / (
            sms * 4 * SM_CLOCK_HZ)
        rec = {"name": "G1", "label": label, "dtype": "bfloat16",
               "shape": list(shape), "max_abs_err": err,
               "ms": time_ms(kernel, 50), "device_ms": graph_ms(kernel, 50),
               "plain_ms": time_ms(plain, 10),
               "library_ms": time_ms(library, 50),
               "library_device_ms": graph_ms(library, 50),
               "bound_ms": max(t_mem, t_issue) * 1e3,
               "bound_by": "bytes" if t_mem >= t_issue else
               "instruction issue", "bytes_bound_ms": t_mem * 1e3,
               "issue_bound_ms": t_issue * 1e3}
        print(f"[kernel] G1 {label} bf16 {list(shape)}: bit-equal to the "
              f"plain version; kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, F.gelu+bias "
              f"{rec['library_ms']:.4f} ms; device only: kernel "
              f"{rec['device_ms']:.4f} ms, F.gelu+bias "
              f"{rec['library_device_ms']:.4f} ms; bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; bytes "
              f"{rec['bytes_bound_ms']:.4f}, issue "
              f"{rec['issue_bound_ms']:.4f} at {sms} SMs)", flush=True)
        recs.append(rec)
    return recs


# G2 at the paths' shapes (label, input shape, residual, sum kept, eps): the
# EVA ViT-g's norm2 and norm1 at embed batch 32 (32 x 257 rows of 1408), the
# ViT-B's norm2 at embed batch 32, a candidate-major dual-encoder chunk's
# post-LN (8 candidates x 32 queries x 40 tokens), the Q-Former's query
# rows at q_batch 256, and a ragged width (the scalar body)
G2_CASES = (
    ("EVA ViT-g norm2, embed batch 32", (32 * 257, 1408), True, True, 1e-6),
    ("EVA ViT-g norm1, embed batch 32", (32 * 257, 1408), False, False,
     1e-6),
    ("ViT-B norm2, embed batch 32", (32 * 577, 768), True, True, 1e-6),
    ("candidate-major dual-encoder chunk post-LN", (8 * 32 * TEXT_LEN, 768),
     True, False, 1e-12),
    ("Q-Former query rows, q_batch 256", (256, 32, 768), True, False, 1e-12),
    ("ragged rows, odd width (scalar body)", (4099, 1407), True, False,
     1e-12),
)
G2_TOL = 2e-2                  # bf16's bound, absolute and relative
# the share of output elements that may differ from the plain version at
# all: the fp32 sums' order moves a few in 10^5 by one bf16 ulp, while a
# kernel off by a formula (an unbiased variance, eps dropped, a coarse
# rsqrt) moves most of them, if each by less than G2_TOL
G2_DIFFER_SHARE_MAX = 1e-3


def run_layer_norm_cases() -> list:
    """G2 at G2_CASES in bf16 with fp32 gains and biases: within G2_TOL of
    ``add_layer_norm_plain``, with at most G2_DIFFER_SHARE_MAX of the
    elements differing (fails otherwise, or if a kept sum differs in any
    bit), the share of elements that differ, kernel / plain /
    ``F.layer_norm`` times, device-only times and the bytes bound."""
    import torch.nn.functional as F

    from candidate_reranking_cir_tpu_torch.ops import norm

    recs = []
    for label, shape, residual, keep, eps in G2_CASES:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = (torch.randn(shape, generator=g, device="cuda") * 3 + 0.5
             ).bfloat16()
        r = torch.randn(shape, generator=g, device="cuda").bfloat16() \
            if residual else None
        n = shape[-1]
        w = 1 + 0.2 * torch.randn(n, generator=g, device="cuda")
        b = 0.1 * torch.randn(n, generator=g, device="cuda")
        wl, bl = w.bfloat16(), b.bfloat16()
        kernel = lambda: norm.add_layer_norm(x, r, w, b, eps, keep)
        plain = lambda: norm.add_layer_norm_plain(x, r, w, b, eps, keep)
        library = (lambda: F.layer_norm(x + r, (n,), wl, bl, eps)) \
            if residual else (lambda: F.layer_norm(x, (n,), wl, bl, eps))
        n0 = registry.FUSED["G2"]
        got = kernel()
        torch.cuda.synchronize()
        launched = registry.FUSED["G2"] - n0
        ref = plain()
        sum_differ = 0
        if keep:
            sum_differ = int((got[1].view(torch.int16)
                              != ref[1].view(torch.int16)).sum())
            got, ref = got[0], ref[0]
        a, e = got.float(), ref.float()
        err = (a - e).abs().max().item()
        over = int(((a - e).abs() > G2_TOL + G2_TOL * e.abs()).sum())
        share = (got.view(torch.int16) != ref.view(torch.int16)
                 ).float().mean().item()
        if over or share > G2_DIFFER_SHARE_MAX or sum_differ \
                or launched != 1:
            fail(f"G2 {label} {list(shape)}: {over} elements beyond "
                 f"{G2_TOL} of the plain version (max |err| {err:.3e}), "
                 f"{share:.4%} of the elements differ (at most "
                 f"{G2_DIFFER_SHARE_MAX:.2%}), {sum_differ} elements of the "
                 f"sum differ; {launched} launches")
        n_bytes = 2 * x.numel() * (2 + int(residual) + int(keep)) + 8 * n
        t_mem = n_bytes / HBM_BYTES_PER_S
        rec = {"name": "G2", "label": label, "dtype": "bfloat16",
               "shape": list(shape), "residual": residual, "keep_sum": keep,
               "eps": eps, "max_abs_err": err, "differ_share": share,
               "ms": time_ms(kernel, 50), "device_ms": graph_ms(kernel, 50),
               "plain_ms": time_ms(plain, 10),
               "library_ms": time_ms(library, 50),
               "library_device_ms": graph_ms(library, 50),
               "bound_ms": t_mem * 1e3, "bound_by": "bytes",
               "bytes_bound_ms": t_mem * 1e3}
        print(f"[kernel] G2 {label} bf16 {list(shape)}"
              f"{' + residual' if residual else ''}"
              f"{', sum kept' if keep else ''}, eps {eps:g}: within "
              f"{G2_TOL} of the plain version (max |err| {err:.3e}, "
              f"{share:.4%} of the elements differ); kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"F.layer_norm{' after the add' if residual else ''} "
              f"{rec['library_ms']:.4f} ms; device only: kernel "
              f"{rec['device_ms']:.4f} ms, F.layer_norm "
              f"{rec['library_device_ms']:.4f} ms; bytes bound "
              f"{rec['bound_ms']:.4f} ms, kernel/bound "
              f"{rec['device_ms'] / rec['bound_ms']:.2f}x", flush=True)
        recs.append(rec)
    return recs


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
    k5 = lambda: tat.write_keep_mask(buf, seed, 0, 0, rate)
    recs["K5"] = {"name": "K5", "dtype": name, "shape": [lq, m],
                  "max_abs_err": float(mismatches), "ms": time_ms(k5),
                  "plain_ms": time_ms(lambda: tat.keep_mask(
                      seed, 0, 0, lq, m, rate, device="cuda")),
                  "library_ms": None, "device_ms": graph_ms(k5),
                  "bound_ms": b_ms, "bound_by": b_by}
    print(f"[kernel] K5 keep-mask [{lq}, {m}]: kernel "
          f"{recs['K5']['ms']:.4f} ms, plain {recs['K5']['plain_ms']:.4f} "
          f"ms; device only: kernel {recs['K5']['device_ms']:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)

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
    registry.reset()
    res = evaluate_cirr_stage2_datasets(s1, None, s2, None, tok, corpus,
                                        queries, **kw)
    launches = registry.counts()
    dense_share("stage2_eval")
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
    (the same weights, the pairs of the first BF16_CPU_QUERIES queries):
    the max difference within BF16_CARD_VS_CPU_REL_TOL of the fp32 logits'
    std and the root-mean-square one within BF16_CARD_VS_CPU_RMS_REL_TOL,
    with both differences of each bf16 path from fp32 and from each other
    printed beside them; and how far the bf16 re-rank order
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
    d, d_rms = diff("bf16 card", "bf16 cpu")
    tol = BF16_CARD_VS_CPU_REL_TOL * spread
    tol_rms = BF16_CARD_VS_CPU_RMS_REL_TOL * spread
    print(f"[check] bf16 logits over the first {n} queries' "
          f"{rows['bf16 cpu'].size} pairs: {'; '.join(parts)}; tol on bf16 "
          f"card vs bf16 cpu max {BF16_CARD_VS_CPU_REL_TOL} x std = "
          f"{tol:.3e}, rms {BF16_CARD_VS_CPU_RMS_REL_TOL} x std = "
          f"{tol_rms:.3e}", flush=True)
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
    if not (d <= tol and d_rms <= tol_rms):
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
    and the rms |card - CPU|, in fp32 logit std); fails unless every fault
    of BF16_CONTROL_CAUGHT reads above one of the check's tolerances."""
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
              f"logit std; tol on the max {BF16_CARD_VS_CPU_REL_TOL}, on "
              f"the rms {BF16_CARD_VS_CPU_RMS_REL_TOL}): "
              + "; ".join(
                  f"{kid} x {share}: {mx:.3f}, {rms:.3f}"
                  for (ev, kid, share), (mx, rms) in readings.items()
                  if ev == every), flush=True)
    missed = [key for key in BF16_CONTROL_CAUGHT
              if not (readings[key][0] > BF16_CARD_VS_CPU_REL_TOL
                      or readings[key][1] > BF16_CARD_VS_CPU_RMS_REL_TOL)]
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


def is_bias_instantiation(name: str) -> bool:
    """Whether a demangled eval tensor-core kernel name is the bias
    instantiation (K2, K4): ``attn_fwd_tc_kernel<wg, true, head width>``."""
    return re.search(r"attn_fwd_tc_kernel<\d+, true[,>]", name) is not None


def profile_device(label: str, run) -> dict:
    """Device time by kernel family over one run of ``run`` (torch.profiler,
    CUPTI), and the device's idle share of its wall time. Every profiled
    run is bf16: it fails if an eval attention ran on the fp32-FMA kernel,
    or a K6, K7, K8 or K9 on its fp32-FMA body, instead of the tensor-core
    ones. Returns {kernel name: device us} (empty without records)."""
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
        return {}
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
    return kernels


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


# ``Dense``'s kept casts on each path's counted run, by path (printed last)
DENSE_BY_PATH = {}


def dense_share(path: str) -> None:
    """Print and keep ``registry.DENSE`` since the path's ``reset()``: the
    ``Dense`` calls that took their bf16 weight and bias from the cache,
    those that cast them first, and the hit share (None where no call took
    the cached route: fp32, or grad mode)."""
    n = dict(registry.DENSE)
    total = n["cast"] + n["cached"]
    share = round(100.0 * n["cached"] / total, 3) if total else None
    DENSE_BY_PATH[path] = {**n, "hit_share_pct": share}
    print(f"[dense] {path}: {n['cached']} cached, {n['cast']} cast, hit "
          f"share {share}%", flush=True)


def timed_steps(tag: str, step, batches, seed: int, n_steps: int):
    """One warm-up step, then ``n_steps`` counted steps with every launch
    count set to 0 just before them and read just after; prints the
    seconds the cyclic garbage collector took inside each counted step.
    Returns (seconds, losses, launches, peak GiB, text widths)."""

    gc.collect()  # earlier phases' garbage is not this path's
    loss = step(next(batches), seed)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up step: loss {float(loss):.4f}", flush=True)
    registry.reset()
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
    launches = registry.counts()
    dense_share(tag)
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
            registry.reset()
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
                        vocab_words: list[str],
                        text_len: int = TEXT_LEN) -> list[dict]:
    """CIRR-val-shaped queries: the reference drawn uniformly from the
    corpus (4,181 over 2,297 images: about 1.8 queries an image, as in
    CIRR val), a 6-member group of the reference, the target and four
    more, and a caption of ``caption_lengths``' token count (one toy word
    a token; [ENC] and [SEP] take two)."""
    n = len(names)
    refs = rng.integers(0, n, size=n_q)
    n_words = caption_lengths(n_q, text_len, rng) - 2
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
    profile of one fusion pass. Returns {"launches": the counted run's,
    "corpus" (phase 11 serves it), "result", "model": the stage-I model,
    "pred": the profiled fusion pass's predictions, "pooled": the pooled
    index} (phase 15 replays the same eval as one program)."""
    from candidate_reranking_cir_tpu_torch.data.topk_io import (
        load_topk_file,
        save_topk_file,
    )
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
    registry.reset()
    res, payload = evaluate_cirr_stage1(s1, None, corpus, queries, tok, **kw)
    launches = registry.counts()
    dense_share("stage1_eval")
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
            and launches["G1"] > 0 and launches["G2"] > 0
            and launches["K3"] == 0):
        fail(f"stage-I eval launches {launches}: K1, K2, G1 and G2 must run, "
             "K3 not")
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
    preds = []
    profile_device("stage-I fusion pass",
                   lambda: preds.append(predict_queries(fuse, *fuse_args)))
    del bank, fuse_args
    stage1_fp32_eval_check(s1, tok, queries, corpus, pooled)
    return {"launches": launches, "corpus": corpus, "result": res,
            "model": s1, "pred": preds[0], "pooled": pooled}


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
# phase 15: the single-program stage-I eval and the dropout layouts

def single_program_path(tok, words, queries: list[dict], s1e: dict) -> dict:
    """Phase 15 (a): ``evaluate_cirr_stage1(single_program=True)`` on phase
    9's corpus, queries and model: the host's and the copy's seconds, the
    capture, SP_REPLAYS timed replays, queries/s beside phase 9's, a
    profiled replay, the graph's pool; the replay held to phase 9's
    multi-launch top-K and ranks bit for bit (else the stated fallback),
    two replays bit-equal, weights from SEED + 1 loaded in place replayed
    from the cache against a multi-launch run with them, and a model moved
    to the CPU and back captured again (on a small corpus). Returns the
    launches the first call made (its eager pass and its capture; a
    replay adds none)."""
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        evaluate_cirr_stage1,
        make_single_program_eval,
    )

    s1, corpus, multi = s1e["model"], s1e["corpus"], s1e["result"]
    kw = dict(text_len=TEXT_LEN, batch_size=S1E_EMBED_BATCH,
              save_topk_k=TOPK, q_batch=S1E_Q_BATCH, device="cuda")
    n_q = len(queries)
    gc.collect()
    registry.reset()
    res, _ = evaluate_cirr_stage1(s1, None, corpus, queries, tok,
                                  single_program=True, **kw)
    launches = registry.counts()
    dense_share("single_program")
    run = make_single_program_eval(s1)
    cap = run.capture
    sec = res.seconds
    in_gib = sum(x.numel() * x.element_size() for x in cap.inputs) / 2 ** 30
    print(f"[single_program] first call seconds {json.dumps(sec)} (load: "
          f"the dataset's batches on the host; copy: host to card, "
          f"{S1E_IMAGES} images; plan: tokenize, schedule, upload; "
          f"program: an eager pass, the capture and one replay)",
          flush=True)
    print(f"[single_program] capture {cap.seconds:.3f} s; graph pool "
          f"{cap.pool_bytes / 2 ** 30:.2f} GiB, static inputs "
          f"{in_gib:.2f} GiB (the corpus images and the plan); launches "
          f"recorded by the capture {json.dumps(cap.launches)}; the first "
          f"call's launches (eager pass and capture) "
          f"{json.dumps(launches)}", flush=True)
    if not (cap.launches["K1"] > 0 and cap.launches["K2"] > 0
            and cap.launches["K3"] == 0):
        fail(f"the single program's launches {cap.launches}: K1 and K2 "
             "must run, K3 not")
    same = (np.array_equal(res.topk, multi.topk)
            and np.array_equal(res.ranks, multi.ranks))
    d_pred = float((run.pred - s1e["pred"]).abs().max())
    print(f"[single_program] replay vs phase 9's multi-launch path: topk "
          f"and ranks bit-equal {same}; metrics equal "
          f"{res.metrics == multi.metrics}; max |prediction diff| "
          f"{d_pred:.3e}", flush=True)
    if not same:
        top_gap_check("single-program replay", res.topk, multi.topk,
                      run.pred, s1e["pooled"])

    walls, events, outs = [], [], []
    for _ in range(SP_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        outs.append(run.replay())
        end.record()
        end.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(start.elapsed_time(end) / 1e3)
    wall = float(np.median(walls))
    multi_qps = n_q / multi.seconds["total"]
    print(f"[single_program] {SP_REPLAYS} replays: wall median {wall:.4f} s "
          f"(spread {min(walls):.4f}-{max(walls):.4f}), CUDA events median "
          f"{float(np.median(events)):.4f} s; stage-I queries/s over a "
          f"replay {n_q / wall:.1f} against phase 9's multi-launch "
          f"{multi_qps:.1f} (its whole call) and "
          f"{n_q / (multi.seconds['total'] - multi.seconds['index']):.1f} "
          f"(fusion and ranking only)", flush=True)
    equal = all(np.array_equal(a, b) for out in outs[1:]
                for a, b in zip(outs[0], out))
    print(f"[single_program] replays bit-equal: {equal}", flush=True)
    if not equal:
        fail("two replays of the single program differ")
    kernels = profile_device("single-program replay", run.replay)
    attn = sorted({nm[:80] for nm in kernels if "attn_fwd_tc_kernel" in nm})
    print(f"[single_program] eval attention kernels in the profiled "
          f"replay: {attn if attn else 'not measured (no records)'}",
          flush=True)
    if kernels and not any(is_bias_instantiation(nm) for nm in attn):
        fail("the profiled replay shows no K2 (attn_fwd_tc_kernel<., "
             "true, .>)")

    # weights from SEED + 1 loaded in place: the cache's graph replays them
    t0 = time.perf_counter()
    torch.manual_seed(SEED + 1)
    other = RetrievalModel(s1.cfg, dtype=torch.bfloat16, device="cuda")
    s1.load_state_dict(other.state_dict())
    del other
    captures = run.captures
    swapped, _ = evaluate_cirr_stage1(s1, None, corpus, queries, tok,
                                      single_program=True, **kw)
    eager, _ = evaluate_cirr_stage1(s1, None, corpus, queries, tok, **kw)
    hit = run.captures == captures
    same = (np.array_equal(swapped.topk, eager.topk)
            and np.array_equal(swapped.ranks, eager.ranks))
    print(f"[single_program] weights of seed {SEED + 1} loaded in place: "
          f"cache hit {hit}, replay vs a multi-launch run with them: topk "
          f"and ranks bit-equal {same}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"[single_program] whole calls, end to end: the cache-hit "
          f"single-program call {swapped.seconds['total']:.4f} s "
          f"({n_q / swapped.seconds['total']:.1f} queries/s; "
          f"{json.dumps(swapped.seconds)}) against the multi-launch call "
          f"right after it, same weights {eager.seconds['total']:.4f} s "
          f"({n_q / eager.seconds['total']:.1f} queries/s); the first "
          f"single-program call {sec['total']:.4f} s, phase 9's "
          f"multi-launch call {multi.seconds['total']:.4f} s", flush=True)
    if not hit or np.array_equal(swapped.ranks, res.ranks):
        fail("the weight swap did not replay the cached graph with the "
             "new weights")
    if not same:
        fail("the replay with swapped weights disagrees with the "
             "multi-launch path")

    # a model moved off the card and back has new addresses: captured
    # again (on the warm-up's small corpus, a plan of its own)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)
    small = Corpus(S1E_WARMUP[0], s1.cfg.vit.image_size, rng,
                   float32_draw=True)
    small_q = stage1_eval_queries(small.index_names, S1E_WARMUP[1], rng,
                                  words)
    before, _ = evaluate_cirr_stage1(s1, None, small, small_q, tok,
                                     single_program=True, **kw)
    captures = run.captures
    s1.to("cpu")
    s1.to("cuda")
    moved, _ = evaluate_cirr_stage1(s1, None, small, small_q, tok,
                                    single_program=True, **kw)
    eager, _ = evaluate_cirr_stage1(s1, None, small, small_q, tok, **kw)
    same = all(np.array_equal(getattr(moved, k), getattr(r, k))
               for r in (before, eager) for k in ("topk", "ranks"))
    print(f"[single_program] moved to the CPU and back ({S1E_WARMUP[0]} "
          f"images, {S1E_WARMUP[1]} queries): captures {captures} -> "
          f"{run.captures}; equal to the replay before the move and to a "
          f"multi-launch run: {same}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if run.captures != captures + 1 or not same:
        fail("a moved model was not captured again, or its replay differs")
    run.release()
    return launches


def top_gap_check(label: str, topk, ref_topk, pred, pooled) -> None:
    """The card rule of PERF.md section 2 for two top-K lists over one
    index: equal but where the two candidates' distances (from ``pred``
    [N_q, E] and ``pooled`` [N, E]) differ by under S1E_TIE_GAP."""
    a, b = topk[:, :TOPK], ref_topk[:, :TOPK]
    dist = (1.0 - pred.float() @ pooled.float().T).cpu().numpy()
    rows = np.arange(a.shape[0])[:, None]
    differ = a != b
    gaps = np.abs(dist[rows, a] - dist[rows, b])[differ]
    print(f"[single_program] {label}: top-{TOPK} lists differ at "
          f"{int(differ.sum())} of {differ.size} places, largest distance "
          f"gap there {float(gaps.max()) if gaps.size else 0.0:.3e} (tol "
          f"{S1E_TIE_GAP})", flush=True)
    if gaps.size and not gaps.max() <= S1E_TIE_GAP:
        fail(f"{label}: the top-{TOPK} lists differ beyond ties")


@contextlib.contextmanager
def kernel_thresholds(zero: bool):
    """``ops/attention_train``'s MIN_KV and MIN_ROWS at 0 (every attention
    site with dropout takes the kernels' hash mask, so the card and the
    CPU draw the same) or left at their defaults."""
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat

    saved = tat.MIN_KV, tat.MIN_ROWS
    if zero:
        tat.MIN_KV = tat.MIN_ROWS = 0
    try:
        yield
    finally:
        tat.MIN_KV, tat.MIN_ROWS = saved


def seed_table(shape: tuple[int, int], base: int) -> list[list[int]]:
    return [[base + i * shape[1] + j for j in range(shape[1])]
            for i in range(shape[0])]


def loss_and_grads(model, run, device: str) -> tuple:
    """(output on the CPU, {name: grad on the CPU}, seconds) of one
    forward and backward: ``run()`` returns (loss, output)."""
    model.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    loss, out = run()
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    return out.detach().float().cpu(), grads, seconds


def card_vs_cpu_grads(label: str, card: tuple, cpu: tuple) -> None:
    """Outputs within DL_LOGIT_TOL and gradients within DL_GRAD_REL_TOL of
    the largest, fp32 card against CPU."""
    d_out = float((card[0] - cpu[0]).abs().max())
    g_max = max(float(g.abs().max()) for g in cpu[1].values())
    d_grad = max(float((card[1][n] - g).abs().max())
                 for n, g in cpu[1].items())
    print(f"[dropout] {label}: card {card[2]:.2f} s, cpu {cpu[2]:.2f} s; "
          f"max |output diff| {d_out:.3e} (tol {DL_LOGIT_TOL}); max |grad "
          f"diff| {d_grad:.3e} over {len(cpu[1])} tensors, largest |grad| "
          f"{g_max:.3e} (tol {DL_GRAD_REL_TOL} x largest)", flush=True)
    if set(card[1]) != set(cpu[1]) or not d_out <= DL_LOGIT_TOL \
            or not d_grad <= DL_GRAD_REL_TOL * g_max:
        fail(f"{label}: the card disagrees with the CPU")


def dropout_layouts_path(tok) -> dict:
    """Phase 15 (b) and (c), fp32 at full width, attention dropout
    DL_RATE (hidden dropout and drop-path 0): the 12-layer re-ranker's
    ``score_per_query`` over DL_PQ (queries, candidates) and
    ``score_grid`` over DL_GRID (candidates, queries), and a
    ``CaptionDecoder``'s teacher-forced caption loss over DL_CAP_B images,
    each a forward and a backward on the card and on the CPU with the
    kernel thresholds at 0 (card vs CPU within DL_LOGIT_TOL and
    DL_GRAD_REL_TOL), then timed on the card at the default thresholds
    (the re-ranker at DL_PQ_TIMED and DL_GRID_TIMED, where score_grid must
    launch K6/K7). Returns the card runs' launches."""
    from candidate_reranking_cir_tpu_torch.config import (
        RerankerModelConfig,
        RetrievalModelConfig,
        TextEncoderConfig,
        vit_config,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_decoder import (
        CaptionDecoder,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )

    rng = np.random.default_rng(SEED + 40)
    text = TextEncoderConfig(hidden_dropout=0.0, attention_dropout=DL_RATE)
    vit = vit_config("base", 384, attention_dropout=DL_RATE)
    width = text.hidden_size

    def texts(lead: tuple) -> tuple:
        n = int(np.prod(lead))
        lens = caption_lengths(n, TEXT_LEN, rng).reshape(lead)
        ids = rng.integers(1000, 30000, (*lead, TEXT_LEN)).astype(np.int32)
        mask = (np.arange(TEXT_LEN) < lens[..., None]).astype(np.int32)
        return ids, mask

    m = vit.num_tokens

    def case(method: str, lead: tuple) -> tuple:
        """(arrays, what) of one call: score_per_query over lead = (queries,
        candidates), score_grid over lead = (candidates, queries)."""
        if method == "score_per_query":
            q, c = lead
            return ((rng.standard_normal((q, TEXT_LEN, width), np.float32),
                     *texts((q,)),
                     rng.standard_normal((q, c, m, width), np.float32)),
                    f"{q} queries x {c} candidates")
        a, b = lead
        return ((rng.standard_normal((a, b, TEXT_LEN, width), np.float32),
                 *texts((a, b)),
                 rng.standard_normal((a, m, width), np.float32)),
                f"{a} candidates x {b} queries")

    sizes = {"score_per_query": (DL_PQ, DL_PQ_TIMED),
             "score_grid": (DL_GRID, DL_GRID_TIMED)}
    torch.manual_seed(SEED + 41)
    models = {"cpu": RerankerModel(RerankerModelConfig(
        vit=vit, text=text, text_len=TEXT_LEN), device="cpu")}
    models["cuda"] = RerankerModel(models["cpu"].cfg, device="cuda")
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    seeds = seed_table(models["cpu"].text_encoder.seed_shape, SEED + 42)
    registry.reset()

    def layout_run(dev, method, arrays):
        model = models[dev]
        x = [torch.from_numpy(arr).to(dev) for arr in arrays]
        w = torch.from_numpy(np.random.default_rng(SEED + 43).standard_normal(
            arrays[0].shape[:-2] if method == "score_grid"
            else arrays[3].shape[:2]).astype(np.float32)).to(dev)

        def run():
            out = getattr(model, method)(*x, deterministic=False,
                                         seeds=seeds)
            return (out * w).mean(), out

        return loss_and_grads(model, run, dev)

    for method, (small, timed) in sizes.items():
        arrays, what = case(method, small)
        with kernel_thresholds(zero=True):
            runs = {dev: layout_run(dev, method, arrays)
                    for dev in ("cuda", "cpu")}
        card_vs_cpu_grads(f"{method} [{what}] fp32, thresholds 0",
                          runs["cuda"], runs["cpu"])
        arrays, what = case(method, timed)
        layout_run("cuda", method, arrays)            # warm-up
        before = registry.counts()
        t = layout_run("cuda", method, arrays)[2]
        k67 = {k: registry.counts()[k] - before[k] for k in ("K6", "K7")}
        print(f"[dropout] {method} [{what}] fp32 on the card at the default "
              f"thresholds: {t:.3f} s a forward and backward; launches "
              f"{json.dumps(k67)}", flush=True)
        if method == "score_grid" and not (k67["K6"] > 0 and k67["K7"] > 0):
            fail(f"score_grid [{what}] at the default thresholds launched "
                 f"{k67}: K6/K7 must run on the [A, B*Lq] fold")
    del models

    # (c) captioning
    cfg = RetrievalModelConfig(vit=vit, text=text, text_len=TEXT_LEN)
    torch.manual_seed(SEED + 44)
    cap = {"cpu": CaptionDecoder(cfg, device="cpu")}
    cap["cuda"] = CaptionDecoder(cfg, device="cuda")
    cap["cuda"].load_state_dict(cap["cpu"].state_dict())
    seeds = (seed_table(cap["cpu"].visual_encoder.seed_shape, SEED + 45),
             seed_table(cap["cpu"].text_decoder.seed_shape, SEED + 46))
    images = rng.standard_normal((DL_CAP_B, vit.image_size, vit.image_size,
                                  3), np.float32)
    ids, mask = texts((DL_CAP_B,))

    def caption_run(dev):
        model = cap[dev]
        x, i, k = (torch.from_numpy(arr).to(dev) for arr in (images, ids,
                                                             mask))

        def run():
            logits = model(x, i, k, deterministic=False, seeds=seeds)
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            nll = -logp.gather(-1, i[:, 1:, None].long())[..., 0]
            valid = k[:, 1:].float()
            return (nll * valid).sum() / valid.sum(), logits

        return loss_and_grads(model, run, dev)

    with kernel_thresholds(zero=True):
        runs = {dev: caption_run(dev) for dev in ("cuda", "cpu")}
    card_vs_cpu_grads(f"CaptionDecoder caption loss [{DL_CAP_B} images] "
                      "fp32, thresholds 0", runs["cuda"], runs["cpu"])
    t = caption_run("cuda")[2]
    print(f"[dropout] CaptionDecoder caption loss fp32 on the card at the "
          f"default thresholds: {t:.3f} s a forward and backward",
          flush=True)
    launches = registry.counts()
    print(f"[dropout] launches of the card runs {json.dumps(launches)}",
          flush=True)
    if not all(launches[k] > 0 for k in ("K5", "K6", "K7", "K8", "K9")):
        fail(f"the dropout layouts' launches {launches}: K5-K9 must run")
    del cap
    gc.collect()
    return launches


def phase15(tok, words, queries: list[dict], s1e: dict) -> dict:
    """Phase 15: (a) the single-program eval, (b) and (c) the dropout
    layouts. Returns each part's launches and the phase's seconds."""
    t0 = time.perf_counter()
    out = {"single_program": single_program_path(tok, words, queries, s1e),
           "dropout_layouts": dropout_layouts_path(tok)}
    seconds = time.perf_counter() - t0
    print(f"[phase15] phase seconds {seconds:.1f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: serving

def write_jpegs(directory, names: list[str], rng) -> list[str]:
    """Smooth jpegs at S1T_IMAGE_SIZE px (upsampled noise, as photos
    compress); returns their paths."""
    import PIL.Image

    paths = []
    for name in names:
        small = rng.integers(0, 255, size=(12, 12, 3), dtype=np.uint8)
        path = f"{directory}/{name}.jpg"
        PIL.Image.fromarray(small).resize(
            (S1T_IMAGE_SIZE, S1T_IMAGE_SIZE)).save(path, quality=90)
        paths.append(path)
    return paths


def serve_requests(names: list[str], words: list[str], uploads: list[str],
                   rng) -> list[dict]:
    """SRV_CLIENTS x SRV_PER_CLIENT /rank bodies: captions at the lengths
    of ``caption_lengths`` (one toy word a token; [ENC] and [SEP] take
    two), references drawn from ``names``; every SRV_UPLOAD_EVERY-th
    carries a jpeg's ``reference_path`` instead."""
    n = SRV_CLIENTS * SRV_PER_CLIENT
    n_words = caption_lengths(n, TEXT_LEN, rng) - 2
    out = []
    for i in range(n):
        body = {"caption": " ".join(rng.choice(words, n_words[i])),
                "k": SRV_K}
        if i % SRV_UPLOAD_EVERY == SRV_UPLOAD_EVERY - 1:
            body["reference_path"] = uploads[i % len(uploads)]
        else:
            body["reference"] = names[int(rng.integers(0, len(names)))]
        out.append(body)
    return out


def _http(port: int, path: str, body=None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def drive_http(engine, bodies: list[dict], admin=None) -> dict:
    """``make_http_server`` on an ephemeral port; SRV_CLIENTS threads send
    SRV_PER_CLIENT /rank requests each. ``admin``: (add body, remove body),
    posted by one more thread once half the requests are answered.
    Returns the answers by request, the errors, the wall seconds and the
    batcher's stats; the server and its worker are stopped."""
    import threading

    from candidate_reranking_cir_tpu_torch.cli.serve import make_http_server

    server = make_http_server(engine, 0, SRV_WINDOW_MS,
                              enable_admin=admin is not None)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    answers, errors, admin_out = {}, [], []
    lock, half = threading.Lock(), threading.Event()

    def client(c: int):
        for i in range(c, len(bodies), SRV_CLIENTS):
            code, out = _http(port, "/rank", bodies[i])
            with lock:
                if code == 200:
                    answers[i] = out
                else:
                    errors.append((i, code, out))
                if len(answers) + len(errors) >= len(bodies) // 2:
                    half.set()

    def admin_thread():
        half.wait(timeout=600)
        for path, body in zip(("/admin/add", "/admin/remove"), admin):
            admin_out.append((path, *_http(port, path, body)))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SRV_CLIENTS)]
    if admin is not None:
        threads.append(threading.Thread(target=admin_thread))
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            fail("serving: a client thread did not finish")
        stats = server.batcher.stats()
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        serving.join(timeout=30)
    return {"answers": answers, "errors": errors, "wall": wall,
            "stats": stats, "admin": admin_out}


def report_http(tag: str, run: dict, n: int) -> None:
    st = run["stats"]
    print(f"[serve] {tag}: {n} /rank requests from {SRV_CLIENTS} clients in "
          f"{run['wall']:.3f} s: {n / run['wall']:.1f} requests/s; batcher "
          f"latency p50 {st['latency_p50_s']} s, p95 {st['latency_p95_s']} "
          f"s, p99 {st['latency_p99_s']} s; {st['waves']} waves, mean "
          f"occupancy {st['mean_wave_occupancy']} of {SRV_Q_PAD}; errors "
          f"{len(run['errors'])} (batcher {st['errors']})", flush=True)
    for path, code, out in run["admin"]:
        print(f"[serve] {tag}: {path} -> {code} {json.dumps(out)}",
              flush=True)
    if run["errors"] or st["errors"]:
        fail(f"serving {tag}: errors {run['errors'][:4]}")
    if any(code != 200 for _, code, _ in run["admin"]):
        fail(f"serving {tag}: an admin request failed: {run['admin']}")


def serving_path(tok, words, corpus: Corpus) -> dict:
    """Phase 11: the serving path at full width in bf16 over the stage-I
    eval's corpus (CIRR-val scale): the index built, a cache round trip,
    HTTP traffic with admin updates, the int8 index, then the fp32 checks.
    Returns the launches of the bf16 HTTP run."""
    from candidate_reranking_cir_tpu_torch.data.preprocessing import (
        make_transform,
    )
    from candidate_reranking_cir_tpu_torch.runtime.serve import (
        CIRServingEngine,
        ServeRequest,
        ServingIndex,
        build_serving_index,
    )

    t_phase = time.perf_counter()
    s1, s2 = eval_models()
    size = s1.cfg.vit.image_size
    t0 = time.perf_counter()
    index = build_serving_index(s1, None, corpus, reranker=s2,
                                batch_size=S1E_EMBED_BATCH, device="cuda")
    torch.cuda.synchronize()
    bank_bytes = sum(b.numel() * b.element_size()
                     for b in (index.raw_s1, index.raw_s2))
    print(f"[serve] index of {len(index.names)} images built in "
          f"{time.perf_counter() - t0:.1f} s (two ViT passes at batch "
          f"{S1E_EMBED_BATCH}, the images' host-to-card copy included): "
          f"banks {list(index.raw_s1.shape)} x 2 {index.raw_s1.dtype}, "
          f"{bank_bytes / 2 ** 30:.3f} GiB; pooled "
          f"{list(index.pooled_s1.shape)}", flush=True)

    # the npz cache on a 128-image index
    n = SRV_CACHE_IMAGES
    small = ServingIndex(names=index.names[:n],
                         pooled_s1=index.pooled_s1[:n].clone(),
                         raw_s1=index.raw_s1[:n].clone(),
                         raw_s2=index.raw_s2[:n].clone(),
                         fingerprint={"dataset": "cirr", "seed": SEED})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        small.save(f"{tmp}/index.npz")
        t_save = time.perf_counter() - t0
        mib = os.path.getsize(f"{tmp}/index.npz") / 2 ** 20
        t0 = time.perf_counter()
        back = ServingIndex.load(f"{tmp}/index.npz", device="cuda",
                                 expect_fingerprint={"seed": SEED})
        t_load = time.perf_counter() - t0
    same = back.names == small.names and all(
        torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                    else a, b.view(torch.int16)
                    if b.dtype == torch.bfloat16 else b)
        for a, b in ((back.pooled_s1, small.pooled_s1),
                     (back.raw_s1, small.raw_s1),
                     (back.raw_s2, small.raw_s2)))
    print(f"[serve] cache of {n} images: {mib:.1f} MiB saved in "
          f"{t_save:.2f} s, loaded in {t_load:.2f} s; banks equal bit for "
          f"bit: {same}", flush=True)
    if not same:
        fail("serving: the index cache read back differs")
    del small, back

    rng = np.random.default_rng(SEED + 31)
    with tempfile.TemporaryDirectory() as tmp:
        uploads = write_jpegs(tmp, [f"upload{i}" for i in range(4)], rng)
        added = [f"added{i}" for i in range(SRV_ADMIN)]
        add_paths = write_jpegs(tmp, added, rng)
        removed = index.names[-SRV_ADMIN:]
        bodies = serve_requests(index.names[:-SRV_ADMIN], words, uploads,
                                rng)
        engine = CIRServingEngine(
            s1, None, tok, index, text_len=TEXT_LEN, q_pad=SRV_Q_PAD,
            reranker=s2, rerank_k=SRV_RERANK_K,
            transform=make_transform("targetpad", size), device="cuda")
        t0 = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        print(f"[serve] warm-up request in {time.perf_counter() - t0:.2f} s",
              flush=True)
        gc.collect()
        registry.reset()
        run = drive_http(engine, bodies, admin=(
            {"names": added, "paths": add_paths}, {"names": removed}))
        torch.cuda.synchronize()
        launches = registry.counts()
        dense_share("serve")
        report_http("bf16 index", run, len(bodies))
        print(f"[serve] launches {json.dumps(launches)}", flush=True)
        if not all(launches[k] > 0 for k in MAIN_PATH_KERNELS) or any(
                launches[k] for k in launches if k not in MAIN_PATH_KERNELS):
            fail(f"serving launches {launches}: K1-K3, G1 and G2 must run, "
                 "K4-K9 not")
        if index.n_valid != len(corpus) or any(
                nm in index.pos for nm in removed) or not all(
                nm in index.pos for nm in added):
            fail("serving: the admin updates did not take")
        reranked = [a["reranked"] for i, a in run["answers"].items()
                    if "reference" in bodies[i]]
        if len(run["answers"]) != len(bodies) or set(reranked) != {
                SRV_RERANK_K} or any(len(a["ranking"]) != SRV_K
                                     or not np.isfinite(a["scores"]).all()
                                     for a in run["answers"].values()):
            fail("serving: an answer has the wrong depth or scores")
        print(f"[serve] index after the admin updates: capacity "
              f"{index.capacity}, {index.n_valid} live images", flush=True)

        reqs = [ServeRequest(caption=b["caption"], reference=b["reference"],
                             k=SRV_K) for b in bodies
                if "reference" in b][:SRV_INT8_COMPARE]
        profile_device("serving wave", lambda: engine.handle(
            reqs[:SRV_Q_PAD]))
        base = engine.handle(reqs)
        torch.cuda.synchronize()

        # the int8 index: the same requests
        index.quantize()
        int8_bytes = index.raw_s1.nbytes + index.raw_s2.nbytes
        bf16_bytes = sum(int(np.prod(b.shape)) * 2
                         for b in (index.raw_s1, index.raw_s2))
        int8_run = drive_http(engine, bodies)
        report_http("int8 index", int8_run, len(bodies))
    quant = engine.handle(reqs)
    d_logit, overlap = 0.0, []
    for b, q in zip(base, quant):
        head_b = dict(zip(b.ranking[:b.reranked], b.scores[:b.reranked]))
        head_q = dict(zip(q.ranking[:q.reranked], q.scores[:q.reranked]))
        common = head_b.keys() & head_q.keys()
        d_logit = max([d_logit] + [abs(head_b[k] - head_q[k])
                                   for k in common])
        overlap.append(len(set(b.ranking[:10]) & set(q.ranking[:10])))
    ratio = int8_bytes / bf16_bytes
    print(f"[serve] int8 banks {int8_bytes / 2 ** 30:.3f} GiB against bf16 "
          f"{bf16_bytes / 2 ** 30:.3f} GiB at capacity {index.capacity}: "
          f"{ratio:.4f}x (gate <= {SRV_INT8_BYTES_RATIO}); re-ranked logits "
          f"of the heads' shared candidates differ by at most {d_logit:.3e} "
          f"from the bf16 index's; top-10 overlap {np.mean(overlap):.2f} of "
          f"10 (min {min(overlap)}) over {len(reqs)} requests (recorded, "
          f"not gated)", flush=True)
    if not ratio <= SRV_INT8_BYTES_RATIO:
        fail("serving: the int8 banks are not about half the bf16 banks")
    del engine, index, base, quant
    gc.collect()
    torch.cuda.empty_cache()

    serving_fp32_check(s1, s2, tok, words)
    query_major_fp32_check(s1, s2)
    del s1, s2
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return launches


def fp32_copy(model, device: str):
    """``model``'s weights in a float32 model of its class on ``device``."""
    out = type(model)(model.cfg, dtype=torch.float32, device=device)
    out.load_state_dict(model.state_dict())
    return out


def serving_fp32_check(s1, s2, tok, words) -> None:
    """The port's serving in fp32 on the card against the CPU: a
    SRV_CHECK_IMAGES-image index at full width built on each device, the
    same SRV_CHECK_REQUESTS requests, rerank_k SRV_CHECK_RERANK_K. Stage-I
    scores within SRV_STAGE1_TOL, re-ranked logits within SRV_STAGE2_TOL;
    rankings equal except where two candidates' CPU scores differ by less
    than SRV_TIE_GAP in the stage-I tail, or by less than twice the
    largest logit difference read in the re-ranked head."""
    from candidate_reranking_cir_tpu_torch.runtime.serve import (
        CIRServingEngine,
        ServeRequest,
        build_serving_index,
    )

    corpus = Corpus(SRV_CHECK_IMAGES, s1.cfg.vit.image_size,
                    np.random.default_rng(SEED + 41))
    rng = np.random.default_rng(SEED + 42)
    reqs = [ServeRequest(
        caption=" ".join(rng.choice(words, int(w))), reference=nm,
        k=SRV_CHECK_IMAGES - 1) for nm, w in zip(
            corpus.index_names, caption_lengths(SRV_CHECK_REQUESTS,
                                                TEXT_LEN, rng) - 2)]
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m1, m2 = fp32_copy(s1, dev), fp32_copy(s2, dev)
        index = build_serving_index(m1, None, corpus, reranker=m2,
                                    batch_size=SRV_CHECK_IMAGES, device=dev)
        engine = CIRServingEngine(
            m1, None, tok, index, text_len=TEXT_LEN, q_pad=SRV_Q_PAD,
            reranker=m2, rerank_k=SRV_CHECK_RERANK_K,
            max_k=SRV_CHECK_IMAGES - 1, device=dev)
        res[dev] = engine.handle(reqs)
        print(f"[check] fp32 serving on {dev}: a {SRV_CHECK_IMAGES}-image "
              f"index and {len(reqs)} requests in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del m1, m2, index, engine
    d1 = d2 = 0.0
    for c, p in zip(res["cuda"], res["cpu"]):
        if set(c.ranking) != set(p.ranking) or c.reranked != p.reranked:
            fail("fp32 serving: card and CPU rank different candidates")
        sc, sp = dict(zip(c.ranking, c.scores)), dict(zip(p.ranking,
                                                          p.scores))
        head = p.ranking[:p.reranked]
        d2 = max([d2] + [abs(sc[k] - sp[k]) for k in head])
        d1 = max([d1] + [abs(sc[k] - sp[k]) for k in p.ranking[p.reranked:]])
    swaps, worst_gap = 0, 0.0
    for c, p in zip(res["cuda"], res["cpu"]):
        sp = dict(zip(p.ranking, p.scores))
        for i, (a, b) in enumerate(zip(c.ranking, p.ranking)):
            if a != b:
                gap = abs(sp[a] - sp[b])
                tol = 2 * d2 if i < p.reranked else SRV_TIE_GAP
                swaps += 1
                worst_gap = max(worst_gap, gap)
                if not gap < tol:
                    fail(f"fp32 serving: rankings differ at a gap of {gap}")
    print(f"[check] fp32 serving card vs cpu: stage-I scores max |diff| "
          f"{d1:.3e} (tol {SRV_STAGE1_TOL}), re-ranked logits {d2:.3e} (tol "
          f"{SRV_STAGE2_TOL}); rankings differ at {swaps} places, largest "
          f"CPU score gap there {worst_gap:.3e}", flush=True)
    if not (d1 <= SRV_STAGE1_TOL and d2 <= SRV_STAGE2_TOL):
        fail("fp32 serving on the card disagrees with the CPU")


def query_major_fp32_check(s1, s2) -> None:
    """fp32 on the card: the query-major ``rerank`` (per-pair, and with
    dedup) against ``rerank_candidate_major`` over phase 5's first
    SRV_QM_QUERIES queries, groups and skip mask included: logits within
    FP32_CARD_VS_CPU_TOL."""
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
    from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
        rerank,
        rerank_candidate_major,
    )

    corpus, queries, tok, skip = eval_workload(s1.cfg.vit.image_size)
    queries, skip = queries[:SRV_QM_QUERIES], skip[:SRV_QM_QUERIES]
    m1, m2 = fp32_copy(s1, "cuda"), fp32_copy(s2, "cuda")
    bank, names = build_index(corpus, m2.embed_images, 16, device="cuda")
    kw = dict(captions=[q["caption"] for q in queries],
              reference_names=[q["reference_name"] for q in queries],
              topk_names=np.stack([q["topk_names"] for q in queries]),
              index_feats=bank, index_names=names, text_len=TEXT_LEN,
              skip_mask=skip,
              group_members=[q["group_members"] for q in queries],
              device="cuda")
    t0 = time.perf_counter()
    cm = rerank_candidate_major(m1, None, m2, None, tok, **kw)
    out = {dedup: rerank(m1, None, m2, None, tok, q_batch=8, dedup=dedup,
                         **kw) for dedup in (False, True)}
    diffs = {}
    for dedup, qm in out.items():
        diffs[dedup] = max(float(np.abs(qm.logits - cm.logits).max()),
                           float(np.abs(qm.group_logits
                                        - cm.group_logits).max()))
    print(f"[check] fp32 query-major vs candidate-major on the card over "
          f"{len(queries)} queries (K {TOPK} + 5 group members, q_batch 8) "
          f"in {time.perf_counter() - t0:.1f} s: max |logit diff| per-pair "
          f"{diffs[False]:.3e}, dedup {diffs[True]:.3e} (tol "
          f"{FP32_CARD_VS_CPU_TOL})", flush=True)
    if not max(diffs.values()) <= FP32_CARD_VS_CPU_TOL:
        fail("fp32 query-major re-rank disagrees with candidate-major")


# ---------------------------------------------------------------------------
# phase 17: BLIP-2's stage-I eval

def blip2_stage1_eval_path(tok, words) -> dict:
    """``evaluate_cirr_stage1`` with BLIP-2's ``Blip2RetrievalModel`` at its
    published widths in bf16 (random weights from SEED) on B2_IMAGES
    images at 224 px and B2_QUERIES queries, after a warm-up on B2_WARMUP.
    Fails unless every ViT-g block launched one 88-wide K1 an embed batch
    and nothing else did (K1_d88 = layers x batches), no 88-wide K3 ran,
    and the Q-Former's K1 (cross-attention), K2 (masked self-attention),
    K3 (the query pass's unmasked self-attention), G1 and G2 ran. Returns the
    counted run's launches."""
    from candidate_reranking_cir_tpu_torch.config import (
        Blip2RetrievalModelConfig,
    )
    from candidate_reranking_cir_tpu_torch.models.blip2_retrieval import (
        Blip2RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        evaluate_cirr_stage1,
    )

    t_phase = time.perf_counter()
    cfg = Blip2RetrievalModelConfig()
    torch.manual_seed(SEED)
    model = Blip2RetrievalModel(cfg, dtype=torch.bfloat16,
                                device="cuda").eval()
    size, text_len = cfg.vit.image_size, cfg.text_len
    kw = dict(text_len=text_len, batch_size=S1E_EMBED_BATCH,
              save_topk_k=TOPK, q_batch=S1E_Q_BATCH, device="cuda")
    rng = np.random.default_rng(SEED + 17)
    small = Corpus(B2_WARMUP[0], size, rng, float32_draw=True)
    evaluate_cirr_stage1(model, None, small, stage1_eval_queries(
        small.index_names, B2_WARMUP[1], rng, words, text_len), tok, **kw)
    corpus = Corpus(B2_IMAGES, size, rng, float32_draw=True)
    queries = stage1_eval_queries(corpus.index_names, B2_QUERIES, rng, words,
                                  text_len)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset()
    res, payload = evaluate_cirr_stage1(model, None, corpus, queries, tok,
                                        **kw)
    launches = registry.counts()
    dense_share("blip2_stage1_eval")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec = res.seconds
    batches = -(-B2_IMAGES // S1E_EMBED_BATCH)
    print(f"[blip2] EVA ViT-g/14 @ {size} ({cfg.vit.num_layers} blocks of "
          f"{cfg.vit.hidden_size}, {cfg.vit.num_heads} heads of "
          f"{cfg.vit.hidden_size // cfg.vit.num_heads}) + Q-Former "
          f"({cfg.text.num_layers} layers, {cfg.num_query_tokens} queries), "
          f"bf16: {B2_IMAGES} images, {len(queries)} queries; seconds "
          f"{json.dumps(sec)}; stage-I queries/s "
          f"{len(queries) / sec['total']:.1f}; peak {peak:.2f} GiB",
          flush=True)
    print(f"[blip2] launches {json.dumps(launches)}", flush=True)
    print(f"[blip2] metrics {json.dumps(res.metrics)}", flush=True)
    want_wide = cfg.vit.num_layers * batches
    if launches["K1_d88"] != want_wide or launches["K3_d88"] != 0 \
            or launches["K1"] <= launches["K1_d88"] \
            or not all(launches[k] > 0 for k in ("K2", "K3", "G1", "G2")):
        fail(f"BLIP-2 stage-I launches {launches}: K1_d88 must be "
             f"{want_wide} (one a ViT-g block and embed batch), 88-wide K3 "
             "0, K1 above K1_d88, K2, K3, G1 and G2 > 0")
    for key, val in res.metrics.items():
        if not 0.0 <= val <= 100.0:
            fail(f"BLIP-2 stage-I metric {key} = {val} out of range")
    if payload["sorted_index_names"].shape != (len(queries), TOPK):
        fail("unexpected BLIP-2 top-K payload shape")
    del model, corpus, small
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[blip2] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return launches


def draw_in_place(model, seed: int) -> None:
    """Random weights in each parameter's own dtype, on its device: a
    matrix (or a stack of them, the last axis its input) N(0, 1 / fan_in),
    a norm gain 1 + N(0, 0.02^2), every other vector (biases, the router's
    selection bias) N(0, 0.02^2)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if prm.dim() >= 2:
                prm.normal_(0.0, prm.shape[-1] ** -0.5, generator=g)
            elif name.endswith("weight"):
                prm.normal_(1.0, 0.02, generator=g)
            else:
                prm.normal_(0.0, 0.02, generator=g)


def kimi_vl_rerank_path(tok, words) -> dict:
    """``evaluate_cirr_stage2_datasets`` with no stage-I model and
    ``KimiVLReranker`` at its published widths, parameters held in bf16
    (random weights drawn in place from SEED), query-major in chunks of
    KV_Q_BATCH on KV_IMAGES images at 392 px and KV_QUERIES queries, after
    a warm-up on one chunk. Fails unless every MoonViT block launched one
    72-wide K1 a bank batch and no other K1 ran (K1_d72 = K1 = layers x
    batches), no 72-wide K3 ran, G2 ran, every routed layer routed rows,
    the latent attention ran, every ``Dense`` call was a hit and the
    scores are finite. Returns the counted run's launches."""
    from candidate_reranking_cir_tpu_torch.config import KimiVLRerankerConfig
    from candidate_reranking_cir_tpu_torch.models.kimi_vl import (
        KimiVLReranker,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
        evaluate_cirr_stage2_datasets,
    )

    t_phase = time.perf_counter()
    cfg = KimiVLRerankerConfig()
    model = KimiVLReranker(cfg, dtype=torch.bfloat16, device="cuda").eval()
    draw_in_place(model, SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[kimi_vl] {n_params / 1e9:.2f} B parameters held in bf16, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card, "
          f"drawn in {time.perf_counter() - t_phase:.1f} s", flush=True)
    size = cfg.vision.image_size
    rng = np.random.default_rng(SEED + 18)
    corpus = Corpus(KV_IMAGES, size, rng, float32_draw=True)
    queries = make_queries(corpus.index_names, KV_QUERIES, TOPK, rng, words)
    kw = dict(k=TOPK, text_len=32, batch_size=KV_BANK_BATCH,
              schedule="query_major", q_batch=KV_Q_BATCH, device="cuda")
    evaluate_cirr_stage2_datasets(None, None, model, None, tok, corpus,
                                  queries[:KV_Q_BATCH], **kw)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset()
    res = evaluate_cirr_stage2_datasets(None, None, model, None, tok, corpus,
                                        queries, **kw)
    launches = registry.counts()
    moe = {key: int(val) for key, val in registry.MOE.items()}
    sdpa = dict(registry.SDPA)
    dense_share("kimi_vl_rerank")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec, out = res.seconds, res.rerank
    print(f"[kimi_vl] MoonViT @ {size} ({cfg.vision.num_layers} blocks of "
          f"{cfg.vision.hidden_size}, {cfg.vision.num_heads} heads of "
          f"{cfg.vision.hidden_size // cfg.vision.num_heads}) + the "
          f"{cfg.lm.num_hidden_layers}-layer MLA decoder with "
          f"{cfg.lm.n_routed_experts} experts, bf16: {KV_IMAGES} images, "
          f"{len(queries)} queries; seconds {json.dumps(sec)}; queries/s "
          f"{len(queries) / sec['total']:.2f}; peak {peak:.2f} GiB",
          flush=True)
    print(f"[kimi_vl] launches {json.dumps(launches)}; routed rows "
          f"{json.dumps(moe)}; SDPA calls {json.dumps(sdpa)}", flush=True)
    print(f"[kimi_vl] metrics {json.dumps(res.metrics)}", flush=True)
    batches = -(-KV_IMAGES // KV_BANK_BATCH)
    want = cfg.vision.num_layers * batches
    if launches["K1_d72"] != want or launches["K1"] != want \
            or launches["K3_d72"] != 0 or launches["G2"] <= 0:
        fail(f"Kimi-VL launches {launches}: K1_d72 and K1 must be {want} "
             "(one a MoonViT block and bank batch), 72-wide K3 0, G2 > 0")
    if moe["routed"] <= 0 or moe["busiest"] <= 0 or sdpa["mla"] <= 0:
        fail(f"Kimi-VL routed rows {moe}, SDPA calls {sdpa}: both must "
             "be > 0")
    if DENSE_BY_PATH["kimi_vl_rerank"]["hit_share_pct"] != 100.0:
        fail(f"Kimi-VL Dense calls {DENSE_BY_PATH['kimi_vl_rerank']}: "
             "every parameter is held in bf16, so every call is a hit")
    if out.logits.shape != (len(queries), TOPK) or \
            not np.isfinite(out.logits).all() or \
            not np.isfinite(out.group_logits).all():
        fail("unexpected or non-finite Kimi-VL scores")
    for key, val in res.metrics.items():
        if not 0.0 <= val <= 100.0:
            fail(f"Kimi-VL metric {key} = {val} out of range")
    del model, corpus
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[kimi_vl] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return launches


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


@contextlib.contextmanager
def validate_seconds(store: list):
    """Within the block, each ``cli/validate`` run appends its stage-I
    engine's seconds ({'index', 'fusion', 'ranking', 'total'}) to
    ``store``."""
    from candidate_reranking_cir_tpu_torch.cli import validate

    inner = validate.evaluate_cirr_stage1

    def recorded(*args, **kw):
        result, payload = inner(*args, **kw)
        store.append(dict(result.seconds))
        return result, payload

    validate.evaluate_cirr_stage1 = recorded
    try:
        yield store
    finally:
        validate.evaluate_cirr_stage1 = inner


def loader_split(root, transform, prefix: str, tag: str) -> dict:
    """One stage-I batch as the trainer CLI loads it (S1_B triplets'
    reference images; the targets come from the feature cache), split:
    decode plus transform on the loader's 8 threads, ``np.stack``, the
    trainer's ``astype`` copy and the pageable host-to-card copy; printed
    under ``prefix``."""
    from candidate_reranking_cir_tpu_torch.data.datasets import CIRRDataset

    ds = CIRRDataset(root, "train", "relative", transform,
                     skip_target_image=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:   # BatchLoader's workers
        samples = list(pool.map(ds.__getitem__, range(S1_B), chunksize=4))
    t1 = time.perf_counter()
    stacked = np.stack([x["reference_image"] for x in samples])
    t2 = time.perf_counter()
    host = stacked.astype(np.float32)
    t3 = time.perf_counter()
    torch.as_tensor(host).to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    out = {"decode_transform": t1 - t0, "stack": t2 - t1, "astype": t3 - t2,
           "copy": t4 - t3, "gib": host.nbytes / 2 ** 30}
    print(f"{prefix} loader split, {tag}: {S1_B} reference jpegs at "
          f"{S1T_IMAGE_SIZE} px on 8 threads: decode+transform "
          f"{out['decode_transform']:.3f} s, np.stack {out['stack']:.3f} s, "
          f"the trainer's astype copy {out['astype']:.3f} s, host-to-card "
          f"copy {out['copy']:.3f} s ({out['gib']:.2f} GiB, pageable)",
          flush=True)
    return out


def epoch_seconds(text: str) -> list[float]:
    """The seconds of each ``[epoch N] ... (Xs)`` line of a trainer run."""
    import re

    return [float(x) for x in re.findall(r"^\[epoch \d+\] .*\(([\d.]+)s\)$",
                                         text, flags=re.M)]


def native_lines(root, flags: list[str], s1: list[str], models, whole: dict,
                 ckpt1, pil_validate: dict) -> dict:
    """Phase 10's ``[native]`` lines: the loader's split with the native
    pipeline (PIL's is printed in every run), native pixels against PIL,
    one stage-I epoch with ``--native-pipe`` beside the PIL run's, and
    ``cli/validate --native-pipe``'s index seconds beside the PIL
    run's."""
    import shutil
    from pathlib import Path

    from candidate_reranking_cir_tpu_torch.cli import stage1_train, validate
    from candidate_reranking_cir_tpu_torch.data import native_pipe
    from candidate_reranking_cir_tpu_torch.data.preprocessing import (
        CLIP_STD,
        load_image,
        make_transform,
    )

    t_native = time.perf_counter()
    pil = make_transform("targetpad", S1T_IMAGE_SIZE, 1.25)
    nat = native_pipe.make_native_transform("targetpad", S1T_IMAGE_SIZE, 1.25)
    split = loader_split(root, nat, "[native]", "native")
    paths = sorted((Path(root) / "cirr_dataset" / "img").glob("tr*.jpg"))
    t0 = time.perf_counter()
    nat.batch_from_paths(paths[:S1_B])
    batch_s = time.perf_counter() - t0
    print(f"[native] batch path (iter_batches, one native call): "
          f"{min(S1_B, len(paths))} jpegs in {batch_s:.3f} s", flush=True)
    worst_mean = worst_max = 0.0
    for path in paths[:NATIVE_PIXEL_IMAGES]:
        diff = np.abs(nat(path) - pil(load_image(path))) \
            * CLIP_STD[None, None] * 255
        worst_mean = max(worst_mean, float(diff.mean()))
        worst_max = max(worst_max, float(diff.max()))
    print(f"[native] pixels vs PIL on {NATIVE_PIXEL_IMAGES} jpegs (8-bit "
          f"units): mean |diff| up to {worst_mean:.4f} (tol "
          f"{NATIVE_MEAN_TOL}), max {worst_max:.3f} (tol {NATIVE_MAX_TOL})",
          flush=True)
    if worst_mean >= NATIVE_MEAN_TOL or worst_max >= NATIVE_MAX_TOL:
        fail("the native pipeline's pixels are off PIL's")

    epochs_at = s1.index("--num-epochs")
    run = run_cli("stage I, --native-pipe, 1 epoch", stage1_train,
                  s1[:epochs_at] + ["--num-epochs", "1"] + s1[epochs_at + 2:]
                  + ["--experiment-name", "native", "--native-pipe"])
    if "falling back to PIL" in run["text"]:
        fail("--native-pipe fell back to PIL with the library built")
    steps = S1T_TRAIN // S1_B
    pil_epochs = epoch_seconds(whole["text"])
    nat_epochs = epoch_seconds(run["text"])
    rate = [round(steps * S1_B / x, 1) for x in pil_epochs + nat_epochs]
    print(f"[native] stage-I CLI epochs of {steps} steps at B={S1_B}: PIL "
          f"{pil_epochs} s ({rate[:len(pil_epochs)]} pairs/s), native "
          f"{nat_epochs} s ({rate[len(pil_epochs):]} pairs/s); step losses "
          f"PIL {[round(x, 6) for x in whole['losses'][:steps]]}, native "
          f"{[round(x, 6) for x in run['losses']]}", flush=True)
    shutil.rmtree(models / "native")
    with validate_seconds([]) as nat_validate:
        run_cli("validate --native-pipe", validate,
                flags + ["--stage1-path", str(ckpt1), "--native-pipe"])
    print(f"[native] cli/validate index seconds: PIL "
          f"{pil_validate['index']:.3f}, native "
          f"{nat_validate[0]['index']:.3f} (total "
          f"{pil_validate['total']:.3f} vs {nat_validate[0]['total']:.3f})",
          flush=True)
    return {"split": split, "batch_s": batch_s,
            "epochs": {"PIL": pil_epochs, "native": nat_epochs},
            "validate_index": {"PIL": pil_validate["index"],
                               "native": nat_validate[0]["index"]},
            "seconds": time.perf_counter() - t_native}


def train_cli_path(tok, words, native_ok: bool) -> dict:
    """The two trainer CLIs on the card at full width in bf16 (phase 10);
    with the native libraries built, the ``[native]`` lines."""
    import shutil
    from pathlib import Path

    from candidate_reranking_cir_tpu_torch.cli import (
        stage1_train,
        stage2_train,
        validate,
    )
    from candidate_reranking_cir_tpu_torch.data.preprocessing import (
        make_transform,
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

        registry.reset()
        whole = run_cli("stage I, uninterrupted", stage1_train,
                        s1 + ["--experiment-name", "whole"])
        cut = run_cli("stage I, SIGTERM after step 1", stage1_train,
                      s1 + ["--experiment-name", "cut"], kill_after=1)
        saved = models / "cut" / "saved_models" / "blip_last"
        if "preempted (SIGTERM)" not in cut["text"] or not saved.is_dir():
            fail("the preempted stage-I run saved no resumable blip_last")
        resumed = run_cli("stage I, --resume", stage1_train,
                          s1 + ["--experiment-name", "cut", "--resume"])
        s1_launches = registry.counts()
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
        registry.reset()
        with validate_seconds([]) as pil_validate:
            run_cli("validate (stage-I blip_mean -> top-50 file)", validate,
                    flags + ["--stage1-path", str(ckpt1), "--save-topk",
                             "--k", str(S2T_K), "--topk-out", str(topk)])
        s2 = run_cli("stage II", stage2_train, [
            "--dataset", "CIRR", "--data-root", str(root2),
            "--allow-test-vocab", "--device", "cuda", "--output-dir",
            str(models), "--experiment-name", "s2", "--num-epochs", "1",
            "--batch-size", str(S2T_B), "--stage1-path", str(ckpt1),
            "--top-k-path", str(topk), "--K-value", str(S2T_K)])
        s2_launches = registry.counts()
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
        pil_split = loader_split(
            root, make_transform("targetpad", S1T_IMAGE_SIZE, 1.25),
            "[train_cli]", "PIL")
        native = native_lines(root, flags, s1, models, whole, ckpt1,
                              pil_validate[0]) if native_ok else None
    finally:
        tmp.cleanup()
    memory = remat_memory(tok, words)
    seconds = {"stage1_whole": whole["seconds"], "stage1_cut": cut["seconds"],
               "stage1_resume": resumed["seconds"],
               "stage2": s2["seconds"],
               "native": native["seconds"] if native else 0.0,
               "phase": time.perf_counter() - t_phase}
    print("[train_cli] seconds "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}",
          flush=True)
    launches = {k: s1_launches[k] + s2_launches[k] for k in s1_launches}
    return {"launches": launches, "seconds": seconds, "sizes": sizes,
            "memory": memory, "loader_split": pil_split, "native": native}


# ---------------------------------------------------------------------------
# phase 13: captioning

def caption_config():
    from candidate_reranking_cir_tpu_torch.config import (
        RetrievalModelConfig,
        TextEncoderConfig,
        vit_config,
    )

    return RetrievalModelConfig(vit=vit_config("base", 384),
                                text=TextEncoderConfig())


def top2_gaps(logits) -> np.ndarray:
    """[B, L] top-2 gaps of teacher-forced logits [B, L, V]."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


def same_ids(label: str, ref, out, gaps) -> bool:
    """Whether ``out`` equals ``ref`` row by row, but after a step whose
    top-2 logit gap (``gaps``: along ``ref``) is under CAP_TIE_GAP, which
    a line names. Prints and returns False at another difference."""
    ref, out = ref.cpu().numpy(), out.cpu().numpy()
    ok = True
    for r in range(ref.shape[0]):
        diff = np.nonzero(ref[r] != out[r])[0]
        if diff.size == 0:
            continue
        step = diff[0] - 1
        near_tie = gaps[r, step] < CAP_TIE_GAP
        print(f"[caption] {label}: row {r} differs from position {diff[0]} "
              f"on; the top-2 logit gap at step {step} is "
              f"{gaps[r, step]:.3e} "
              f"({'a near tie' if near_tie else 'not a near tie'})",
              flush=True)
        ok = ok and near_tie
    return ok


def caption_decodes(decoder, feats, tok, prompt_ids) -> dict:
    """Every decode of phase 13 on ``feats``, timed (wall, synchronised):
    name -> (ids, seconds, decode steps)."""
    from candidate_reranking_cir_tpu_torch.models import blip_decoder as bd

    ids = {"bos_id": tok.dec_token_id, "eos_id": tok.sep_id,
           "pad_id": tok.pad_id}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    runs = {
        "greedy": (bd.greedy_caption, {"max_len": CAP_MAX_LEN}),
        "greedy_cached": (bd.greedy_caption_cached,
                          {"max_len": CAP_MAX_LEN}),
        "beam": (bd.beam_caption, {"max_len": CAP_MAX_LEN,
                                   "num_beams": CAP_BEAMS}),
        "beam_cached": (bd.beam_caption_cached,
                        {"max_len": CAP_MAX_LEN, "num_beams": CAP_BEAMS}),
        "sample_cached": (lambda d, f, **kw: bd.sample_caption_cached(
            d, f, gen, **kw), CAP_SAMPLE),
        "greedy_cached_prompt": (bd.greedy_caption_cached,
                                 {"max_len": CAP_MAX_LEN,
                                  "prompt_ids": prompt_ids}),
    }
    out = {}
    for name, (fn, kw) in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(decoder, feats, **ids, **kw)
        torch.cuda.synchronize()
        out[name] = (result, time.perf_counter() - t0, kw["max_len"] - 1)
    return out


def caption_fp32_check(decoder, images, tok) -> None:
    """fp32 at CAP_CHECK_B images, the card against the CPU from the same
    weights: greedy (recompute and cached) and cached beam ids, cached
    equal to recompute on the card (beam too), card equal to the CPU but
    after near ties, and the step logits (teacher-forced and cached, along
    the CPU's greedy ids) within FP32_CARD_VS_CPU_TOL."""
    from candidate_reranking_cir_tpu_torch.models import blip_decoder as bd

    cfg = caption_config()
    state = {k: v.detach().cpu() for k, v in decoder.state_dict().items()}
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = bd.CaptionDecoder(cfg, device=dev).eval()
        models[dev].load_state_dict(state)
    del state
    kw = {"bos_id": tok.dec_token_id, "eos_id": tok.sep_id,
          "pad_id": tok.pad_id, "max_len": CAP_MAX_LEN}
    out, feats = {}, {}
    t0 = time.perf_counter()
    for dev, model in models.items():
        with torch.inference_mode():
            feats[dev] = model.visual_encoder(
                images[:CAP_CHECK_B].float().to(dev))
        out[dev] = {
            "greedy": bd.greedy_caption(model, feats[dev], **kw),
            "greedy_cached": bd.greedy_caption_cached(model, feats[dev], **kw),
            "beam_cached": bd.beam_caption_cached(
                model, feats[dev], num_beams=CAP_BEAMS, **kw)}
        if dev == "cuda":
            out[dev]["beam"] = bd.beam_caption(model, feats[dev],
                                               num_beams=CAP_BEAMS, **kw)
    ref = out["cpu"]["greedy"]
    ones = torch.ones_like(ref)
    with torch.inference_mode():
        logits = {dev: models[dev].logits(feats[dev], ref.to(dev),
                                          ones.to(dev)).cpu()
                  for dev in models}
        gaps = {dev: top2_gaps(v) for dev, v in logits.items()}
        beam_gaps = {dev: top2_gaps(models[dev].logits(
            feats[dev], out[dev]["beam_cached"], torch.ones_like(
                out[dev]["beam_cached"])).cpu()) for dev in models}
        step_err = 0.0
        caches = {}
        for dev, model in models.items():
            k_img, v_img = model.precompute_kv(feats[dev])
            k_self, v_self = bd._self_cache(model, CAP_CHECK_B, CAP_MAX_LEN,
                                            dev)
            caches[dev] = (k_self, v_self, k_img, v_img)
        mask = torch.zeros_like(ref)
        for t in range(CAP_MAX_LEN - 1):
            mask[:, t] = 1
            step = [models[dev].decode_step(
                ref[:, t:t + 1].to(dev), mask.to(dev), caches[dev], t)[0]
                .cpu() for dev in ("cuda", "cpu")]
            step_err = max(step_err, float((step[0] - step[1]).abs().max()))
    feat_err = float((feats["cuda"].cpu() - feats["cpu"]).abs().max())
    logit_err = float((logits["cuda"] - logits["cpu"]).abs().max())
    print(f"[check] fp32 captions, card vs CPU ({CAP_CHECK_B} images, "
          f"{time.perf_counter() - t0:.1f} s): image features max |diff| "
          f"{feat_err:.3e}; teacher-forced logits along the CPU's greedy "
          f"ids {logit_err:.3e}, cached step logits {step_err:.3e} (tol "
          f"{FP32_CARD_VS_CPU_TOL})", flush=True)
    ok = logit_err <= FP32_CARD_VS_CPU_TOL and step_err <= FP32_CARD_VS_CPU_TOL
    card = out["cuda"]
    checks = [
        ("card greedy cached vs recompute", card["greedy"],
         card["greedy_cached"], None),
        ("card beam cached vs recompute", card["beam"], card["beam_cached"],
         None),
        ("card vs CPU greedy", ref, card["greedy"], gaps["cpu"]),
        ("card vs CPU greedy cached", ref, card["greedy_cached"],
         gaps["cpu"]),
        ("card vs CPU beam cached", out["cpu"]["beam_cached"],
         card["beam_cached"], beam_gaps["cpu"]),
        ("CPU greedy cached vs recompute", ref,
         out["cpu"]["greedy_cached"], gaps["cpu"]),
    ]
    for label, a, b, g in checks:
        if g is None:   # gaps along the card's own decode
            with torch.inference_mode():
                g = top2_gaps(models["cuda"].logits(
                    feats["cuda"], a, torch.ones_like(a)).cpu())
        equal = same_ids(label, a, b, g)
        print(f"[check] fp32 captions, {label}: "
              f"{'equal' if torch.equal(a.cpu(), b.cpu()) else 'differ'}"
              f"{'' if equal else ' (not at a near tie)'}", flush=True)
        ok = ok and equal
    if not ok:
        fail("fp32 captions: the card is off the CPU, or cached off "
             "recompute")


def blip_base_check(tok) -> None:
    """BlipBase in each mode once, fp32, card vs CPU from the same random
    weights (CAP_CHECK_B images)."""
    from candidate_reranking_cir_tpu_torch.models.blip_base import BlipBase

    cfg = caption_config()
    torch.manual_seed(SEED + 16)
    cpu = BlipBase(cfg, device="cpu").eval()
    card = BlipBase(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(SEED + 17)
    images = torch.randn(CAP_CHECK_B, 384, 384, 3, generator=g)
    ids, mask = (torch.from_numpy(x) for x in tok.encode(
        ["a red dress with the same dog", "the blue shirt"], TEXT_LEN,
        set_enc_token=True))
    errs = {}
    with torch.inference_mode():
        for mode in ("image", "text", "multimodal"):
            ref = cpu(images, ids, mask, mode=mode)
            out = card(images.cuda(), ids.cuda(), mask.cuda(), mode=mode)
            errs[mode] = float((out.cpu() - ref).abs().max())
    print(f"[check] fp32 BlipBase, card vs CPU: max |diff| "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
          f"(tol {FP32_CARD_VS_CPU_TOL})", flush=True)
    if max(errs.values()) > FP32_CARD_VS_CPU_TOL:
        fail("fp32 BlipBase: the card is off the CPU")


def caption_path(tok) -> dict:
    """Phase 13: a CaptionDecoder at full width in bf16 with random weights
    from the seed over CAP_B images through every decoding entry point;
    launches (K1-K3 > 0, K4-K9 = 0), tokens/s and ms a step, one profiled
    cached step; then the fp32 checks and BlipBase."""
    from candidate_reranking_cir_tpu_torch.models import blip_decoder as bd

    t_phase = time.perf_counter()
    cfg = caption_config()
    torch.manual_seed(SEED + 14)
    decoder = bd.CaptionDecoder(cfg, dtype=torch.bfloat16,
                                device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    images = torch.randn(CAP_B, 384, 384, 3, generator=g, device="cuda")
    # the reference's prompt handling: [CLS] becomes bos, [SEP] is dropped
    prompt = tok.encode([CAP_PROMPT], 8)[0][0]
    prompt_ids = tuple(int(x) for x in prompt[1:4])
    common = {"bos_id": tok.dec_token_id, "eos_id": tok.sep_id,
              "pad_id": tok.pad_id}
    with torch.inference_mode():   # warm-up: allocator, cuBLAS handles
        warm = decoder.visual_encoder(images[:2])
        bd.greedy_caption_cached(decoder, warm, max_len=3, **common)
        bd.beam_caption(decoder, warm, max_len=3, num_beams=2, **common)
    registry.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        feats = decoder.visual_encoder(images)
    torch.cuda.synchronize()
    vit_s = time.perf_counter() - t0
    runs = caption_decodes(decoder, feats, tok, prompt_ids)
    launches = registry.counts()
    dense_share("caption")
    print(f"[caption] CaptionDecoder ViT-B/16 @ 384 + 12-layer MED + vocab "
          f"{cfg.text.vocab_size}, bf16, {CAP_B} images: ViT {vit_s:.3f} s; "
          f"launches {json.dumps(launches)}", flush=True)
    for name, (ids, seconds, steps) in runs.items():
        print(f"[caption] {name}: {seconds:.3f} s, {steps} steps, "
              f"{1e3 * seconds / steps:.2f} ms a step, "
              f"{CAP_B * steps / seconds:.1f} tokens/s ({CAP_B} rows x "
              f"{steps} steps); ids {list(ids.shape)}, first row "
              f"{ids[0].tolist()}", flush=True)
    for kid in ("K1", "K2", "K3", "G1", "G2"):
        if launches[kid] <= 0:
            fail(f"{kid} was not launched on the caption path")
    for kid in ("K4", "K5", "K6", "K7", "K8", "K9"):
        if launches[kid] != 0:
            fail(f"{kid} was launched on the caption path")
    for a, b in (("greedy", "greedy_cached"), ("beam", "beam_cached")):
        same = (runs[a][0] == runs[b][0]).all(dim=1)
        print(f"[caption] bf16 {b} vs {a}: {int(same.sum())} of {CAP_B} "
              "rows equal (not gated: different kernels at random "
              "weights)", flush=True)
    prompt = runs["greedy_cached_prompt"][0]
    if not (prompt[:, 1:4] == torch.tensor(prompt_ids, device="cuda")).all():
        fail("the prompted decode did not keep its prompt")
    sample = runs["sample_cached"][0]
    eos_at = (sample == tok.sep_id).int().argmax(dim=1)
    if ((sample == tok.sep_id).any(dim=1)
            & (eos_at < CAP_SAMPLE["min_len"])).any():
        fail("sampling emitted eos below min_len")

    with torch.inference_mode():   # one cached step, profiled
        k_img, v_img = decoder.precompute_kv(feats)
        k_self, v_self = bd._self_cache(decoder, CAP_B, CAP_MAX_LEN, "cuda")
        ids = runs["greedy_cached"][0]
        mask = torch.zeros_like(ids)
        mask[:, :6] = 1
        cache = (k_self, v_self, k_img, v_img)
        profile_device("one cached caption step (greedy, step 5)",
                       lambda: decoder.decode_step(ids[:, 5:6], mask, cache,
                                                   5))
    caption_fp32_check(decoder, images, tok)
    del decoder, feats, runs, k_img, v_img, k_self, v_self, cache
    gc.collect()
    torch.cuda.empty_cache()
    blip_base_check(tok)
    seconds = time.perf_counter() - t_phase
    print(f"[caption] phase seconds {seconds:.1f}", flush=True)
    return {"launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 14: attention capture and perturbation, device-side preprocessing
# and the glue modules


def image_ops_lines(model):
    """``[image_ops]``: IMG_B synthetic uint8 images of IMG_HW, padded on
    the host (bit for bit the PIL ``target_pad``), preprocessed on the card
    (against the same function on the CPU) and, on a smooth image, against
    the PIL transform; ms a batch, the bytes a loader would copy; then the
    ViT of ``model`` embeds the batch. Returns the preprocessed batch and
    the launches of that embedding."""
    import PIL.Image

    from candidate_reranking_cir_tpu_torch.data.preprocessing import (
        make_transform,
        target_pad,
    )
    from candidate_reranking_cir_tpu_torch.ops import image_ops

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    raw = rng.integers(0, 256, size=(IMG_B, *IMG_HW, 3), dtype=np.uint8)
    padded = []
    for img in raw:
        out = image_ops.pad_to_target_ratio(torch.from_numpy(img), 1.25)
        host = np.asarray(target_pad(PIL.Image.fromarray(img), 1.25))
        if not np.array_equal(out.numpy(), host):
            fail("[image_ops] pad_to_target_ratio differs from target_pad")
        padded.append(out)
    batch = torch.stack(padded)
    dim = model.cfg.vit.image_size
    dev = batch.to("cuda")
    out = image_ops.preprocess_batch_uniform(dev, dim)
    ref = image_ops.preprocess_batch_uniform(batch, dim)
    err = (out.cpu() - ref).abs().max().item()
    ms = time_ms(lambda: image_ops.preprocess_batch_uniform(dev, dim))
    yy, xx = np.mgrid[0:IMG_HW[0], 0:IMG_HW[1]]
    base = (np.stack([yy, xx, yy + xx], -1) % 255).astype(np.float32)
    smooth = (0.8 * base + 10).astype(np.uint8)
    pil = make_transform("targetpad", dim, 1.25)(PIL.Image.fromarray(smooth))
    card = image_ops.preprocess_image(
        torch.from_numpy(smooth).to("cuda"), dim, 1.25).cpu().numpy()
    pil_err = float(np.abs(card - pil).mean())
    print(f"[image_ops] {IMG_B} uint8 images {list(IMG_HW)} -> padded "
          f"{list(batch.shape[1:3])} on the host (= target_pad), "
          f"preprocess_batch_uniform({dim}) on the card: max|card - CPU| "
          f"{err:.3e} (tol {IMAGE_OPS_TOL}), {ms:.3f} ms a batch (CUDA "
          f"events); copy to the card {batch.numel() / 2 ** 20:.1f} MiB as "
          f"uint8 against {out.numel() * 4 / 2 ** 20:.1f} MiB of fp32 "
          f"pixels; smooth image vs PIL mean|diff| {pil_err:.4f} (bound "
          f"{IMAGE_OPS_PIL_MEAN})", flush=True)
    if not torch.isfinite(out).all() or err > IMAGE_OPS_TOL:
        fail(f"[image_ops] card vs CPU {err:.3e}")
    if pil_err >= IMAGE_OPS_PIL_MEAN:
        fail(f"[image_ops] mean |card - PIL| {pil_err:.4f}")
    registry.reset()
    with torch.inference_mode():
        feats = model.embed_images(out)
    torch.cuda.synchronize()
    launches = registry.counts()
    k1 = launches["K1"]
    print(f"[image_ops] the ViT embeds the batch: {list(feats.shape)}, K1 "
          f"launches {k1}; {time.perf_counter() - t0:.1f} s", flush=True)
    if not torch.isfinite(feats).all() or k1 <= 0:
        fail("[image_ops] the ViT did not run on K1")
    return out, launches


def capture_inputs(tok, words):
    """CAP_G reference images' CAP_Q captions each (3-30 words, the toy
    vocabulary), tokenized to TEXT_LEN, and unit target features, from the
    seed."""
    rng = np.random.default_rng(SEED + 22)
    captions = [" ".join(rng.choice(words, size=int(rng.integers(3, 31))))
                for _ in range(CAP_G * CAP_Q)]
    ids, mask = tok.encode(captions, TEXT_LEN, overflow="truncate")
    target = torch.from_numpy(rng.normal(size=(CAP_G * CAP_Q, 256)).astype(
        np.float32))
    return (torch.from_numpy(ids), torch.from_numpy(mask),
            target / target.norm(dim=-1, keepdim=True))


def captured_fusion(model, feats, ids, mask, target):
    """One captured fusion with zero perturbations: (z_t, records, the
    perturbations' gradients of the prediction's cosine with ``target``)
    at query_group CAP_Q."""
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        l2_normalize,
    )

    dev = feats.device
    rec = {}
    perts = model.text_encoder.zero_perturbations(
        ids.shape[0], ids.shape[1], feats.shape[1], device=dev)
    hidden = model.fuse(feats, ids.to(dev), mask.to(dev), return_raw=True,
                        query_group=CAP_Q, intermediates=rec,
                        perturbations=perts)
    pred = l2_normalize(model.text_proj(hidden[:, 0])).float()
    loss = (pred * target.to(dev)).sum()
    grads = torch.autograd.grad(loss, list(perts.values()))
    return hidden.detach(), rec, dict(zip(perts, grads))


def compare_captures(label: str, card, cpu, prob_tol: float,
                     gated: bool) -> None:
    """Card against CPU: probabilities, z_t and the gradients (each
    against its largest magnitude); gated at ``prob_tol`` on the
    probabilities and, where ``gated``, at CAP_Z_TOL and CAP_GRAD_REL_TOL
    on z_t and the gradients."""
    (z_a, rec_a, g_a), (z_b, rec_b, g_b) = card, cpu
    p_err = max((rec_a[k].cpu() - rec_b[k]).abs().max().item() for k in rec_b)
    z_err = (z_a.float().cpu() - z_b.float()).abs().max().item()
    g_rel = max((g_a[k].cpu() - g_b[k]).abs().max().item()
                / g_b[k].abs().max().item() for k in g_b)
    print(f"[capture] {label}: probabilities max|diff| {p_err:.3e} (tol "
          f"{prob_tol}), z_t {z_err:.3e}, dLoss/dProbs {g_rel:.3e} of the "
          f"largest" + (f" (tols {CAP_Z_TOL}, {CAP_GRAD_REL_TOL})" if gated
                        else " (reported)"), flush=True)
    if p_err > prob_tol or (gated and (z_err > CAP_Z_TOL
                                       or g_rel > CAP_GRAD_REL_TOL)):
        fail(f"[capture] {label} is off the CPU")


def capture_lines(models: dict, images, tok, words) -> None:
    """``[capture]``: the MED's records and perturbation gradients at full
    width, fp32 and bf16, card against the CPU, and the captured fusion
    against the kernel route; ms and peak GiB of a captured batch, an
    uncaptured one and the perturbation backward (bf16)."""
    from candidate_reranking_cir_tpu_torch.models.med import (
        CROSS_PROBS,
        SELF_PROBS,
    )

    t0 = time.perf_counter()
    ids, mask, target = capture_inputs(tok, words)
    refs = images[:CAP_G]
    for dtype in (torch.float32, torch.bfloat16):
        cap, plain = models[dtype]
        with torch.inference_mode():
            feats = cap.embed_images(refs)
        feats = feats.clone()
        card = captured_fusion(cap, feats, ids, mask, target)
        rec = card[1]
        shapes = {k: list(v.shape) for k, v in rec.items()}
        row_err = max((v.sum(-1) - 1).abs().max().item() for v in rec.values())
        text = cap.cfg.text
        shape = [text.num_layers, CAP_G * CAP_Q, text.num_heads, TEXT_LEN]
        want = {SELF_PROBS: shape + [TEXT_LEN],
                CROSS_PROBS: shape + [cap.cfg.vit.num_tokens]}
        print(f"[capture] {str(dtype)[6:]} records {json.dumps(shapes)}, "
              f"max|row sum - 1| {row_err:.3e}", flush=True)
        if shapes != want or row_err > 1e-5:
            fail(f"[capture] records {shapes}, row sums off by {row_err}")
        if dtype == torch.float32:
            with torch.inference_mode():
                routed = plain.fuse(feats, ids.to("cuda"),
                                    mask.to("cuda"), return_raw=True,
                                    query_group=CAP_Q)
            err = (card[0] - routed).abs().max().item()
            print(f"[capture] fp32 z_t captured vs the kernel route "
                  f"(image-major, K1/K2): max|diff| {err:.3e} (tol "
                  f"{CAP_ROUTE_TOL})", flush=True)
            if err > CAP_ROUTE_TOL:
                fail("[capture] the captured fusion is off the kernel route")
        # the CPU at the same inputs; bf16 over the first image's queries
        n = CAP_G if dtype == torch.float32 else 1
        cpu_model = type(cap)(cap.cfg, dtype=dtype, device="cpu")
        cpu_model.load_state_dict(cap.state_dict())
        sub = slice(0, n * CAP_Q)
        cpu = captured_fusion(cpu_model, feats[:n].cpu(), ids[sub],
                              mask[sub], target[sub])
        card_sub = (card[0][sub], {k: v[:, sub] for k, v in rec.items()},
                    {k: v[:, sub] for k, v in card[2].items()})
        if n < CAP_G:   # the card's own run at the CPU's size
            card_sub = captured_fusion(cap, feats[:n], ids[sub], mask[sub],
                                       target[sub])
        compare_captures(f"{str(dtype)[6:]} card vs CPU ({n * CAP_Q} "
                         "queries)", card_sub, cpu,
                         CAP_PROB_TOL[dtype], dtype == torch.float32)
        del cpu_model, cpu, card, card_sub
    cap, plain = models[torch.bfloat16]
    with torch.inference_mode():
        feats = cap.embed_images(refs)
    feats = feats.clone()
    dev_ids, dev_mask = ids.to("cuda"), mask.to("cuda")

    def fuse(model, **kw):
        with torch.inference_mode():
            return model.fuse(feats, dev_ids, dev_mask, return_raw=True,
                              query_group=CAP_Q, **kw)

    cost = {}
    for name, run in (("captured", lambda: fuse(cap, intermediates={})),
                      ("uncaptured", lambda: fuse(plain))):
        cost[name] = (time_ms(run, iters=5), peak_gib(run))
    def perturbed():
        perts = cap.text_encoder.zero_perturbations(
            CAP_G * CAP_Q, TEXT_LEN, feats.shape[1], device="cuda")
        hidden = cap.fuse(feats, dev_ids, dev_mask, return_raw=True,
                          query_group=CAP_Q, perturbations=perts)
        return hidden.float().sum(), list(perts.values())

    back_ms = []
    for _ in range(3):
        loss, perts = perturbed()
        back_ms.append(time_ms(
            lambda: torch.autograd.grad(loss, perts, retain_graph=True),
            iters=1))
    del loss, perts
    back_gib = peak_gib(lambda: torch.autograd.grad(*perturbed()))
    print("[capture] bf16, " + ", ".join(
        f"{k} fusion batch {v[0]:.2f} ms (peak {v[1]:.2f} GiB)"
        for k, v in cost.items()) + f", perturbation backward "
        f"{min(back_ms):.2f}-{max(back_ms):.2f} ms (peak of the forward "
        f"and backward {back_gib:.2f} GiB); "
        f"{time.perf_counter() - t0:.1f} s", flush=True)


def peak_gib(run) -> float:
    """The card's peak allocated GiB during one ``run``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def trace_lines(cap, images, tok, words, root: str) -> None:
    """``[trace]``: one captured batch between ``start_trace`` and
    ``stop_trace``, each step a ``PhaseTimer`` phase; the trace must name
    the phases and hold a kernel record."""
    from candidate_reranking_cir_tpu_torch.runtime import tracing

    t0 = time.perf_counter()
    ids, mask, target = capture_inputs(tok, words)
    timer = tracing.PhaseTimer()
    phases = ("capture_embed", "capture_fuse", "capture_backward")
    tracing.start_trace(os.path.join(root, "trace"))
    try:
        with timer.phase(phases[0]):
            with torch.no_grad():
                feats = cap.embed_images(images[:CAP_G])
        with timer.phase(phases[1]):
            perts = cap.text_encoder.zero_perturbations(
                CAP_G * CAP_Q, TEXT_LEN, feats.shape[1], device="cuda")
            hidden = cap.fuse(feats, ids.to("cuda"),
                              mask.to("cuda"), return_raw=True,
                              query_group=CAP_Q, intermediates={},
                              perturbations=perts)
        with timer.phase(phases[2]):
            torch.autograd.grad(hidden.float().sum(), list(perts.values()))
            torch.cuda.synchronize()
    finally:
        path = tracing.stop_trace()
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[trace] {os.path.basename(path)}: {len(events)} events, "
          f"{kernels} kernel records, phases "
          f"{[p for p in phases if p in names]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in timer.summary().splitlines():
        print(f"[trace] {line}", flush=True)
    if not set(phases) <= names or kernels == 0:
        fail("[trace] the trace lacks a phase or a kernel record")
    gc.collect()


def export_lines(model, root: str) -> None:
    """``[export]``: the full-width stage-I model and its AdamW saved as a
    trainer checkpoint, ``cli/export_checkpoint --stage 1`` on it, and
    ``load_params`` of the ``.pt`` equal to the state dict bit for bit."""
    from candidate_reranking_cir_tpu_torch.cli import export_checkpoint
    from candidate_reranking_cir_tpu_torch.cli.common import load_params
    from candidate_reranking_cir_tpu_torch.runtime.checkpoint import (
        save_checkpoint,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import AdamW

    from pathlib import Path

    t0 = time.perf_counter()
    ckpt, out = os.path.join(root, "blip_mean"), os.path.join(root, "s1.pt")
    save_checkpoint(ckpt, model, AdamW(model.parameters(), lambda n: 2e-5,
                                       0.05), metadata={"epoch": 0})
    t_save = time.perf_counter() - t0
    cfg = model.cfg
    config = os.path.join(root, "model_config.json")
    with open(config, "w") as f:
        json.dump({"vit": {k: getattr(cfg.vit, k) for k in (
            "image_size", "patch_size", "hidden_size", "num_layers",
            "num_heads")}, "text": {k: getattr(cfg.text, k) for k in (
                "vocab_size", "hidden_size", "num_layers", "num_heads",
                "intermediate_size", "encoder_width")},
            "embed_dim": cfg.embed_dim}, f)
    with contextlib.redirect_stdout(sys.stderr):
        export_checkpoint.main([
            "--stage", "1", "--checkpoint", ckpt, "--out", out,
            "--model-config", config, "--image-size",
            str(cfg.vit.image_size), "--text-len", str(cfg.text_len),
            "--device", "cuda"])
    t_export = time.perf_counter() - t0 - t_save
    loaded = load_params(out, 1, model.cfg)
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    same = sorted(loaded) == sorted(want) and all(
        torch.equal(loaded[k], want[k]) for k in want)
    print(f"[export] checkpoint {checkpoint_gib(Path(ckpt)):.3f} GiB in "
          f"{t_save:.1f} s; cli/export_checkpoint --stage 1: "
          f"{os.path.getsize(out) / 2 ** 30:.3f} GiB in {t_export:.1f} s; "
          f"load_params of the .pt equals the state dict bit for bit: "
          f"{same} ({len(want)} tensors)", flush=True)
    if not same:
        fail("[export] the exported checkpoint does not load back equal")


def entry_lines() -> dict:
    """``[entry]``: the one-card check of the scoring path, at full width.
    Returns the launches of its one call (not of the timing runs)."""
    from candidate_reranking_cir_tpu_torch.entry import entry

    t0 = time.perf_counter()
    fn, args = entry("cuda")
    registry.reset()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = registry.counts()
    ms = time_ms(lambda: fn(*args), iters=5)
    print(f"[entry] entry(): scores {list(out.shape)}, finite "
          f"{bool(torch.isfinite(out).all())}, {ms:.2f} ms a call (CUDA "
          f"events), launches {json.dumps(launches)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if list(out.shape) != [2, 4] or not torch.isfinite(out).all() \
            or launches["K1"] <= 0:
        fail("[entry] the scoring path failed")
    return launches


def demo_lines(root: str) -> dict:
    """``[demo]``: the port's quickstart on the card (its tiny models'
    6-wide heads run the kernels padded); every artifact of the JAX
    package's demo must be there, and K2 and K3 launched."""
    from candidate_reranking_cir_tpu_torch import demo

    t0 = time.perf_counter()
    workdir = os.path.join(root, "demo")
    registry.reset()
    with contextlib.redirect_stdout(sys.stderr):
        res = demo.main(["--workdir", workdir, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = registry.counts()
    missing = [a for a in demo.ARTIFACTS
               if not os.path.isfile(os.path.join(workdir, a))]
    print(f"[demo] demo.main --device {"cuda"}: "
          f"{time.perf_counter() - t0:.1f} "
          f"s, {len(demo.ARTIFACTS) - len(missing)} of "
          f"{len(demo.ARTIFACTS)} artifacts, served top-{len(res.ranking)} "
          f"(re-scored {res.reranked}); launches {json.dumps(launches)}",
          flush=True)
    if missing or launches["K2"] <= 0 or launches["K3"] <= 0:
        fail(f"[demo] missing {missing} or no K2/K3 launch")
    return launches


def glue_path(tok, words) -> dict:
    """Phase 14: ``[image_ops]``, ``[capture]``, ``[trace]``, ``[export]``,
    ``[entry]`` and ``[demo]`` at full width (ViT-B/16 @ 384, the 12-layer
    MED, ``text_len`` 40), random weights from the seed. Returns the
    launches of the image_ops embedding, the one entry() call and the
    demo, summed."""
    from candidate_reranking_cir_tpu_torch.config import (
        RetrievalModelConfig,
        TextEncoderConfig,
        vit_config,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    t_phase = time.perf_counter()
    cfg, cap_cfg = (RetrievalModelConfig(
        vit=vit_config("base", 384), text=TextEncoderConfig(
            capture_attention=flag, perturb_attention=flag),
        text_len=TEXT_LEN) for flag in (False, True))
    models = {}
    torch.manual_seed(SEED + 20)
    for dtype in (torch.bfloat16, torch.float32):
        plain = RetrievalModel(cfg, dtype=dtype, device="cuda").eval()
        if models:
            plain.load_state_dict(models[torch.bfloat16][1].state_dict())
        cap = RetrievalModel(cap_cfg, dtype=dtype, device="cuda").eval()
        cap.load_state_dict(plain.state_dict())
        for p in cap.parameters():
            p.requires_grad_(False)
        models[dtype] = (cap, plain)
    images, launches = image_ops_lines(models[torch.bfloat16][1])
    capture_lines(models, images, tok, words)
    with tempfile.TemporaryDirectory() as root:
        trace_lines(models[torch.bfloat16][0], images, tok, words, root)
        export_lines(models[torch.bfloat16][1], root)
        del models, images
        gc.collect()
        torch.cuda.empty_cache()
        runs = [entry_lines(), demo_lines(root)]
    launches = {k: v + sum(r[k] for r in runs) for k, v in launches.items()}
    seconds = time.perf_counter() - t_phase
    print(f"[glue] phase seconds {seconds:.1f}", flush=True)
    return {"launches": launches, "seconds": seconds}


def native_missing() -> str | None:
    """What the native libraries' build (``make -C native``: g++ and the
    libjpeg headers) lacks on this machine, or None."""
    import shutil

    cxx = os.environ.get("CXX", "g++")
    for tool in ("make", cxx):
        if shutil.which(tool) is None:
            return f"{tool} not found"
    probe = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=60)
    if probe.returncode != 0:
        return "jpeglib.h not found (the libjpeg headers)"
    return None


def build_native() -> tuple[str | None, float]:
    """``make -B -C native`` (rebuilt from the checkout's sources) where
    the toolchain has what it needs: (what is missing or None, seconds).
    A failed build with the toolchain present fails the script."""
    missing = native_missing()
    if missing is not None:
        return missing, 0.0
    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-B", "-C", NATIVE_DIR],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"make -C native failed:\n{proc.stdout}\n{proc.stderr}")
    return None, time.perf_counter() - t0


def build_libraries() -> bool:
    """The kernel libraries (``ops/build.LIBRARIES``), one nvcc each, and
    the native host libraries (``make -C native``), started together;
    ptxas's register and spill lines of every kernel (the tensor-core
    kernels', G1's and G2's must be among them when a library was built),
    and the tensor-core kernels' dynamic shared memory. Returns whether the
    native libraries were built; if not, a ``[native] unavailable`` line
    says what is missing."""
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
    from candidate_reranking_cir_tpu_torch.ops.build import (
        LIBRARIES,
        build,
        load,
    )

    names = tuple(LIBRARIES)
    with ThreadPoolExecutor(len(names) + 1) as pool:
        native = pool.submit(build_native)
        built = list(pool.map(build, names))
        native_missing_what, native_s = native.result()
    if native_missing_what is None:
        print(f"[build] native/ (make -B -C native: libimagepipe.so, "
              f"libwordpiece.so): {native_s:.1f} s", flush=True)
    else:
        print(f"[native] unavailable: {native_missing_what}", flush=True)
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
                                      "attn_bwd_tc_keys_kernel"),
                  "activation": ("bias_gelu_vec_kernel",
                                 "bias_gelu_scalar_kernel"),
                  "layer_norm": ("add_layer_norm_vec_kernel",
                                 "add_layer_norm_scalar_kernel")}[name]
        for kernel in wanted:
            if log and kernel not in log:
                fail(f"ptxas reported no {kernel}")
    lib = load("attention")
    print("[build] attn_fwd_tc_kernel dynamic shared memory: "
          f"{lib.crc_attention_tc_smem_bytes(1, 64)} B with 1 warpgroup "
          f"over one key tile, {lib.crc_attention_tc_smem_bytes(1, 577)} B "
          f"over more, {lib.crc_attention_tc_smem_bytes(2, 577)} B with 2",
          flush=True)
    smem = load("attention_train").crc_attention_train_tc_smem_bytes
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
    return native_missing_what is None


# ---------------------------------------------------------------------------
# phase 16: the multi-card paths

def mesh_compare_indices(report: dict, label: str, got, want,
                         exact: bool) -> None:
    """Record the share of equal entries of two index arrays under
    ``label``; fail unless all equal (``exact``, one rank) or at least
    MESH_INDEX_SHARE."""
    got, want = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                 for x in (got, want))
    if got.shape != want.shape:
        fail(f"[mesh] {label}: shape {got.shape} against {want.shape}")
    share = float((got == want).mean()) if got.size else 1.0
    report.setdefault("equal_share", {})[label] = share
    if share < (1.0 if exact else MESH_INDEX_SHARE):
        fail(f"[mesh] {label}: {share:.6f} of the entries equal")


def mesh_compare(report: dict, label: str, got, want, exact: bool,
                 tol: float) -> None:
    """Record max |got - want| under ``label``; fail unless bit-equal
    (``exact``, one rank) or within ``tol``."""
    got, want = (x.detach().float().cpu().numpy() if torch.is_tensor(x)
                 else np.asarray(x, np.float64) for x in (got, want))
    if got.shape != want.shape:
        fail(f"[mesh] {label}: shape {got.shape} against {want.shape}")
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    report.setdefault("max_abs_diff", {})[label] = diff
    if (diff != 0.0) if exact else not diff <= tol:
        fail(f"[mesh] {label}: max |mesh - no mesh| {diff:.3e} "
             f"({'bit-equal required' if exact else f'tol {tol}'})")


def mesh_train_check(report: dict, tag: str, make_step, model, batch: dict,
                     mesh, exact: bool, run) -> None:
    """One step of ``make_step(mesh, fsdp)`` from ``model``'s weights
    without a mesh, replicated over ``mesh`` and with ``fsdp``: losses and
    trained parameters held to the run without a mesh; each variant's
    seconds and peak memory."""
    from candidate_reranking_cir_tpu_torch.parallel.mesh import shard_batch

    init = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for variant, m, fsdp in (("none", None, False), ("replicated", mesh,
                                                       False),
                             ("fsdp", mesh, True)):
        model.load_state_dict(init)
        step = make_step(m, fsdp)
        local = batch if m is None else shard_batch(m, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = run(lambda: step(local, SEED)) if m is not None \
            else step(local, SEED)
        loss = float(loss)
        torch.cuda.synchronize()
        out[variant] = (loss, {n: p.detach().clone()
                               for n, p in model.named_parameters()
                               if p.requires_grad})
        report.setdefault("train", {})[f"{tag} {variant}"] = {
            "loss": loss, "seconds": round(time.perf_counter() - t0, 4),
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
    for variant in ("replicated", "fsdp"):
        loss, params = out[variant]
        mesh_compare(report, f"{tag} {variant} loss", [loss],
                     [out["none"][0]], exact, MESH_TOL["loss"])
        for name, p in params.items():
            mesh_compare(report, f"{tag} {variant} params", p,
                         out["none"][1][name], exact, MESH_TOL["params"])
    model.load_state_dict(init)


def mesh_checks(tok, words, dtype, exact: bool) -> dict:
    """Phase 16's calls over the world's mesh, each against the same call
    without a mesh (bit-equal at one rank, else within MESH_TOL), with the
    kernels' launches of the mesh calls. Every rank runs it; rank 0's
    report is returned."""
    from candidate_reranking_cir_tpu_torch.config import TrainConfig
    from candidate_reranking_cir_tpu_torch.entry import dryrun_multichip
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.ops.topk import (
        cosine_topk,
        sharded_cosine_topk,
    )
    from candidate_reranking_cir_tpu_torch.parallel.mesh import (
        make_mesh,
        pad_rows,
        shard_rows,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
    from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
        rerank_candidate_major,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        ranked_slices,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage1_train_step,
        make_stage2_train_step,
    )

    mesh = make_mesh(device="cuda")
    report = {"world": mesh.size,
              "launches": dict.fromkeys(registry.counts(), 0)}

    def run(fn):  # a mesh call: its kernel launches count for "mesh"
        before = registry.counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in registry.counts().items():
            report["launches"][k] += v - before[k]
        return out

    rng = np.random.default_rng(SEED + 40)
    t0 = time.perf_counter()
    # stage I at B = MESH_S1_B: the trainer's model (MED with remat,
    # dropout 0.1), cached target features
    cfg = stage1_config()
    torch.manual_seed(SEED + 41)
    s1t = RetrievalModel(cfg, dtype=dtype, device="cuda")
    tgt = rng.normal(size=(MESH_S1_B, cfg.embed_dim)).astype(np.float32)
    ids, mask = tok.encode([" ".join(rng.choice(words, size=1 + i % 20))
                            for i in range(MESH_S1_B)], TEXT_LEN,
                           set_enc_token=True)
    batch1 = {"ref_images": rng.normal(size=(MESH_S1_B, 384, 384, 3))
              .astype(np.float32), "input_ids": ids, "attention_mask": mask,
              "target_pooled": tgt / np.linalg.norm(tgt, axis=1,
                                                    keepdims=True)}

    def stage1_step(m, fsdp):
        opt, _ = make_optimizer(TrainConfig(learning_rate=MESH_LR), s1t,
                                1000, freeze_prefixes=("visual_encoder",),
                                mesh=m, fsdp=fsdp)
        return make_stage1_train_step(s1t, opt, mesh=m)

    mesh_train_check(report, "stage1", stage1_step, s1t, batch1, mesh, exact,
                     run)
    del s1t, batch1
    gc.collect()
    torch.cuda.empty_cache()

    # stage II at B = MESH_S2_B: the trainer's models (dropout 0.1)
    cfg1, cfg2 = train_configs(dropout=True)
    torch.manual_seed(SEED + 42)
    s1 = RetrievalModel(cfg1, dtype=dtype, device="cuda")
    s2 = RerankerModel(cfg2, dtype=dtype, device="cuda")
    ids, mask = tok.encode([" ".join(rng.choice(words, size=3 + i))
                            for i in range(MESH_S2_B)], TEXT_LEN,
                           set_enc_token=True)
    batch2 = {k: rng.normal(size=(MESH_S2_B, 384, 384, 3)).astype(np.float32)
              for k in ("ref_images", "target_images")}
    batch2.update(input_ids=ids, attention_mask=mask)

    def stage2_step(m, fsdp):
        opt, _ = make_optimizer(TrainConfig(learning_rate=MESH_LR), s2,
                                1000, freeze_prefixes=("visual_encoder",),
                                mesh=m, fsdp=fsdp)
        return make_stage2_train_step(s1, s2, opt, mesh=m)

    mesh_train_check(report, "stage2", stage2_step, s2, batch2, mesh, exact,
                     run)
    del batch2
    report["seconds_train"] = round(time.perf_counter() - t0, 3)

    # ranked_slices at CIRR-val scale, random pooled features
    t1 = time.perf_counter()
    pred = rng.normal(size=(S1E_QUERIES, 256)).astype(np.float32)
    pooled = torch.from_numpy(rng.normal(size=(S1E_IMAGES, 256))
                              .astype(np.float32)).cuda()
    ent = rng.integers(0, S1E_IMAGES, size=(S1E_QUERIES, 7))
    got = run(lambda: ranked_slices(pred, pooled, 501, ent, mesh=mesh))
    want = ranked_slices(pred, pooled, 501, ent)
    for label, a, b in zip(("ranked_slices topk", "ranked_slices ranks"),
                           got, want):
        mesh_compare_indices(report, label, a, b, exact)

    # the stage-II bank over MESH_INDEX_IMAGES images, block-sharded
    # (bf16 as the eval path stores it; in an fp32 run fp32, since the
    # ranks' embeds round apart and bf16 storage turns that into an ulp)
    corpus = Corpus(MESH_INDEX_IMAGES, 384, rng)
    bank_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    torch.cuda.reset_peak_memory_stats()
    block, names = run(lambda: build_index(
        corpus, s2.embed_images, 32, feature_dtype=bank_dtype, mesh=mesh,
        shard_index=True))
    whole, _ = build_index(corpus, s2.embed_images, 32,
                           feature_dtype=bank_dtype, device="cuda")
    padded, n = pad_rows(whole, mesh.size)
    mesh_compare(report, "build_index shard", block,
                 padded[shard_rows(mesh, len(padded))], exact,
                 MESH_TOL["bank"])
    report["bank_bytes_per_rank"] = block.numel() * block.element_size()
    report["bank_bytes_whole"] = whole.numel() * whole.element_size()

    # the candidate-major re-rank over the sharded and the replicated bank
    queries = make_queries(names, MESH_RERANK_Q, TOPK, rng, words)
    kw = dict(captions=[q["caption"] for q in queries],
              reference_names=[q["reference_name"] for q in queries],
              topk_names=np.stack([q["topk_names"] for q in queries]),
              index_names=names, text_len=TEXT_LEN,
              group_members=[q["group_members"] for q in queries])
    plain = rerank_candidate_major(s1, None, s2, None, tok,
                                   index_feats=whole, device="cuda", **kw)
    for label, bank, sharded in (("replicated", whole, False),
                                 ("sharded", block, True)):
        out = run(lambda: rerank_candidate_major(
            s1, None, s2, None, tok, index_feats=bank, mesh=mesh,
            index_sharded=sharded, **kw))
        mesh_compare(report, f"rerank {label} logits", out.logits,
                     plain.logits, exact, MESH_TOL["logits"])
        mesh_compare(report, f"rerank {label} group logits",
                     out.group_logits, plain.group_logits, exact,
                     MESH_TOL["logits"])

    # the per-shard top-k over the pooled features' row blocks
    pooled_pad, _ = pad_rows(pooled, mesh.size)
    q = torch.from_numpy(pred[:MESH_RERANK_Q]).cuda()
    scores, idx = run(lambda: sharded_cosine_topk(
        q, pooled_pad[shard_rows(mesh, len(pooled_pad))], TOPK, mesh))
    ref_scores, ref_idx = cosine_topk(q, pooled, TOPK)
    mesh_compare_indices(report, "sharded_cosine_topk indices", idx,
                         ref_idx, exact)
    mesh_compare(report, "sharded_cosine_topk scores", scores, ref_scores,
                 exact, MESH_TOL["bank"])
    report["seconds_eval"] = round(time.perf_counter() - t1, 3)
    report["peak_gib_eval"] = round(torch.cuda.max_memory_allocated()
                                    / 2**30, 3)
    del s1, s2, whole, block, pooled
    gc.collect()
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    report["dryrun"] = run(lambda: dryrun_multichip(mesh.size))
    report["seconds_dryrun"] = round(time.perf_counter() - t2, 3)
    return report if mesh.rank == 0 else None


def mesh_rank(words: list[str]):
    """A rank of a several-card world: phase 16 in fp32, to tolerances."""
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )

    return mesh_checks(WordPieceTokenizer(build_test_vocab()), words,
                       torch.float32, exact=False)


def mesh_path(tok, words) -> dict:
    """Phase 16: the mesh paths at full width through NCCL, over
    min(4, cards) ranks: one rank in this process (bf16, every result
    bit-equal to the same call without a mesh), or one spawned rank a card
    (fp32, MESH_TOL). Returns the launches of the mesh calls."""
    import torch.distributed as dist

    from candidate_reranking_cir_tpu_torch.parallel.launch import run_world
    from candidate_reranking_cir_tpu_torch.parallel.mesh import (
        init_process_group,
    )

    world = min(MESH_WORLD_MAX, torch.cuda.device_count())
    t0 = time.perf_counter()
    if world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            init_process_group(0, 1, device="cuda",
                               init_method=f"file://{tmp}/store")
            try:
                report = mesh_checks(tok, words, torch.bfloat16, exact=True)
            finally:
                dist.destroy_process_group()
    else:
        report = run_world(mesh_rank, world, device="cuda", args=(words,),
                           timeout_s=900.0)[0]
    seconds = time.perf_counter() - t0
    missed = [k for k in MESH_KERNELS if report["launches"][k] == 0]
    print(f"[mesh] world {report['world']} (NCCL, "
          f"{'bf16, bit-equal to no mesh' if world == 1 else 'fp32'}); "
          f"phase seconds {seconds:.1f} (train {report['seconds_train']}, "
          f"eval {report['seconds_eval']}, dryrun "
          f"{report['seconds_dryrun']})", flush=True)
    print(f"[mesh] train steps {json.dumps(report['train'])}", flush=True)
    print(f"[mesh] bank bytes per rank {report['bank_bytes_per_rank']} of "
          f"{report['bank_bytes_whole']}; eval peak "
          f"{report['peak_gib_eval']} GiB per rank", flush=True)
    print(f"[mesh] max |mesh - no mesh| "
          f"{json.dumps(report['max_abs_diff'])}; equal index shares "
          f"{json.dumps(report['equal_share'])}", flush=True)
    print(f"[mesh] dryrun {json.dumps(report['dryrun'])}; launches "
          f"{json.dumps(report['launches'])}", flush=True)
    if missed:
        fail(f"[mesh] kernels of the mesh paths not launched: {missed}")
    if not seconds <= MESH_PHASE_S:
        print(f"[mesh] WARNING: the phase took {seconds:.1f} s, over its "
              f"{MESH_PHASE_S} s budget", flush=True)
    report["seconds"] = seconds
    return report


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = smi_name_and_limit()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    native_ok = build_libraries()
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
    for case, d in NARROW_CASES:
        run_kernel_case(*case, torch.bfloat16, d=d)
    records.update(run_wide_cases())
    # the JSON line keeps G1 at the ViT's shape
    records["G1"] = run_bias_gelu_cases()[0]
    # and G2 at the EVA ViT-g's norm2
    records["G2"] = run_layer_norm_cases()[0]
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
    s1e = stage1_eval_path(tok, words, s1e_queries)
    s1e_launches = s1e["launches"]
    p15 = phase15(tok, words, s1e_queries, s1e)
    serve_launches = serving_path(tok, words, s1e["corpus"])
    del s1e
    gc.collect()
    blip2_launches = blip2_stage1_eval_path(tok, words)
    kimi_launches = kimi_vl_rerank_path(tok, words)
    cli = train_cli_path(tok, words, native_ok)
    caption = caption_path(tok)
    glue = glue_path(tok, words)
    mesh = mesh_path(tok, words)

    kernels = []
    for kid in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "G1",
                "G2", "K1_d88", "K1_d72"):
        rec = records[kid]
        # K1-K4: launches on the two eval paths (stage II, then stage I);
        # K6/K7 on the stage-II training path; K8/K9 on the stage-I one; K5
        # runs inside every K6-K9 launch that applies the mask, on both
        # training paths
        # every kernel also counts its launches in the trainer CLIs' runs
        # (phase 10) under the path key "train_cli" and in the caption
        # decodes (phase 13, K1-K3 > 0 and the others 0) under "caption",
        # and K1-K3 in the serving run (phase 11) under "serve"; K1-K4 the
        # single-program eval's first call (phase 15 (a): its eager pass and
        # its capture; a replay adds none) under "single_program", K5-K9
        # the dropout layouts' card runs (phase 15 (b), (c)) under
        # "dropout_layouts"
        # G1 runs in every FFN and G2 at every LayerNorm: they count on the
        # eval paths, both training paths and the dropout layouts
        # K1_d88 (K1 at 88-wide heads, in K1's counts too) runs on BLIP-2's
        # stage-I eval (phase 17) alone, under "blip2_stage1_eval", which
        # also counts K1-K4, G1 and G2; K1_d72 on Kimi-VL's re-rank (phase
        # 18) alone, under "kimi_vl_rerank", which also counts K1 and G2
        by_path = {}
        wide = kid in ("K1_d88", "K1_d72")
        if kid == "K1_d88":
            by_path = {"blip2_stage1_eval": blip2_launches[kid]}
        elif kid == "K1_d72":
            by_path = {"kimi_vl_rerank": kimi_launches[kid]}
        elif kid in EVAL_KERNELS or kid in ("G1", "G2"):
            by_path = {"stage2_eval": launches[kid],
                       "stage1_eval": s1e_launches[kid],
                       "serve": serve_launches[kid],
                       "single_program": p15["single_program"][kid],
                       "blip2_stage1_eval": blip2_launches[kid],
                       "kimi_vl_rerank": kimi_launches[kid]}
        if kid in ("K5", "G1", "G2"):
            by_path.update(stage2_train=train["launches"][kid],
                           stage1_train=stage1["launches"][kid])
        elif kid in ("K8", "K9"):
            by_path["stage1_train"] = stage1["launches"][kid]
        elif kid in ("K6", "K7"):
            by_path["stage2_train"] = train["launches"][kid]
        if kid not in EVAL_KERNELS and not wide:
            by_path["dropout_layouts"] = p15["dropout_layouts"][kid]
        if not wide:
            by_path["train_cli"] = cli["launches"][kid]
            by_path["caption"] = caption["launches"][kid]
            by_path["glue"] = glue["launches"][kid]
            by_path["mesh"] = mesh["launches"][kid]
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
                                         "sdpa_own_mask_ms", "bytes_bound_ms",
                                         "issue_bound_ms") if key in rec}})
    print(json.dumps({"kernels": kernels}))
    print(f"[dense] hit share by path {json.dumps(DENSE_BY_PATH)}",
          flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
