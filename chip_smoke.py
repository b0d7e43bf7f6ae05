#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            (from the repository root)

Phases, each printing its own lines:
1. device: requires CUDA; prints ``nvidia-smi`` name and power limit.
2. build: compiles the attention kernels from ``csrc/`` (nvcc, sm_90a).
3. kernels K1-K4 at the main path's shapes, bf16 and fp32: max |error|
   against the plain PyTorch version, kernel / plain / SDPA times (SDPA is
   a yardstick only; the port never calls it) and the least time the card
   could take (bytes over 3.35 TB/s or operations over the dtype's peak).
4. main path: stage-II re-rank evaluation through the port's
   ``evaluate_cirr_stage2`` entry at full ViT-B/16@384 + MED + dual-encoder
   width in bf16, random weights from a seed, on a synthetic CIRR-shaped
   corpus held in memory; launch counts per kernel (K1-K3 must be > 0);
   then a few hundred pairs re-scored in fp32 on the card and on the CPU.
5. a JSON line of kernel figures, then the card's name and power limit,
   then the last line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero without the last line.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_IMAGES, N_QUERIES, TOPK, TEXT_LEN = 128, 256, 50, 40
N_CHECK_QUERIES = 4            # queries re-scored in fp32 on card and CPU
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FP32_CARD_VS_CPU_TOL = 1e-3    # summation order through 12+12 layers
BF16_VS_FP32_TOL = 0.1         # bf16 compute vs fp32 on the same weights
SOURCE = "candidate_reranking_cir_tpu_torch/csrc/attention.cu"
JAX_KERNELS = "candidate_reranking_cir_tpu/ops/pallas_attention.py"
REPLACES = {"K1": f"{JAX_KERNELS}:220", "K2": f"{JAX_KERNELS}:132",
            "K3": f"{JAX_KERNELS}:122", "K4": f"{JAX_KERNELS}:236"}
MAIN_PATH_KERNELS = ("K1", "K2", "K3")


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


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes

def kernel_cases():
    """(kernel id, label, e, lq, m, heads, folded, with key-mask bias)."""
    return [
        ("K1", "ViT self-attention", 16, 577, 577, 12, True, False),
        ("K1", "MED cross-attention", 32, 40, 577, 12, True, False),
        ("K2", "masked text self-attention", 256, 40, 40, 12, False, True),
        ("K3", "candidate-major cross-attention", 8, 32 * 40, 577, 12,
         False, False),
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
    n_ops = 4 * e * h * lq * m * d
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    rec = {"name": kid, "label": label, "dtype": str(dtype).split(".")[-1],
           "shape": [e, lq, m, h, d], "max_abs_err": err,
           "ms": time_ms(kernel), "plain_ms": time_ms(plain),
           "library_ms": time_ms(library),
           "bound_ms": max(t_mem, t_ops) * 1e3,
           "bound_by": "bytes" if t_mem >= t_ops else "operations"}
    print(f"[kernel] {kid} {label} {rec['dtype']} q/k/v {list(shape_q)} x "
          f"{m} keys{' +mask' if with_bias else ''}: max|err| {err:.3e} "
          f"(tol {TOL[dtype]}), kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the main path

class Corpus:
    """'classic' dataset over in-memory [H, W, 3] images (CLIP-normalised
    scale), made from a seed."""

    def __init__(self, n: int, size: int, rng):
        self.index_names = [f"img{i:04d}" for i in range(n)]
        self.images = rng.normal(size=(n, size, size, 3)).astype(np.float32)

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


def main_path():
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
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
    from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
        rerank_candidate_major,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
        evaluate_cirr_stage2_datasets,
    )

    vit, text = vit_config("base", 384), TextEncoderConfig()
    cfg1 = RetrievalModelConfig(vit=vit, text=text, text_len=TEXT_LEN)
    cfg2 = RerankerModelConfig(vit=vit, text=text, text_len=TEXT_LEN)
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    s1 = RetrievalModel(cfg1, dtype=torch.bfloat16, device="cuda")
    s2 = RerankerModel(cfg2, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] random weights at full width (seed {SEED}): "
          f"{sum(p.numel() for p in s1.parameters()) / 1e6:.1f}M + "
          f"{sum(p.numel() for p in s2.parameters()) / 1e6:.1f}M params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(SEED)
    corpus = Corpus(N_IMAGES, vit.image_size, rng)
    vocab = build_test_vocab()
    words = [w for w in vocab if w.isalpha() and len(w) > 1]
    queries = make_queries(corpus.index_names, N_QUERIES, TOPK, rng, words)
    tok = WordPieceTokenizer(vocab)
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
    skip = np.asarray([not q["topk_labels"].any() for q in queries])
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
    sel = [i for i in range(N_QUERIES) if not skip[i]][:N_CHECK_QUERIES]
    sub = dict(captions=[queries[i]["caption"] for i in sel],
               reference_names=[queries[i]["reference_name"] for i in sel],
               topk_names=np.stack([queries[i]["topk_names"] for i in sel]),
               index_names=names, text_len=TEXT_LEN,
               group_members=[queries[i]["group_members"] for i in sel],
               zt_batch=N_CHECK_QUERIES)
    logits = {}
    for tag, dtype, device in (("bf16 card", torch.bfloat16, "cuda"),
                               ("fp32 card", torch.float32, "cuda"),
                               ("fp32 cpu", torch.float32, "cpu")):
        m1 = RetrievalModel(cfg1, dtype=dtype, device=device)
        m1.load_state_dict(s1.state_dict())
        m2 = RerankerModel(cfg2, dtype=dtype, device=device)
        m2.load_state_dict(s2.state_dict())
        t0 = time.perf_counter()
        r = rerank_candidate_major(m1, None, m2, None, tok, device=device,
                                   index_feats=bank.to(device), **sub)
        logits[tag] = np.concatenate([r.logits, r.group_logits], axis=1)
        print(f"[check] {tag}: {logits[tag].size} pairs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del m1, m2
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

    profile_scoring(lambda: rerank_candidate_major(
        s1, None, s2, None, tok, device="cuda", index_feats=bank,
        captions=[q["caption"] for q in queries],
        reference_names=[q["reference_name"] for q in queries],
        topk_names=np.stack([q["topk_names"] for q in queries]),
        index_names=names, text_len=TEXT_LEN, skip_mask=skip,
        group_members=[q["group_members"] for q in queries]))
    return launches


def profile_scoring(run):
    """Device time by kernel family over one z_t + scoring pass (after the
    counted run; torch.profiler, CUPTI), and the device's idle share of
    the pass's wall time."""
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
        if "attn_fwd_kernel" in name:
            fam = ("attention, bias (K2/K4)" if "true" in name.lower()
                   else "attention, no bias (K1/K3)")
        elif any(s in name.lower() for s in ("gemm", "xmma", "cutlass",
                                             "nvjet")):
            fam = "matmul (cuBLAS)"
        elif name.startswith("Memcpy"):
            fam = "copies"
        else:
            fam = "elementwise, norms, gathers"
        families[fam] = families.get(fam, 0.0) + us
    busy = sum(families.values())
    if busy == 0.0:
        print("[profile] the profiler reported no device time: device "
              "breakdown not measured", flush=True)
        return
    parts = ", ".join(f"{k} {v / 1e3:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in sorted(families.items(),
                                         key=lambda kv: -kv[1]))
    print(f"[profile] scoring pass: wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share "
          f"{100 * max(0.0, 1 - busy / wall_us):.1f}%; {parts}", flush=True)
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {us / 1e3:8.1f} ms  {name[:110]}", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = smi_name_and_limit()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    from candidate_reranking_cir_tpu_torch.ops.build import build

    path, seconds, log = build("attention")
    print(f"[build] {path.name}: {seconds:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    records = {}
    for case in kernel_cases():
        for dtype in (torch.float32, torch.bfloat16):
            rec = run_kernel_case(*case, dtype)
            # the JSON line keeps each kernel's first main-path shape, bf16
            if dtype == torch.bfloat16 and case[0] not in records:
                records[case[0]] = rec

    launches = main_path()
    kernels = []
    for kid in ("K1", "K2", "K3", "K4"):
        rec = records[kid]
        kernels.append({
            "name": kid, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kid], "launches": launches[kid],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
