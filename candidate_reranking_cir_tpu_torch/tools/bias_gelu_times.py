"""What the bias + exact-GELU kernel (``ops/activation.py``) does to one ViT
batch and one dual-encoder chunk, eager route against the kernel.

    python -m candidate_reranking_cir_tpu_torch.tools.bias_gelu_times \
        [--tag TEXT] [--out FILE]

Runs on one CUDA card, from the repository root. With full-width bf16
models from a fixed seed, one ViT batch of 32 images and one dual-encoder
chunk (8 candidates x 32 queries x 40 tokens) are each timed and profiled
twice: every FFN on the eager route (``bias_gelu_plain``, what the models
ran before the kernel), then on the kernel. One JSON line of ms a call,
launches and the top device ops, also written to ``--out``. About a
minute after the build. The kernel alone, at the paths' shapes, is
``chip_smoke.py``'s ``[kernel] G1`` lines.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

CHUNK = (8, 32, 40)  # candidates, queries, tokens


@contextlib.contextmanager
def eager_ffns():
    """Every FFN of the models on the plain version of ``bias_gelu``: the
    eager route they ran before the kernel."""
    from candidate_reranking_cir_tpu_torch.models import layers
    from candidate_reranking_cir_tpu_torch.ops import activation as act

    saved, layers.bias_gelu = layers.bias_gelu, act.bias_gelu_plain
    try:
        yield
    finally:
        layers.bias_gelu = saved


def model_calls(cs) -> dict:
    """One ViT batch and one dual-encoder chunk, eager route then kernel:
    ms a call (CUDA events) and the profiler's device breakdown."""
    from candidate_reranking_cir_tpu_torch.ops import activation as act

    s1, s2 = cs.eval_models()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    images = torch.randn(32, 384, 384, 3, generator=g, device="cuda")
    a, b, length = CHUNK
    d = s2.cfg.text.hidden_size
    z_t = torch.randn(a, b, length, d, generator=g, device="cuda").bfloat16()
    ids = torch.randint(1, 1000, (a, b, length), generator=g, device="cuda",
                        dtype=torch.int32)
    mask = torch.ones(a, b, length, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        feats = s2.embed_images(images[:a])
    calls = {
        "vit_batch_32": lambda: s1.embed_images(images,
                                                pool_and_normalize=True),
        "dual_chunk_8x32x40": lambda: s2.score_grid(z_t, ids, mask, feats),
    }
    out = {}
    for name, call in calls.items():
        for route in ("eager", "kernel"):
            ctx = (eager_ffns() if route == "eager"
                   else contextlib.nullcontext())
            with ctx, torch.inference_mode():
                act.reset_launch_counts()
                call()
                torch.cuda.synchronize()
                launches = dict(act.LAUNCHES)
                ms = cs.time_ms(call, 5)
                kernels = cs.profile_device(f"{name} {route}", call)
            out[f"{name}.{route}"] = {
                "ms": ms, "launches": launches,
                "device_ms_by_kernel": {k[:160]: round(v / 1e3, 4) for k, v in
                                        sorted(kernels.items(),
                                               key=lambda kv: -kv[1])[:12]}}
            print(f"[bias_gelu] {name} {route}: {ms:.3f} ms a call; "
                  f"launches {launches}", flush=True)
        speed = out[f"{name}.eager"]["ms"] / out[f"{name}.kernel"]["ms"]
        print(f"[bias_gelu] {name}: eager / kernel {speed:.2f}x", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bias_gelu_times: CUDA is not available")
    import chip_smoke as cs

    rec = {"tag": args.tag, "card": cs.smi_name_and_limit(),
           "models": model_calls(cs)}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
