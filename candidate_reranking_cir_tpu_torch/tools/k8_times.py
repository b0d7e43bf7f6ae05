"""K8 alone at the stage-I MED's shapes, and K6 at the stage-II shape.

    python -m candidate_reranking_cir_tpu_torch.tools.k8_times [--tag TEXT]

Runs on one CUDA card, from the repository root (or the root of a copy of
it whose kernel sources were changed, to time a design choice: it builds
the copy's own sources). For bf16 K8 at [512, Lq, 768] queries x 577 keys,
Lq 32 and 40, rate 0.1, and bf16 K6 at [16, 640, 12, 64] x 577 keys, it
prints the max |error| against the plain version, then CUDA-event times
over back-to-back calls and device-only times of CUDA-graph replays, two
of each, and one JSON line of it all. About 15 s after the build.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k8_times: CUDA is not available")
    import chip_smoke as cs
    from candidate_reranking_cir_tpu_torch.ops import attention_train as tat

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    seed, rate = cs.TRAIN_SEED, cs.TRAIN_RATE
    e, m, h, d = cs.S1_SHAPE
    cases = {}
    for lq in cs.S1_WIDTHS:
        q = torch.randn(e, lq, h * d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(e, m, h * d, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        heads = [tat._heads(x, h) for x in (q, k, v)]
        cases[f"K8 Lq {lq}"] = (
            lambda heads=heads: tat._kernel_fwd(*heads, None, seed, rate,
                                                folded=True),
            lambda q=q, k=k, v=v: tat.attention_train_folded_plain(
                q, k, v, None, seed, rate, num_heads=h).unflatten(-1, (h, d)))
    e6, lq6, m6, h6, d6 = cs.TRAIN_SHAPE
    q6 = torch.randn(e6, lq6, h6, d6, generator=g, device="cuda").bfloat16()
    k6, v6 = (torch.randn(e6, m6, h6, d6, generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    cases["K6"] = (lambda: tat._kernel_fwd(q6, k6, v6, None, seed, rate),
                   lambda: tat.attention_train_plain(q6, k6, v6, None, seed,
                                                     rate))
    out = {"tag": args.tag, "card": cs.smi_name_and_limit()}
    for name, (kernel, plain) in cases.items():
        err = (kernel().float() - plain().float()).abs().max().item()
        runs = [(cs.time_ms(kernel), cs.graph_ms(kernel)) for _ in range(2)]
        out[name] = {"max_abs_err": err, "ms": [r[0] for r in runs],
                     "device_ms": [r[1] for r in runs]}
        print(f"[k8-times{' ' + args.tag if args.tag else ''}] {name}: "
              f"max|err| {err:.3e}; ms " + ", ".join(
                  f"{a:.4f} [device {b:.4f}]" for a, b in runs), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
