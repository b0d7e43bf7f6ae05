"""The benchmark's one command.

    python3 -m cirbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port
(``candidate_reranking_cir_tpu_torch``). It needs as many CUDA cards as
the cell asks for and refuses to run without them. The last line of
standard output is the result as one JSON object; the numbers compared
with the reference, each beside its limit, are the last lines of standard
error and the result's last key, ``checks``.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
CACHE = Path(__file__).resolve().parent / "_cache"


def fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc libraries already land in its own ``_build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()

    import torch

    from cirbench import harness

    t_start = harness.process_start() or T_IMPORT
    bench = harness.load_benchmark(ROOT)
    entry = harness.cell_entry(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"[cirbench] {args.workload} needs {entry['chips']} CUDA "
              "card(s); none or too few here, so no result",
              file=sys.stderr, flush=True)
        return 2
    harness.log(f"card: {harness.power_limit()}")
    result = harness.run_cell(bench, ROOT, args.workload, args.seed,
                              args.seconds, bool(args.trace), "cuda",
                              t_start=t_start)
    found = harness.forbidden_loaded()
    if found:
        print(f"[cirbench] the run loaded {found}: the benchmark and the "
              "port may not load JAX or the JAX package; no result",
              file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
