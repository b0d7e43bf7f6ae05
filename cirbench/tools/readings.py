"""The readings that the correctness limits are set from, on the card, at
a cell's own size: for each seed one call of the timed path (an
open-loop cell: one window of ``--seconds`` at its rate) compared with the
plain reference (the program's readings), and with ``--control`` the
reference one precision lower (fp8) in the program's place.

    python3 -m cirbench.tools.readings --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6]

Prints one line per seed and reading; the last line is a JSON object of
them all. Every seed builds the cell anew (weights and traffic are the
seed's)."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from cirbench import harness


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="an open-loop cell's window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = Path.cwd()
    bench = harness.load_benchmark(root)
    entry = harness.cell_entry(bench, args.workload)
    spec = harness.load_json("workloads", args.workload)
    cfg = harness.config_of(bench, root, entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    driver = harness.load_module("drivers", spec["driver"])
    out = {"program": {}, "control": {}}
    for kind, todo in (("program", args.seeds), ("control", args.control)):
        for seed in todo:
            t0 = time.perf_counter()
            cell = driver.Cell(cfg, traffic, spec.get("engine", {}), seed,
                               "cuda")
            window = hasattr(cell, "window")
            cell.setup(warm=window and kind == "program")
            if kind == "program":
                rec = cell.window(args.seconds) if window else cell.call()
                torch.cuda.synchronize()
                cell.release()
                nums = cell.check([cell.outputs(rec)])
            else:
                nums = cell.control("fp8")
                if window:
                    cell.release()
            out[kind][seed] = nums
            print(f"[readings] {args.workload} {kind} seed {seed}: "
                  f"{json.dumps(nums)} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            del cell
            gc.collect()
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
