"""The serving sweep: the highest rate the server sustains, found once on
the card, from which the serving cells' fixed rates are set.

    python3 -m cirbench.tools.serve_sweep --workload serve_cirr_open_0p8 \
        --rates 8,12,16,20,24 --seconds 30 --seed 1

One set-up, then one open-loop window at each offered rate (Poisson, the
cell's traffic but for its rate). For each rate: the requests, the
answered rate, p50/p95 latency from the due time, the generator's p95
lateness, the batcher's wave occupancy, and whether the backlog grew (the
median latency of the window's last third over its first third). A rate is
sustained when every request was answered, the answered rate is within 3%
of the offered one and the backlog did not double."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from cirbench import harness


def summary(rate: float, rec: dict) -> dict:
    recs = rec["records"]
    ok = [r for r in recs if r.get("status") == 200]
    lat = np.asarray([r["done"] - r["due"] for r in ok]) * 1e3
    third = max(1, len(lat) // 3)
    first, last = np.median(lat[:third]), np.median(lat[-third:])
    span = max(r["done"] for r in ok) - min(r["due"] for r in ok)
    s0, s1 = rec["stats0"], rec["stats1"]
    out = {"rate": rate, "requests": len(recs), "failed": len(recs) - len(ok),
           "answered_per_s": len(ok) / span,
           "p50_ms": float(np.percentile(lat, 50)),
           "p95_ms": float(np.percentile(lat, 95)),
           "late_p95_ms": float(np.percentile(
               [(r["sent"] - r["due"]) * 1e3 for r in recs], 95)),
           "occupancy": (s1["requests"] - s0["requests"])
           / max(1, s1["waves"] - s0["waves"]),
           "backlog_growth": float(last / first)}
    out["sustained"] = (out["failed"] == 0
                        and out["answered_per_s"] >= 0.97 * rate
                        and out["backlog_growth"] < 2.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
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
    cell = driver.Cell(cfg, traffic, spec["engine"], args.seed, "cuda")
    cell.setup()
    rows = []
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            cell.traffic = {**traffic, "arrival": {**traffic["arrival"],
                                                   "rate": rate}}
            rows.append(summary(rate, cell.window(args.seconds)))
            print(f"[sweep] {json.dumps(rows[-1])}", flush=True)
    finally:
        cell.release()
    knee = max((r["rate"] for r in rows if r["sustained"]), default=None)
    print(json.dumps({"rows": rows, "knee": knee,
                      "card": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
