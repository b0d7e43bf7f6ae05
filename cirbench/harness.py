"""The benchmark's machinery, driven by data: ``BENCHMARK.json`` names the
cells, metrics and configurations, and each is found by its name.

- ``cirbench/workloads/<cell>.json``: the driver, the engine's settings
  and the correctness limits of one cell;
- ``cirbench/traffic/<traffic>.json``: the parameters of a traffic mix;
- ``cirbench/configs/<config>.json``: a model configuration (the file
  that ``BENCHMARK.json`` names);
- ``cirbench/drivers/<driver>.py``: a ``Cell`` class that builds the
  system under test from the seed, runs one unit of work (``call``) and
  compares what the timed path produced with the plain reference;
- ``cirbench/metrics/<metric>.py``: a ``read(run)`` that takes one metric
  from the run's record, or returns None where it finds nothing to read.

A run: set-up (the driver's, warm-up included), the window of
``seconds`` (whole calls: one that starts inside it is finished and
counted), the peak memory, optionally the trace of one more call, then the
program's state freed and the comparison with the reference.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from cirbench.counts import kernels

PKG = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "candidate_reranking_cir_tpu")


class BenchmarkError(RuntimeError):
    """A run that cannot give a result."""


# ---------------------------------------------------------------------------
# finding things by name

def load_benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchmarkError(f"no {path}")
    return json.loads(path.read_text())


def load_json(kind: str, name: str, pkg: Path = PKG) -> dict:
    path = pkg / kind / f"{name}.json"
    if not path.is_file():
        raise BenchmarkError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, pkg: Path = PKG):
    """``cirbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = pkg / kind / f"{name}.py"
    if not path.is_file():
        raise BenchmarkError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"cirbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise BenchmarkError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: dict, root: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise BenchmarkError(f"no configuration {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those that list it under ``workloads``, or list no cells at all."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


# ---------------------------------------------------------------------------
# the device

def device_kind(device: str) -> str:
    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"


def power_limit() -> str:
    """The card's name and power limit from ``nvidia-smi``, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def forbidden_loaded(modules=None) -> list[str]:
    """Modules of JAX or of the JAX package in ``modules`` (default
    ``sys.modules``), compared by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN_MODULES})


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux /proc),
    or None."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    hz = os.sysconf("SC_CLK_TCK")
    return time.time() - (uptime - start_ticks / hz)


# ---------------------------------------------------------------------------
# the trace

def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(device_events, host_events, t0: float, t1: float) -> dict:
    """Device time by kernel family and by name, the busy time (the union
    of the device's intervals) and the idle gaps by what the host was
    doing, over the traced window [t0, t1] (microseconds).

    device_events: (name, start, end); host_events: top-level host ops
    (name, start, end)."""
    fam: dict[str, float] = {}
    by_name: dict[str, float] = {}
    n_attention = 0
    spans = []
    for name, s, e in device_events:
        dur = e - s
        f = kernels.family(name)
        fam[f] = fam.get(f, 0.0) + dur
        by_name[name] = by_name.get(name, 0.0) + dur
        n_attention += f == kernels.ATTENTION
        spans.append((max(s, t0), min(e, t1)))
    merged = _merge([sp for sp in spans if sp[1] > sp[0]])
    busy = sum(e - s for s, e in merged)
    gaps, last = [], t0
    for s, e in merged:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    host = sorted(host_events, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        label = host[i][0] if i >= 0 and host[i][2] >= mid else "host idle"
        idle[label] = idle.get(label, 0.0) + (e - s)
    return {"families_us": fam, "kernels_us": by_name, "busy_us": busy,
            "window_us": t1 - t0, "attention_kernels": n_attention,
            "idle_us": idle}


def top_level(events: list[tuple[str, float, float]]) -> list:
    """The host events that no other event encloses."""
    out, end = [], -math.inf
    for name, s, e in sorted(events, key=lambda h: (h[1], -h[2])):
        if s >= end:
            out.append((name, s, e))
            end = e
    return out


def profile(fn, device: str) -> tuple[object, dict]:
    """Run ``fn`` under ``torch.profiler`` (host and device activity) and
    reduce its raw trace (the profiler's own per-op tables are never
    built: they take minutes for a call of a million events); the host's
    clock gives the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync(device)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t_host = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t_host
    dev, host = [], []
    for evt in prof.profiler.kineto_results.events():
        s = evt.start_ns() / 1e3
        span = (evt.name(), s, s + evt.duration_ns() / 1e3)
        (dev if evt.device_type() == DeviceType.CUDA else host).append(span)
    del prof
    gc.collect()
    if not dev:
        return out, {}
    host = top_level(host)
    t0 = host[0][1] if host else min(d[1] for d in dev)
    return out, reduce_trace(dev, host, t0, t0 + wall * 1e6)


def launches() -> dict:
    """The port's own attention launch counters."""
    from candidate_reranking_cir_tpu_torch.ops import attention_train, \
        cuda_attention
    return {**cuda_attention.LAUNCHES, **attention_train.LAUNCHES}


def breakdown(red: dict) -> dict:
    top = sorted(red["kernels_us"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["idle_us"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


# ---------------------------------------------------------------------------
# a run

def log(msg: str) -> None:
    print(f"[cirbench] {msg}", file=sys.stderr, flush=True)


def run_cell(bench: dict, root: Path, workload: str, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             config_override=None, traffic_override=None,
             t_start: float | None = None, pkg: Path = PKG) -> dict:
    """One run of ``workload``; returns the result line's object, with the
    compared numbers last under ``checks``. ``*_override`` (tests on the
    CPU): functions that take the loaded config or traffic and return the
    one to run; ``pkg`` the directory the named files are found in."""
    t_start = time.time() if t_start is None else t_start
    entry = cell_entry(bench, workload)
    spec = load_json("workloads", workload, pkg)
    cfg = config_of(bench, root, entry["config"])
    traffic = load_json("traffic", entry["traffic"], pkg)
    if config_override is not None:
        cfg = config_override(cfg)
    if traffic_override is not None:
        traffic = traffic_override(traffic)
    driver = load_module("drivers", spec["driver"], pkg)
    cell = driver.Cell(cfg, traffic, spec.get("engine", {}), seed, device)

    cell.setup()
    try:
        return _measure(bench, cell, entry, spec, cfg, traffic, workload,
                        seconds, trace, device, t_start, pkg)
    except BaseException:
        if not getattr(cell, "released", False):
            cell.release()              # stops what the cell started
        raise


def _measure(bench, cell, entry, spec, cfg, traffic, workload, seconds,
             trace, device, t_start, pkg) -> dict:
    sync(device)
    gc.collect()
    setup_s = time.time() - t_start
    log(f"{workload}: set-up {setup_s:.3f} s")

    if hasattr(cell, "window"):          # one open-loop window
        calls = [cell.window(seconds)]
        window_s = calls[0]["wall"]
    else:                                # whole calls, back to back
        calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            c0 = time.perf_counter()
            rec = cell.call()
            sync(device)
            rec["wall"] = time.perf_counter() - c0
            calls.append(rec)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"{workload}: {len(calls)} calls in {window_s:.3f} s")

    red, traced = {}, None
    if trace:
        for attempt in range(3):
            before = dict(launches())
            traced, red = profile(cell.traced if hasattr(cell, "traced")
                                  else cell.call, device)
            after = launches()
            counted = sum(after[k] - before[k] for k in after)
            found = red.get("attention_kernels", -1)
            agree = bool(red) and found == counted * cell.kernels_per_launch
            log(f"{workload}: trace attempt {attempt + 1}: attention "
                f"kernels in the trace {found}, launches counted {counted}"
                f": {'agree' if agree else 'SHORT TRACE, not a reading'}")
            if agree:
                break
            red = {}
        if not red:
            raise BenchmarkError("every trace lost kernel records")

    outputs = [cell.outputs(rec) for rec in calls]
    cell.release()
    cell.released = True
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    limits = spec["check"]["limits"]
    numbers = cell.check(outputs)
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    run = {"workload": workload, "config": cfg, "traffic": traffic,
           "calls": calls, "window_s": window_s, "setup_s": setup_s,
           "work": cell.work(), "trace": red, "traced": traced,
           "device": device}
    chosen = metrics_for(bench, workload, trace)
    metrics = {}
    for m in chosen:
        value = load_module("metrics", m["name"], pkg).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": device_kind(device),
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = red["busy_us"] / 1e6
        dev["window_s"] = red["window_us"] / 1e6
    out = {"correct": correct,
           "attempted": sum(rec["queries"] for rec in calls),
           "failed": sum(cell.failed(rec) for rec in calls)
           if hasattr(cell, "failed") else 0,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown(red)
    out["checks"] = checks
    return out
