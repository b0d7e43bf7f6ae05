"""Profiling and tracing hooks (port of the JAX package's
``runtime/tracing.py``): ``torch.profiler`` annotations around the hot
phases, so that a Chrome/Perfetto trace attributes device time to the
stages of a pipeline, and a light host wall-clock phase timer for console
summaries. Like the JAX package's, these are library functions: no path
of the package calls them.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_PROFILE: dict = {}  # the running start_trace's profiler and directory


@contextlib.contextmanager
def trace_phase(name: str):
    """A named ``torch.profiler.record_function`` range: the phase's span
    in a trace (host and, under ``start_trace``, the device work it
    launches)."""
    with torch.profiler.record_function(name):
        yield


def start_trace(log_dir: str):
    """Start a profiler over the CPU and, where a card is present, CUDA
    activities; ``stop_trace`` writes its Chrome trace under
    ``log_dir``."""
    if _PROFILE:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILE.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the running trace; returns the path of the Chrome trace it
    wrote (``<log_dir>/trace_<pid>_<ns>.json``)."""
    if not _PROFILE:
        raise RuntimeError("no trace is running")
    prof, log_dir = _PROFILE.pop("prof"), _PROFILE.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


class PhaseTimer:
    """Accumulates host wall-clock per phase; print with ``summary()``.
    The host clock does not wait for the device, as JAX's does not."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with trace_phase(name):
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:32s} {t:8.2f}s total {t / n * 1e3:8.1f}ms/it"
                         f" x{n}")
        return "\n".join(lines)
