"""The port's tracing facility (the JAX package's ``runtime/tracing.py``
API, grown into the spans the eval engines and the server keep).

Two levels of span, both context managers:

- a *layer span* (``layer_span``) times one layer of a path: the eval
  engines' ``seconds`` keys ('index', 'zt', 'score', 'fusion', 'ranking',
  'total', ...) and the server's wave ('serve.wave');
- a *phase span* (``trace_phase``) times one stretch of host work inside
  a layer that launches no kernel (planning, tokenizing, assembling) or
  that blocks on the device (named ``*.wait``). Phase spans never nest in
  one another.

Always, every span adds its host duration (``time.perf_counter_ns``) to
the innermost totals dict that ``collect`` opened on its thread, under the
span's name, in seconds: a clock read each side and a dict add, with no
device sync and nothing recorded.

While tracing is on (a ``torch.profiler`` runs in the process, or
``enable()`` was called), each phase span also enters a profiler range of
its name; layer spans take no range, so the program's ranges never
enclose each other and an idle gap in a trace takes the name of the phase
over it. The range is a function-scope ``record_function``
(``_RecordFunctionFast``, a host event like an aten op's): a user-scope
one (``torch.profiler.record_function``) also gets a copy on the device's
timeline over the work it launched, which a trace's reader would count
as device time a second time. Every span, of either level and on
any thread, is also appended to a bounded buffer (name, thread, start and
end on ``time.time_ns``'s clock, which the profiler's host events share,
the enclosing layer, and the number of its ``collect`` call).
``stop_trace`` writes the buffer's spans into the Chrome trace as complete
events on their threads' ids: the profiler records no range on a thread
started before it (the server's batcher worker), so this is how such a
thread's spans reach a trace.

``PhaseTimer`` keeps the JAX package's console summary of host
wall-clock per phase.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch
from torch.autograd import profiler as _autograd_profiler

BUFFER_EVENTS = 1 << 18    # the most spans the buffer holds (oldest go)
_RANGE = torch._C._profiler._RecordFunctionFast

_PROFILE: dict = {}  # the running start_trace's profiler and directory
_EVENTS: deque = deque(maxlen=BUFFER_EVENTS)
_CALLS = itertools.count(1)
_enabled = False


class _Local(threading.local):
    def __init__(self):
        self.collectors: list[dict] = []   # open totals, innermost last
        self.calls: list[int] = []         # their collect call numbers
        self.layers: list[str] = []        # open layer spans, innermost last


_local = _Local()


def enable() -> None:
    """Trace without a profiler: phase ranges and the span buffer."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    """Whether spans enter ranges and fill the buffer: ``enable()`` was
    called, or a ``torch.profiler`` runs (a flag every thread sees)."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def events() -> list[tuple]:
    """The buffered spans: (name, native thread id, start ns, end ns,
    enclosing layer or None, collect call number or 0, 'layer' or
    'phase'), oldest first."""
    return list(_EVENTS)


def clear_events() -> None:
    _EVENTS.clear()


@contextlib.contextmanager
def collect(totals: dict | None = None):
    """Spans on this thread add their seconds to ``totals`` (a new dict
    by default, yielded) until the block ends; an inner ``collect`` takes
    them over while it is open."""
    totals = {} if totals is None else totals
    local = _local
    local.collectors.append(totals)
    local.calls.append(next(_CALLS))
    try:
        yield totals
    finally:
        local.collectors.pop()
        local.calls.pop()


class _Span:
    __slots__ = ("name", "phase", "t0", "wall0", "parent", "call", "range")

    def __init__(self, name: str, phase: bool):
        self.name = name
        self.phase = phase
        self.wall0 = 0

    def __enter__(self):
        local = _local
        if _enabled or _autograd_profiler._is_profiler_enabled:
            self.parent = local.layers[-1] if local.layers else None
            self.call = local.calls[-1] if local.calls else 0
            self.range = None
            if self.phase:
                self.range = _RANGE(self.name)
                self.range.__enter__()
            self.wall0 = time.time_ns()
        if not self.phase:
            local.layers.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        local = _local
        if not self.phase:
            local.layers.pop()
        if local.collectors:
            totals = local.collectors[-1]
            totals[self.name] = totals.get(self.name, 0.0) + dt * 1e-9
        if self.wall0:
            end = time.time_ns()
            if self.range is not None:
                self.range.__exit__(None, None, None)
            _EVENTS.append((self.name, threading.get_native_id(), self.wall0,
                            end, self.parent, self.call,
                            "phase" if self.phase else "layer"))
        return False


def layer_span(name: str) -> _Span:
    """A layer span: its seconds under ``name`` in the innermost totals;
    buffered while tracing is on, never a profiler range."""
    return _Span(name, False)


def trace_phase(name: str) -> _Span:
    """A phase span: its seconds under ``name`` in the innermost totals;
    while tracing is on, a profiler range of that name too (the phase's
    span in a trace), and buffered."""
    return _Span(name, True)


def start_trace(log_dir: str):
    """Start a profiler over the CPU and, where a card is present, CUDA
    activities, and empty the span buffer; ``stop_trace`` writes its
    Chrome trace under ``log_dir``."""
    if _PROFILE:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    _EVENTS.clear()
    prof.start()
    _PROFILE.update(prof=prof, log_dir=log_dir)


def _add_spans(path: str, spans: list[tuple]) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events
    (category 'program_span') on their threads' ids, at the trace's own
    time base."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid,
         "tid": tid, "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
         "args": {"level": level, "layer": parent, "call": call}}
        for name, tid, t0, t1, parent, call, level in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


def stop_trace() -> str:
    """Stop the running trace; returns the path of the Chrome trace it
    wrote (``<log_dir>/trace_<pid>_<ns>.json``), which holds every span
    buffered since ``start_trace``."""
    if not _PROFILE:
        raise RuntimeError("no trace is running")
    prof, log_dir = _PROFILE.pop("prof"), _PROFILE.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, list(_EVENTS))
    return path


class PhaseTimer:
    """Accumulates host wall-clock per phase; print with ``summary()``.
    Each phase is a ``trace_phase`` span. The host clock does not wait for
    the device, as JAX's does not."""

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
