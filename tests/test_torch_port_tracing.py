"""The port's tracing facility (``runtime/tracing.py``) and the spans and
counters the eval engines and the server keep with it, on the CPU at tiny
shapes: ranges only while tracing is on and only for phases, phase ranges
that never nest in the three timed paths, the buffer on the profiler's
clock and in the Chrome trace under its thread, the batcher's counters
against what a caller sees, and the phase totals inside their layers."""
from __future__ import annotations

import json
import statistics
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from candidate_reranking_cir_tpu_torch.runtime import tracing
from candidate_reranking_cir_tpu_torch.runtime.serve import (
    CIRServingEngine,
    MicroBatcher,
    ServeRequest,
    ServeResult,
    build_serving_index,
)
from cirbench import harness, system
from cirbench.tests.tiny import tiny_config, tiny_traffic
from cirbench.traffic import cirr

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 91


@pytest.fixture(autouse=True)
def fresh_buffer():
    tracing.disable()
    tracing.clear_events()
    yield
    tracing.disable()
    tracing.clear_events()


def tiny_cell(workload: str):
    bench = harness.load_benchmark(ROOT)
    entry = harness.cell_entry(bench, workload)
    spec = harness.load_json("workloads", workload)
    cfg = tiny_config(harness.config_of(bench, ROOT, entry["config"]))
    traffic = tiny_traffic(harness.load_json("traffic", entry["traffic"]))
    driver = harness.load_module("drivers", spec["driver"])
    cell = driver.Cell(cfg, traffic, spec["engine"], SEED, "cpu")
    cell.setup(warm=False)
    return cell


@pytest.fixture(scope="module")
def serving():
    """A tiny serving engine with the re-ranker over 40 images, and
    requests that name corpus references."""
    bench = harness.load_benchmark(ROOT)
    entry = harness.cell_entry(bench, "serve_cirr_open_0p8")
    cfg = tiny_config(harness.config_of(bench, ROOT, entry["config"]))
    s1, _ = system.build_stage1(cfg, SEED, "cpu")
    s2, _ = system.build_reranker(cfg, SEED, "cpu")
    corpus = cirr.Corpus(cirr.make_images(40, cfg["vit"]["image_size"],
                                          SEED, "cpu"))
    index = build_serving_index(s1, None, corpus, reranker=s2,
                                batch_size=16, device="cpu")
    engine = CIRServingEngine(s1, None, system.tokenizer(), index,
                              text_len=cfg["text_len"], q_pad=4,
                              reranker=s2, rerank_k=10, device="cpu")
    words = cirr.caption_words(cirr.load_vocab())
    reqs = [ServeRequest(caption=" ".join(words[i:i + 6 + i % 5]),
                         reference=corpus.index_names[3 * i], k=10)
            for i in range(6)]
    return engine, reqs


def phase_names() -> set[str]:
    return {e[0] for e in tracing.events() if e[6] == "phase"}


def profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the kineto events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.profiler.kineto_results.events())


def assert_ranges_do_not_nest(events, names: set[str]) -> int:
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in events if e.name() in names)
    for (s0, e0, n0), (s1, _, n1) in zip(ranges, ranges[1:]):
        assert s1 >= e0, f"{n1} starts inside {n0}"
    return len(ranges)


def assert_phases_inside_layers(events) -> None:
    """Every buffered phase lies inside an instance of its layer, on its
    thread, and the phases of one layer instance add up to no more than
    it."""
    layers = [e for e in events if e[6] == "layer"]
    inside: dict[int, int] = {}
    for name, tid, s, e, parent, _, level in events:
        if level != "phase" or parent is None:
            continue
        owners = [i for i, lay in enumerate(layers)
                  if lay[0] == parent and lay[1] == tid
                  and lay[2] <= s and e <= lay[3]]
        assert owners, f"{name} lies outside every {parent}"
        inside[owners[-1]] = inside.get(owners[-1], 0) + (e - s)
    for i, total in inside.items():
        assert total <= layers[i][3] - layers[i][2], layers[i][0]


def test_spans_enter_ranges_only_while_tracing_is_on(monkeypatch):
    entered = []
    real = tracing._RANGE

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "_RANGE", spy)
    totals = {}
    with tracing.collect(totals):
        with tracing.layer_span("lay"):
            with tracing.trace_phase("lay.phase"):
                pass
    assert entered == [] and tracing.events() == []
    assert set(totals) == {"lay", "lay.phase"}
    assert 0.0 <= totals["lay.phase"] <= totals["lay"]

    tracing.enable()
    with tracing.collect(totals):
        with tracing.layer_span("lay"):
            with tracing.trace_phase("lay.phase"):
                pass
    assert entered == ["lay.phase"]    # layers take no range
    assert [(e[0], e[4], e[6]) for e in tracing.events()] == [
        ("lay.phase", "lay", "phase"), ("lay", None, "layer")]
    tracing.disable()

    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()       # a profiler turns tracing on
        with tracing.trace_phase("under.profiler"):
            pass
    assert not tracing.enabled()
    assert entered == ["lay.phase", "under.profiler"]


def test_a_span_and_its_range_share_the_profiler_clock():
    """Entered together, a span's buffered start and end sit within 2 ms
    of its range's in the profiler's events (the median of five, so that
    one preemption of the test's thread between the two reads does not
    decide it)."""
    def run():
        for _ in range(5):
            with tracing.trace_phase("clock.phase"):
                torch.ones(32, 32) @ torch.ones(32, 32)

    _, events = profiled(run)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.name() == "clock.phase")
    spans = [e[2:4] for e in tracing.events() if e[0] == "clock.phase"]
    assert len(ranges) == len(spans) == 5
    starts = [abs(r[0] - s[0]) for r, s in zip(ranges, spans)]
    ends = [abs(r[1] - s[1]) for r, s in zip(ranges, spans)]
    assert statistics.median(starts) < 2e6 and statistics.median(ends) < 2e6


def test_stop_trace_writes_a_worker_threads_spans_under_its_tid(tmp_path):
    go, done, tid = threading.Event(), threading.Event(), []

    def worker():                     # started before the profiler
        tid.append(threading.get_native_id())
        go.wait(10)
        with tracing.collect(), tracing.layer_span("worker.layer"):
            with tracing.trace_phase("worker.phase"):
                torch.ones(16).sum()
        done.set()

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    tracing.start_trace(str(tmp_path / "trace"))
    try:
        go.set()
        assert done.wait(10)
    finally:
        path = tracing.stop_trace()
    th.join(10)
    assert not th.is_alive()
    trace = json.loads(Path(path).read_text())
    mine = {e["name"]: e for e in trace["traceEvents"]
            if e.get("cat") == "program_span" and e.get("tid") == tid[0]}
    assert set(mine) == {"worker.layer", "worker.phase"}
    layer, phase = mine["worker.layer"], mine["worker.phase"]
    assert layer["ts"] <= phase["ts"]
    assert phase["ts"] + phase["dur"] <= layer["ts"] + layer["dur"] + 1e-3
    assert phase["args"]["layer"] == "worker.layer"


@pytest.mark.parametrize("workload", ["rerank_cirr_val_quarter",
                                      "stage1_eval_cirr_val"])
def test_eval_phases_never_nest_and_sit_inside_their_layers(workload):
    cell = tiny_cell(workload)
    rec, events = profiled(cell.call)
    names = phase_names()
    assert assert_ranges_do_not_nest(events, names) > 0
    assert_phases_inside_layers(tracing.events())
    sec = rec["seconds"]
    assert sec["index.load"] + sec["index.upload"] + sec["index.wait"] \
        <= sec["index"]
    if workload.startswith("rerank"):
        assert names == {"index.load", "index.upload", "index.wait",
                         "rerank.labels", "rerank.prep", "rerank.zt.wait",
                         "rerank.plan", "rerank.score.wait", "rerank.finish",
                         "rerank.metrics"}
        assert sec["rerank.zt.wait"] <= sec["zt"]
        assert sec["rerank.plan"] + sec["rerank.score.wait"] <= sec["score"]
        layers = sec["index"] + sec["zt"] + sec["score"]
    else:
        assert names == {"stage1.labels", "index.load", "index.upload",
                         "index.wait", "fusion.plan", "fusion.wait",
                         "ranking.plan", "ranking.wait", "stage1.metrics"}
        assert sec["fusion.plan"] + sec["fusion.wait"] <= sec["fusion"]
        assert sec["ranking.plan"] + sec["ranking.wait"] <= sec["ranking"]
        layers = sec["index"] + sec["fusion"] + sec["ranking"]
    outside = sum(v for k, v in sec.items() if k.split(".")[0] in
                  ("rerank", "stage1") and k not in ("rerank.zt.wait",
                                                     "rerank.plan",
                                                     "rerank.score.wait"))
    assert layers + outside <= sec["total"]
    cell.release()


def test_serving_wave_phases_never_nest(serving):
    engine, reqs = serving
    _, events = profiled(lambda: engine.handle(reqs[:4]))
    names = phase_names()
    assert names == {"serve.tokenize", "serve.stage1.wait", "serve.assemble",
                     "serve.rerank.plan", "serve.rerank.wait",
                     "serve.rerank.finish", "serve.merge"}
    assert assert_ranges_do_not_nest(events, names) >= len(names)

    tracing.enable()
    batcher = MicroBatcher(engine, window_ms=2.0)
    try:
        out = [None] * len(reqs)
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, batcher.submit(reqs[i])))
            for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert all(isinstance(r, ServeResult) for r in out)
    finally:
        batcher.close()
    assert not batcher.worker.is_alive()
    worker = batcher.worker.native_id
    spans = [e for e in tracing.events() if e[1] == worker]
    phases = sorted((e[2], e[3], e[0]) for e in spans if e[6] == "phase")
    for (s0, e0, n0), (s1, _, n1) in zip(phases, phases[1:]):
        assert s1 >= e0, f"{n1} starts inside {n0}"
    assert {"batcher.idle", "batcher.gather", "serve.rerank.wait"} <= \
        {p[2] for p in phases}
    assert_phases_inside_layers(spans)
    stats = batcher.stats()
    assert stats["requests"] == len(reqs)
    assert 0.0 < stats["device_wait_s"] < stats["wave_s"]


class SleepyEngine:
    """Waves that sleep: ``work`` s in all, ``wait`` s of it in a
    ``serve.*.wait`` span; ``waves`` logs (requests, seconds) of each."""
    q_pad = 4

    def __init__(self, work: float, wait: float):
        self.work, self.wait = work, wait
        self.waves: list[tuple[int, float]] = []
        self.started = threading.Event()

    def handle(self, reqs):
        t0 = time.perf_counter()
        work = self.work
        self.started.set()
        time.sleep(work - self.wait)
        with tracing.trace_phase("serve.stub.wait"):
            time.sleep(self.wait)
        self.waves.append((len(reqs), time.perf_counter() - t0))
        return [ServeResult(ranking=[r.caption], scores=[0.0]) for r in reqs]


def test_batcher_counters_add_up_to_what_a_caller_sees():
    """A request's latency is its queue wait (here the 5 ms straggler
    window at least) plus its wave's time and the caller's wake-up, which
    the host's scheduler sets (several ms on a loaded machine): so every
    excess is >= 0 and the median excess, not each, is held under 1 ms;
    a missing queue wait or wave would show as 5 or 20 ms."""
    engine = SleepyEngine(work=0.02, wait=0.005)
    batcher = MicroBatcher(engine, window_ms=5.0)
    try:
        time.sleep(0.45)
        s0 = batcher.stats()
        assert s0["idle_s"] >= 0.2 and s0["waves"] == 0
        # a first wave outside the comparison: it pays the worker's and the
        # caller's first pass through each code path
        batcher.submit(ServeRequest(caption="warm", reference="x"))
        gaps = []
        for i in range(9):             # one request a wave
            before = batcher.stats()
            t0 = time.perf_counter()
            batcher.submit(ServeRequest(caption=f"q{i}", reference="x"))
            lat = time.perf_counter() - t0
            after = batcher.stats()
            assert after["waves"] - before["waves"] == 1
            queued = after["queue_wait_s"] - before["queue_wait_s"]
            wave = after["wave_s"] - before["wave_s"]
            assert queued >= batcher.window and wave >= engine.work
            waited = after["device_wait_s"] - before["device_wait_s"]
            assert engine.wait <= waited < wave
            gaps.append(lat - queued - wave)
        assert min(gaps) >= 0.0 and statistics.median(gaps) < 1e-3, gaps

        # three queued behind a slow wave share the next: each waits out
        # the slow wave, then takes its wave's time
        lats = [0.0] * 4

        def call(i):
            t0 = time.perf_counter()
            batcher.submit(ServeRequest(caption=f"w{i}", reference="x"))
            lats[i] = time.perf_counter() - t0

        before = batcher.stats()
        engine.waves.clear()
        engine.started.clear()
        engine.work = 0.2
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        threads[0].start()
        assert engine.started.wait(10)
        engine.work = 0.02
        for th in threads[1:]:
            th.start()
        for th in threads:
            th.join(10)
        after = batcher.stats()
        assert [n for n, _ in engine.waves] == [1, 3]
        assert after["wave_s"] - before["wave_s"] >= \
            sum(d for _, d in engine.waves)
        queued = after["queue_wait_s"] - before["queue_wait_s"]
        assert queued > 3 * 0.1
        # the excess is four callers' wake-ups; an accounting fault would
        # miss the slow wave (0.2 s) in each of three queue waits
        gap = sum(lats) - queued - sum(n * d for n, d in engine.waves)
        assert 0.0 <= gap < 0.1, gap
    finally:
        batcher.close()
    assert not batcher.worker.is_alive()
