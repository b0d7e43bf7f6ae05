"""The readers of the per-layer metrics that read the program's phase spans
and the micro-batcher's counters, on hand-built run records: what each
reads, and nothing (no error) from a program that keeps neither."""
from __future__ import annotations

import pytest

from cirbench import harness


def reader(name: str):
    return harness.load_module("metrics", name).read


def serve_run(stats0: dict, stats1: dict, wall: float = 30.0) -> dict:
    return {"calls": [{"wall": wall, "records": [], "stats0": stats0,
                       "stats1": stats1}]}


OLD = {"requests": 10, "waves": 4, "errors": 0}
NEW = {"requests": 490, "waves": 184, "errors": 0}
COUNTERS0 = {"queue_wait_s": 1.0, "wave_s": 0.5, "device_wait_s": 0.2,
             "idle_s": 3.0}
COUNTERS1 = {"queue_wait_s": 49.0, "wave_s": 27.5, "device_wait_s": 18.2,
             "idle_s": 6.0}


def test_serving_counters_per_request_per_wave_and_per_second():
    run = serve_run({**OLD, **COUNTERS0}, {**NEW, **COUNTERS1})
    # 480 requests and 180 waves in the window
    assert reader("serve.queue_wait_ms")(run) == pytest.approx(100.0)
    assert reader("serve.wave_ms")(run) == pytest.approx(150.0)
    assert reader("serve.wave_host_ms")(run) == pytest.approx(50.0)
    assert reader("serve.worker_idle")(run) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["serve.queue_wait_ms", "serve.wave_ms",
                                  "serve.wave_host_ms", "serve.worker_idle"])
def test_serving_readers_find_nothing_without_the_counters(name):
    assert reader(name)(serve_run(OLD, NEW)) is None
    assert reader(name)({"calls": [{"wall": 1.0, "seconds": {}}]}) is None
    idle = serve_run({**OLD, **COUNTERS0}, {**OLD, **COUNTERS0})
    if name == "serve.worker_idle":
        assert reader(name)(idle) == 0.0
    else:                              # no request or wave in the window
        assert reader(name)(idle) is None


@pytest.mark.parametrize("name, seconds, want", [
    ("rerank.plan_s", [{"rerank.plan": 0.2}, {"rerank.plan": 0.4}], 0.3),
    ("stage1.staging_s", [{"index.load": 0.5, "index.upload": 0.7},
                          {"index.load": 0.3, "index.upload": 0.5}], 1.0),
    ("stage1.fusion_plan_s", [{"fusion.plan": 0.1},
                              {"fusion.plan": 0.2}], 0.15),
])
def test_span_readers_average_over_the_calls(name, seconds, want):
    run = {"calls": [{"seconds": {"index": 6.0, "total": 8.0, **s}}
                     for s in seconds]}
    assert reader(name)(run) == pytest.approx(want)
    old = {"calls": [{"seconds": {"index": 6.0, "zt": 1.0, "score": 9.0,
                                  "fusion": 1.2, "total": 8.0}}]}
    assert reader(name)(old) is None
    assert reader(name)({"calls": []}) is None
