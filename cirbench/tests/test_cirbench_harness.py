"""The harness finds what a later change adds as files, the trace reduces
as stated, and the command refuses to run without a card."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from cirbench import harness

ROOT = Path(__file__).resolve().parents[2]

DRIVER = '''
class Cell:
    kernels_per_launch = 1

    def __init__(self, cfg, traffic, engine, seed, device):
        self.n = traffic["items"] * engine["repeat"] + cfg["width"]

    def setup(self):
        pass

    def call(self):
        return {"queries": self.n, "seconds": {"step": 0.001}}

    def outputs(self, rec):
        return rec["queries"]

    def work(self):
        return {"flops": 1.0}

    def release(self):
        pass

    def check(self, outputs):
        return {"items_off": float(max(outputs) - self.n)}
'''

METRIC = '''
def read(run):
    return sum(c["seconds"]["step"] for c in run["calls"]) / len(run["calls"])
'''


def dropped_in(tmp_path: Path) -> tuple[dict, Path]:
    """A new cell, configuration, traffic mix, driver and per-layer metric,
    each added as a file, and the entries that name them."""
    pkg = tmp_path / "bench"
    for kind in ("workloads", "traffic", "configs", "drivers", "metrics"):
        (pkg / kind).mkdir(parents=True)
    (pkg / "configs" / "toy_cfg.json").write_text(json.dumps({"width": 3}))
    (pkg / "traffic" / "toy_mix.json").write_text(json.dumps({"items": 4}))
    (pkg / "workloads" / "toy_cell.json").write_text(json.dumps({
        "driver": "toy_driver", "engine": {"repeat": 2},
        "check": {"limits": {"items_off": 0.0}}}))
    (pkg / "drivers" / "toy_driver.py").write_text(textwrap.dedent(DRIVER))
    (pkg / "metrics" / "toy.step_s.py").write_text(textwrap.dedent(METRIC))
    (pkg / "metrics" / "setup_s.py").write_text(
        (harness.PKG / "metrics" / "setup_s.py").read_text())
    (pkg / "metrics" / "eval_queries_per_s.py").write_text(
        (harness.PKG / "metrics" / "eval_queries_per_s.py").read_text())
    bench = {
        "configs": [{"name": "toy_cfg", "file": "bench/configs/toy_cfg.json"}],
        "workloads": [{"name": "toy_cell", "config": "toy_cfg",
                       "traffic": "toy_mix", "chips": 1}],
        "end_to_end": [
            {"name": "eval_queries_per_s", "unit": "queries/s",
             "workloads": ["toy_cell"]},
            {"name": "setup_s", "unit": "s"},
            {"name": "other_rate", "unit": "x/s", "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "toy.step_s", "unit": "s",
                       "workloads": ["toy_cell"]}]}
    return bench, pkg


def test_new_files_are_found_by_name(tmp_path):
    bench, pkg = dropped_in(tmp_path)
    assert {m["name"] for m in harness.metrics_for(bench, "toy_cell",
                                                   False)} == \
        {"eval_queries_per_s", "setup_s"}
    assert [m["name"] for m in harness.metrics_for(bench, "toy_cell",
                                                   True)] == ["toy.step_s"]
    out = harness.run_cell(bench, tmp_path, "toy_cell", 7, 0.05, False,
                           "cpu", pkg=pkg)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["attempted"] % 11 == 0
    assert set(out["metrics"]) == {"eval_queries_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["checks"] == {"items_off": {"value": 0.0, "limit": 0.0}}
    reader = harness.load_module("metrics", "toy.step_s", pkg)
    assert reader.read({"calls": [{"seconds": {"step": 2.0}}]}) == 2.0


def test_unknown_names_are_refused(tmp_path):
    bench, pkg = dropped_in(tmp_path)
    with pytest.raises(harness.BenchmarkError):
        harness.cell_entry(bench, "no_such_cell")
    with pytest.raises(harness.BenchmarkError):
        harness.load_module("drivers", "no_such_driver", pkg)
    with pytest.raises(harness.BenchmarkError):
        harness.load_json("traffic", "no_such_mix", pkg)


def test_forbidden_modules_by_whole_top_level_name():
    names = ["candidate_reranking_cir_tpu_torch.ops", "jaxtyping", "numpy",
             "flax.linen", "candidate_reranking_cir_tpu.models"]
    assert harness.forbidden_loaded(names) == [
        "candidate_reranking_cir_tpu", "flax"]
    assert harness.forbidden_loaded(["jax", "jaxlib.xla"]) == ["jax",
                                                               "jaxlib"]


def test_reduce_trace_families_busy_and_gaps():
    dev = [("attn_fwd_tc_kernel<4, false>", 10.0, 20.0),
           ("sm90_xmma_gemm_bf16", 15.0, 30.0),      # overlaps the first
           ("vectorized_elementwise_kernel", 50.0, 60.0),
           ("Memcpy HtoD (Pageable -> Device)", 70.0, 75.0)]
    host = [("aten::copy_", 30.0, 55.0), ("cudaStreamSynchronize", 60.0,
                                          100.0)]
    red = harness.reduce_trace(dev, host, 0.0, 100.0)
    assert red["busy_us"] == 20.0 + 10.0 + 5.0
    assert red["window_us"] == 100.0
    assert red["attention_kernels"] == 1
    assert red["families_us"] == {"attention": 10.0, "gemm": 15.0,
                                  "elementwise": 10.0, "copies": 5.0}
    # gaps: [0,10] before any host op, [30,50] in copy_, [60,70] and
    # [75,100] in the sync
    assert red["idle_us"] == {"host idle": 10.0, "aten::copy_": 20.0,
                              "cudaStreamSynchronize": 35.0}
    bd = harness.breakdown(red)
    assert bd["device_ops"][0] == ["sm90_xmma_gemm_bf16", 15e-6]
    assert bd["idle_gaps"][0] == ["cudaStreamSynchronize", 35e-6]


def test_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "cirbench.run", "--workload",
         "rerank_cirr_val_quarter", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    if proc.returncode == 0:
        pytest.skip("a card is present")
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_command_fails_without_the_program(tmp_path):
    """In a directory of BENCHMARK.json and cirbench/ alone: no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cirbench", tmp_path / "cirbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = subprocess.run(
        [sys.executable, "-m", "cirbench.run", "--workload",
         "stage1_eval_cirr_val", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
