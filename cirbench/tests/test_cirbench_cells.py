"""Each cell rehearsed at tiny widths on the CPU through the harness (set-up,
warm-up, the window's accounting, the comparison), the same with the timed
path broken underneath (``correct`` must come out false), and the control:
the reference one precision lower in the program's place must fail a
limit. The cells at their own size need the card (marker ``cuda``)."""
from __future__ import annotations

import copy
from pathlib import Path

import pytest
import torch

from cirbench import harness
from cirbench.tests.tiny import tiny_config, tiny_traffic

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["rerank_cirr_val_quarter", "stage1_eval_cirr_val",
         "serve_cirr_open_0p8"]
E2E = {"rerank_cirr_val_quarter": "eval_queries_per_s",
       "stage1_eval_cirr_val": "eval_queries_per_s",
       "serve_cirr_open_0p8": "serve_p50_ms"}
SEED = 2**31 + 77


def bench() -> dict:
    return harness.load_benchmark(ROOT)


def rehearse(workload: str, seconds: float = 0.5) -> dict:
    return harness.run_cell(bench(), ROOT, workload, SEED, seconds, False,
                            "cpu", config_override=tiny_config,
                            traffic_override=tiny_traffic)


def make_cell(workload: str, seed: int, device: str = "cpu",
              tiny: bool = True):
    b = bench()
    entry = harness.cell_entry(b, workload)
    spec = harness.load_json("workloads", workload)
    cfg = harness.config_of(b, ROOT, entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    if tiny:
        cfg, traffic = tiny_config(cfg), tiny_traffic(traffic)
    driver = harness.load_module("drivers", spec["driver"])
    return driver.Cell(cfg, traffic, spec["engine"], seed, device), spec


@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearsal_on_the_cpu(workload):
    out = rehearse(workload)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {E2E[workload], "setup_s"}
    assert out["device"]["platform"] == "cpu"
    spec = harness.load_json("workloads", workload)
    assert set(out["checks"]) == set(spec["check"]["limits"])
    assert list(out)[-1] == "checks"


def test_rerank_answer_altered_where_produced(monkeypatch):
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )

    honest = RerankerModel._cls_scores

    def altered(self, cls_pair):
        out = honest(self, cls_pair).clone()
        out.view(-1)[0] += 3.0               # one pair's logit a call
        return out

    monkeypatch.setattr(RerankerModel, "_cls_scores", altered)
    out = rehearse("rerank_cirr_val_quarter")
    assert out["correct"] is False, out["checks"]


def test_stage1_answer_altered_where_produced(monkeypatch):
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    honest = RetrievalModel.fuse

    def altered(self, *args, **kw):
        out = honest(self, *args, **kw)
        if kw.get("return_raw"):
            return out
        out = out.clone()
        out[0] = -out[0]                     # one query a fusion batch
        return out

    monkeypatch.setattr(RetrievalModel, "fuse", altered)
    out = rehearse("stage1_eval_cirr_val")
    assert out["correct"] is False, out["checks"]


def test_stage1_pooled_feature_altered_where_produced(monkeypatch):
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    honest = RetrievalModel.pool_image_features

    def altered(self, feats):
        out = honest(self, feats).clone()
        out[0] = out[-1]                     # one image a batch
        return out

    monkeypatch.setattr(RetrievalModel, "pool_image_features", altered)
    out = rehearse("stage1_eval_cirr_val")
    assert out["correct"] is False, out["checks"]


def test_served_answer_altered_where_produced(monkeypatch):
    from candidate_reranking_cir_tpu_torch.runtime.serve import (
        CIRServingEngine,
    )

    honest = CIRServingEngine._rerank_wave

    def altered(self, requests, results):
        honest(self, requests, results)
        results[0].scores[0] += 3.0          # one answer a wave

    monkeypatch.setattr(CIRServingEngine, "_rerank_wave", altered)
    out = rehearse("serve_cirr_open_0p8")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit_at_tiny_widths(workload):
    cell, spec = make_cell(workload, SEED)
    cell.setup(warm=False)
    numbers = cell.control("fp8")
    if hasattr(cell, "window"):
        cell.release()
    limits = spec["check"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit_at_the_cells_size(workload):
    """On the card, three seeds: the fp8 reference in the program's place
    reads above a limit on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (101, 202, 303):
        cell, spec = make_cell(workload, seed, "cuda", tiny=False)
        cell.setup(warm=False)
        numbers = cell.control("fp8")
        if hasattr(cell, "window"):
            cell.release()
        limits = spec["check"]["limits"]
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers)
        del cell
        torch.cuda.empty_cache()


def test_tiny_config_keeps_every_key():
    b = bench()
    for c in b["configs"]:
        cfg = harness.config_of(b, ROOT, c["name"])
        small = tiny_config(copy.deepcopy(cfg))
        assert set(small) == set(cfg)
        assert set(small["vit"]) == set(cfg["vit"])
        assert set(small["text"]) == set(cfg["text"])
