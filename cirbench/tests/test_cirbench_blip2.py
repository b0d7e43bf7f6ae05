"""The BLIP-2 stage-I cell, rehearsed at tiny widths on the CPU through the
harness (the window's accounting, the comparison; ``correct`` false where
the timed path is broken; the fp8 control failing a limit), the BLIP-2
reference against the port, the counts by hand and the new readers. The
cell at its own size, and at tiny widths through the card's kernels,
needs the card (marker ``cuda``)."""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

from cirbench import harness
from cirbench.counts import blip2 as counts2
from cirbench.reference import blip as ref_blip
from cirbench.reference import blip2 as ref2
from cirbench.tests.tiny import tiny_config, tiny_traffic

ROOT = Path(__file__).resolve().parents[2]
CELL = "blip2_stage1_eval_cirr_val"
SEED = 2**31 + 91


def bench() -> dict:
    return harness.load_benchmark(ROOT)


def rehearse(workload: str, device: str = "cpu", seconds: float = 0.5
             ) -> dict:
    return harness.run_cell(bench(), ROOT, workload, SEED, seconds, False,
                            device, config_override=tiny_config,
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


def test_new_cell_rehearsal_on_the_cpu():
    out = rehearse(CELL)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"eval_queries_per_s", "setup_s"}
    spec = harness.load_json("workloads", CELL)
    assert set(out["checks"]) == set(spec["check"]["limits"])


def test_new_cell_control_fails_a_limit_at_tiny_widths():
    cell, spec = make_cell(CELL, SEED)
    cell.setup(warm=False)
    numbers = cell.control("fp8")
    limits = spec["check"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("where", ["fuse", "target_features"])
def test_blip2_answer_altered_where_produced(monkeypatch, where):
    from candidate_reranking_cir_tpu_torch.models.blip2_retrieval import (
        Blip2RetrievalModel,
    )

    honest = getattr(Blip2RetrievalModel, where)

    def altered(self, *args, **kw):
        out = honest(self, *args, **kw).clone()
        out[0] = -out[0]                 # one query or image a batch
        return out

    monkeypatch.setattr(Blip2RetrievalModel, where, altered)
    out = rehearse(CELL)
    assert out["correct"] is False, out["checks"]


def test_blip2_reference_agrees_with_the_port_on_the_cpu():
    """The reference and the port's model on the same tiny weights, in
    float32: targets and fused queries within 1e-5 (the same function in
    other orders), and the port's state dict holds every tensor the
    reference draws, under its name."""
    from cirbench.drivers import stage1_eval_blip2 as drv
    from candidate_reranking_cir_tpu_torch.models.blip2_retrieval import (
        Blip2RetrievalModel,
    )

    b = bench()
    cfg = tiny_config(harness.config_of(b, ROOT, "blip2_evag14_qformer_224"))
    w = ref_blip.make_weights(ref2.blip2_shapes(cfg), 11, "cpu")
    model = Blip2RetrievalModel(drv.port_config(cfg), device="cpu").eval()
    model.load_state_dict(w, strict=True)
    g = torch.Generator().manual_seed(4)
    images = torch.randn(3, 32, 32, 3, generator=g)
    ids = torch.tensor([[2, 7, 9, 3, 0], [2, 8, 3, 0, 0], [2, 5, 6, 7, 3]])
    mask = (ids != 0).long()
    with torch.inference_mode():
        feats, targets = model.embed_images(images, pool_and_normalize=True)
        f_q = model.fuse(feats, ids, mask)
    want_feats = ref2.vision(w, cfg["vit"], images)
    torch.testing.assert_close(feats, want_feats, rtol=0, atol=1e-4)
    torch.testing.assert_close(targets, ref2.targets(w, cfg, want_feats),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(
        f_q, ref2.fused_query(w, cfg, ids, mask, want_feats), rtol=0,
        atol=1e-5)


def test_blip2_counts_by_hand():
    cfg = harness.config_of(bench(), ROOT, "blip2_evag14_qformer_224")
    attn = 39 * 4 * 257 * 257 * 1408
    c = counts2.stage1_eval_call(cfg, 1, [15], 1)
    assert c["d88_attn_flops"] == attn
    assert c["d88_attn_bytes"] == 39 * 4 * 257 * 1408 * 2
    tower = (2 * 256 * 588 * 1408
             + 39 * (2 * 257 * (4 * 1408 ** 2 + 2 * 1408 * 6144)) + attn)
    q_only = 12 * (8 * 32 * 768 ** 2 + 4 * 32 * 32 * 768
                   + 4 * 32 * 768 * 3072) \
        + 6 * (4 * 32 * 768 ** 2 + 4 * 32 * 257 * 768)
    kv = 6 * 4 * 257 * 1408 * 768
    rows = 32 + 15
    fused = 12 * (8 * rows * 768 ** 2 + 4 * rows * rows * 768
                  + 4 * rows * 768 * 3072) \
        + 6 * (4 * 32 * 768 ** 2 + 4 * 32 * 257 * 768)
    heads = 2 * 32 * 768 * 256 + 2 * 768 * 256 + 2 * 256 * 32
    assert c["flops"] == tower + q_only + kv + fused + heads
    # a caption longer than text_len counts at text_len
    assert counts2.stage1_eval_call(cfg, 1, [60], 1)["flops"] == \
        counts2.stage1_eval_call(cfg, 1, [32], 1)["flops"]


def test_blip2_reference_truncates_as_lavis():
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "red", "dog"]
    ids, mask = ref2.encode(["red", "dog"] * 5, vocab, 6)
    assert ids.tolist() == [[2, 4, 5, 4, 5, 3]] and mask.all()


@pytest.mark.parametrize("name,run,want", [
    ("blip2.qformer_s", {"calls": [{"seconds": {"targets": 1.0,
                                                 "fusion": 2.0}},
                                   {"seconds": {"targets": 2.0,
                                                "fusion": 1.0}}]}, 3.0),
    ("blip2.qformer_s", {"calls": [{"seconds": {"fusion": 2.0}}]}, None),
    ("blip2.index_s", {"calls": [{"seconds": {"index": 4.0}}]}, 4.0),
    ("attention_roofline.blip2_d88",
     {"trace": {"kernels_us": {
         "void crc::tc::attn_fwd_tc_kernel<2, false, 88>(...)": 2e6,
         "void crc::tc::attn_fwd_tc_kernel<2, false, 64>(...)": 5e6}},
      "work": {"d88_attn_flops": 989e12, "d88_attn_bytes": 0.0}}, 50.0),
    ("attention_roofline.blip2_d88",
     {"trace": {"kernels_us": {
         "void crc::tc::attn_fwd_tc_kernel<2, false, 64>(...)": 5e6}},
      "work": {"d88_attn_flops": 989e12, "d88_attn_bytes": 0.0}}, None),
])
def test_new_readers(name, run, want):
    got = harness.load_module("metrics", name).read(run)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.cuda
def test_blip2_cell_at_tiny_widths_on_the_card():
    """The driver's cell through the card's kernels at tiny widths: correct
    against the reference, and the fp8 control fails a limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = rehearse(CELL, "cuda")
    assert out["correct"] is True, out["checks"]
    cell, spec = make_cell(CELL, SEED, "cuda")
    cell.setup(warm=False)
    numbers = cell.control("fp8")
    limits = spec["check"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.cuda
def test_new_cell_control_fails_a_limit_at_the_cells_size():
    """On the card, three seeds: the fp8 reference in the program's place
    reads above a limit on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (101, 202, 303):
        cell, spec = make_cell(CELL, seed, "cuda", tiny=False)
        cell.setup(warm=False)
        numbers = cell.control("fp8")
        limits = spec["check"]["limits"]
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers)
        del cell
        torch.cuda.empty_cache()
