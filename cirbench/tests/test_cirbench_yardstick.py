"""The yardstick: the generators repeat for a seed and differ across
seeds, the analytic counts equal hand-worked values, the plain reference
agrees with the port's CPU path at tiny widths, and nothing under
``cirbench/`` imports JAX or the JAX package (nor, under
``cirbench/reference/``, the port)."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cirbench import compare, harness, system
from cirbench.counts import blip as counts
from cirbench.counts import kernels
from cirbench.reference import blip as ref
from cirbench.reference import text as ref_text
from cirbench.tests.tiny import tiny_config
from cirbench.traffic import cirr

PKG = harness.PKG
ROOT = PKG.parent
BIG_SEED = 2**31 + 12345


def config(name: str) -> dict:
    bench = harness.load_benchmark(ROOT)
    return harness.config_of(bench, ROOT, name)


# -- generators ------------------------------------------------------------

@pytest.mark.parametrize("traffic", ["cirr_val_quarter_top50", "cirr_val"])
def test_queries_repeat_for_a_seed_and_differ_across_seeds(traffic):
    params = harness.load_json("traffic", traffic)
    params = {**params, "images": 60, "queries": 40,
              **({"top_k": 20} if "top_k" in params else {})}
    names = [f"img{i}" for i in range(60)]
    words = cirr.caption_words(cirr.load_vocab())
    a = cirr.make_queries(params, names, BIG_SEED, words)
    b = cirr.make_queries(params, names, BIG_SEED, words)
    c = cirr.make_queries(params, names, BIG_SEED + 1, words)
    assert (a.group == b.group).all() and a.words == b.words
    assert a.topk is None or (a.topk == b.topk).all()
    assert not (a.group == c.group).all() and a.words != c.words
    # CIRR's shapes: distinct group members, the reference first, the
    # target second; a top-K never holds the reference
    assert all(len(set(g)) == len(g) for g in a.group)
    assert (a.ref == a.group[:, 0]).all()
    if a.topk is not None:
        assert not (a.topk == a.ref[:, None]).any()
        assert all(len(set(t)) == len(t) for t in a.topk)
    lengths = a.lengths
    assert lengths.min() >= 5 and lengths.max() <= 40


def test_images_weights_and_samples_repeat_and_differ():
    im = [cirr.make_images(3, 32, s, "cpu") for s in (BIG_SEED, BIG_SEED,
                                                      BIG_SEED + 1)]
    assert im[0].shape == (3, 32, 32, 3) and im[0].dtype == np.float32
    assert (im[0] == im[1]).all() and not (im[0] == im[2]).all()
    shapes = ref.stage1_shapes(tiny_config(config(
        "blip_retrieval_vitb16_384")))
    w = [ref.make_weights(shapes, s, "cpu") for s in (5, 5, 6)]
    assert all(torch.equal(w[0][k], w[1][k]) for k in shapes)
    assert not torch.equal(w[0]["text_proj.weight"], w[2]["text_proj.weight"])
    assert float(w[0]["temp"]) == pytest.approx(0.07)
    s = [cirr.sample_rows(100, 10, x, must=[42]) for x in (BIG_SEED,
                                                           BIG_SEED, 9)]
    assert (s[0] == s[1]).all() and not (s[0] == s[2]).all()
    assert s[0][0] == 42 and len(set(s[0])) == 10
    assert cirr.stream_seed(BIG_SEED, "images") != cirr.stream_seed(
        BIG_SEED, "queries")


# -- counts ------------------------------------------------------------------

def test_vit_layer_count_by_hand():
    vit = {**config("blip_retrieval_vitb16_384")["vit"], "num_layers": 1}
    c = counts.vit_image(vit)
    patch = 679_477_248                  # 2 * 576 * 768 * 768
    proj = 2_722_627_584                 # 4 * 2 * 577 * 768^2
    attn = 1_022_757_888                 # 4 * 577^2 * 768
    mlp = 5_445_255_168                  # 2 * 2 * 577 * 768 * 3072
    assert c.flops == patch + proj + attn + mlp
    assert c.attn_flops == attn
    assert c.attn_bytes == 4 * 577 * 768 * 2


def test_med_layer_count_by_hand():
    text = {**config("blip_retrieval_vitb16_384")["text"], "num_layers": 1}
    c = counts.med_query(text, 15, 577)
    self_proj, self_attn = 70_778_880, 691_200      # 8*15*768^2, 4*15^2*768
    cross_proj, cross_attn = 35_389_440, 26_588_160  # 4*15*768^2, 4*15*577*768
    ffn = 141_557_760                                # 4 * 15 * 768 * 3072
    assert c.flops == self_proj + self_attn + cross_proj + cross_attn + ffn
    assert c.attn_flops == self_attn + cross_attn
    assert c.attn_bytes == 6 * 15 * 768 * 2
    kv = counts.med_image_kv(text, 577)
    assert kv.flops == 1_361_313_792                  # 2 * 2 * 577 * 768^2
    assert kv.attn_bytes == 2 * 577 * 768 * 2


def test_least_seconds_takes_the_larger_bound():
    assert kernels.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert kernels.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def test_compare_gaps():
    s = np.asarray([3.0, 2.0, 1.99, 0.0])
    assert compare.order_gap([0, 1, 2], s, 1.0) == 0.0
    assert compare.order_gap([0, 2, 1], s, 1.0) == pytest.approx(0.01)
    assert compare.order_gap([3, 0], s, 1.0) == pytest.approx(3.0)
    assert compare.rank_gap([1, 3], [1, 3], s, 1.0) == 0.0
    assert compare.rank_gap([0], [3], s, 2.0) == pytest.approx(1.5)
    assert compare.rel_err([[1.0, 0.0]], [[1.0, 0.0]]) == 0.0


# -- the reference against the port's CPU path -------------------------------

@torch.no_grad()
def test_reference_agrees_with_the_port_on_the_cpu():
    cfg = tiny_config(config("blip_reranker_vitb16_384"))
    s1, w1 = system.build_stage1(cfg, 11, "cpu")
    s2, w2 = system.build_reranker(cfg, 11, "cpu")
    imgs = torch.from_numpy(cirr.make_images(5, 32, 11, "cpu"))
    vocab = cirr.load_vocab()
    words = ["red", "dog", "with", "the", "blue", "cat"]
    ids, mask = (torch.from_numpy(a) for a in ref_text.encode(words, vocab))
    port_ids, _ = system.tokenizer().encode([" ".join(words)], 12,
                                            set_enc_token=True)
    assert (port_ids[0, :ids.shape[1]] == ids[0].numpy()).all()

    feats = ref.vit_forward(w2, cfg["vit"], imgs)
    assert (s2.embed_images(imgs) - feats).abs().max() < 1e-5
    f1 = ref.vit_forward(w1, cfg["vit"], imgs)
    raw, pooled = s1.embed_images(imgs, pool_and_normalize=True)
    assert (raw - f1).abs().max() < 1e-5
    assert (pooled - ref.pooled_image(w1, f1)).abs().max() < 1e-6
    pred, z_t = ref.fused_query(w1, cfg, ids, mask, feats[:1])
    assert (s1.fuse(feats[:1], ids, mask, return_raw=True)
            - z_t).abs().max() < 1e-5
    assert (s1.fuse(feats[:1], ids, mask) - pred).abs().max() < 1e-6
    scores = ref.rerank_scores(w2, cfg["text"], ids, mask, z_t, feats[1:])
    port = s2.score_per_query(z_t, ids, mask, feats[None, 1:])[0]
    assert (port - scores).abs().max() < 1e-5
    assert scores.std() > 0.05          # the candidates are told apart


def test_fp8_numerics_round_to_fewer_bits():
    x = torch.linspace(-3.0, 3.0, 1001)
    lo = ref.Numerics("fp8").round(x)
    err = (lo - x).abs().max() / x.abs().max()
    assert 1e-3 < err < 0.07            # e4m3: 3 mantissa bits
    assert torch.equal(ref.FP32.round(x), x)
    with pytest.raises(ValueError):
        ref.Numerics("int3")


# -- import hygiene ----------------------------------------------------------

def imported_top_names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_module_under_cirbench_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = {}
    for f in files:
        names = imported_top_names(f)
        banned = {"jax", "jaxlib", "flax", "candidate_reranking_cir_tpu"}
        if f.is_relative_to(PKG / "reference"):
            banned.add("candidate_reranking_cir_tpu_torch")
        if names & banned:
            bad[str(f.relative_to(ROOT))] = sorted(names & banned)
    assert bad == {}


def test_the_hygiene_walk_sees_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import candidate_reranking_cir_tpu_torch.ops as o\n"
                 "from jaxtyping import Array\n"
                 "import importlib\n"
                 "importlib.import_module('candidate_reranking_cir_tpu.x')\n")
    assert imported_top_names(f) == {"candidate_reranking_cir_tpu_torch",
                                     "jaxtyping", "importlib",
                                     "candidate_reranking_cir_tpu"}


def test_benchmark_json_names_what_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        spec = harness.load_json("workloads", w["name"])
        assert (PKG / "drivers" / f"{spec['driver']}.py").is_file()
        harness.load_json("traffic", w["traffic"])
        for m in harness.metrics_for(bench, w["name"], False) \
                + harness.metrics_for(bench, w["name"], True):
            assert (PKG / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
