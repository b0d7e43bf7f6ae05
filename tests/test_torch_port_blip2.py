"""BLIP-2 as a stage-I retrieval model of the port, on the CPU in float32,
against the plain reference ``tests/_blip2_reference.py``.

A small BLIP-2: an EVA-style ViT of 2 blocks, width 176 (2 heads of 88,
the published head width), patch 14 at 28 px; a Q-Former of 4 layers, 4
queries, width 64, cross-attention every 2nd layer from width 176. Random
weights from a seed, every bias and gain drawn.

Tolerances: the port and the reference compute the same float32 function
in other orders (batched products and padded captions against one image
and one caption at a time); at these widths and depths the gap reads
1e-7..1e-6, so 1e-5 on unit-norm features and scores leaves room without
hiding a wrong term, which moves them by 1e-2 or more.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import _blip2_reference as ref
from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.models.blip2_retrieval import (
    Blip2RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.models.tokenizer import (
    WordPieceTokenizer,
    build_test_vocab,
)
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
from candidate_reranking_cir_tpu_torch.ops import topk
from candidate_reranking_cir_tpu_torch.retrieval import validate_engine as tv

TOL = 1e-5
WORDS = ["red", "blue", "dog", "cat", "dress", "shirt", "same", "image",
         "the", "with", "and", "of"]


def small_config() -> tcfg.Blip2RetrievalModelConfig:
    vit = tcfg.ViTConfig(image_size=28, patch_size=14, hidden_size=176,
                         num_layers=2, num_heads=2, mlp_ratio=2.0,
                         qkv_bias="qv", final_norm_eps=1e-5)
    text = tcfg.TextEncoderConfig(vocab_size=160, hidden_size=64,
                                  num_layers=4, num_heads=4,
                                  intermediate_size=96,
                                  max_position_embeddings=32,
                                  encoder_width=176)
    return tcfg.Blip2RetrievalModelConfig(vit=vit, text=text,
                                          num_query_tokens=4,
                                          cross_attention_freq=2,
                                          embed_dim=32, text_len=16)


def ref_cfg(cfg) -> dict:
    return {"vit": dataclasses.asdict(cfg.vit),
            "text": dataclasses.asdict(cfg.text),
            "num_query_tokens": cfg.num_query_tokens,
            "cross_attention_freq": cfg.cross_attention_freq}


def random_weights(model, seed: int) -> dict:
    """Every tensor drawn: a product's weight N(0, 1/fan_in), LayerNorm
    gains 1 + N(0, 0.02^2), biases, embeddings and queries N(0, 0.02^2)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        x = torch.randn(t.shape, generator=g)
        if t.ndim == 2 and "embeddings" not in name:
            x = x * t.shape[1] ** -0.5
        elif name.endswith("ln.weight") or "norm" in name \
                and name.endswith(".weight"):
            x = 1.0 + 0.02 * x
        else:
            x = 0.02 * x
        out[name] = x
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = small_config()
    model = Blip2RetrievalModel(cfg, device="cpu").eval()
    weights = random_weights(model, 19)
    model.load_state_dict(weights, strict=True)
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 28, 28, 3), dtype=np.float32))
    return cfg, model, weights, images


def _captions(rng, n):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 9))))
            for _ in range(n)]


def _tokenizer():
    return WordPieceTokenizer(build_test_vocab(WORDS))


def test_published_config_has_the_published_shapes(tmp_path):
    cfg = tcfg.Blip2RetrievalModelConfig()
    v, t = cfg.vit, cfg.text
    assert (v.image_size, v.patch_size, v.num_tokens) == (224, 14, 257)
    assert (v.hidden_size, v.num_layers, v.num_heads, v.head_dim) == \
        (1408, 39, 16, 88)
    assert int(v.hidden_size * v.mlp_ratio) == 6144
    assert (v.qkv_bias, v.layer_norm_eps, v.final_norm_eps) == \
        ("qv", 1e-6, 1e-5)
    assert (t.num_layers, t.hidden_size, t.num_heads, t.head_dim,
            t.intermediate_size, t.layer_norm_eps) == \
        (12, 768, 12, 64, 3072, 1e-12)
    assert (t.vocab_size, t.encoder_width) == (30523, 1408)
    assert (cfg.num_query_tokens, cfg.cross_attention_freq, cfg.embed_dim,
            cfg.text_len) == (32, 2, 256, 32)
    # load_config round-trips it as an experiment's stage-I model
    exp = tcfg.ExperimentConfig(stage1=cfg)
    tcfg.save_config(exp, tmp_path / "blip2.json")
    assert tcfg.load_config(tmp_path / "blip2.json") == exp
    # BLIP's defaults are as they were
    assert tcfg.ViTConfig().qkv_bias == "qkv"
    assert tcfg.ViTConfig().final_norm_eps is None


@pytest.mark.parametrize("part", ["vit_block", "qformer_layer"])
def test_published_widths_build(part):
    """One ViT-g block and one cross Q-Former layer at the published
    widths: the tensors LAVIS's have (no key bias in the tower)."""
    from candidate_reranking_cir_tpu_torch.models.qformer import QFormerLayer
    from candidate_reranking_cir_tpu_torch.models.vit import ViTBlock

    cfg = tcfg.Blip2RetrievalModelConfig()
    if part == "vit_block":
        shapes = {k: tuple(x.shape) for k, x in
                  ViTBlock(cfg.vit, device="cpu").state_dict().items()}
        assert "attn.key.bias" not in shapes
        assert shapes["attn.query.bias"] == shapes["attn.value.bias"] == \
            (1408,)
        assert shapes["mlp.fc1.weight"] == (6144, 1408)
        assert shapes["mlp.fc2.weight"] == (1408, 6144)
    else:
        shapes = {k: tuple(x.shape) for k, x in
                  QFormerLayer(cfg.text, True, device="cpu")
                  .state_dict().items()}
        assert shapes["cross_attn.attn.key.weight"] == (768, 1408)
        assert shapes["cross_attn.attn.value.weight"] == (768, 1408)
        for ffn in ("ffn", "ffn_query"):
            assert shapes[f"{ffn}.intermediate.weight"] == (3072, 768)
            assert shapes[f"{ffn}.output.weight"] == (768, 3072)


def test_vit_qkv_bias_rule():
    cfg = small_config().vit
    with pytest.raises(ValueError, match="qkv_bias"):
        from candidate_reranking_cir_tpu_torch.models.vit import ViTBlock

        ViTBlock(dataclasses.replace(cfg, qkv_bias="kv"), device="cpu")


def _port_fuse(model, tok, captions, images, groups: int):
    """f_q of ``captions``, ``groups`` a reference image (image-major)."""
    ids, mask = tok.encode(captions, 16, set_enc_token=False)
    refs = model.embed_images(images)
    with torch.inference_mode():
        return model.fuse(refs, torch.from_numpy(ids), torch.from_numpy(mask),
                          query_group=groups), ids, mask


@pytest.mark.parametrize("groups", [1, 2])
def test_port_matches_reference(setup, groups):
    """Target rows, f_q (padded captions, image-major at 2 a reference)
    and the max-over-queries scores."""
    cfg, model, w, images = setup
    rc = ref_cfg(cfg)
    with torch.inference_mode():
        feats, targets = model.embed_images(images, pool_and_normalize=True)
    want_t = torch.stack([ref.target(w, rc, im) for im in images])
    assert targets.shape == (6, 4, 32)
    torch.testing.assert_close(targets, want_t, rtol=0, atol=TOL)

    tok = _tokenizer()
    captions = _captions(np.random.default_rng(groups), 3 * groups)
    f_q, ids, mask = _port_fuse(model, tok, captions, images[:3], groups)
    want_q = torch.stack([
        ref.composed(w, rc, torch.from_numpy(ids[i][mask[i] == 1]).long(),
                     images[i // groups]) for i in range(len(captions))])
    torch.testing.assert_close(f_q, want_q, rtol=0, atol=TOL)
    assert ids[0, 0] == tok.cls_id          # BERT's [CLS], not [ENC]

    scores = topk.cosine_scores(f_q, targets)
    want_s = torch.stack([torch.stack([ref.score(q, t) for t in want_t])
                          for q in want_q])
    torch.testing.assert_close(scores, want_s, rtol=0, atol=TOL)


def _perturbed(model, w, prefix: str):
    out = dict(w)
    for k in w:
        if k.startswith(prefix):
            out[k] = w[k] + 0.5
    m = Blip2RetrievalModel(model.cfg, device="cpu").eval()
    m.load_state_dict(out, strict=True)
    return m


@pytest.mark.parametrize("prefix,moves", [
    ("qformer.layers.1.ffn.", False),          # the text FFN
    ("qformer.layers.3.ffn.", False),
    ("qformer.layers.1.ffn_query.", True),     # the query FFN
    ("qformer.layers.2.cross_attn.", True),    # an even (cross) layer
])
def test_query_and_text_rows_split(setup, prefix, moves):
    """The target side runs the queries alone: the text FFN's weights
    leave its outputs bit-equal; the query FFN's and a cross layer's move
    them."""
    cfg, model, w, images = setup
    with torch.inference_mode():
        base = model.embed_images(images[:2], pool_and_normalize=True)[1]
        got = _perturbed(model, w, prefix).embed_images(
            images[:2], pool_and_normalize=True)[1]
    assert torch.equal(got, base) is not moves


def test_cross_attention_only_in_every_other_layer(setup):
    """Layers 1 and 3 have no cross-attention, so no weights there to
    change; the query rows of a caption pass see the image only through
    layers 0 and 2."""
    cfg, model, w, _ = setup
    crossing = [i for i, layer in enumerate(model.qformer.layers)
                if layer.cross_attn is not None]
    assert crossing == [0, 2]
    assert not any(k.startswith(("qformer.layers.1.cross_attn",
                                 "qformer.layers.3.cross_attn")) for k in w)


class _Corpus:
    def __init__(self, images: np.ndarray):
        self.images = images
        self.index_names = [f"img{i}" for i in range(len(images))]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"name": self.index_names[i], "image": self.images[i]}


@pytest.mark.parametrize("image_major", [True, False])
def test_engine_ranks_as_the_reference_scores(setup, image_major):
    """``evaluate_cirr_stage1`` with the BLIP-2 model: every query's top-K
    and its target's, reference's and members' exact ranks are those the
    reference's max-over-queries scores give; its seconds hold the layer
    span 'targets'."""
    cfg, model, w, images = setup
    rc = ref_cfg(cfg)
    rng = np.random.default_rng(7)
    corpus = _Corpus(images.numpy())
    n = len(corpus)
    rows = []
    for i in range(10):
        g = rng.choice(n, size=6, replace=False)
        if i < 4:                      # four queries of one reference
            g = np.concatenate([[1], rng.permutation(np.delete(
                np.arange(n), 1))[:5]])
        rows.append({"caption": _captions(rng, 1)[0],
                     "reference_name": corpus.index_names[g[0]],
                     "target_name": corpus.index_names[g[1]],
                     "group_members": [corpus.index_names[j] for j in g]})
    tok = _tokenizer()
    res, _ = tv.evaluate_cirr_stage1(
        model, None, corpus, rows, tok, text_len=16, batch_size=4,
        save_topk_k=3, q_batch=8, image_major=image_major, device="cpu")
    assert {"index", "targets", "fusion", "ranking"} <= set(res.seconds)

    targets = [ref.target(w, rc, im) for im in images]
    ids, mask = tok.encode([r["caption"] for r in rows], 16)
    pos = {nm: i for i, nm in enumerate(corpus.index_names)}
    for qi, r in enumerate(rows):
        f_q = ref.composed(w, rc, torch.from_numpy(ids[qi][mask[qi] == 1])
                           .long(), images[pos[r["reference_name"]]])
        s = np.asarray([float(ref.score(f_q, t)) for t in targets])
        order = np.argsort(-s, kind="stable")
        assert res.topk[qi, :3].tolist() == order[:3].tolist()
        place = np.argsort(order, kind="stable")
        members = [m for m in r["group_members"]
                   if m != r["reference_name"]][:5]
        ents = [r["target_name"], r["reference_name"], *members]
        assert res.ranks[qi].tolist() == [int(place[pos[e]]) for e in ents]


def test_blip2_refuses_the_single_program_and_mesh_executors(setup):
    cfg, model, _, images = setup
    corpus = _Corpus(images.numpy())
    rows = [{"caption": "red dog", "reference_name": "img0",
             "target_name": "img1",
             "group_members": [f"img{i}" for i in range(6)]}]
    with pytest.raises(ValueError, match="multi-launch"):
        tv.evaluate_cirr_stage1(model, None, corpus, rows, _tokenizer(),
                                text_len=16, single_program=True,
                                device="cpu")


@pytest.mark.parametrize("block", [1, 7, 1 << 24])
def test_multi_vector_scores_in_blocks(monkeypatch, block):
    """Scores of a [N, T, E] index: the max over T of the products, the
    same in any block of query rows."""
    g = torch.Generator().manual_seed(5)
    pred = torch.randn(11, 8, generator=g)
    index = torch.randn(9, 4, 8, generator=g)
    monkeypatch.setattr(topk, "MULTI_BLOCK_SCORES", block)
    got = topk.cosine_scores(pred, index)
    want = torch.einsum("qe,nte->qnt", pred, index).amax(-1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    order = topk.cosine_rank(pred, index)
    assert torch.equal(order, torch.argsort(1.0 - got, dim=-1, stable=True))


def test_wide_head_route_predicate():
    """88-wide bf16 heads without a bias go to the kernel as they are;
    fp32, a bias, or another width above 64 do not (and raise there)."""
    q = torch.zeros(2, 5, 3, 88, dtype=torch.bfloat16)
    bias3 = torch.zeros(2, 5, 5)
    assert ck.takes_wide_heads(q, None)
    assert not ck.takes_wide_heads(q, bias3)
    assert not ck.takes_wide_heads(q.float(), None)
    assert not ck.takes_wide_heads(torch.zeros(2, 5, 3, 96,
                                               dtype=torch.bfloat16), None)
    with pytest.raises(ValueError, match="head width 96"):
        ck.pad_heads(torch.zeros(1, 2, 1, 96))
    # the plain version takes any width, at the scale 88 ** -0.5
    k = torch.randn(2, 5, 3, 88)
    s = ck.scaled_scores(k, k)
    torch.testing.assert_close(
        s, torch.einsum("elhd,emhd->ehlm", k, k) * 88 ** -0.5)
