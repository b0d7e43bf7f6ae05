"""Kimi-VL-A3B-Instruct as a point-wise stage-II re-ranker
(``models/kimi_vl.py``, ``models/moonvit.py``, ``models/kimi_lm.py``,
``ops/moe.py``, ``retrieval/rerank.rerank_prefixed``) against the plain
float32 reference ``cirbench/reference/kimi_vl.py`` on seeded tiny weights,
on the CPU, within float32's 1e-4 (the same functions in other orders):
MoonViT and the projector; the router; prefix-cached scores with ragged
prefixes against each sequence's whole forward; the engine end to end on
a tiny CIRR split; the grouped experts against the per-expert loop. Also
``Dense`` with parameters held in the compute dtype (no kept copy), the
existing fp32-held routes bit for bit, and the published checkpoint's
names.

Tiny sizes: width 64, 4 MLA heads (nope 16, rope 8, v 16, latent 32), one
dense and two routed layers of 8 experts (top-2, 1 shared); MoonViT 2 x 48
with heads of 12 at a 56-px image (a 4 x 4 grid, 4 LM tokens an image).
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from candidate_reranking_cir_tpu_torch.config import (
    KimiLMConfig,
    KimiVLRerankerConfig,
    MoonViTConfig,
    RerankTemplate,
)
from candidate_reranking_cir_tpu_torch.models import kimi_lm
from candidate_reranking_cir_tpu_torch.models.kimi_vl import KimiVLReranker
from candidate_reranking_cir_tpu_torch.models.layers import Dense
from candidate_reranking_cir_tpu_torch.ops import moe, registry
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    kimi_vl_state_dict,
)
from cirbench.reference import kimi_vl as ref

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "cirbench" / "configs" / "kimi_vl_a3b_rerank_392.json"
TOL = 1e-4
SEED = 7

TINY_LM = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
               num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, first_k_dense_replace=1)
TINY_VISION = dict(image_size=56, hidden_size=48, num_layers=2, num_heads=4,
                   intermediate_size=96, pos_grid=8)
TINY_TEMPLATE = dict(template_ids=[200, 201, 202],
                     media_start_ids=[203, 204, 205], media_end_ids=[206],
                     question_ids=list(range(40, 52)),
                     assistant_ids=[207, 208, 209, 210], yes_id=211,
                     no_id=212)


def tiny_dict() -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg.update(TINY_LM)
    cfg["vision"].update(TINY_VISION)
    cfg["template"] = copy.deepcopy(TINY_TEMPLATE)
    return cfg


def port_config(cfg: dict) -> KimiVLRerankerConfig:
    lm = {k: cfg[k] for k in KimiLMConfig.__dataclass_fields__ if k in cfg}
    return KimiVLRerankerConfig(
        vision=MoonViTConfig(**cfg["vision"]), lm=KimiLMConfig(**lm),
        template=RerankTemplate(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg["template"].items()}))


@pytest.fixture(scope="module")
def tiny():
    """(config dict, the port's model with the reference's weights, the
    reference's weights)."""
    cfg = tiny_dict()
    torch.manual_seed(0)
    model = KimiVLReranker(port_config(cfg), dtype=torch.float32,
                           device="cpu").eval()
    ref.load_into(model.named_parameters(), cfg, SEED)
    return cfg, model, ref.Weights(cfg, SEED, "cpu")


def _images(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 56, 56, 3, generator=g)


def test_the_port_holds_every_reference_tensor(tiny):
    cfg, model, _ = tiny
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert names == {n: s for n, (s, _) in ref.shapes(cfg).items()}


def test_full_size_parameter_count():
    """16.41 B parameters (LM 15.96 B, MoonViT 0.42 B, projector 0.03 B):
    32.8 GB in bf16, one copy on an 80 GB card."""
    n = ref.count_params(json.loads(CONFIG.read_text()))
    assert n == {"lm": 15960110208, "vision": 416866032,
                 "projector": 30679808}
    assert 2 * sum(n.values()) < 33e9


def test_moonvit_and_projector_tokens(tiny):
    cfg, model, w = tiny
    images = _images(3)
    with torch.inference_mode():
        got = model.embed_images(images)
    want = ref.image_tokens(w, cfg, images)
    assert got.shape == (3, 4, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_rope2d_turns_columns_then_rows():
    """Pair 2j of a head turns by col * theta_j, pair 2j + 1 by row *
    theta_j: on a 2 x 2 grid patch (row 1, col 0) leaves pairs 2j alone."""
    from candidate_reranking_cir_tpu_torch.models.moonvit import grid_angles

    vc = MoonViTConfig(image_size=28, patch_size=14, hidden_size=24,
                       num_heads=2)
    ang = grid_angles(vc, "cpu")
    assert ang.shape == (4, 6)
    assert (ang[2, 0::2] == 0).all() and (ang[2, 1::2] > 0).all()
    assert (ang[1, 1::2] == 0).all() and (ang[1, 0::2] > 0).all()


def _router(n_exp=8, k=2, d=16, seed=5):
    lm = KimiLMConfig(hidden_size=d, n_routed_experts=n_exp,
                      num_experts_per_tok=k)
    r = kimi_lm.Router(lm, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        r.weight.copy_(torch.randn(n_exp, d, generator=g) * d ** -0.5)
    return r, torch.randn(6, d, generator=g)


def test_router_bias_picks_and_never_weighs():
    r, x = _router()
    idx0, w0 = r(x)
    s = torch.sigmoid(x @ r.weight.t())
    # normalised over the chosen, then scaled
    torch.testing.assert_close(w0.sum(-1), torch.full((6,), 2.446),
                               rtol=0, atol=1e-6)
    with torch.no_grad():
        r.e_score_correction_bias[3] = 10.0   # expert 3 always chosen
    idx1, w1 = r(x)
    assert (idx1 == 3).any(-1).all() and not (idx0 == 3).all()
    # its weight is its score, not its score plus the bias
    chosen = s.gather(-1, idx1)
    torch.testing.assert_close(
        w1, chosen / chosen.sum(-1, keepdim=True) * 2.446, rtol=0,
        atol=1e-6)


def test_router_matches_the_reference(tiny):
    cfg, model, w = tiny
    lay = "lm.layers.1"
    p = w.group(lay)
    x = torch.randn(20, 64, generator=torch.Generator().manual_seed(2))
    idx, wt = model.lm.layers[1].mlp.gate(x)
    ridx, rwt, _ = ref.route(ref.FP32, p, lay, cfg, x)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(wt, rwt, rtol=0, atol=1e-6)


def test_moe_adds_the_shared_expert(tiny):
    cfg, model, w = tiny
    layer = model.lm.layers[2].mlp
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        got = layer(x)
        flat = x.reshape(-1, 64)
        idx, wt = layer.gate(flat)
        routed = moe.grouped_experts(flat, idx, wt, layer.experts.gate_up,
                                     layer.experts.down)
        shared = layer.shared_experts(flat)
    torch.testing.assert_close(got.reshape(-1, 64), routed + shared,
                               rtol=0, atol=1e-6)
    lay = "lm.layers.2"
    want, _ = ref.moe(ref.FP32, w.group(lay), lay, cfg, flat)
    torch.testing.assert_close(got.reshape(-1, 64), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_experts_equal_the_per_expert_loop(dtype):
    """Every expert's rows, an expert with none among them."""
    g = torch.Generator().manual_seed(9)
    e, d, f, t, k = 6, 32, 16, 40, 2
    x = torch.randn(t, d, generator=g).to(dtype)
    gate_up = (torch.randn(e, 2 * f, d, generator=g) * d ** -0.5).to(dtype)
    down = (torch.randn(e, d, f, generator=g) * f ** -0.5).to(dtype)
    idx = torch.randint(0, e - 1, (t, k), generator=g)   # expert 5 idle
    idx[:, 1] = (idx[:, 0] + 1) % (e - 1)
    w = torch.rand(t, k, generator=g)
    registry.reset()
    got = moe.grouped_experts(x, idx, w, gate_up, down)
    want = moe.grouped_experts_plain(x, idx, w, gate_up, down)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert registry.MOE["routed"] == t * k
    assert int(registry.MOE["busiest"]) == int(torch.bincount(
        idx.reshape(-1)).max())


def test_prefix_cached_scores_equal_the_whole_forward(tiny):
    """Ragged prefixes (captions of 1, 3 and 8 words), each with its own
    candidates: the prefix pass, then the suffixes against its latent,
    equal to each (prefix; suffix) sequence's whole causal forward."""
    cfg, model, w = tiny
    bank = ref.image_tokens(w, cfg, _images(6, seed=8))
    caps = [[3, 5, 7], [10, 11, 12, 13, 14, 15, 16, 17], [20]]
    cands = torch.tensor([[1, 2, 3, 4], [0, 2, 3, 5], [5, 3, 2, 1]])
    registry.reset()
    with torch.inference_mode():
        cache = model.prefix(bank[:3], [np.asarray(c) for c in caps])
        got = model.score(cache, bank[cands])
    want = ref.scores(w, cfg, caps, bank[:3], bank[cands])
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
    # a prefix's latent is 576 values a token at full size: here 32 + 8
    assert cache.latents[0].shape == (3, 6 + 4 + 1 + 8, 40)
    assert registry.SDPA["mla"] == 2 * 3
    assert registry.counts()["K1"] == 0      # the CPU's plain versions


def test_a_suffix_sees_no_padding_and_no_other_candidate(tiny):
    """A query's score of a candidate does not move when another query of
    the chunk is longer (its padding) or another candidate changes."""
    cfg, model, w = tiny
    bank = ref.image_tokens(w, cfg, _images(6, seed=8))
    with torch.inference_mode():
        alone = model.score(model.prefix(bank[:1], [np.asarray([3, 5])]),
                            bank[torch.tensor([[1, 2]])])
        padded = model.score(
            model.prefix(bank[:2], [np.asarray([3, 5]),
                                    np.arange(20, 40)]),
            bank[torch.tensor([[1, 4], [0, 2]])])
    torch.testing.assert_close(padded[0, 0], alone[0, 0], rtol=0, atol=1e-5)


def test_reference_takes_forced_expert_choices(tiny):
    """The reference with its own choices forced back reads the same
    scores and no flip. With other choices forced and no margin, other
    scores, each forced id outside the choice it makes itself on that path
    counted as a near tie and none as a flip. With a margin of 0, no
    forced row that differs is taken: the scores of its own choices, and
    each forced id outside them a flip."""
    cfg, model, w = tiny
    bank = ref.image_tokens(w, cfg, _images(5, seed=6))
    caps = [[3, 5, 7], [10, 11, 12, 13, 14, 15]]
    cands = bank[torch.tensor([[1, 2, 3], [0, 3, 4]])]
    own = ref.Routes()
    base = ref.scores(w, cfg, caps, bank[:2], cands, routes=own)
    assert set(own.own) == {1, 2} and own.slots == 0
    same = ref.Routes(own.own, margin=0.0)
    torch.testing.assert_close(
        ref.scores(w, cfg, caps, bank[:2], cands, routes=same), base,
        rtol=0, atol=0)
    assert same.flips == same.near == 0
    assert same.slots == own.own[1].numel() * 2
    e = cfg["n_routed_experts"]
    other = {i: (t + 1) % e for i, t in own.own.items()}
    other[1][:, :4] = -1                   # the first tokens choose

    def outside(t, mine):
        rows = t[..., 0] >= 0
        return int((t[rows][:, :, None] != mine[rows][:, None, :]).all(-1)
                   .sum())

    moved = ref.Routes(other)
    got = ref.scores(w, cfg, caps, bank[:2], cands, routes=moved)
    assert not torch.allclose(got, base)
    # against the choices of the forced run's own path
    want = sum(outside(t, moved.own[i]) for i, t in other.items())
    assert moved.near == want > 0 and moved.flips == 0
    assert moved.widest > 0
    assert moved.slots == sum(int((t >= 0).sum()) for t in other.values())
    held = ref.Routes(other, margin=0.0)
    torch.testing.assert_close(
        ref.scores(w, cfg, caps, bank[:2], cands, routes=held), base,
        rtol=0, atol=0)
    want = sum(outside(t, own.own[i]) for i, t in other.items())
    assert held.flips == want > 0 and held.near == 0
    assert held.beyond[0] == want


def _tiny_split(seed: int, n_images=12, n_queries=7, k=6):
    from cirbench.traffic import cirr

    images = cirr.make_images(n_images, 56, seed, "cpu")
    corpus = cirr.Corpus(images)
    vocab = cirr.load_vocab()
    queries = cirr.make_queries(
        {"queries": n_queries, "group_size": 6, "top_k": k,
         "target_in_topk": 0.9,
         "caption": {"model": "geometric", "min": 3, "max": 30, "p": 0.12}},
        corpus.index_names, seed, cirr.caption_words(vocab))
    return corpus, queries, vocab


def test_engine_end_to_end_equals_the_reference(tiny):
    """``evaluate_cirr_stage2_datasets(stage1=None, schedule='query_major')``
    on a tiny CIRR split, chunks of 3 queries (a padded tail): the scores
    within 1e-4, the orders and the recalls equal to the reference's on
    the bank as the index keeps it (``build_index``'s bf16 rows)."""
    from cirbench.system import tokenizer
    from candidate_reranking_cir_tpu_torch.retrieval import metrics as M
    from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
        evaluate_cirr_stage2_datasets,
    )

    cfg, model, w = tiny
    corpus, q, vocab = _tiny_split(11)
    res = evaluate_cirr_stage2_datasets(
        None, None, model, None, tokenizer(), corpus, q.rows(), k=6,
        text_len=32, batch_size=5, schedule="query_major", q_batch=3,
        device="cpu")
    assert {"index", "prefix", "score", "rerank"} <= set(res.seconds)
    feats = ref.image_tokens(w, cfg, torch.from_numpy(corpus.images)).to(
        torch.bfloat16).float()
    cands = torch.from_numpy(np.concatenate([q.topk, q.group[:, 1:]], 1))
    want = ref.scores(w, cfg, [ref.encode(wd, vocab) for wd in q.words],
                      feats[torch.from_numpy(q.ref)], feats[cands]).numpy()
    hit = q.topk_hit()
    out = res.rerank
    np.testing.assert_allclose(out.logits[hit], want[hit, :6], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(out.group_logits, want[:, 6:], rtol=0,
                               atol=TOL)
    assert (out.logits[~hit] == -99999.99).all()
    order = np.argsort(-want[:, :6], axis=1, kind="stable")
    assert (out.order[hit] == order[hit]).all()
    assert (out.group_order == np.argsort(-want[:, 6:], axis=1,
                                          kind="stable")).all()
    labels = M.reranked_labels(
        np.stack([r["topk_labels"] for r in q.rows()]),
        np.where(hit[:, None], order, out.order))
    assert res.metrics["recall_at1"] == M.recall_at(labels, 1)
    assert res.metrics["recall_at5"] == M.recall_at(labels, 5)


def test_engine_refuses_the_prefix_scorer_off_its_route(tiny):
    from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
        run_rerank,
    )

    _, model, _ = tiny
    with pytest.raises(ValueError, match="query_major"):
        run_rerank("candidate_major", None, model, None, q_batch=4,
                   l_buckets=None, device="cpu")
    with pytest.raises(ValueError, match="one device"):
        run_rerank("query_major", None, model, None, q_batch=4,
                   l_buckets=None, device="cpu", mesh=object())


def test_a_bf16_held_dense_keeps_no_second_copy():
    d = Dense(16, 8, torch.bfloat16, "cpu", param_dtype=torch.bfloat16)
    registry.reset()
    x = torch.randn(3, 16)
    with torch.inference_mode():
        y = d(x)
        w, b = d.cast()
    assert w is d.weight and b is d.bias and d._casts is None
    assert w.untyped_storage().data_ptr() == \
        d.weight.untyped_storage().data_ptr()
    assert registry.DENSE == {"cast": 0, "cached": 2}
    want = torch.nn.functional.linear(x.to(torch.bfloat16), d.weight) \
        + d.bias
    assert torch.equal(y, want)


def test_an_fp32_held_dense_keeps_its_routes_bit_for_bit():
    """The existing models' Dense: fp32 parameters, one bf16 copy kept and
    reused, and the output's bits those of the formula."""
    torch.manual_seed(1)
    d = Dense(16, 8, torch.bfloat16, "cpu")
    with torch.no_grad():
        d.bias.normal_()
    assert d.weight.dtype == torch.float32
    x = torch.randn(5, 16)
    registry.reset()
    with torch.inference_mode():
        y1, y2 = d(x), d(x)
    assert registry.DENSE == {"cast": 1, "cached": 1}
    want = torch.nn.functional.linear(x.to(torch.bfloat16),
                                      d.weight.to(torch.bfloat16)) \
        + d.bias.to(torch.bfloat16)
    assert torch.equal(y1.view(torch.int16), want.view(torch.int16))
    assert torch.equal(y2.view(torch.int16), want.view(torch.int16))
    with torch.no_grad():                    # grad mode off, no kept copy
        assert torch.equal(d(x), want)


def _published(cfg: dict, seed: int = 0) -> dict:
    """A tiny state dict under the published checkpoint's names."""
    g = torch.Generator().manual_seed(seed)
    v, d = cfg["vision"], cfg["hidden_size"]
    vd, p, vf = v["hidden_size"], v["patch_size"], v["intermediate_size"]

    def r(*shape):
        return torch.randn(*shape, generator=g)

    sd = {"vision_tower.patch_embed.proj.weight": r(vd, 3, p, p),
          "vision_tower.patch_embed.proj.bias": r(vd),
          "vision_tower.patch_embed.pos_emb.weight": r(8, 8, vd),
          "vision_tower.encoder.final_layernorm.weight": r(vd),
          "vision_tower.encoder.final_layernorm.bias": r(vd),
          "multi_modal_projector.pre_norm.weight": r(vd),
          "multi_modal_projector.pre_norm.bias": r(vd),
          "multi_modal_projector.linear_1.weight": r(4 * vd, 4 * vd),
          "multi_modal_projector.linear_1.bias": r(4 * vd),
          "multi_modal_projector.linear_2.weight": r(d, 4 * vd),
          "multi_modal_projector.linear_2.bias": r(d),
          "language_model.model.embed_tokens.weight": r(256, d),
          "language_model.model.norm.weight": r(d),
          "language_model.lm_head.weight": r(256, d),
          "language_model.model.layers.0.self_attn.rotary_emb.inv_freq":
              r(4)}
    for i in range(v["num_layers"]):
        b = f"vision_tower.encoder.blocks.{i}."
        for n, shape in (("norm0", (vd,)), ("norm1", (vd,))):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = r(*shape), r(*shape)
        sd[b + "wqkv.weight"], sd[b + "wqkv.bias"] = r(3 * vd, vd), r(3 * vd)
        sd[b + "wo.weight"], sd[b + "wo.bias"] = r(vd, vd), r(vd)
        sd[b + "mlp.fc0.weight"], sd[b + "mlp.fc0.bias"] = r(vf, vd), r(vf)
        sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = r(vd, vf), r(vd)
    for i in range(cfg["num_hidden_layers"]):
        b = f"language_model.model.layers.{i}."
        sd[b + "input_layernorm.weight"] = r(d)
        sd[b + "post_attention_layernorm.weight"] = r(d)
        sd[b + "self_attn.q_proj.weight"] = r(4 * 24, d)
        sd[b + "self_attn.kv_a_proj_with_mqa.weight"] = r(40, d)
        sd[b + "self_attn.kv_a_layernorm.weight"] = r(32)
        sd[b + "self_attn.kv_b_proj.weight"] = r(4 * 32, 32)
        sd[b + "self_attn.o_proj.weight"] = r(d, 4 * 16)
        if i == 0:
            for n, shape in (("gate", (96, d)), ("up", (96, d)),
                             ("down", (d, 96))):
                sd[b + f"mlp.{n}_proj.weight"] = r(*shape)
            continue
        sd[b + "mlp.gate.weight"] = r(8, d)
        sd[b + "mlp.gate.e_score_correction_bias"] = r(8)
        for e in range(8):
            for n, shape in (("gate", (32, d)), ("up", (32, d)),
                             ("down", (d, 32))):
                sd[b + f"mlp.experts.{e}.{n}_proj.weight"] = r(*shape)
        for n, shape in (("gate", (32, d)), ("up", (32, d)),
                         ("down", (d, 32))):
            sd[b + f"mlp.shared_experts.{n}_proj.weight"] = r(*shape)
    return {k: v.to(torch.bfloat16) for k, v in sd.items()}


def test_published_checkpoint_names_load(tiny):
    """Every tensor of the port's model from the published names, strict;
    the experts stacked in order (gate, then up), the convolution read as
    (row, column, channel) patches."""
    cfg, _, _ = tiny
    model = KimiVLReranker(port_config(cfg), dtype=torch.bfloat16,
                           device="cpu")
    sd = _published(cfg)
    model.load_state_dict(kimi_vl_state_dict(sd), strict=True)
    pre = "language_model.model.layers.2.mlp.experts.5."
    gate_up = model.lm.layers[2].mlp.experts.gate_up[5]
    assert torch.equal(gate_up[:32], sd[pre + "gate_proj.weight"])
    assert torch.equal(gate_up[32:], sd[pre + "up_proj.weight"])
    assert torch.equal(model.lm.layers[2].mlp.experts.down[5],
                       sd[pre + "down_proj.weight"])
    conv = sd["vision_tower.patch_embed.proj.weight"]
    patch = torch.randn(1, 14, 14, 3).to(torch.bfloat16)
    by_conv = torch.einsum("ochw,bhwc->bo", conv.float(), patch.float())
    by_dense = patch.reshape(1, -1).float() \
        @ model.vision.patch_embed.weight.float().t()
    torch.testing.assert_close(by_dense, by_conv, rtol=0, atol=1e-3)
    assert model.lm.layers[1].mlp.gate.e_score_correction_bias.dtype == \
        torch.float32
