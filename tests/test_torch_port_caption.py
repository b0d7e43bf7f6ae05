"""Captioning in the port (``models/blip_decoder.py``, ``models/blip_base.py``
and the MED's causal and KV-cache modes) against the JAX package's, fp32 on
the CPU: the JAX models run their XLA attention, the port its kernels'
plain versions, from the same parameters (``from_jax_params``).

Token ids must equal JAX's. They may differ only after a step whose top-2
logit gap in JAX is under GAP_TOL; ``assert_same_ids`` names such a step.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_utils import f32, np_tree, port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models import blip_decoder as jdec
from candidate_reranking_cir_tpu.models.blip_base import BlipBase as JBase
from candidate_reranking_cir_tpu.runtime import convert
from candidate_reranking_cir_tpu_torch.models import blip_decoder as pdec
from candidate_reranking_cir_tpu_torch.models.blip_base import BlipBase
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
    load_reference_state_dict,
)

B, MAX_LEN, BEAMS = 2, 8, 2
BOS, PAD = 2, 0
PROMPT = (11, 12, 13)
LOGIT_TOL = 1e-4
BASE_TOL = 2e-5
GAP_TOL = 1e-5
CFG = jcfg.RetrievalModelConfig(
    vit=jcfg.ViTConfig(image_size=32, patch_size=16, hidden_size=64,
                       num_layers=2, num_heads=4),
    text=jcfg.TextEncoderConfig(vocab_size=100, hidden_size=64, num_layers=2,
                                num_heads=4, intermediate_size=128,
                                encoder_width=64, hidden_dropout=0.0,
                                attention_dropout=0.0),
    text_len=MAX_LEN)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 100, size=(B, MAX_LEN)).astype(np.int32)
    mask = np.ones((B, MAX_LEN), np.int32)
    mask[1, 5:] = 0
    return imgs, ids, mask


@pytest.fixture(scope="module")
def cap():
    """(JAX model, params, port model, images, image features, eos id).
    eos is the token JAX's greedy decode (without an eos) emits third in
    row 0, so that finishing and the pad after it are exercised."""
    imgs, ids, mask = _inputs(0)
    model = jdec.CaptionDecoder(CFG)
    params = np_tree(model.init(jax.random.key(0), imgs, ids, mask))
    port = pdec.CaptionDecoder(port_cfg(CFG), device="cpu").eval()
    port.load_state_dict(from_jax_params(params, port_cfg(CFG)))
    feats = np.asarray(model.apply(params, imgs,
                                   method=lambda m, im: m.visual_encoder(im)))
    free = jdec.greedy_caption(model, params, feats, bos_id=BOS, eos_id=-1,
                               pad_id=PAD, max_len=MAX_LEN)
    return model, params, port, imgs, feats, int(np.asarray(free)[0, 3])


def jax_gaps(model, params, feats, ids) -> np.ndarray:
    """[rows, steps] top-2 gap of JAX's teacher-forced logits along
    ``ids``: step t's logits decide position t + 1. Rows of a beam decode
    take their image's features."""
    feats = np.repeat(feats, ids.shape[0] // feats.shape[0], axis=0)
    mask = np.ones(ids.shape, np.int32)
    logits = np.asarray(model.apply(params, feats, ids, mask,
                                    method=jdec.CaptionDecoder.logits))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def assert_same_ids(name, ref, out, gaps):
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape, name
    for r in range(ref.shape[0]):
        diff = np.nonzero(ref[r] != out[r])[0]
        if diff.size == 0:
            continue
        step = diff[0] - 1
        assert gaps[r, step] < GAP_TOL, (
            f"{name}: row {r} differs at position {diff[0]}; the JAX top-2 "
            f"gap at step {step} is {gaps[r, step]:.3e} (>= {GAP_TOL})")
        warnings.warn(f"{name}: row {r} differs from position {diff[0]} "
                      f"on, after step {step}, a near tie (JAX top-2 gap "
                      f"{gaps[r, step]:.3e})")


def test_weights_and_teacher_forced_logits(cap):
    model, params, port, imgs, _, _ = cap
    _, ids, mask = _inputs(1)
    ref = model.apply(params, imgs, ids, mask)
    with torch.no_grad():
        out = port(t(imgs), t(ids), t(mask))
    assert out.dtype == torch.float32 and out.shape == (B, MAX_LEN, 100)
    np.testing.assert_allclose(f32(out), f32(ref), atol=LOGIT_TOL, rtol=0)
    # with dropout the forward needs both seed tables; at this config's
    # rates of 0 it gives the eval logits (the rates at 0.1 are held to JAX
    # in tests/test_torch_port_dropout_layouts.py)
    with pytest.raises(ValueError, match="seed table"):
        port(t(imgs), t(ids), t(mask), deterministic=False)
    seeds = tuple(np.zeros(m.seed_shape, np.int64).tolist()
                  for m in (port.visual_encoder, port.text_decoder))
    with torch.no_grad():
        train = port(t(imgs), t(ids), t(mask), deterministic=False,
                     seeds=seeds)
    np.testing.assert_allclose(f32(train), f32(out), atol=1e-6, rtol=0)


def test_causal_mask_and_decode_modes_match_jax(cap):
    """TextEncoder's causal forward, the stacked image K/V and one-token
    steps over the self-attention caches, against JAX's."""
    model, params, port, _, feats, _ = cap
    _, ids, _ = _inputs(2)
    mask = np.ones_like(ids)
    ref = model.apply(params, feats, ids, mask,
                      method=jdec.CaptionDecoder.logits)
    with torch.no_grad():
        out = port.logits(t(feats), t(ids), t(mask))
    np.testing.assert_allclose(f32(out), f32(ref), atol=LOGIT_TOL, rtol=0)

    k_img, v_img = model.apply(params, feats,
                               method=jdec.CaptionDecoder.precompute_kv)
    pk, pv = port.precompute_kv(t(feats))
    assert pk.shape == (2, B, 5, 4, 16)
    np.testing.assert_allclose(f32(pk), f32(k_img), atol=2e-5, rtol=0)
    np.testing.assert_allclose(f32(pv), f32(v_img), atol=2e-5, rtol=0)

    jk, jv = jdec._self_cache(model, B, MAX_LEN)
    tk, tv = pdec._self_cache(port, B, MAX_LEN, "cpu")
    step_mask = np.zeros((B, MAX_LEN), np.int32)
    with torch.no_grad():
        for step in range(4):
            step_mask[:, step] = 1
            tok = ids[:, step:step + 1]
            jl, (jk, jv) = model.apply(
                params, tok, step_mask, (jk, jv, k_img, v_img), step,
                method=jdec.CaptionDecoder.decode_step)
            tl, (tk, tv) = port.decode_step(t(tok), t(step_mask),
                                            (tk, tv, pk, pv), step)
            np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL,
                                       rtol=0)
            # the cached step's logits are the causal forward's at its row
            np.testing.assert_allclose(f32(tl), f32(out[:, step]),
                                       atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(f32(tk), f32(jk), atol=2e-5, rtol=0)


DECODES = [
    ("greedy", dict(), jdec.greedy_caption, pdec.greedy_caption),
    ("greedy_cached", dict(), jdec.greedy_caption_cached,
     pdec.greedy_caption_cached),
    ("beam", dict(num_beams=BEAMS), jdec.beam_caption, pdec.beam_caption),
    ("beam_cached", dict(num_beams=BEAMS), jdec.beam_caption_cached,
     pdec.beam_caption_cached),
]


@pytest.mark.parametrize("prompt", [(), PROMPT], ids=["bos", "prompt"])
@pytest.mark.parametrize("name,kw,jfn,pfn", DECODES,
                         ids=[d[0] for d in DECODES])
def test_decode_ids_match_jax(cap, name, kw, jfn, pfn, prompt):
    model, params, port, _, feats, eos = cap
    common = dict(bos_id=BOS, eos_id=eos, pad_id=PAD, max_len=MAX_LEN,
                  prompt_ids=prompt, **kw)
    ref = np.asarray(jfn(model, params, feats, **common))
    out = pfn(port, t(feats), **common)
    assert out.dtype == torch.int32 and out.shape == (B, MAX_LEN)
    assert (out[:, 0] == BOS).all()
    assert (out[:, 1:len(prompt) + 1] == torch.tensor(prompt,
                                                      dtype=torch.int32)).all()
    assert_same_ids(name, ref, out.numpy(),
                    jax_gaps(model, params, feats, ref))
    for row in out.numpy():  # pad after eos
        hits = np.nonzero(row == eos)[0]
        if hits.size:
            assert (row[hits[0] + 1:] == PAD).all()


def test_eos_is_reached(cap):
    """The fixture's eos ends a row of the greedy decode early."""
    model, params, port, _, feats, eos = cap
    out = pdec.greedy_caption(port, t(feats), bos_id=BOS, eos_id=eos,
                              pad_id=PAD, max_len=MAX_LEN).numpy()
    assert (out[0, 3] == eos) and (out[0, 4:] == PAD).all()


@pytest.mark.parametrize("prompt", [(), PROMPT], ids=["bos", "prompt"])
@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_cached_equals_recompute(cap, kind, prompt):
    model, params, port, _, feats, eos = cap
    common = dict(bos_id=BOS, eos_id=eos, pad_id=PAD, max_len=MAX_LEN,
                  prompt_ids=prompt)
    if kind == "beam":
        common["num_beams"] = BEAMS + 1
        ref = pdec.beam_caption(port, t(feats), **common)
        out = pdec.beam_caption_cached(port, t(feats), **common)
    else:
        ref = pdec.greedy_caption(port, t(feats), **common)
        out = pdec.greedy_caption_cached(port, t(feats), **common)
    assert_same_ids(f"port {kind}", ref.numpy(), out.numpy(),
                    jax_gaps(model, params, feats, ref.numpy()))


def _penalty_case():
    logits = np.array([[2.0, 1.0, 1.0, -1.0, 0.5, -1.0, 0.0, 3.0],
                       [-0.5, -0.5, 4.0, 4.0, 0.25, -2.0, 1.5, 0.0]],
                      np.float32)
    ids = np.array([[1, 1, 3, 6, 0], [2, 5, 5, 7, 4]], np.int32)
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], np.int32)
    return logits, ids, mask


@pytest.mark.parametrize("penalty", [1.0, 1.1, 1.7])
def test_repetition_penalty_exact(penalty):
    logits, ids, mask = _penalty_case()
    ref = jdec.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(ids),
                                        jnp.asarray(mask), penalty)
    out = pdec.apply_repetition_penalty(t(logits), t(ids), t(mask), penalty)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 1.0])
def test_top_p_filter_exact(top_p):
    logits, _, _ = _penalty_case()
    # ties: [1] and [2] of row 0, [0]/[1] and [2]/[3] of row 1, and a row
    # of equal logits whose cumulative sum crosses top_p inside the tie
    logits = np.concatenate([logits, np.zeros((1, 8), np.float32)])
    ref_sorted, ref_idx = jdec.top_p_filter(jnp.asarray(logits), top_p)
    out_sorted, out_idx = pdec.top_p_filter(t(logits), top_p)
    np.testing.assert_array_equal(out_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(out_sorted.numpy(), np.asarray(ref_sorted))


def test_sample_caption_cached_support_and_seed(cap):
    """Each drawn token lies in the top-p set of its step's logits after
    the repetition penalty and the min-length eos ban; one generator seed
    gives one set of ids."""
    _, _, port, _, feats, eos = cap
    kw = dict(bos_id=BOS, eos_id=eos, pad_id=PAD, max_len=MAX_LEN,
              min_len=5, top_p=0.9, repetition_penalty=1.1, prompt_ids=(11,))
    gens = [torch.Generator().manual_seed(s) for s in (7, 7, 8)]
    runs = [pdec.sample_caption_cached(port, t(feats), g, **kw)
            for g in gens]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    ids = runs[0]
    with torch.no_grad():
        logits = port.logits(t(feats), ids, torch.ones_like(ids))
    finished = torch.zeros(B, dtype=torch.bool)
    for step in range(1, MAX_LEN - 1):   # step 0 writes the prompt
        mask = torch.zeros_like(ids)
        mask[:, :step + 1] = (~finished).int()[:, None] | (
            torch.arange(step + 1) < 2)
        step_logits = pdec.apply_repetition_penalty(
            logits[:, step], ids, mask, 1.1)
        if step + 1 < kw["min_len"]:
            step_logits[:, eos] = float("-inf")
        kept_logits, order = pdec.top_p_filter(step_logits, 0.9)
        for r in range(B):
            nxt = int(ids[r, step + 1])
            if finished[r]:
                assert nxt == PAD
                continue
            kept = order[r][torch.isfinite(kept_logits[r])].tolist()
            assert nxt in kept, (r, step, nxt, kept)
        finished |= ids[:, step + 1] == eos
    assert (ids[:, :2] == torch.tensor([BOS, 11], dtype=torch.int32)).all()


@pytest.fixture(scope="module")
def base():
    imgs, ids, mask = _inputs(3)
    model = JBase(CFG)
    params = np_tree(model.init(jax.random.key(3), imgs, ids, mask))
    port = BlipBase(port_cfg(CFG), device="cpu").eval()
    port.load_state_dict(from_jax_params(params, port_cfg(CFG)))
    return model, params, port, imgs, ids, mask


@pytest.mark.parametrize("mode", ["image", "text", "multimodal"])
def test_blip_base_modes_match_jax(base, mode):
    model, params, port, imgs, ids, mask = base
    ref = model.apply(params, imgs, ids, mask, mode=mode)
    with torch.no_grad():
        out = port(t(imgs), t(ids), t(mask), mode=mode)
    np.testing.assert_allclose(f32(out), f32(ref), atol=BASE_TOL, rtol=0)


def test_blip_base_text_mode_reads_no_cross_attention(base):
    _, _, port, imgs, ids, mask = base
    with torch.no_grad():
        ref = port(t(imgs), t(ids), t(mask), mode="text")
        saved = {k: v.clone() for k, v in port.state_dict().items()
                 if "cross_attn" in k}
        for k in saved:
            port.state_dict()[k].zero_()
        out = port(torch.zeros(B, 32, 32, 3), t(ids), t(mask), mode="text")
        port.load_state_dict(saved, strict=False)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        port(t(imgs), t(ids), t(mask), mode="fusion")


def _lm_head_keys(params) -> dict:
    p = params["params"]["lm_head"]
    pre = "text_decoder.cls.predictions"
    return {
        f"{pre}.transform.dense.weight": np.asarray(
            p["transform"]["kernel"]).T.copy(),
        f"{pre}.transform.dense.bias": np.asarray(p["transform"]["bias"]),
        f"{pre}.transform.LayerNorm.weight": np.asarray(p["ln"]["scale"]),
        f"{pre}.transform.LayerNorm.bias": np.asarray(p["ln"]["bias"]),
        f"{pre}.decoder.weight": np.asarray(p["decoder"]["kernel"]).T.copy(),
        f"{pre}.decoder.bias": np.asarray(p["decoder"]["bias"]),
        f"{pre}.bias": np.asarray(p["decoder"]["bias"]),
    }


def _assert_same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0, msg=key)


def test_reference_keys_caption_decoder(cap, tmp_path):
    """A BLIP_Decoder state dict (built with JAX's export_vit and export_med
    plus the LM head's keys) through ``load_reference_state_dict`` equals
    JAX's ``convert_caption_decoder`` through ``from_jax_params``, with the
    tied bias taken from ``cls.predictions.bias`` and, without it, from
    ``decoder.bias``."""
    _, params, port, _, _, _ = cap
    n = CFG.vit.num_layers
    tree = params["params"]
    sd = {**convert.export_vit(tree["visual_encoder"], "visual_encoder", n),
          **convert.export_med(tree["text_decoder"], "text_decoder.bert",
                               CFG.text.num_layers),
          **_lm_head_keys(params),
          "text_decoder.bert.embeddings.position_ids": np.arange(8)[None]}
    pcfg = port_cfg(CFG)
    want = from_jax_params(convert.convert_caption_decoder(sd, CFG), pcfg)
    got = load_reference_state_dict(sd, pcfg, model="caption")
    _assert_same_state(got, want)
    _assert_same_state(got, port.state_dict())
    sd2 = dict(sd)
    bias = sd2.pop("text_decoder.cls.predictions.bias")
    sd2["text_decoder.cls.predictions.decoder.bias"] = bias + 1.0
    got2 = load_reference_state_dict(sd2, pcfg, model="caption")
    torch.testing.assert_close(got2["lm_head.decoder.bias"],
                               torch.from_numpy(bias + 1.0))
    path = tmp_path / "caption.pt"
    convert.save_torch_checkpoint(str(path), sd, "BLIP_Decoder")
    _assert_same_state(load_reference_state_dict(str(path), pcfg,
                                                 model="caption"), want)
    with pytest.raises(ValueError, match="model"):
        load_reference_state_dict(sd, pcfg, model="decoder")


def test_reference_keys_blip_base(base):
    _, params, port, _, _, _ = base
    tree = params["params"]
    sd = {**convert.export_vit(tree["visual_encoder"], "visual_encoder",
                               CFG.vit.num_layers),
          **convert.export_med(tree["text_encoder"], "text_encoder",
                               CFG.text.num_layers),
          # a retrieval checkpoint's heads are not BlipBase parameters
          "vision_proj.weight": np.zeros((4, 64), np.float32),
          "temp": np.float32(0.07)}
    pcfg = port_cfg(CFG)
    want = from_jax_params(convert.convert_base(sd, CFG), pcfg)
    got = load_reference_state_dict(sd, pcfg, model="base")
    _assert_same_state(got, want)
    _assert_same_state(got, port.state_dict())
