"""The port's glue modules against the JAX package's, on the CPU:
``runtime/weights.convert_vit_npz`` (the google-research ViT importer),
``cli/export_checkpoint``, ``runtime/tracing`` and ``entry``.

Tolerances: converted and exported weights bit for bit, but a resized
position embedding 1e-6 (``interpolate_pos_embed``'s float64 products
against JAX's float32 ``jax.image.resize``, as
tests/test_torch_port_train_cli.py holds it); the ViT's forward 2e-5
(fp32, tests/test_pallas_attention*'s).
"""
import json
import re

import jax
import numpy as np
import pytest
import torch

from _torch_port_utils import TINY_TEXT, TINY_VIT, f32, np_tree, port_cfg, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models.blip_reranker import (
    RerankerModel as JReranker,
)
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.models.vit import VisionTransformer as JViT
from candidate_reranking_cir_tpu.runtime import convert as jconvert
from candidate_reranking_cir_tpu.runtime import tracing as jtracing
from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.cli import export_checkpoint
from candidate_reranking_cir_tpu_torch.entry import entry
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.runtime import tracing
from candidate_reranking_cir_tpu_torch.runtime.checkpoint import (
    save_checkpoint,
)
from candidate_reranking_cir_tpu_torch.runtime.optim import AdamW
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    convert_vit_npz,
    from_jax_params,
    read_reference_file,
)

TEXT_LEN = 10


def _vit_npz(rng, layers, heads, d, p, n_tokens):
    """A google-research ViT checkpoint's arrays (tests/test_convert.py's
    layout) for a ViT of ``layers`` blocks, ``heads`` x (d / heads) heads
    and ``n_tokens`` position embeddings."""
    hd = d // heads
    r = lambda *s: rng.normal(scale=0.05, size=s).astype(np.float32)
    npz = {"embedding/kernel": r(p, p, 3, d), "embedding/bias": r(d),
           "cls": r(1, 1, d),
           "Transformer/posembed_input/pos_embedding": r(1, n_tokens, d),
           "Transformer/encoder_norm/scale": r(d),
           "Transformer/encoder_norm/bias": r(d)}
    for i in range(layers):
        b = f"Transformer/encoderblock_{i}/"
        a = b + "MultiHeadDotProductAttention_1/"
        for name in ("query", "key", "value"):
            npz[a + f"{name}/kernel"] = r(d, heads, hd)
            npz[a + f"{name}/bias"] = r(heads, hd)
        npz[a + "out/kernel"] = r(heads, hd, d)
        npz[a + "out/bias"] = r(d)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            npz[b + f"{ln}/scale"] = r(d)
            npz[b + f"{ln}/bias"] = r(d)
        npz[b + "MlpBlock_3/Dense_0/kernel"] = r(d, 4 * d)
        npz[b + "MlpBlock_3/Dense_0/bias"] = r(4 * d)
        npz[b + "MlpBlock_3/Dense_1/kernel"] = r(4 * d, d)
        npz[b + "MlpBlock_3/Dense_1/bias"] = r(d)
    return npz


@pytest.mark.parametrize("grid", [4, 3])
def test_convert_vit_npz_matches_jax(tmp_path, grid):
    """The port's importer against JAX's ``convert_vit_npz`` followed by
    ``from_jax_params``, bit for bit, from a file and from a dict; at grid
    3 the checkpoint's 3 x 3 position grid is resized to the model's 4 x 4.
    Then the port ViT's forward against JAX's on those weights."""
    rng = np.random.default_rng(grid)
    vit = TINY_VIT  # 32 px, patch 8: 16 patches
    npz = _vit_npz(rng, vit.num_layers, vit.num_heads, vit.hidden_size,
                   vit.patch_size, grid * grid + 1)
    path = tmp_path / "vit.npz"
    np.savez(path, **npz)
    tree = jconvert.convert_vit_npz(npz, vit.num_layers, vit.num_patches)
    cfg = jcfg.RetrievalModelConfig(vit=vit, text=TINY_TEXT, embed_dim=16,
                                    text_len=TEXT_LEN)
    ref = from_jax_params({"visual_encoder": np_tree(tree)}, port_cfg(cfg))
    for src in (str(path), npz):
        out = convert_vit_npz(src, vit.num_layers, vit.num_patches,
                              prefix="visual_encoder.")
        assert sorted(out) == sorted(ref)
        for key in ref:
            if key.endswith("pos_embed") and grid != 4:
                torch.testing.assert_close(out[key], ref[key], rtol=0,
                                           atol=1e-6)
            else:
                assert torch.equal(out[key], ref[key]), key

    model = VisionTransformer(port_cfg(vit), device="cpu").eval()
    model.load_state_dict(convert_vit_npz(str(path), vit.num_layers,
                                          vit.num_patches), strict=True)
    imgs = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jref = JViT(vit).apply({"params": tree}, imgs)
    with torch.no_grad():
        out = model(t(imgs))
    np.testing.assert_allclose(f32(out), f32(jref), rtol=0, atol=2e-5)


def _tiny_stage_cfgs():
    s1 = jcfg.RetrievalModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                   embed_dim=16, text_len=TEXT_LEN)
    s2 = jcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT,
                                  text_len=TEXT_LEN)
    return s1, s2


def _jax_variables(stage, cfg, rng):
    imgs = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 250, size=(2, TEXT_LEN)).astype(np.int32)
    mask = np.ones((2, TEXT_LEN), np.int32)
    if stage == 1:
        return JRetrieval(cfg).init(jax.random.key(1), imgs, ids, mask)
    z_t = rng.normal(size=(2, TEXT_LEN, 24)).astype(np.float32)
    return JReranker(cfg).init(jax.random.key(2), imgs, ids, mask, z_t)


@pytest.mark.parametrize("stage", [1, 2])
def test_export_checkpoint_matches_jax_export(tmp_path, stage, capsys):
    """``cli/export_checkpoint`` on a checkpoint directory of the port's
    trainers, against the JAX package's ``export_stage1/2`` of the same
    weights: the same keys, the arrays bit for bit, the class name and
    the epoch."""
    jcfg_s = _tiny_stage_cfgs()[stage - 1]
    variables = np_tree(_jax_variables(stage, jcfg_s, np.random.default_rng(
        stage)))
    pcfg = port_cfg(jcfg_s)
    model = (RetrievalModel if stage == 1 else RerankerModel)(
        pcfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, pcfg), strict=True)
    ckpt = tmp_path / "saved_models" / "blip_mean"
    save_checkpoint(ckpt, model, AdamW(model.parameters(), lambda n: 1e-4,
                                       0.05), metadata={"epoch": 3})
    model_config = tmp_path / "tiny.json"
    model_config.write_text(json.dumps({
        "vit": {k: getattr(TINY_VIT, k) for k in (
            "image_size", "patch_size", "hidden_size", "num_layers",
            "num_heads")},
        "text": {k: getattr(TINY_TEXT, k) for k in (
            "vocab_size", "hidden_size", "num_layers", "num_heads",
            "intermediate_size", "encoder_width", "merge_mlp_from")},
        "embed_dim": 16}))
    out = tmp_path / f"stage{stage}.pt"
    export_checkpoint.main([
        "--stage", str(stage), "--checkpoint", str(ckpt), "--out", str(out),
        "--model-config", str(model_config), "--image-size", "32",
        "--text-len", str(TEXT_LEN), "--no-bf16", "--epoch", "5",
        "--device", "cpu"])
    class_name = "BLIP_Retrieval" if stage == 1 else "BLIP_NLVR"
    assert f"wrote {out} ({class_name}" in capsys.readouterr().out
    raw = torch.load(out, weights_only=False)
    assert raw["epoch"] == 5 and class_name in raw
    ref = (jconvert.export_stage1 if stage == 1
           else jconvert.export_stage2)(variables, jcfg_s)
    got = read_reference_file(out)
    assert sorted(got) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(got[key], np.asarray(val, np.float32),
                                      err_msg=key)


def test_export_checkpoint_refuses_another_configuration(tmp_path):
    """A checkpoint of another width does not load into the stage's
    model (strict load)."""
    pcfg = port_cfg(_tiny_stage_cfgs()[0])
    model = RetrievalModel(pcfg, device="cpu")
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, model, AdamW(model.parameters(), lambda n: 1e-4,
                                       0.05))
    with pytest.raises(RuntimeError, match="size mismatch"):
        export_checkpoint.main([
            "--stage", "1", "--checkpoint", str(ckpt), "--out",
            str(tmp_path / "x.pt"), "--image-size", "32", "--no-bf16",
            "--device", "cpu"])


def test_tracing_names_phases_in_a_cpu_trace(tmp_path):
    """``trace_phase`` spans appear under their names in the Chrome trace
    that ``start_trace``/``stop_trace`` write; ``PhaseTimer``'s summary
    has the JAX package's format, line for line."""
    timer = tracing.PhaseTimer()
    tracing.start_trace(str(tmp_path / "trace"))
    try:
        with tracing.trace_phase("outer_phase"):
            with timer.phase("matmul_phase"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with timer.phase("matmul_phase"):
                torch.ones(8, 8).sum()
    finally:
        path = tracing.stop_trace()
    assert path.startswith(str(tmp_path / "trace"))
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"outer_phase", "matmul_phase"} <= names
    with pytest.raises(RuntimeError, match="no trace"):
        tracing.stop_trace()

    assert timer.counts == {"matmul_phase": 2}
    pattern = re.compile(r"^\S+\s+\d+\.\d{2}s total\s+\d+\.\dms/it x\d+$")
    assert pattern.match(timer.summary())
    timer, jtimer = tracing.PhaseTimer(), jtracing.PhaseTimer()
    for timer_ in (timer, jtimer):
        timer_.totals.update({"fuse": 0.25, "embed": 1.5, "rank": 0.0625})
        timer_.counts.update({"fuse": 1, "embed": 3, "rank": 4})
    assert timer.summary() == jtimer.summary()
    assert timer.summary().splitlines()[0].startswith("embed ")


def test_entry_scores_the_pair_grid_on_the_cpu():
    """``entry`` at the JAX package's tiny shapes: [2, 4] finite scores
    (zero weights, so every score is the cls head's zero bias)."""
    vit = tcfg.ViTConfig(image_size=32, patch_size=16, hidden_size=32,
                         num_layers=2, num_heads=4)
    text = tcfg.TextEncoderConfig(vocab_size=128, hidden_size=32,
                                  num_layers=4, num_heads=4,
                                  intermediate_size=64, encoder_width=32,
                                  merge_mlp_from=2)
    fn, args = entry("cpu", tcfg.RerankerModelConfig(vit=vit, text=text,
                                                     text_len=8))
    out = fn(*args)
    assert out.shape == (2, 4) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert args[0].shape == (4, 32, 32, 3) and args[3].shape == (2, 8, 32)
