"""The port's trainer CLIs (``cli/stage1_train.py``, ``cli/stage2_train.py``)
and what they stand on, on the CPU.

- Against the JAX package: both trainers run one epoch on
  tests/test_trainers.py's tiny models and synthetic CIRR split, fp32,
  dropout 0, from the same reference-format ``--pretrained`` files (a
  position embedding of another grid, single-stream keys for stage II,
  keys neither stage has), once through the JAX CLI and once through the
  port's: epoch losses in train_metrics.csv within 1e-5 (the train-step
  parity tolerance), validation recalls equal, ``mean_r5_rs1`` within
  1e-4.
- Preemption and resume: SIGTERM after a step, then ``--resume``, gives
  the uninterrupted run's later step losses, final parameters and
  optimizer state bit for bit (fp32, dropout 0.1), inside an
  accumulation cycle too.
- The pieces: the AdamW state round trip, ``load_params`` on the port's
  checkpoint directories, remat 'dots' against '' and no remat (bit-equal
  in fp32), ``interpolate_pos_embed`` against ``jax.image.resize``, a
  single-stream pretrain into stage II against JAX's ``convert_stage2``,
  and the refused flags.
"""
import contextlib
import csv
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from _torch_port_train_data import (
    RecordingComet,
    trainer_flags,
    write_cirr,
)
from _torch_port_utils import f32, np_tree, port_cfg
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.models.blip_retrieval import (
    RetrievalModel as JRetrieval,
)
from candidate_reranking_cir_tpu.runtime import convert as jconvert
from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.cli import common
from candidate_reranking_cir_tpu_torch.cli import stage1_train, stage2_train
from candidate_reranking_cir_tpu_torch.models.dual_encoder import (
    DualStreamEncoder,
)
from candidate_reranking_cir_tpu_torch.models.med import TextEncoder
from candidate_reranking_cir_tpu_torch.models.vit import VisionTransformer
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.runtime import checkpoint as tckpt
from candidate_reranking_cir_tpu_torch.runtime.optim import AdamW
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    from_jax_params,
    interpolate_pos_embed,
    load_reference_state_dict,
    resize_matrix,
)

IMG, TEXT_LEN, B = 32, 10, 4
VIT = {"image_size": IMG, "patch_size": 8, "hidden_size": 24,
       "num_layers": 2, "num_heads": 4}
TEXT = {"vocab_size": 256, "hidden_size": 24, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 48, "encoder_width": 24,
        "merge_mlp_from": 1}
NO_DROPOUT = {"hidden_dropout": 0.0, "attention_dropout": 0.0}
LOSS_TOL, MEAN_TOL = 1e-5, 1e-4


def _model_config(path, **text):
    path.write_text(json.dumps({"vit": VIT, "text": {**TEXT, **text},
                                "embed_dim": 16}))
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = write_cirr(tmp_path_factory.mktemp("train_cli"))
    _model_config(root / "no_dropout.json", **NO_DROPOUT)
    _model_config(root / "dropout.json", hidden_dropout=0.1,
                  attention_dropout=0.1)
    return root


def _jax_stage1_cfg():
    return jcfg.RetrievalModelConfig(vit=jcfg.ViTConfig(**VIT),
                                     text=jcfg.TextEncoderConfig(**TEXT),
                                     embed_dim=16, text_len=TEXT_LEN)


def _pretrain_dicts():
    """Reference-format pretrains made from a JAX model's random weights:
    stage I with a 2 x 2 position-embedding grid (the model's is 4 x 4),
    stage II single-stream with a cls head; both with keys neither model
    has (the text decoder, momentum copies, BERT's position_ids)."""
    cfg = _jax_stage1_cfg()
    imgs = np.zeros((2, IMG, IMG, 3), np.float32)
    ids = np.ones((2, TEXT_LEN), np.int32)
    params = JRetrieval(cfg).init(jax.random.key(0), imgs, ids, ids)
    sd = jconvert.export_stage1(np_tree(params), cfg)
    rng = np.random.default_rng(1)
    d = TEXT["hidden_size"]
    sd["visual_encoder.pos_embed"] = rng.normal(
        0, 0.02, (1, 5, d)).astype(np.float32)
    extra = {"text_decoder.bert.embeddings.word_embeddings.weight":
             rng.normal(size=(8, d)).astype(np.float32),
             "visual_encoder_m.pos_embed": np.zeros((1, 5, d), np.float32),
             "text_proj_m.weight": np.zeros((16, d), np.float32),
             "text_encoder.embeddings.position_ids":
             np.arange(512, dtype=np.int64)[None]}
    s1 = {**sd, **extra}
    s2 = {k: v for k, v in s1.items()
          if not k.startswith(("vision_proj", "text_proj.", "temp"))}
    s2.update({"cls_head.0.weight": rng.normal(0, 0.02, (d, 2 * d)),
               "cls_head.0.bias": np.zeros(d),
               "cls_head.2.weight": rng.normal(0, 0.02, (2, d)),
               "cls_head.2.bias": np.zeros(2)})
    return s1, {k: np.asarray(v) for k, v in s2.items()}


def _save_pretrain(path, sd):
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    return path


@pytest.fixture(scope="module")
def pretrained(root):
    s1, s2 = _pretrain_dicts()
    return (_save_pretrain(root / "pretrain_s1.pth", s1),
            _save_pretrain(root / "pretrain_s2.pth", s2))


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def topk(root, pretrained):
    """The stage-I top-K file of the validation split (the port's
    validate CLI on the stage-I pretrain), read by both stage-II
    trainers."""
    from candidate_reranking_cir_tpu_torch.cli import validate

    path = root / "topk.npz"
    _quiet(validate.main, trainer_flags(root, IMG, root / "no_dropout.json")
           + ["--stage1-path", str(pretrained[0]), "--save-topk", "--k", "6",
              "--topk-out", str(path), "--batch-size", "4"])
    return path


def _train_args(root, name, out, epochs=1, config="no_dropout.json",
                device=None):
    return trainer_flags(root, IMG, root / config, device=device) + [
        "--experiment-name", name, "--output-dir", str(out),
        "--num-epochs", str(epochs), "--batch-size", str(B),
        "--blip-max-epoch", "2"]


@pytest.fixture(scope="module")
def stage1_runs(root, pretrained):
    from candidate_reranking_cir_tpu.cli import stage1_train as jstage1

    out = {}
    for side, main, device in (("jax", jstage1.main, None),
                               ("port", stage1_train.main, "cpu")):
        _quiet(main, _train_args(root, f"s1_{side}", root / "models",
                                 device=device)
               + ["--pretrained", str(pretrained[0])])
        out[side] = root / "models" / f"s1_{side}"
    return out


@pytest.fixture(scope="module")
def stage2_runs(root, pretrained, topk):
    from candidate_reranking_cir_tpu.cli import stage2_train as jstage2

    out = {}
    for side, main, device in (("jax", jstage2.main, None),
                               ("port", stage2_train.main, "cpu")):
        _quiet(main, _train_args(root, f"s2_{side}", root / "models",
                                 device=device)
               + ["--stage1-path", str(pretrained[0]),
                  "--pretrained", str(pretrained[1]),
                  "--top-k-path", str(topk), "--K-value", "4"])
        out[side] = root / "models" / f"s2_{side}"
    return out


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_trainer_matches_jax(stage, request):
    runs = request.getfixturevalue(f"{stage}_runs")
    jt, pt = (_read_csv(runs[s] / "train_metrics.csv")
              for s in ("jax", "port"))
    assert [r["epoch"] for r in pt] == [r["epoch"] for r in jt] == ["0"]
    jl, pl = (float(r[0]["train_epoch_loss"]) for r in (jt, pt))
    assert 0.3 < jl < 4.0                       # near ln(B) at random init
    assert abs(pl - jl) < LOSS_TOL, (pl, jl)
    jv, pv = (_read_csv(runs[s] / "validation_metrics.csv")
              for s in ("jax", "port"))
    assert len(jv) == len(pv) == 1 and jv[0].keys() == pv[0].keys()
    for key, want in jv[0].items():
        if key == "mean_r5_rs1":
            assert abs(float(pv[0][key]) - float(want)) < MEAN_TOL
        else:
            assert float(pv[0][key]) == float(want), key
    saved = runs["port"] / "saved_models"
    for name in ("blip_last", "blip_mean"):
        assert tckpt.is_checkpoint(saved / name)
    assert (runs["port"] / f"{runs['port'].name}.json").exists()


def _run(main, argv, kill_after=None, monkeypatch=None, module=None):
    comet = RecordingComet(kill_after)
    monkeypatch.setattr(module, "make_comet", lambda *a, **k: comet)
    text = _quiet(main, argv)
    return comet.losses, text


def _assert_same_state(a_dir, b_dir):
    a, b = (tckpt.read_train_state(d) for d in (a_dir, b_dir))
    assert a["step"] == b["step"]
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    oa, ob = a["opt_state"], b["opt_state"]
    assert (oa["count"], oa["mini_step"]) == (ob["count"], ob["mini_step"])
    for key in ("mu", "nu", "acc"):
        if oa[key] is None:
            assert ob[key] is None
            continue
        assert all(torch.equal(x, y) for x, y in zip(oa[key], ob[key])), key


@pytest.mark.parametrize("stage,accumulation,kill_after,kernel_route", [
    ("stage1", 1, 1, False),
    ("stage1", 2, 1, False),        # inside an accumulation cycle
    ("stage1", 2, 3, True),         # the second epoch's cycle, K8/K9 hash
    ("stage2", 1, 1, True),         # K6/K7 hash
])
def test_preemption_and_resume_are_exact(stage, accumulation, kill_after,
                                         kernel_route, root, pretrained,
                                         topk, tmp_path, monkeypatch):
    """Two epochs of two steps, attention and hidden dropout 0.1: the run
    preempted after ``kill_after`` steps and resumed gives the
    uninterrupted run's step losses, parameters and optimizer state bit
    for bit. ``kernel_route``: the kernels' thresholds lowered to 0, so
    the attention dropout is the kernels' hash (their plain versions
    here)."""
    if kernel_route:
        monkeypatch.setattr(tat, "MIN_KV", 0)
        monkeypatch.setattr(tat, "MIN_ROWS", 0)
    module = stage1_train if stage == "stage1" else stage2_train
    extra = ["--grad-accumulation-step", str(accumulation),
             "--validation-frequency", "100"]
    if stage == "stage2":
        extra += ["--stage1-path", str(pretrained[0]), "--top-k-path",
                  str(topk), "--K-value", "4"]

    def args(name):
        return _train_args(root, name, tmp_path, epochs=2,
                           config="dropout.json", device="cpu") + extra

    whole, _ = _run(module.main, args("whole"), monkeypatch=monkeypatch,
                    module=module)
    first, text = _run(module.main, args("cut"), kill_after, monkeypatch,
                       module)
    assert f"preempted (SIGTERM) at epoch {(kill_after - 1) // 2}" in text
    assert "training done" not in text
    rest, text = _run(module.main, args("cut") + ["--resume"],
                      monkeypatch=monkeypatch, module=module)
    assert "resumed from" in text and "training done" in text
    if kill_after % 2:
        assert f"skipping {kill_after % 2} already-applied batches" in text
    assert len(whole) == 4 and first + rest == whole
    assert len(set(whole)) == 4               # the steps differ
    saved = tmp_path / "{}" / "saved_models" / "blip_last"
    _assert_same_state(str(saved).format("whole"), str(saved).format("cut"))


def test_adamw_state_round_trip():
    """The state of an AdamW in the middle of an accumulation cycle, loaded
    into a fresh AdamW over a copy of the parameters: both continue bit
    for bit. A state of another accumulation or other shapes is
    refused."""
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(3, 4, generator=g, requires_grad=True),
              torch.randn(5, generator=g, requires_grad=True)]
    grads = [[torch.randn(p.shape, generator=g) for p in params]
             for _ in range(5)]

    def make(ps):
        return AdamW(ps, lambda n: 1e-2 / (n + 1), 0.05, accumulation=2)

    def micro(opt, ps, gs):
        opt.zero_grad()
        for p, gr in zip(ps, gs):
            p.grad = gr.clone()
        opt.step()

    opt = make(params)
    for gs in grads[:3]:
        micro(opt, params, gs)
    assert (opt.count, opt.mini_step, opt.micro_steps) == (1, 1, 3)
    state = opt.state_dict()
    copies = [p.detach().clone().requires_grad_() for p in params]
    fresh = make(copies)
    fresh.load_state_dict({k: ([t.clone() for t in v]
                               if isinstance(v, list) else v)
                           for k, v in state.items()})
    for gs in grads[3:]:
        micro(opt, params, gs)
        micro(fresh, copies, gs)
    assert (fresh.count, fresh.mini_step) == (opt.count, opt.mini_step)
    for a, b in zip(params, copies):
        assert torch.equal(a, b)
    for key in ("mu", "nu", "acc"):
        for a, b in zip(getattr(opt, key), getattr(fresh, key)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="accumulates"):
        AdamW(copies, lambda n: 1e-2, 0.05).load_state_dict(state)
    with pytest.raises(ValueError, match="does not fit"):
        make(copies[:1]).load_state_dict(state)


def test_load_params_reads_the_trainer_checkpoint(stage1_runs, tmp_path):
    """``load_params`` takes a checkpoint directory of the port's trainer
    (the parameters of its train state, the frozen ViT included) and
    still refuses another directory (an Orbax checkpoint) and URLs."""
    ckpt = stage1_runs["port"] / "saved_models" / "blip_mean"
    cfg = tcfg.RetrievalModelConfig(
        vit=tcfg.ViTConfig(**VIT),
        text=tcfg.TextEncoderConfig(**{**TEXT, **NO_DROPOUT}),
        embed_dim=16, text_len=TEXT_LEN)
    params = common.load_params(str(ckpt), 1, cfg)
    assert params.keys() == tckpt.read_train_state(ckpt)["params"].keys()
    assert any(k.startswith("visual_encoder.") for k in params)
    meta = json.loads((ckpt / "framework_metadata.json").read_text())
    assert meta == tckpt.read_train_state(ckpt)["metadata"]
    assert meta["epoch"] == 0 and "metric" in meta
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="export_checkpoint"):
        common.load_params(str(orbax), 1, cfg)
    with pytest.raises(NotImplementedError):
        common.load_params("https://example.invalid/ckpt", 1, cfg)
    with pytest.raises(TypeError):
        common.load_params(str(ckpt), 2, cfg)


def _remat_runs(build, forward, n_out):
    """Loss and gradients of ``forward(model)`` under no remat, remat ''
    and remat 'dots' (seed-0 weights each time), and the 'dots' policy."""
    runs = []
    w = torch.randn(n_out, generator=torch.Generator().manual_seed(9))
    for remat, policy in ((False, ""), (True, ""), (True, "dots")):
        torch.manual_seed(0)
        model = build(remat, policy)
        loss = (forward(model).float() * w).sum()
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()},
                     model.remat_policy))
    return runs


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("module", ["med", "dual", "vit"])
def test_remat_dots_matches_recompute_everything(module, kernel_route,
                                                 monkeypatch):
    """fp32, dropout on (hidden 0.1, attention 0.1, the ViT's stochastic
    depth 0.5): remat 'dots' and '' give the loss and gradients of no
    remat bit for bit. 'dots' keeps exactly the Dense products (one
    ``aten.mm`` each: 10 a MED layer with cross-attention, 20 a dual
    layer, 21 with its merge MLP, 6 a ViT block) and recomputes the rest,
    which '' recomputes as well. ``kernel_route``: the thresholds at 0, so
    attention runs the kernels' autograd Functions (plain versions)."""
    if kernel_route:
        monkeypatch.setattr(tat, "MIN_KV", 0)
        monkeypatch.setattr(tat, "MIN_ROWS", 0)
    g = torch.Generator().manual_seed(3)
    text = tcfg.TextEncoderConfig(**{**TEXT, "hidden_dropout": 0.1,
                                     "attention_dropout": 0.1,
                                     "merge_mlp_from": 1})
    ids = torch.randint(1, 250, (B, 8), generator=g)
    mask = torch.ones(B, 8)
    mask[1, 5:] = 0
    d = TEXT["hidden_size"]
    if module == "med":
        img = torch.randn(B, 17, d, generator=g)
        runs = _remat_runs(
            lambda r, p: TextEncoder(dataclasses.replace(
                text, remat=r, remat_policy=p), device="cpu"),
            lambda m: m(ids, mask, img, deterministic=False,
                        seeds=[[1, 2, 3]] * 3), d)
        per_call = 10 * 2
    elif module == "dual":
        z, cand = (torch.randn(3, 8, d, generator=g),
                   torch.randn(3, 17, d, generator=g))
        runs = _remat_runs(
            lambda r, p: DualStreamEncoder(dataclasses.replace(
                text, remat=r, remat_policy=p), device="cpu"),
            lambda m: m(ids[:3], mask[:3], z, cand, layout="shared",
                        deterministic=False, seeds=[[1, 2, 3, 4, 5]] * 3),
            2 * d)
        per_call = 20 + 21       # layer 0 averages, layer 1 merges
    else:
        images = torch.randn(2, IMG, IMG, 3, generator=g)
        runs = _remat_runs(
            lambda r, p: VisionTransformer(tcfg.ViTConfig(
                **VIT, drop_path_rate=0.5, remat=r, remat_policy=p),
                device="cpu"),
            lambda m: m(images, deterministic=False, seeds=[[1, 2]] * 3), d)
        per_call = 6 * 2
    (l0, g0, _), (l1, g1, none), (l2, g2, dots) = runs
    assert none is None and l0 == l1 == l2
    assert g0.keys() == g1.keys() == g2.keys()
    assert any(float(v.abs().max()) > 0 for v in g0.values() if v is not None)
    for name, want in g0.items():
        for got in (g1[name], g2[name]):
            assert (want is None and got is None) or torch.equal(got, want), \
                name
    assert dots.saved == per_call and dots.recomputed > 0


def test_remat_policy_names():
    from candidate_reranking_cir_tpu_torch.models.layers import (
        DotsPolicy,
        resolve_remat_policy,
    )

    assert resolve_remat_policy("") is None
    assert isinstance(resolve_remat_policy("dots"), DotsPolicy)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TextEncoder(tcfg.TextEncoderConfig(**TEXT, remat=True,
                                           remat_policy="offload"),
                    device="cpu")


def test_interpolate_pos_embed_matches_jax_resize():
    """14 x 14 -> 24 x 24 (a BLIP pretrain at 224 px into ViT-B/16 at 384):
    the separable weights are ``jax.image.resize``'s bicubic to 1e-12 in
    float64 (JAX with x64 on the same grid), and the port's function
    matches JAX's ``interpolate_pos_embed`` within 1e-6 on a pretrain-scale
    embedding (std 0.02), JAX's float32 rounding included."""
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(1, 14, 14, 8))
    with jax.enable_x64(True):
        want = np.asarray(jax.image.resize(jax.numpy.asarray(grid),
                                           (1, 24, 24, 8), "bicubic"))
    r = resize_matrix(14, 24)
    got = np.einsum("ai,bj,ijd->abd", r, r, grid[0])
    np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-12)
    pos = rng.normal(0, 0.02, (1, 197, 768)).astype(np.float32)
    out = interpolate_pos_embed(pos, 576)
    assert out.shape == (1, 577, 768) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, 0], pos[:, 0])
    np.testing.assert_allclose(out, jconvert.interpolate_pos_embed(pos, 576),
                               rtol=0, atol=1e-6)
    assert interpolate_pos_embed(pos, 196) is pos


def test_single_stream_pretrain_into_stage2_matches_jax():
    """A single-stream pretrain loaded for stage II: both streams from the
    one stream's weights, the merge layers zero, the pos-embed resized,
    the extra keys ignored, equal to JAX's ``convert_stage2`` of the same
    dict after ``from_jax_params``."""
    _, sd = _pretrain_dicts()
    jcfg2 = jcfg.RerankerModelConfig(vit=jcfg.ViTConfig(**VIT),
                                     text=jcfg.TextEncoderConfig(**TEXT),
                                     text_len=TEXT_LEN)
    want = from_jax_params(jconvert.convert_stage2(dict(sd), jcfg2),
                           port_cfg(jcfg2))
    got = load_reference_state_dict(sd, port_cfg(jcfg2))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(f32(got[k]), f32(v), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert not got["text_encoder.layers.1.merge.weight"].any()
    assert torch.equal(got["text_encoder.layers.0.self_attn0.query.weight"],
                       got["text_encoder.layers.0.self_attn1.query.weight"])


def test_trainer_refusals(root, pretrained, topk, monkeypatch):
    """--fsdp is ported: it parses on both trainers (on one process it is
    the JAX trainers' one-device mesh: nothing to shard). What stays
    refused: an unknown dataset; without --device the trainers run on the
    card, so without one they raise; a rank's loader refuses a batch that
    does not split over the ranks."""
    s2 = ["--stage1-path", str(pretrained[0]), "--top-k-path", str(topk),
          "--K-value", "4"]
    for module, extra in ((stage1_train, []), (stage2_train, s2)):
        argv = _train_args(root, "x", root / "refused", device="cpu") + extra
        args = module.parse_args(argv + ["--fsdp"])
        assert args.fsdp and stage1_train.check_train_args(args) == "cirr"
        args.dataset = "COCO"
        with pytest.raises(ValueError, match="CIRR"):
            stage1_train.check_train_args(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, extra in ((stage1_train.main, []), (stage2_train.main, s2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(_train_args(root, "x", root / "refused") + extra)
    from candidate_reranking_cir_tpu_torch.data.loader import BatchLoader

    with pytest.raises(ValueError, match="splits"):
        BatchLoader(list(range(12)), 6, shard=(0, 4))


def test_cached_targets_match_embedding_them(root, tmp_path):
    """The stage-I target-feature cache (the default with a frozen ViT)
    gives the epoch loss of embedding the targets in every step."""
    losses = []
    for name, extra in (("cache", []),
                        ("plain", ["--no-cache-target-features"])):
        _quiet(stage1_train.main, _train_args(root, name, tmp_path,
                                              device="cpu")
               + ["--validation-frequency", "5"] + extra)
        losses.append(float(_read_csv(tmp_path / name / "train_metrics.csv")
                            [0]["train_epoch_loss"]))
    assert abs(losses[0] - losses[1]) < LOSS_TOL, losses


def test_stage2_blip_img_tune_trains_the_vit(root, pretrained, topk,
                                             tmp_path):
    """--blip-img-tune: the stage-II ViT trains (remat 'dots' with
    stochastic depth) and is saved changed; without it, it stays the
    pretrain's."""
    states = {}
    for name, extra in (("frozen", []), ("tuned", ["--blip-img-tune"])):
        _quiet(stage2_train.main, _train_args(root, name, tmp_path,
                                              device="cpu")
               + ["--stage1-path", str(pretrained[0]), "--pretrained",
                  str(pretrained[1]), "--top-k-path", str(topk),
                  "--K-value", "4"] + extra)
        states[name] = tckpt.read_train_state(
            tmp_path / name / "saved_models" / "blip_last")
    vit = [k for k in states["frozen"]["params"]
           if k.startswith("visual_encoder.")]
    frozen, tuned = states["frozen"]["params"], states["tuned"]["params"]
    assert all(not torch.equal(frozen[k], tuned[k]) for k in vit)
    n_frozen = len(states["frozen"]["opt_state"]["mu"])
    assert len(states["tuned"]["opt_state"]["mu"]) == n_frozen + len(vit)


def test_fashioniq_trainers_and_resume(tmp_path, monkeypatch):
    """Both trainers on a Fashion-IQ split (three categories): stage I with
    its target cache, validating each category and saving ``blip``;
    validate writes the per-category top-K files stage II reads through
    '{dress}'. A stage-I run preempted after its first step and resumed
    gives the uninterrupted run's step losses bit for bit, the random
    caption compositions included (dropout 0.1)."""
    from _torch_port_train_data import write_fiq

    from candidate_reranking_cir_tpu_torch.cli import validate

    root = write_fiq(tmp_path)
    config = _model_config(tmp_path / "dropout.json", hidden_dropout=0.1,
                           attention_dropout=0.1)
    flags = ["--dataset", "fashionIQ", "--data-root", str(root),
             "--allow-test-vocab", "--image-size", str(IMG), "--text-len",
             "16", "--model-config", str(config), "--device", "cpu",
             "--no-bf16"]
    train = flags + ["--output-dir", str(tmp_path / "models"),
                     "--num-epochs", "2", "--batch-size", str(B),
                     "--blip-max-epoch", "2", "--validation-frequency", "1"]
    runs = {}
    for name, kill in (("whole", None), ("cut", 3)):
        runs[name], text = _run(stage1_train.main, train + [
            "--experiment-name", name], kill, monkeypatch, stage1_train)
    assert "preempted (SIGTERM) at epoch 0" in text
    rest, text = _run(stage1_train.main, train + [
        "--experiment-name", "cut", "--resume"], monkeypatch=monkeypatch,
        module=stage1_train)
    assert "skipping 3 already-applied batches" in text
    assert len(runs["whole"]) == 12 and runs["cut"] + rest == runs["whole"]
    exp = tmp_path / "models" / "whole"
    val = _read_csv(exp / "validation_metrics.csv")
    assert len(val) == 2 and "dress_recall_at10" in val[0] \
        and "average_recall" in val[0]
    ckpt = exp / "saved_models" / "blip"
    assert tckpt.is_checkpoint(ckpt)
    _assert_same_state(exp / "saved_models" / "blip_last",
                       tmp_path / "models" / "cut" / "saved_models"
                       / "blip_last")

    _quiet(validate.main, flags + [
        "--stage1-path", str(ckpt), "--save-topk", "--k", "6",
        "--topk-out", str(tmp_path / "top.npz"), "--batch-size", "4"])
    losses, text = _run(stage2_train.main, train + [
        "--experiment-name", "s2", "--num-epochs", "1", "--stage1-path",
        str(ckpt), "--top-k-path", str(tmp_path / "top_{dress}.npz"),
        "--K-value", "4"], monkeypatch=monkeypatch, module=stage2_train)
    assert len(losses) == 6 and np.isfinite(losses).all()
    val = _read_csv(tmp_path / "models" / "s2" / "validation_metrics.csv")
    assert "average_recall" in val[0]
    assert tckpt.is_checkpoint(tmp_path / "models" / "s2" / "saved_models"
                               / "blip")
