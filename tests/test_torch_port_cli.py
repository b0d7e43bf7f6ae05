"""The port's four evaluation CLIs on the CPU (``--device cpu``), on a
synthetic CIRR val/test1 split and a synthetic Fashion-IQ val split with
tiny models (``--model-config``) and the toy vocabulary, as
tests/test_cli.py drives the JAX CLIs.

The checkpoints are the port's own random weights written in the
reference's format (``runtime/convert.py``). Each CLI's output is checked
against the port's engines called directly on the same weights: validate
-> the top-K file and the printed metrics; validate_stage2 over that file;
the stage-I test1 submission and its top-K file; the stage-II submission
re-ranking it. Also the common helpers: ``--device``,
``--fused-attention``, ``load_params``' refusals.
"""
import json

import numpy as np
import pytest
import torch

from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.cli import common
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    make_transform,
)
from candidate_reranking_cir_tpu_torch.data.topk_io import load_topk_file
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.models.tokenizer import (
    WordPieceTokenizer,
    build_test_vocab,
    load_tokenizer,
)
from candidate_reranking_cir_tpu_torch.retrieval import metrics as M
from candidate_reranking_cir_tpu_torch.retrieval import validate2_engine as v2
from candidate_reranking_cir_tpu_torch.retrieval import validate_engine as v1
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
    rerank_candidate_major,
)
from candidate_reranking_cir_tpu_torch.runtime.convert import (
    export_stage1,
    export_stage2,
    save_torch_checkpoint,
)

IMG, TEXT_LEN, N_IMAGES, N_QUERIES = 32, 12, 12, 8
MODEL_CONFIG = {
    "vit": {"image_size": IMG, "patch_size": 8, "hidden_size": 24,
            "num_layers": 2, "num_heads": 4},
    "text": {"vocab_size": 256, "hidden_size": 24, "num_layers": 2,
             "num_heads": 4, "intermediate_size": 48, "encoder_width": 24,
             "hidden_dropout": 0.0, "attention_dropout": 0.0,
             "merge_mlp_from": 1},
    "embed_dim": 16,
}
WORDS = ("the", "a", "red", "blue", "dog", "cat", "dress", "shirt", "with")


def _jpg(path, rng):
    import PIL.Image

    PIL.Image.fromarray(rng.integers(0, 255, size=(40, 36, 3),
                                     dtype=np.uint8)).save(path)


def make_workdir(root, model_config: dict, text_len: int = TEXT_LEN):
    """Synthetic CIRR (val + test1) and Fashion-IQ (val, three types)
    splits under ``root``, the model config, and two checkpoints of the
    port's random weights (seed 0) in the reference's format. Returns
    (stage-I model, stage-II model) on the CPU, holding those weights."""
    rng = np.random.default_rng(0)
    base = root / "cirr_dataset"
    (base / "cirr" / "captions").mkdir(parents=True)
    (base / "cirr" / "image_splits").mkdir(parents=True)
    (base / "img").mkdir()
    names = [f"im{i}" for i in range(N_IMAGES)]
    for name in names:
        _jpg(base / "img" / f"{name}.jpg", rng)
    for split in ("val", "test1"):
        triplets = []
        for q in range(N_QUERIES):
            ref, tgt = names[q // 2], names[(q // 2 + 3 + q) % N_IMAGES]
            members = [ref, tgt] + [n for n in names
                                    if n not in (ref, tgt)][q % 6:q % 6 + 4]
            t = {"pairid": 100 + q, "reference": ref,
                 "caption": " ".join(rng.choice(WORDS, size=1 + q % 5)),
                 "img_set": {"members": members}}
            if split != "test1":
                t["target_hard"] = tgt
            triplets.append(t)
        with open(base / "cirr" / "captions" / f"cap.rc2.{split}.json",
                  "w") as f:
            json.dump(triplets, f)
        with open(base / "cirr" / "image_splits" / f"split.rc2.{split}.json",
                  "w") as f:
            json.dump({n: f"img/{n}.jpg" for n in names}, f)

    fiq = root / "fashionIQ_dataset"
    for sub in ("captions", "image_splits", "images"):
        (fiq / sub).mkdir(parents=True)
    for dress in ("dress", "shirt", "toptee"):
        fnames = [f"{dress}{i}" for i in range(6)]
        for n in fnames:
            _jpg(fiq / "images" / f"{n}.jpg", rng)
        caps = [{"candidate": fnames[q // 2], "target": fnames[(q + 2) % 6],
                 "captions": ["is red.", f"with a {WORDS[q]}"]}
                for q in range(5)]
        with open(fiq / "captions" / f"cap.{dress}.val.json", "w") as f:
            json.dump(caps, f)
        with open(fiq / "image_splits" / f"split.{dress}.val.json",
                  "w") as f:
            json.dump(fnames, f)

    (root / "model_config.json").write_text(json.dumps(model_config))
    vit = tcfg.ViTConfig(**model_config["vit"])
    text = tcfg.TextEncoderConfig(**model_config["text"])
    torch.manual_seed(0)
    s1 = RetrievalModel(tcfg.RetrievalModelConfig(
        vit=vit, text=text, embed_dim=model_config["embed_dim"],
        text_len=text_len), device="cpu")
    s2 = RerankerModel(tcfg.RerankerModelConfig(
        vit=vit, text=text, text_len=text_len), device="cpu")
    save_torch_checkpoint(root / "s1.pt", export_stage1(s1.state_dict()),
                          "BLIP_Retrieval")
    save_torch_checkpoint(root / "s2.pt", export_stage2(s2.state_dict()),
                          "BLIP_NLVR")
    return s1.eval(), s2.eval()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cliroot")
    return (root, *make_workdir(root, MODEL_CONFIG))


def common_flags(root, image_size: int, dataset: str = "CIRR",
                 device: str = "cpu"):
    return ["--dataset", dataset, "--data-root", str(root),
            "--allow-test-vocab", "--image-size", str(image_size),
            "--text-len", str(TEXT_LEN), "--device", device,
            "--model-config", str(root / "model_config.json")]


def _common(root, dataset="CIRR"):
    return common_flags(root, IMG, dataset) + ["--no-bf16"]


def _as_printed(metrics: dict) -> dict:
    return {k: float(f"{v:.2f}") for k, v in metrics.items()}


def _printed(out: str) -> dict:
    return {k: float(v) for k, v in
            (line.split(" = ") for line in out.splitlines() if " = " in line)}


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(build_test_vocab())


def _cirr(root, split, mode, **kw):
    return CIRRDataset(root, split, mode, make_transform("targetpad", IMG),
                       **kw)


def test_validate_then_validate_stage2(workdir, tok, capsys):
    from candidate_reranking_cir_tpu_torch.cli import validate, \
        validate_stage2

    root, s1, s2 = workdir
    topk = root / "cirr_topk_val.npz"
    validate.main(_common(root) + [
        "--stage1-path", str(root / "s1.pt"), "--save-topk", "--k", "8",
        "--topk-out", str(topk), "--batch-size", "4", "--q-batch", "4"])
    printed = _printed(capsys.readouterr().out)
    res, payload = v1.evaluate_cirr_stage1(
        s1, None, _cirr(root, "val", "classic"),
        _cirr(root, "val", "relative"), tok, text_len=TEXT_LEN, batch_size=4,
        save_topk_k=8, q_batch=4, device="cpu")
    assert printed == _as_printed(res.metrics)
    saved = load_topk_file(topk)
    assert saved.keys() == payload.keys()
    for key in payload:
        np.testing.assert_array_equal(saved[key], payload[key])

    validate_stage2.main(_common(root) + [
        "--stage1-path", str(root / "s1.pt"),
        "--stage2-path", str(root / "s2.pt"),
        "--top-k-path", str(topk), "--K-value", "4", "--q-batch", "4"])
    printed = _printed(capsys.readouterr().out)
    mets = v2.evaluate_cirr_stage2(
        s1, None, s2, None, tok, data_root=root,
        transform=make_transform("targetpad", IMG), top_k_path=topk, k=4,
        text_len=TEXT_LEN, device="cpu")
    assert printed.pop("recall_mean") == _as_printed(mets)["mean_r5_rs1"]
    assert printed == _as_printed(mets)


def test_validate_fashioniq_then_stage2(workdir, tok, capsys):
    from candidate_reranking_cir_tpu_torch.cli import validate, \
        validate_stage2

    root, s1, s2 = workdir
    validate.main(_common(root, "fashionIQ") + [
        "--stage1-path", str(root / "s1.pt"), "--save-topk", "--k", "4",
        "--topk-out", str(root / "fiq_top.npz"), "--batch-size", "4"])
    out = capsys.readouterr().out
    assert "average recall10 =" in out
    for dress in ("shirt", "dress", "toptee"):
        classic, relative = (
            FashionIQDataset(root, "val", [dress], mode,
                             make_transform("targetpad", IMG))
            for mode in ("classic", "relative"))
        _, payload = v1.evaluate_fiq_stage1(
            s1, None, classic, relative, tok, text_len=TEXT_LEN,
            batch_size=4, save_topk_k=4, dress_types=[dress], device="cpu")
        saved = load_topk_file(root / f"fiq_top_{dress}.npz")
        for key in payload:
            np.testing.assert_array_equal(saved[key], payload[key])

    validate_stage2.main(_common(root, "fashionIQ") + [
        "--stage1-path", str(root / "s1.pt"),
        "--stage2-path", str(root / "s2.pt"),
        "--top-k-path", str(root / "fiq_top_{dress}.npz"), "--K-value", "4"])
    printed = _printed(capsys.readouterr().out)
    mets = v2.evaluate_fiq_stage2(
        s1, None, s2, None, tok, data_root=root,
        transform=make_transform("targetpad", IMG),
        top_k_path=root / "fiq_top_DTYPE.npz", k=4, text_len=TEXT_LEN,
        device="cpu")
    assert printed == _as_printed(mets)


def test_submissions(workdir, tok):
    from candidate_reranking_cir_tpu_torch.cli import (
        cirr_test_submission,
        cirr_test_submission_stage2,
    )

    root, s1, s2 = workdir
    sub_dir, topk = root / "submission", root / "cirr_topk_test1.npz"
    cirr_test_submission.main(_common(root) + [
        "--stage1-path", str(root / "s1.pt"),
        "--submission-name", "s1", "--out-dir", str(sub_dir),
        "--save-topk", "--k", "4", "--topk-out", str(topk),
        "--batch-size", "4"])
    sub = json.loads((sub_dir / "recall_submission_s1.json").read_text())
    subset = json.loads(
        (sub_dir / "recall_subset_submission_s1.json").read_text())
    assert sub.pop("version") == subset.pop("version") == "rc2"
    assert (sub.pop("metric"), subset.pop("metric")) == ("recall",
                                                         "recall_subset")

    # the engine's ranking of the same queries: the reference removed
    classic, relative = (_cirr(root, "test1", m) for m in ("classic",
                                                             "relative"))
    samples = [relative[i] for i in range(len(relative))]
    embed, fuse = v1.make_stage1_fns(s1, None, "cpu")
    raw, pooled, names = build_index(classic, embed, 4, pooled=True,
                                     device="cpu")
    pred = v1.predict_queries(fuse, tok, [s["caption"] for s in samples],
                              [s["reference_name"] for s in samples], raw,
                              names, TEXT_LEN, 4)
    full = M.rank_names(v1.full_ranking(pred, pooled), names)
    for s, row in zip(samples, full):
        ranked = [n for n in row if n != s["reference_name"]]
        assert sub[str(s["pair_id"])] == ranked[:50]
        members = [m for m in s["group_members"]
                   if m != s["reference_name"]][:5]
        assert subset[str(s["pair_id"])] == [n for n in ranked
                                             if n in members][:3]
    saved = load_topk_file(topk)
    assert saved["split"] == "test1" and saved["index_names"] == names
    np.testing.assert_array_equal(
        saved["sorted_index_names"],
        np.asarray([sub[str(s["pair_id"])][:4] for s in samples]))

    cirr_test_submission_stage2.main(_common(root) + [
        "--stage1-path", str(root / "s1.pt"),
        "--stage2-path", str(root / "s2.pt"),
        "--top-k-path", str(topk), "--K-value", "4",
        "--submission-name", "s2", "--out-dir", str(sub_dir),
        "--batch-size", "4"])
    sub2 = json.loads((sub_dir / "recall_submission_s2.json").read_text())
    bank, names2 = build_index(classic, s2.embed_images, 4, device="cpu")
    out = rerank_candidate_major(
        s1, None, s2, None, tok,
        captions=[s["caption"] for s in samples],
        reference_names=[s["reference_name"] for s in samples],
        topk_names=saved["sorted_index_names"], index_feats=bank,
        index_names=names2, text_len=TEXT_LEN,
        group_members=[s["group_members"] for s in samples], device="cpu")
    for s, row, order in zip(samples, saved["sorted_index_names"],
                             out.order):
        assert sub2[str(s["pair_id"])] == [str(row[j]) for j in order]
        assert set(sub2[str(s["pair_id"])]) == set(sub[str(s["pair_id"])][:4])


def test_unported_flags_raise(workdir, tok, capsys, monkeypatch, tmp_path):
    from candidate_reranking_cir_tpu_torch.cli import (
        cirr_test_submission,
        cirr_test_submission_stage2,
        validate,
        validate_stage2,
    )
    from candidate_reranking_cir_tpu_torch.data.topk_io import save_topk_file

    root, s1_model, _ = workdir
    s1 = ["--stage1-path", str(root / "s1.pt")]
    both = s1 + ["--stage2-path", str(root / "s2.pt"), "--top-k-path", "x"]
    # --single-program is ported: the same printed metrics as without it
    printed = []
    for flag in ([], ["--single-program"]):
        validate.main(_common(root) + s1 + ["--q-batch", "4"] + flag)
        printed.append(_printed(capsys.readouterr().out))
    assert printed[0] == printed[1] and printed[0]
    # ... and refused by the parser with a mesh, as in JAX
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit):
        validate.main(common_flags(root, IMG, device="cuda") + s1
                      + ["--single-program", "--mesh", "auto"])
    monkeypatch.undo()
    with pytest.raises(SystemExit):  # refused by the parser, as in JAX
        validate_stage2.main(_common(root) + both + ["--shard-index",
                                                     "--index-int8"])
    # --shard-index is ported; without a mesh it has no effect, as in the
    # JAX CLIs: the same printed metrics and submissions as without it
    _, payload = v1.evaluate_cirr_stage1(
        s1_model, None, _cirr(root, "val", "classic"),
        _cirr(root, "val", "relative"), tok, text_len=TEXT_LEN, batch_size=4,
        save_topk_k=8, device="cpu")
    save_topk_file(tmp_path / "top.npz", payload)
    both[-1] = str(tmp_path / "top.npz")
    printed = []
    for flag in ([], ["--shard-index"]):
        validate_stage2.main(_common(root) + both + ["--K-value", "4"] + flag)
        printed.append(_printed(capsys.readouterr().out))
    assert printed[0] == printed[1] and printed[0]
    topk1 = tmp_path / "top_test1.npz"
    cirr_test_submission.main(_common(root) + s1 + [
        "--submission-name", "t", "--out-dir", str(tmp_path / "stage1"),
        "--save-topk", "--k", "4", "--topk-out", str(topk1),
        "--batch-size", "4"])
    sub = []
    for flag in ([], ["--shard-index"]):
        out = tmp_path / f"sub{len(sub)}"
        cirr_test_submission_stage2.main(
            _common(root) + s1 + ["--stage2-path", str(root / "s2.pt"),
                                  "--top-k-path", str(topk1),
                                  "--K-value", "4",
                                  "--submission-name", "x", "--out-dir",
                                  str(out)] + flag)
        sub.append(sorted(p.read_text() for p in out.glob("*.json")))
    assert sub[0] == sub[1] and sub[0]


def test_validate_stage2_query_major_int8(workdir, tok, capsys, tmp_path):
    """``--schedule query_major --q-batch 3 --index-int8`` through the
    CLI gives the engine's metrics with the same options."""
    from candidate_reranking_cir_tpu_torch.cli import validate_stage2
    from candidate_reranking_cir_tpu_torch.data.topk_io import save_topk_file

    root, s1, s2 = workdir
    _, payload = v1.evaluate_cirr_stage1(
        s1, None, _cirr(root, "val", "classic"),
        _cirr(root, "val", "relative"), tok, text_len=TEXT_LEN, batch_size=4,
        save_topk_k=8, device="cpu")
    topk = tmp_path / "top.npz"
    save_topk_file(topk, payload)
    validate_stage2.main(_common(root) + [
        "--stage1-path", str(root / "s1.pt"),
        "--stage2-path", str(root / "s2.pt"), "--top-k-path", str(topk),
        "--K-value", "4", "--schedule", "query_major", "--q-batch", "3",
        "--index-int8"])
    printed = _printed(capsys.readouterr().out)
    mets = v2.evaluate_cirr_stage2(
        s1, None, s2, None, tok, data_root=root,
        transform=make_transform("targetpad", IMG), top_k_path=topk, k=4,
        text_len=TEXT_LEN, schedule="query_major", q_batch=3,
        index_int8=True, device="cpu")
    assert printed.pop("recall_mean") == _as_printed(mets)["mean_r5_rs1"]
    assert printed == _as_printed(mets)


def _args(*extra):
    import argparse

    parser = common.add_common_flags(argparse.ArgumentParser())
    return parser.parse_args(["--dataset", "CIRR", *extra])


def test_device_flag(monkeypatch):
    assert _args().device == "cuda"
    assert common.get_device(_args("--device", "cpu",
                                   "--fused-attention", "off")).type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        common.get_device(_args())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert common.get_device(_args("--fused-attention", "on")).type == "cuda"
    with pytest.raises(NotImplementedError, match="fused-attention"):
        common.get_device(_args("--fused-attention", "off"))
    # several cards: --mesh auto runs over them (one rank a card, started
    # by run_ranks), --mesh off and the CPU stay on one device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert common.get_device(_args()).type == "cuda"
    assert common.mesh_requested(_args())
    assert not common.mesh_requested(_args("--mesh", "off"))
    assert not common.mesh_requested(_args("--device", "cpu"))
    assert common.get_mesh(_args()) is None  # no process group here
    assert common.get_device(_args("--mesh", "off")).type == "cuda"


def test_load_params(workdir, tmp_path):
    root, s1, _ = workdir
    cfg1 = s1.cfg
    loaded = common.load_params(str(root / "s1.pt"), 1, cfg1)
    assert loaded.keys() == s1.state_dict().keys()
    assert all(torch.equal(loaded[k], v) for k, v in s1.state_dict().items())
    with pytest.raises(ValueError, match="export_checkpoint"):
        common.load_params(str(tmp_path), 1, cfg1)
    with pytest.raises(NotImplementedError):
        common.load_params("https://example.invalid/ckpt.pth", 1, cfg1)
    with pytest.raises(TypeError):
        common.load_params(str(root / "s1.pt"), 2, cfg1)


def test_small_helpers(workdir, tok, capsys):
    root = workdir[0]
    assert common.parse_l_buckets("auto") == "auto"
    assert common.parse_l_buckets("off") is None
    assert common.parse_l_buckets("16,24,40") == (16, 24, 40)
    common.print_metrics({"recall_at1": 12.345, "x": 1.0})
    assert capsys.readouterr().out == "recall_at1 = 12.35\nx = 1.00\n"
    common.prescan_captions(tok, _cirr(root, "val", "relative"), TEXT_LEN,
                            "cirr")
    fiq = FashionIQDataset(root, "val", ["dress"], "relative")
    common.prescan_captions(tok, fiq, TEXT_LEN, "fashioniq")
    with pytest.raises(ValueError, match="exceed"):
        common.prescan_captions(tok, fiq, 6, "fashioniq")
    args = _args("--vocab", str(root / "missing.txt"))
    with pytest.raises(FileNotFoundError):
        common.get_tokenizer(args)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(build_test_vocab()) + "\n")
    loaded = common.get_tokenizer(_args("--vocab", str(vocab)))
    # the native tokenizer where native/libwordpiece.so is built: the same
    # ids and masks as the Python one
    caps = [t["caption"] for t in _cirr(root, "val", "relative").triplets]
    for got, want in zip(loaded.encode(caps, TEXT_LEN),
                         tok.encode(caps, TEXT_LEN)):
        np.testing.assert_array_equal(got, want)
    assert load_tokenizer(vocab, prefer_native=False).vocab == tok.vocab


def test_entry_points_require_cuda_by_default(workdir, monkeypatch):
    from candidate_reranking_cir_tpu_torch.cli import (
        cirr_test_submission,
        cirr_test_submission_stage2,
        validate,
        validate_stage2,
    )

    root, _, _ = workdir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (v1.evaluate_cirr_stage1, v1.evaluate_fiq_stage1):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(None, None, [], [], None, text_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        v2.evaluate_fiq_stage2(None, None, None, None, None, data_root="",
                               transform=None, top_k_path="", k=1,
                               text_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        v1.make_stage1_fns(None)
    on_card = [a for a in _common(root) if a not in ("--device", "cpu")]
    s1 = ["--stage1-path", str(root / "s1.pt")]
    both = s1 + ["--stage2-path", str(root / "s2.pt"), "--top-k-path", "x"]
    for main, extra in ((validate.main, s1),
                        (validate_stage2.main, both),
                        (cirr_test_submission.main,
                         s1 + ["--submission-name", "x"]),
                        (cirr_test_submission_stage2.main,
                         both + ["--submission-name", "x"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(on_card + extra)
