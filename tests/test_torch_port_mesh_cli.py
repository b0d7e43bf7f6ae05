"""The port's CLIs at four gloo ranks on the CPU, against the same CLIs in
one process (no JAX: the one-process CLIs are held to JAX's by
tests/test_torch_port_train_cli.py and tests/test_torch_port_cli.py).

The synthetic CIRR tree of the trainer tests (8 train triplets, B = 4:
two steps an epoch), attention and hidden dropout 0.1. One world of four
ranks runs, in turn:
- ``cli/stage1_train --fsdp`` and ``cli/stage2_train --fsdp``, one epoch
  with validation: epoch losses within 1e-5 of one process's, every step
  loss too, and the checkpoints in the one-process format;
- ``cli/validate --save-topk``: the same top-K file (every ranked
  column);
- ``cli/stage1_train --fsdp`` over two epochs, sent SIGTERM on rank 0
  after its first step: every rank stops at that step (the checkpoint
  records one applied batch), and a one-process ``--resume`` from the
  four-rank checkpoint finishes the run with the uninterrupted
  one-process run's step losses (1e-5) and parameters (3e-5).
"""
import csv

import numpy as np
import pytest

import _torch_port_mesh_worker as worker
from _torch_port_train_data import RecordingComet, trainer_flags, write_cirr
from candidate_reranking_cir_tpu_torch.cli import (
    stage1_train,
    stage2_train,
    validate,
)
from candidate_reranking_cir_tpu_torch.data.topk_io import load_topk_file
from candidate_reranking_cir_tpu_torch.parallel.launch import run_world
from candidate_reranking_cir_tpu_torch.runtime import checkpoint as tckpt

WORLD, IMG, B = 4, 32, 4
MODEL = ('{"vit": {"image_size": 32, "patch_size": 8, "hidden_size": 24, '
         '"num_layers": 2, "num_heads": 4}, "text": {"vocab_size": 256, '
         '"hidden_size": 24, "num_layers": 2, "num_heads": 4, '
         '"intermediate_size": 48, "encoder_width": 24, "merge_mlp_from": 1, '
         '"hidden_dropout": 0.1, "attention_dropout": 0.1}, '
         '"embed_dim": 16}')
S1, S2, VAL, CUT = (f"candidate_reranking_cir_tpu_torch.cli.{m}" for m in (
    "stage1_train", "stage2_train", "validate", "stage1_train"))


def _flags(root):
    return trainer_flags(root, IMG, root / "model.json")


def _train(root, out, name, epochs=1, extra=()):
    return _flags(root) + [
        "--experiment-name", name, "--output-dir", str(out),
        "--num-epochs", str(epochs), "--batch-size", str(B),
        "--blip-max-epoch", "2", "--fsdp", *extra]


def _s2_extra(root):
    return ["--stage1-path", str(root / "models" / "s1_one" /
                                 "saved_models" / "blip_last"),
            "--top-k-path", str(root / "top_one.npz"), "--K-value", "4"]


def _validate(root, out):
    return _flags(root) + ["--stage1-path", str(
        root / "models" / "s1_one" / "saved_models" / "blip_last"),
                           "--save-topk", "--k", "6", "--topk-out",
                           str(out), "--batch-size", "4"]


def _one(module, argv, kill_after=None):
    """``module.main(argv)`` in this process, a trainer logging its step
    losses to a Comet stand-in; returns them."""
    comet = RecordingComet(kill_after)
    with pytest.MonkeyPatch.context() as mp:
        if hasattr(module, "make_comet"):
            mp.setattr(module, "make_comet", lambda *a, **k: comet)
        module.main(argv)
    return comet.losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = write_cirr(tmp_path_factory.mktemp("mesh_cli"))
    (root / "model.json").write_text(MODEL)
    out = root / "models"
    # one process: stage I (its checkpoint is stage II's stage-I model and
    # the validation's), its top-K file, stage II, the two-epoch run
    one = {"s1": _one(stage1_train, _train(root, out, "s1_one"))}
    _one(validate, _validate(root, root / "top_one.npz"))
    one["s2"] = _one(stage2_train, _train(root, out, "s2_one",
                                          extra=_s2_extra(root)))
    one["whole"] = _one(stage1_train, _train(
        root, out, "whole_one", epochs=2,
        extra=["--validation-frequency", "100"]))
    four = run_world(worker.run_clis, WORLD, device="cpu", args=([
        (S1, _train(root, out, "s1_four"), None),
        (S2, _train(root, out, "s2_four", extra=_s2_extra(root)), None),
        (VAL, _validate(root, root / "top_four.npz"), None),
        (CUT, _train(root, out, "cut_four", epochs=2,
                     extra=["--validation-frequency", "100"]), 1),
    ],), timeout_s=180)[0]
    cut = tckpt.read_train_state(out / "cut_four" / "saved_models" /
                                 "blip_last")
    resumed = _one(stage1_train, _train(
        root, out, "cut_four", epochs=2,
        extra=["--validation-frequency", "100", "--resume"]))
    return {"root": root, "one": one,
            "four": dict(zip(("s1", "s2", "val", "cut"), four)),
            "cut": cut, "resumed": resumed}


def _epoch_losses(path):
    with open(path / "train_metrics.csv") as f:
        return [float(r["train_epoch_loss"]) for r in csv.DictReader(f)]


@pytest.mark.parametrize("stage", ["s1", "s2"])
def test_fsdp_trainers_match_one_process(runs, stage):
    out = runs["root"] / "models"
    one, four = runs["one"][stage], runs["four"][stage]
    assert len(one) == len(four) == 2 and len(set(one)) == 2
    np.testing.assert_allclose(four, one, atol=1e-5)
    np.testing.assert_allclose(_epoch_losses(out / f"{stage}_four"),
                               _epoch_losses(out / f"{stage}_one"),
                               atol=1e-5)
    for name in ("blip_last", "blip_mean"):
        a, b = (tckpt.read_train_state(out / f"{stage}_{side}" /
                                       "saved_models" / name)
                for side in ("one", "four"))
        assert a["step"] == b["step"] == 2
        assert a["params"].keys() == b["params"].keys()
        for key in ("mu", "nu"):  # gathered: the one-process shapes
            assert [t.shape for t in a["opt_state"][key]] == \
                [t.shape for t in b["opt_state"][key]]
        for k in a["params"]:
            np.testing.assert_allclose(b["params"][k].numpy(),
                                       a["params"][k].numpy(), atol=3e-5,
                                       err_msg=k)


def test_validate_at_four_ranks(runs):
    root = runs["root"]
    one, four = (load_topk_file(root / f"top_{side}.npz")
                 for side in ("one", "four"))
    assert one.keys() == four.keys()
    for key in one:
        np.testing.assert_array_equal(np.asarray(four[key]),
                                      np.asarray(one[key]), err_msg=key)


def test_sigterm_stops_every_rank_and_one_process_resumes(runs):
    root = runs["root"]
    saved = root / "models" / "cut_four" / "saved_models" / "blip_last"
    first, rest = runs["four"]["cut"], runs["resumed"]
    whole = runs["one"]["whole"]
    assert len(first) == 1 and len(rest) == 3 and len(whole) == 4
    np.testing.assert_allclose(first + rest, whole, atol=1e-5)
    # every rank stopped after the first step: one batch applied
    assert runs["cut"]["step"] == 1
    assert runs["cut"]["metadata"] == {"epoch": -1, "skip_batches": 1}
    final = tckpt.read_train_state(saved)
    assert final["metadata"] == {"epoch": 1}
    ref = tckpt.read_train_state(root / "models" / "whole_one" /
                                 "saved_models" / "blip_last")
    assert final["step"] == ref["step"] == 4
    for k in ref["params"]:
        np.testing.assert_allclose(final["params"][k].numpy(),
                                   ref["params"][k].numpy(), atol=3e-5,
                                   err_msg=k)
