"""The port's quickstart (``demo.py``) on the CPU: its synthetic dataset
is the JAX package's byte for byte, and the whole pipeline runs through
the port's CLIs and writes every artifact the JAX package's demo writes
(``demo.ARTIFACTS``; the checkpoints in the port's format)."""
from pathlib import Path

import pytest
import torch

from candidate_reranking_cir_tpu import demo as jdemo
from candidate_reranking_cir_tpu_torch import demo
from candidate_reranking_cir_tpu_torch.runtime.checkpoint import (
    read_train_state,
)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_build_dataset_equals_jax_byte_for_byte(tmp_path):
    jdemo.build_dataset(tmp_path / "jax")
    demo.build_dataset(tmp_path / "port")
    assert demo.MODEL_CONFIG == jdemo.MODEL_CONFIG
    assert demo.CAPTION_BANK == jdemo.CAPTION_BANK
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name


def test_demo_runs_every_stage_on_the_cpu(tmp_path, capsys):
    res = demo.main(["--workdir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    missing = [a for a in demo.ARTIFACTS if not (tmp_path / a).is_file()]
    assert not missing
    for exp in ("demo_s1", "demo_s2"):
        for ckpt in ("blip_last", "blip_mean"):
            state = read_train_state(tmp_path / "models" / exp
                                     / "saved_models" / ckpt)
            assert all(torch.isfinite(v).all()
                       for v in state["params"].values())
    assert len(res.ranking) == 5 and res.reranked == 4
    assert "demo complete" in out


def test_demo_refuses_the_card_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--workdir", str(tmp_path), "--device", "cuda"])
