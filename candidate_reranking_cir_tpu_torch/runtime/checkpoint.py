"""Checkpoints of the port's trainers (counterpart of the JAX package's
``runtime/checkpoint.py``, without Orbax and without URLs).

A checkpoint is a directory holding
- ``train_state.pt``: the full train state, {"step": micro-steps taken,
  "params": every parameter of the model (the frozen ViT too, as the JAX
  package saves ``params`` whole), "opt_state": ``AdamW.state_dict()``,
  "metadata"}; parameters and moments are the float32 masters that AdamW
  updates, whatever the compute dtype;
- ``framework_metadata.json``: the trainer's metadata (epoch, applied
  batches of an interrupted epoch, the selection metric), as JAX writes
  it. A restore reads the state file's copy, which is replaced in one
  rename with the state it belongs to.

Save policy as the reference's (stage1_train.py:494-503): a rolling
``blip_last`` every validation epoch and on preemption, plus the best
checkpoint (``blip_mean`` on CIRR, ``blip`` on Fashion-IQ).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from candidate_reranking_cir_tpu_torch.config import (
    RerankerModelConfig,
    RetrievalModelConfig,
)
from candidate_reranking_cir_tpu_torch.runtime.weights import (
    load_reference_state_dict,
)

STATE_FILE = "train_state.pt"
METADATA_FILE = "framework_metadata.json"


def save_checkpoint(path: str | Path, model, optimizer, *,
                    metadata: dict | None = None,
                    opt_state: dict | None = None) -> None:
    """Write the train state of ``model`` and ``optimizer`` (the port's
    ``AdamW``) to the directory ``path``, replacing what it held. The
    state file is written under a temporary name and renamed, so a crash
    mid-save leaves the previous checkpoint whole. ``opt_state``: the
    optimizer's ``state_dict()`` already taken (a ZeRO-sharded optimizer
    gathers it collectively on every rank; rank 0 then writes)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if opt_state is None:
        opt_state = optimizer.state_dict()
    state = {"step": optimizer.micro_steps, "params": model.state_dict(),
             "opt_state": opt_state,
             "metadata": dict(metadata or {})}
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path / STATE_FILE)
    meta = path / METADATA_FILE
    if metadata:
        meta.write_text(json.dumps(metadata))
    elif meta.exists():
        meta.unlink()


def is_checkpoint(path: str | Path) -> bool:
    return (Path(path) / STATE_FILE).is_file()


def read_train_state(path: str | Path) -> dict:
    """The train state saved in the checkpoint directory ``path``, on the
    CPU."""
    return torch.load(Path(path) / STATE_FILE, map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str | Path, model, optimizer) -> dict:
    """Load the checkpoint directory ``path`` into ``model`` and
    ``optimizer`` in place (the tensors keep their devices, and frozen
    parameters stay frozen: ``requires_grad`` is not touched, and the
    optimizer holds state for the trainable parameters only). Returns the
    saved train state's ``step`` and the metadata, as a dict."""
    state = read_train_state(path)
    model.load_state_dict(state["params"], strict=True)
    optimizer.load_state_dict(state["opt_state"])
    return {"step": int(state["step"]), **state["metadata"]}


def load_model_params(path: str | Path, stage: int, cfg
                      ) -> dict[str, torch.Tensor]:
    """The port's state dict for ``cfg`` from a checkpoint directory of the
    port's trainers, or from a reference-format ``.pt``/``.pth`` file (the
    reference's own, or one ``runtime/convert.py::save_torch_checkpoint``
    wrote; ``runtime/weights.py``). ``stage`` (1 or 2) is checked against
    the config. URLs and other directories (an Orbax checkpoint of the JAX
    package) are refused."""
    want = {1: RetrievalModelConfig, 2: RerankerModelConfig}[stage]
    if not isinstance(cfg, want):
        raise TypeError(f"stage {stage} needs a {want.__name__}")
    if "://" in str(path):
        raise NotImplementedError(
            "checkpoint URLs are not supported; download the file and pass "
            "its path")
    if is_checkpoint(path):
        return read_train_state(path)["params"]
    if Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint of the JAX "
            "package?); convert it to a reference .pt file with `python -m "
            "candidate_reranking_cir_tpu.cli.export_checkpoint`")
    return load_reference_state_dict(path, cfg)
