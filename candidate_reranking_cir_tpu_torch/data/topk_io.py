"""Top-k artifact IO.

The stage-I -> stage-II contract is a "top-k file" holding, per query, the K
best candidate names plus label bookkeeping (reference validate.py:254-264).

Native format here is ``.npz`` (portable, no pickle execution); the reference's
``torch.save`` ``.pt`` files are also readable (and writable) for
cross-validation against published artifacts, using torch-cpu when available.

Fields (CIRR val): sorted_index_names [N, K] str, target_names [N] str,
index_names [N_idx] str, labels [N, K] bool, group_labels [N, 5] bool, split.
FIQ adds dress_types and drops the group fields; test1 keeps only
sorted_index_names / index_names / split (cirr_test_submission.py:121-128).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_STRING_KEYS = ("split", "dress_types")
_LIST_KEYS = ("target_names", "index_names")


def save_topk_file(path: str | Path, data: dict) -> None:
    path = Path(path)
    if path.suffix == ".pt":
        _save_torch(path, data)
        return
    out = {}
    for k, v in data.items():
        if k in _STRING_KEYS:
            out[k] = np.asarray(v)
        elif isinstance(v, (list, tuple)):
            out[k] = np.asarray(v, dtype=object)
        else:
            out[k] = np.asarray(v)
    np.savez_compressed(path, **{k: _to_saveable(v) for k, v in out.items()})


def _to_saveable(v: np.ndarray) -> np.ndarray:
    if v.dtype == object:
        return v.astype(str)
    return v


def load_topk_file(path: str | Path) -> dict:
    path = Path(path)
    if path.suffix == ".pt":
        return _load_torch(path)
    with np.load(path, allow_pickle=False) as z:
        out = {}
        for k in z.files:
            v = z[k]
            if v.dtype.kind in ("U", "S"):
                if v.ndim == 0:
                    out[k] = str(v)
                elif k in _LIST_KEYS:
                    out[k] = [str(x) for x in v]
                else:
                    out[k] = v.astype(object)
            else:
                out[k] = v
        return out


def _save_torch(path: Path, data: dict) -> None:
    import torch

    out = {}
    for k, v in data.items():
        if k in _STRING_KEYS:
            out[k] = str(v)
        elif k in _LIST_KEYS:
            out[k] = [str(x) for x in v]
        elif isinstance(v, np.ndarray) and v.dtype == object:
            out[k] = v  # torch.save pickles numpy object arrays fine
        elif isinstance(v, np.ndarray) and v.dtype == bool:
            out[k] = torch.from_numpy(v)
        else:
            out[k] = v
    torch.save(out, path)


def _load_torch(path: Path) -> dict:
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for k, v in raw.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.numpy()
        else:
            out[k] = v
    return out
