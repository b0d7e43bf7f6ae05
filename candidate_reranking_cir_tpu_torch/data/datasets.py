"""CIRR and Fashion-IQ dataset manifests and sample iteration (an own copy
of the JAX package's ``data/datasets.py``).

Directory layout, JSON formats, split names and sample tuples mirror the
reference datasets (data_utils.py:104-371):

- CIRR:      <root>/cirr_dataset/cirr/captions/cap.rc2.{split}.json
             <root>/cirr_dataset/cirr/image_splits/split.rc2.{split}.json
             images under <root>/cirr_dataset/<relpath from split json>
  splits: train / val / test1; triplets carry reference, target_hard, caption,
  img_set.members (6-image subset groups), pairid.
- FashionIQ: <root>/fashionIQ_dataset/captions/cap.{dress_type}.{split}.json
             <root>/fashionIQ_dataset/image_splits/split.{dress_type}.{split}.json
             images at <root>/fashionIQ_dataset/images/{name}.jpg
  splits: train / val / test; categories dress / shirt / toptee; triplets carry
  candidate, target, captions (two strings).

Modes: 'classic' iterates the index corpus as (name, image); 'relative' iterates
query triplets. ``force_validate`` makes the train split act as a val set
(names instead of pixels). Stage-II attaches a top-k file per query
(data_utils.py:166-180, 289-305) with the same sanity checks.

Unlike the reference (which swallows every __getitem__ exception and silently
drops rows, data_utils.py:227-228), decode errors here raise by default;
``skip_errors=True`` restores drop-on-error for corrupted corpora.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

import numpy as np

from candidate_reranking_cir_tpu_torch.data.preprocessing import load_image
from candidate_reranking_cir_tpu_torch.data.topk_io import load_topk_file


class CIRRDataset:
    def __init__(self, root: str | Path, split: str, mode: str,
                 transform: Callable | None = None, *,
                 force_validate: bool = False,
                 load_topk: str | Path | None = None, k: int | None = None,
                 skip_errors: bool = False, skip_target_image: bool = False):
        if split not in ("train", "val", "test1"):
            raise ValueError("split should be in ['test1', 'train', 'val']")
        if mode not in ("relative", "classic"):
            raise ValueError("mode should be in ['relative', 'classic']")
        self.root = Path(root)
        self.split = split
        self.mode = mode
        self.transform = transform
        self.force_validate = force_validate
        self.skip_errors = skip_errors
        # training with a frozen ViT + cached target features doesn't need
        # target pixels: skip the decode entirely (halves loader work)
        self.skip_target_image = skip_target_image

        base = self.root / "cirr_dataset" / "cirr"
        with open(base / "captions" / f"cap.rc2.{split}.json") as f:
            self.triplets: list[dict] = json.load(f)
        with open(base / "image_splits" / f"split.rc2.{split}.json") as f:
            self.name_to_relpath: dict[str, str] = json.load(f)

        self.topk = None
        if load_topk is not None:
            assert k is not None, "K value required with load_topk"
            t = load_topk_file(load_topk)
            assert k <= t["sorted_index_names"].shape[-1]
            assert t["split"] == split
            assert list(t["index_names"]) == list(self.name_to_relpath.keys()), (
                "top-k file index names do not match the split corpus")
            self.topk = {
                "sorted_index_names": np.asarray(t["sorted_index_names"])[:, :k],
            }
            if split != "test1":
                self.topk["labels"] = np.asarray(t["labels"])[:, :k]
                self.topk["group_labels"] = np.asarray(t["group_labels"])
                targets = [tr["target_hard"] for tr in self.triplets]
                assert list(t["target_names"]) == targets, (
                    "top-k file target names do not match the triplet json")
            self.k = k

    # -- corpus ----------------------------------------------------------
    @property
    def index_names(self) -> list[str]:
        return list(self.name_to_relpath.keys())

    def image_path(self, name: str) -> Path:
        return self.root / "cirr_dataset" / self.name_to_relpath[name]

    def open_image(self, name: str):
        path = self.image_path(name)
        if getattr(self.transform, "wants_path", False):
            return self.transform(path)  # native decode+preprocess pipeline
        img = load_image(path)
        return self.transform(img) if self.transform else img

    def __len__(self) -> int:
        return len(self.triplets) if self.mode == "relative" \
            else len(self.name_to_relpath)

    def __getitem__(self, index: int) -> dict[str, Any] | None:
        try:
            if self.mode == "classic":
                name = self.index_names[index]
                return {"name": name, "image": self.open_image(name)}
            t = self.triplets[index]
            s: dict[str, Any] = {
                "reference_name": t["reference"],
                "caption": t["caption"],
                "group_members": t["img_set"]["members"],
            }
            if self.split == "test1":
                s["pair_id"] = t["pairid"]
            else:
                s["target_name"] = t["target_hard"]
            if self.split == "train" and not self.force_validate:
                s["reference_image"] = self.open_image(t["reference"])
                if not self.skip_target_image:
                    s["target_image"] = self.open_image(t["target_hard"])
            if self.topk is not None:
                s["topk_names"] = self.topk["sorted_index_names"][index]
                if "labels" in self.topk:
                    s["topk_labels"] = self.topk["labels"][index]
                    s["group_labels"] = self.topk["group_labels"][index]
            return s
        except Exception:
            if self.skip_errors:
                return None
            raise


class FashionIQDataset:
    def __init__(self, root: str | Path, split: str, dress_types: list[str],
                 mode: str, transform: Callable | None = None, *,
                 force_validate: bool = False,
                 load_topk: str | Path | None = None, k: int | None = None,
                 skip_target_image: bool = False):
        if split not in ("train", "val", "test"):
            raise ValueError("split should be in ['test', 'train', 'val']")
        if mode not in ("relative", "classic"):
            raise ValueError("mode should be in ['relative', 'classic']")
        for d in dress_types:
            if d not in ("dress", "shirt", "toptee"):
                raise ValueError(
                    "dress_type should be in ['dress', 'shirt', 'toptee']")
        self.root = Path(root)
        self.split = split
        self.dress_types = list(dress_types)
        self.mode = mode
        self.transform = transform
        self.force_validate = force_validate
        # as CIRRDataset's: the stage-I trainer's cached target features
        self.skip_target_image = skip_target_image

        base = self.root / "fashionIQ_dataset"
        self.triplets: list[dict] = []
        self.image_names: list[str] = []
        for d in dress_types:
            with open(base / "captions" / f"cap.{d}.{split}.json") as f:
                self.triplets.extend(json.load(f))
            with open(base / "image_splits" / f"split.{d}.{split}.json") as f:
                self.image_names.extend(json.load(f))

        self.topk = None
        if load_topk is not None:
            assert k is not None, "K value required with load_topk"
            t = load_topk_file(load_topk)
            assert k <= t["sorted_index_names"].shape[-1]
            assert t["split"] == split
            # reference asserts against the *last* dress type in its loop
            # (data_utils.py:170); here: the stored tag must cover our types
            stored = set(str(t["dress_types"]).split(","))
            assert stored.issuperset(dress_types) or stored & set(dress_types), (
                "top-k file dress types do not match")
            self.topk = {
                "sorted_index_names": np.asarray(t["sorted_index_names"])[:, :k],
                "labels": np.asarray(t["labels"])[:, :k],
            }
            self.k = k

    @property
    def index_names(self) -> list[str]:
        return list(self.image_names)

    def image_path(self, name: str) -> Path:
        return self.root / "fashionIQ_dataset" / "images" / f"{name}.jpg"

    def open_image(self, name: str):
        path = self.image_path(name)
        if getattr(self.transform, "wants_path", False):
            return self.transform(path)  # native decode+preprocess pipeline
        img = load_image(path)
        return self.transform(img) if self.transform else img

    def __len__(self) -> int:
        return len(self.triplets) if self.mode == "relative" \
            else len(self.image_names)

    def __getitem__(self, index: int) -> dict[str, Any]:
        if self.mode == "classic":
            name = self.image_names[index]
            return {"name": name, "image": self.open_image(name)}
        t = self.triplets[index]
        s: dict[str, Any] = {
            "reference_name": t["candidate"],
            "captions": list(t["captions"]),
        }
        if self.split != "test":
            s["target_name"] = t["target"]
        if self.split == "train" and not self.force_validate:
            s["reference_image"] = self.open_image(t["candidate"])
            if not self.skip_target_image:
                s["target_image"] = self.open_image(t["target"])
        elif self.split == "test":
            s["reference_image"] = self.open_image(t["candidate"])
        if self.topk is not None:
            s["topk_names"] = self.topk["sorted_index_names"][index]
            s["topk_labels"] = self.topk["labels"][index]
        return s
