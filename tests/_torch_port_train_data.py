"""Synthetic CIRR train/val splits for the trainer CLI tests (no JAX
import: the card tests use it too). The layout and captions are
tests/test_trainers.py's: images im0..im{n-1} as jpegs, train and val
triplets over the same images."""
import json

import numpy as np

N_IMAGES, N_TRAIN, N_VAL = 10, 8, 4


def write_cirr(root, *, n_images: int = N_IMAGES, n_train: int = N_TRAIN,
               n_val: int = N_VAL, size=(36, 40)):
    """A CIRR tree under ``root`` (``root/cirr_dataset``)."""
    import PIL.Image

    base = root / "cirr_dataset"
    (base / "cirr" / "captions").mkdir(parents=True)
    (base / "cirr" / "image_splits").mkdir(parents=True)
    (base / "img").mkdir()
    rng = np.random.default_rng(0)
    names = [f"im{i}" for i in range(n_images)]
    relpath = {}
    for n in names:
        PIL.Image.fromarray(rng.integers(0, 255, size=(*size, 3),
                                         dtype=np.uint8)).save(
            base / "img" / f"{n}.jpg")
        relpath[n] = f"img/{n}.jpg"

    def triplets(count):
        out = []
        for q in range(count):
            ref, tgt = names[q % n_images], names[(q + 3) % n_images]
            members = [ref, tgt] + [names[(q + 4 + j) % n_images]
                                    for j in range(4)]
            out.append({"pairid": q, "reference": ref, "target_hard": tgt,
                        "caption": f"a red dress {q}",
                        "img_set": {"members": members}})
        return out

    for split, count in (("train", n_train), ("val", n_val)):
        with open(base / "cirr" / "captions" / f"cap.rc2.{split}.json",
                  "w") as f:
            json.dump(triplets(count), f)
        with open(base / "cirr" / "image_splits" / f"split.rc2.{split}.json",
                  "w") as f:
            json.dump(relpath, f)
    return root


def trainer_flags(root, image_size: int, model_config, *, text_len: int = 10,
                  device: str | None = "cpu", bf16: bool = False
                  ) -> list[str]:
    """The flags every trainer run of the tests shares (``device`` None:
    no --device flag, as the JAX package's CLIs take none)."""
    return (["--dataset", "CIRR", "--data-root", str(root),
             "--allow-test-vocab", "--image-size", str(image_size),
             "--text-len", str(text_len), "--model-config", str(model_config)]
            + ([] if device is None else ["--device", device])
            + ([] if bf16 else ["--no-bf16"]))


class RecordingComet:
    """A Comet stand-in that keeps the step losses and can ask for a
    preemption: SIGTERM to this process after the ``kill_after``-th step
    (the handler runs before the loop's next check, as a real signal's
    would, mid-epoch)."""

    def __init__(self, kill_after: int | None = None):
        self.losses = []
        self.kill_after = kill_after

    def log_metric(self, name, value, **kw):
        if name == "step_loss":
            self.losses.append(value)
            if len(self.losses) == self.kill_after:
                import os
                import signal

                os.kill(os.getpid(), signal.SIGTERM)


def write_fiq(root, *, n_images: int = 8, n_train: int = 8, n_val: int = 4,
              size=(40, 30)):
    """A Fashion-IQ tree under ``root`` (``root/fashionIQ_dataset``): for
    each of dress, shirt and toptee, ``n_images`` jpegs and train and val
    triplets (two captions each) over them."""
    import PIL.Image

    base = root / "fashionIQ_dataset"
    for sub in ("captions", "image_splits", "images"):
        (base / sub).mkdir(parents=True)
    rng = np.random.default_rng(1)
    for dress in ("dress", "shirt", "toptee"):
        names = [f"{dress}{i}" for i in range(n_images)]
        for n in names:
            PIL.Image.fromarray(rng.integers(0, 255, size=(*size, 3),
                                             dtype=np.uint8)).save(
                base / "images" / f"{n}.jpg")
        for split, count in (("train", n_train), ("val", n_val)):
            caps = [{"candidate": names[q % n_images],
                     "target": names[(q + 2) % n_images],
                     "captions": [f"is red {q}.", f"with a dress {q}"]}
                    for q in range(count)]
            with open(base / "captions" / f"cap.{dress}.{split}.json",
                      "w") as f:
                json.dump(caps, f)
            with open(base / "image_splits" / f"split.{dress}.{split}.json",
                      "w") as f:
                json.dump(names, f)
    return root
