"""The one generator of CIRR-shaped traffic: a corpus of images and the
queries over it, drawn from a seed by the parameters of a traffic file
(``cirbench/traffic/<name>.json``; serving's open-loop schedule is drawn by
its driver from the same corpus and vocabulary).

Rewritten from the port's smoke script (``Corpus``, ``make_queries``,
``stage1_eval_queries``, ``caption_lengths``), which took them from the
JAX package's benchmark: captions are words of the toy vocabulary, one
token a word; images are Gaussian pixels in CLIP-normalised scale, drawn
on the device and handed to the program as the host array its datasets
yield.

Parameters (keys of the traffic file):
  images, queries        corpus and query counts
  group_size             CIRR's group: the reference, the target and the
                         other members (6)
  top_k                  optional: draw each query's stage-I top-K list
                         uniformly from the corpus less its reference
                         and target, the target put in with probability
                         ``target_in_topk``
  caption                {"model": "geometric", "min", "max", "p"}: words
                         min + Geometric(p), at most max; or {"model":
                         "normal", "mean", "std", "min", "max"}: tokens
                         clip(round(N(mean, std)), min, max), [CLS] and
                         [SEP] included
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
VOCAB_FILE = HERE / "vocab.txt"

# the streams drawn from one seed, each from its own child of it
STREAMS = {"weights_stage1": 0, "weights_reranker": 1, "images": 2,
           "queries": 3, "sample": 4}


def load_vocab(path: Path = VOCAB_FILE) -> list[str]:
    return [t for t in path.read_text().split("\n") if t]


def caption_words(vocab: list[str]) -> list[str]:
    """The whole words of the vocabulary: one token each."""
    return [w for w in vocab if w.isalpha() and len(w) > 1]


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of run seed ``seed`` (any size)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def stream_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


@torch.no_grad()
def make_images(n: int, size: int, seed: int, device, chunk: int = 128
                ) -> np.ndarray:
    """[n, size, size, 3] float32 N(0, 1) pixels, drawn on ``device`` from
    the seed's image stream, as one host array."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "images"))
    out = torch.empty((n, size, size, 3), dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        out[start:start + m].copy_(torch.randn(
            (m, size, size, 3), generator=gen, device=device))
    return out.numpy()


class Corpus:
    """A 'classic' dataset over host images: rows {'name', 'image'}."""

    def __init__(self, images: np.ndarray):
        self.images = images
        self.index_names = [f"img{i:05d}" for i in range(len(images))]

    def __len__(self):
        return len(self.index_names)

    def __getitem__(self, i):
        return {"name": self.index_names[i], "image": self.images[i]}


@dataclass
class Queries:
    """Queries as index arrays; ``rows()`` gives the dataset rows the
    program's engines read."""

    names: list[str]
    ref: np.ndarray            # [N] corpus index of the reference
    group: np.ndarray          # [N, group_size]: reference, target, others
    words: list[list[str]]     # caption words
    topk: np.ndarray | None    # [N, K] corpus indices, or None

    @property
    def target(self) -> np.ndarray:
        return self.group[:, 1]

    @property
    def captions(self) -> list[str]:
        return [" ".join(w) for w in self.words]

    @property
    def lengths(self) -> np.ndarray:
        """Token counts: [ENC]/[CLS], the words, [SEP]."""
        return np.asarray([len(w) + 2 for w in self.words], np.int64)

    def topk_hit(self) -> np.ndarray:
        return (self.topk == self.target[:, None]).any(axis=1)

    def rows(self) -> list[dict]:
        out = []
        for q, caption in enumerate(self.captions):
            row = {"reference_name": self.names[self.ref[q]],
                   "target_name": self.names[self.target[q]],
                   "caption": caption,
                   "group_members": [self.names[i] for i in self.group[q]]}
            if self.topk is not None:
                row["topk_names"] = np.asarray(
                    [self.names[i] for i in self.topk[q]])
                row["topk_labels"] = self.topk[q] == self.target[q]
            out.append(row)
        return out


def caption_word_counts(spec: dict, n: int, rng) -> np.ndarray:
    if spec["model"] == "geometric":
        return np.minimum(spec["max"],
                          spec["min"] + rng.geometric(spec["p"], size=n))
    if spec["model"] == "normal":
        tokens = np.clip(np.round(rng.normal(spec["mean"], spec["std"],
                                             size=n)),
                         spec["min"], spec["max"]).astype(np.int64)
        return tokens - 2
    raise ValueError(f"unknown caption model {spec['model']!r}")


def make_queries(params: dict, names: list[str], seed: int,
                 vocab_words: list[str]) -> Queries:
    """The queries of ``params`` over the corpus ``names``."""
    rng = stream_rng(seed, "queries")
    n_img, n_q = len(names), params["queries"]
    g = params["group_size"]
    # a group: g distinct images, the first the reference, the second the
    # target
    group = np.stack([rng.choice(n_img, size=g, replace=False)
                      for _ in range(n_q)])
    counts = caption_word_counts(params["caption"], n_q, rng)
    words = [list(rng.choice(vocab_words, size=int(c))) for c in counts]
    topk = None
    k = params.get("top_k")
    if k:
        topk = np.empty((n_q, k), np.int64)
        for q in range(n_q):
            # k of the corpus less the reference and the target
            pick = rng.choice(n_img - 2, size=k, replace=False)
            lo, hi = sorted(group[q, :2])
            pick = pick + (pick >= lo)
            pick = pick + (pick >= hi)
            if rng.random() < params["target_in_topk"]:
                pick[rng.integers(0, k)] = group[q, 1]
            topk[q] = pick
    return Queries(names, group[:, 0].copy(), group, words, topk)


def sample_rows(n: int, size: int, seed: int, must: np.ndarray | None = None
                ) -> np.ndarray:
    """``size`` distinct rows of ``n`` drawn from the seed's sample stream;
    ``must`` (row indices) are put first."""
    rng = stream_rng(seed, "sample")
    first = [] if must is None else [int(i) for i in must]
    rest = [int(i) for i in rng.permutation(n) if int(i) not in first]
    return np.asarray((first + rest)[:size], np.int64)
