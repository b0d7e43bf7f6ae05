"""Self-contained WordPiece tokenizer (bert-base-uncased compatible).

The reference depends on HuggingFace hub at runtime and keeps a pickled tokenizer
as an outage fallback (blip_stage2.py:38-44). This implementation is fully offline:
it loads a standard ``vocab.txt`` (one token per line) and reproduces the
bert-base-uncased pipeline — text cleaning, whitespace split, lowercasing with
accent stripping (NFD), punctuation splitting, CJK spacing, then greedy
longest-match-first WordPiece with ``##`` continuations.

BLIP additions (reference blip.py:186-191): two extra tokens appended to the
30,522-entry base vocab — ``[DEC]`` (bos for the decoder, unused in CIR) and
``[ENC]``; vocab size becomes 30,524 and ``enc_token_id`` is written over
position 0 of every encoded sequence before fusion (blip_stage1.py:73).

Encoded output is a fixed-length bucket with the attention mask carrying the
true length — numerically identical to the reference's pad-to-longest under
the additive -10000 mask convention. An own copy of the JAX package's
``models/tokenizer.py`` (its native C++ variant is not ported).
"""
from __future__ import annotations

import unicodedata
import warnings
from pathlib import Path

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
DEC, ENC = "[DEC]", "[ENC]"


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation by BERT even when unicode disagrees
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def handle_overflow(policy: str, n_over: int, n_total: int, worst: int,
                    max_len: int) -> None:
    """Shared bucket-overflow policy for all tokenizer implementations.

    The reference pads to the longest caption with NO truncation
    (blip_stage1.py:72), so any caption that exceeds the static bucket would
    silently diverge from reference numerics if clipped. Policies:
    'error' (default) raises, 'warn' truncates with a counted warning,
    'truncate' is the silent legacy behavior.
    """
    if n_over == 0 or policy == "truncate":
        return
    msg = (f"{n_over}/{n_total} caption(s) exceed the static text bucket "
           f"(longest needs {worst + 2} tokens incl. [CLS]/[SEP], bucket is "
           f"{max_len}); the reference pads-to-longest without truncation, "
           f"so clipped rows diverge numerically. Raise --text-len to at "
           f"least {worst + 2}, or set overflow='warn'/'truncate'.")
    if policy == "error":
        raise ValueError(msg)
    if policy == "warn":
        warnings.warn(msg, stacklevel=3)
        return
    raise ValueError(f"unknown overflow policy {policy!r}")


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int], *, lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.overflow = "error"
        self.overflow_count = 0  # cumulative truncated rows (warn/truncate)
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        # BLIP special tokens; appended if absent so base vocab files also work
        for extra in (DEC, ENC):
            if extra not in self.vocab:
                idx = len(self.vocab)
                self.vocab[extra] = idx
                self.ids_to_tokens[idx] = extra
        self.dec_token_id = self.vocab[DEC]
        self.enc_token_id = self.vocab[ENC]

    # -- construction ------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str | Path, **kw) -> "WordPieceTokenizer":
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- basic tokenization --------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def _split_punct(self, token: str) -> list[str]:
        pieces, current = [], []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._space_cjk(self._clean(text))
        tokens = []
        for tok in text.split():
            if self.lowercase:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return tokens

    # -- wordpiece ------------------------------------------------------------
    def wordpiece(self, token: str) -> list[str]:
        if len(token) > self.max_chars_per_word:
            return [UNK]
        pieces, start = [], 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    # -- batch encoding ---------------------------------------------------------
    def encode(self, texts: list[str], max_len: int, *,
               set_enc_token: bool = False,
               overflow: str | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Encode to fixed-shape [B, max_len] int32 ids + int32 mask.

        Layout matches HF: [CLS] tokens [SEP], truncated so [SEP] survives.
        set_enc_token=True overwrites position 0 with [ENC] (blip_stage1.py:73).
        overflow: 'error' (default, via self.overflow) raises when any caption
        needs more than max_len tokens; 'warn' truncates with a warning;
        'truncate' silently clips (reference-divergent, see handle_overflow).
        """
        policy = overflow if overflow is not None else self.overflow
        ids = np.full((len(texts), max_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=np.int32)
        n_over, worst = 0, 0
        for i, text in enumerate(texts):
            toks = self.convert_tokens_to_ids(self.tokenize(text))
            if len(toks) > max_len - 2:
                n_over += 1
                worst = max(worst, len(toks))
            toks = toks[: max_len - 2]
            row = [self.cls_id, *toks, self.sep_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        handle_overflow(policy, n_over, len(texts), worst, max_len)
        self.overflow_count += n_over
        if set_enc_token:
            ids[:, 0] = self.enc_token_id
        return ids, mask


def build_test_vocab(extra_words: list[str] | None = None) -> dict[str, int]:
    """Tiny vocabulary for unit tests (no bert-base-uncased file needed)."""
    tokens = [PAD, UNK, CLS, SEP, MASK]
    tokens += list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'-")
    tokens += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    tokens += ["the", "a", "and", "is", "with", "of", "same", "image", "dress",
               "shirt", "red", "blue", "dog", "cat", "##ing", "##ed", "##s"]
    if extra_words:
        tokens += [w for w in extra_words if w not in tokens]
    # order-preserving dedupe: duplicate entries would leave holes in the id
    # space and break vocab-file round-trips
    seen: dict[str, int] = {}
    for t in tokens:
        if t not in seen:
            seen[t] = len(seen)
    return seen
