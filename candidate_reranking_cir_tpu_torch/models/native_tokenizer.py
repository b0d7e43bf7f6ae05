"""ctypes binding of the native C++ WordPiece tokenizer
(``native/wordpiece.cc``; an own copy of the JAX package's
``models/native_tokenizer.py``).

The same ``encode()`` contract as ``models/tokenizer.py``'s
``WordPieceTokenizer``, for the host's data pipeline. The library is built
with ``make -C native`` at the repository root; ``load_tokenizer`` takes
this class when it is built and the Python tokenizer otherwise.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from candidate_reranking_cir_tpu_torch.models.tokenizer import handle_overflow

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libwordpiece.so"

_I32P = ctypes.POINTER(ctypes.c_int32)


def native_available() -> bool:
    return LIB_PATH.exists()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.wp_load.restype = ctypes.c_void_p
    lib.wp_load.argtypes = [ctypes.c_char_p]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_vocab_size.restype = ctypes.c_int32
    lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
    lib.wp_special_id.restype = ctypes.c_int32
    lib.wp_special_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wp_encode_batch.restype = ctypes.c_int32
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, _I32P, _I32P, _I32P]
    return lib


class NativeWordPieceTokenizer:
    """``WordPieceTokenizer.encode`` in C++: the same ids, masks and
    overflow policy (``overflow``: 'error', 'warn' or 'truncate')."""

    def __init__(self, vocab_path: str | Path):
        self.overflow = "error"
        self.overflow_count = 0
        self._handle = None
        if not native_available():
            raise FileNotFoundError(
                f"{LIB_PATH} not built; run `make -C native`")
        self._lib = _load()
        self._handle = self._lib.wp_load(str(vocab_path).encode())
        if not self._handle:
            raise FileNotFoundError(f"cannot load vocab {vocab_path}")
        self.vocab_size = self._lib.wp_vocab_size(self._handle)
        self.pad_id = self._special("[PAD]")
        self.cls_id = self._special("[CLS]")
        self.sep_id = self._special("[SEP]")
        self.unk_id = self._special("[UNK]")
        self.enc_token_id = self._special("[ENC]")
        self.dec_token_id = self._special("[DEC]")

    def _special(self, tok: str) -> int:
        return int(self._lib.wp_special_id(self._handle, tok.encode()))

    def encode(self, texts: list[str], max_len: int, *,
               set_enc_token: bool = False, overflow: str | None = None):
        """texts -> (ids [N, max_len] int32, mask [N, max_len] int32)."""
        policy = overflow if overflow is not None else self.overflow
        n = len(texts)
        ids = np.empty((n, max_len), np.int32)
        mask = np.empty((n, max_len), np.int32)
        stats = np.zeros(2, np.int32)  # rows over the bucket, longest row
        arr = (ctypes.c_char_p * n)(*[t.encode("utf-8") for t in texts])
        self._lib.wp_encode_batch(
            self._handle, arr, n, max_len, int(set_enc_token),
            ids.ctypes.data_as(_I32P), mask.ctypes.data_as(_I32P),
            stats.ctypes.data_as(_I32P))
        handle_overflow(policy, int(stats[0]), n, int(stats[1]), max_len)
        self.overflow_count += int(stats[0])
        return ids, mask

    def close(self) -> None:
        """Free the native vocabulary (also done when collected)."""
        if self._handle:
            self._lib.wp_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
