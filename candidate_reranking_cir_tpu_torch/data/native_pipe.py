"""ctypes binding of the native C++ image pipeline (``native/image_pipe.cc``;
an own copy of the JAX package's ``data/native_pipe.py``).

JPEG decode, TargetPad/SquarePad, PIL-compatible bicubic resize, centre
crop and CLIP normalisation in one native call that releases the GIL; a
batch decodes on a native thread pool. The library is built with ``make
-C native`` at the repository root; without it ``native_available()`` is
false and callers keep the PIL pipeline (``data/preprocessing.py``),
which stays the pixel-parity reference.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libimagepipe.so"

_F32P = ctypes.POINTER(ctypes.c_float)


def native_available() -> bool:
    return LIB_PATH.exists()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.ip_process_jpeg.restype = ctypes.c_int
    lib.ip_process_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, _F32P]
    lib.ip_process_rgb.restype = ctypes.c_int
    lib.ip_process_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, _F32P]
    lib.ip_process_jpeg_batch.restype = ctypes.c_int32
    lib.ip_process_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int32, _F32P, ctypes.POINTER(ctypes.c_int32)]
    return lib


def process_jpeg_bytes(data: bytes, dim: int = 384,
                       target_ratio: float = 1.25,
                       square_pad: bool = False) -> np.ndarray:
    """JPEG bytes -> normalised float32 [dim, dim, 3]. A decode failure
    raises, as the datasets' default error policy does."""
    lib = _load()
    out = np.empty((dim, dim, 3), np.float32)
    rc = lib.ip_process_jpeg(data, len(data), dim, target_ratio,
                             int(square_pad), out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"native jpeg pipeline failed (code {rc})")
    return out


def process_rgb(rgb: np.ndarray, dim: int = 384, target_ratio: float = 1.25,
                square_pad: bool = False) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> normalised float32 [dim, dim, 3]."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {rgb.shape}")
    lib = _load()
    out = np.empty((dim, dim, 3), np.float32)
    rc = lib.ip_process_rgb(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rgb.shape[1],
        rgb.shape[0], dim, target_ratio, int(square_pad),
        out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"native rgb pipeline failed (code {rc})")
    return out


def process_jpeg_batch(datas: list[bytes], dim: int = 384,
                       target_ratio: float = 1.25, square_pad: bool = False,
                       num_threads: int = 0) -> np.ndarray:
    """A batch of JPEG buffers -> float32 [N, dim, dim, 3], decoded on a
    native thread pool in one call (``num_threads`` 0: every core).
    Raises on any decode failure, naming the failing indices."""
    lib = _load()
    n = len(datas)
    out = np.empty((n, dim, dim, 3), np.float32)
    rcs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_int64 * n)(*[len(d) for d in datas])
    failures = lib.ip_process_jpeg_batch(
        arr, lens, n, dim, target_ratio, int(square_pad), num_threads,
        out.ctypes.data_as(_F32P),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if failures:
        bad = np.nonzero(rcs)[0].tolist()
        raise ValueError(f"native jpeg batch failed for indices {bad}")
    return out


def make_native_transform(kind: str = "targetpad", dim: int = 384,
                          target_ratio: float = 1.25):
    """A path -> [dim, dim, 3] transform with ``make_transform``'s
    semantics that reads the file itself (no PIL decode). It carries
    ``wants_path`` (the datasets hand it paths, not images) and
    ``batch_from_paths`` (``retrieval/index.py::iter_batches`` decodes a
    whole batch in one native call)."""
    square = kind == "squarepad"

    def transform_path(path) -> np.ndarray:
        return process_jpeg_bytes(Path(path).read_bytes(), dim, target_ratio,
                                  square)

    def batch_from_paths(paths) -> np.ndarray:
        return process_jpeg_batch([Path(p).read_bytes() for p in paths], dim,
                                  target_ratio, square)

    transform_path.wants_path = True
    transform_path.batch_from_paths = batch_from_paths
    return transform_path
