"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled on first use with ``nvcc`` into a
shared library with a plain C interface, which ``load(name)`` opens
through ``ctypes`` with the signatures ``LIBRARIES`` declares. The
library lands in ``_build/`` beside this package (listed in .gitignore),
named by a hash of its source and flags, so a changed source rebuilds and
an unchanged one is reused. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def build(name: str = "attention") -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` once per process; returns (library path,
    build seconds — 0.0 when a cached library was reused, compiler
    output such as ptxas's register and spill report). The hash covers
    the source, the shared headers ``csrc/*.cuh`` and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    blob = src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        blob += header.read_bytes()
    digest = hashlib.sha256(blob).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build into a private name, then rename: concurrent processes never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# K6's and K8's entry points take the same arguments, and K7's and K9's
_TRAIN_FWD = (_I32, _VP, _VP, _VP, _VP, _VP, _STRIDES, _I32, _I32, _I32, _I32,
              _F32, _I32, _F32, _F32, _VP)
_TRAIN_BWD = (_I32, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _STRIDES,
              _I32, _I32, _I32, _I32, _F32, _I32, _F32, _F32, _VP)
# every kernel library, ``csrc/<name>.cu``: its C entry points and their
# argument types; each returns an int (0, a refusal code or a cudaError)
LIBRARIES = {
    "attention": {  # K1-K4
        "crc_attention_head_dim": (),
        "crc_attention_tc_smem_bytes": (_I32, _I32),
        "crc_attention_forward": (_I32, _I32, _VP, _VP, _VP, _VP, _VP,
                                  _STRIDES, _I32, _I32, _I32, _I32, _F32,
                                  _VP),
    },
    "attention_train": {  # K5-K9
        "crc_attention_train_max_keys": (),
        "crc_attention_train_forward": _TRAIN_FWD,
        "crc_attention_train_folded_forward": _TRAIN_FWD,
        "crc_attention_train_backward": _TRAIN_BWD,
        "crc_attention_train_folded_backward": _TRAIN_BWD,
        "crc_attention_train_tc_smem_bytes": (_I32,),
        "crc_attention_train_folded_forward_blocks_per_sm": (_I32, _I32),
        "crc_keep_mask": (_I32, _I32, _I32, _I32, _I32, _F32, _VP, _VP),
    },
    "activation": {  # G1
        "crc_bias_gelu": (_VP, _VP, _VP, _I64, _I64, _VP),
    },
    "layer_norm": {  # G2
        "crc_add_layer_norm": (_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64,
                               _F32, _VP),
    },
}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library ``LIBRARIES[name]``, built on first use, with its entry
    points' C signatures declared."""
    lib = ctypes.CDLL(str(build(name)[0]))
    for entry, argtypes in LIBRARIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(argtypes), _I32
    return lib
