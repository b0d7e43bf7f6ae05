"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled on first use with ``nvcc`` into a
shared library with a plain C interface, loaded through ``ctypes``. The
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


@functools.lru_cache(maxsize=None)
def load_attention_library() -> ctypes.CDLL:
    """The attention kernels' library with its C signatures declared."""
    path, _, _ = build("attention")
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.crc_attention_head_dim.argtypes = []
    lib.crc_attention_head_dim.restype = i32
    lib.crc_attention_tc_smem_bytes.argtypes = [i32, i32]
    lib.crc_attention_tc_smem_bytes.restype = i32
    lib.crc_attention_forward.argtypes = [
        i32, i32, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
        i32, i32, i32, i32, ctypes.c_float, vp]
    lib.crc_attention_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_attention_train_library() -> ctypes.CDLL:
    """The train attention kernels' library (K5-K9) with its C signatures
    declared. The folded entry points (K8, K9) take the unfolded ones'
    arguments."""
    path, _, _ = build("attention_train")
    lib = ctypes.CDLL(str(path))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.crc_attention_train_max_keys.argtypes = []
    lib.crc_attention_train_max_keys.restype = i32
    for fn in (lib.crc_attention_train_forward,
               lib.crc_attention_train_folded_forward):
        fn.argtypes = [i32, vp, vp, vp, vp, vp, strides, i32, i32, i32, i32,
                       f32, i32, f32, f32, vp]
        fn.restype = i32
    for fn in (lib.crc_attention_train_backward,
               lib.crc_attention_train_folded_backward):
        fn.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, strides, i32,
                       i32, i32, i32, f32, i32, f32, f32, vp]
        fn.restype = i32
    lib.crc_attention_train_tc_smem_bytes.argtypes = [i32]
    lib.crc_attention_train_tc_smem_bytes.restype = i32
    blocks_per_sm = lib.crc_attention_train_folded_forward_blocks_per_sm
    blocks_per_sm.argtypes = [i32, i32]
    blocks_per_sm.restype = i32
    lib.crc_keep_mask.argtypes = [i32, i32, i32, i32, i32, f32, vp, vp]
    lib.crc_keep_mask.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_activation_library() -> ctypes.CDLL:
    """The bias + exact-GELU kernel's library (``csrc/activation.cu``) with
    its C signature declared."""
    path, _, _ = build("activation")
    lib = ctypes.CDLL(str(path))
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.crc_bias_gelu.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.crc_bias_gelu.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_layer_norm_library() -> ctypes.CDLL:
    """The residual add + LayerNorm kernel's library
    (``csrc/layer_norm.cu``) with its C signature declared."""
    path, _, _ = build("layer_norm")
    lib = ctypes.CDLL(str(path))
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.crc_add_layer_norm.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64,
                                       ctypes.c_float, vp]
    lib.crc_add_layer_norm.restype = ctypes.c_int
    return lib
