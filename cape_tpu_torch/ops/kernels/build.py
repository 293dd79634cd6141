"""Build and load the CUDA kernels of `cape_tpu_torch/csrc/`.

Each source is compiled with `nvcc` into a shared library with a plain C
interface and loaded with ctypes (no PyTorch headers, so a build takes
seconds). Libraries go to `build/cape_tpu_torch/` at the root of the
checkout, named by the hash of their source and flags, so an edited
source is rebuilt at its next first use and an unchanged one is reused.
Nothing is built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "cape_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same source and flags
    exists; return the library's path. The compiler's register and spill
    report is kept beside it as <lib>.log."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"{lib.stem}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _load(name: str, fn: str, n_ints: int, n_ptrs: int) -> ctypes.CDLL:
    """Build csrc/<name>.cu and bind its entry `fn`: n_ptrs pointers, then
    n_ints ints, then the stream; it returns a cudaError_t."""
    lib = ctypes.CDLL(str(build(name)))
    p, i = ctypes.c_void_p, ctypes.c_int
    entry = getattr(lib, fn)
    entry.argtypes = [p] * n_ptrs + [i] * n_ints + [p]
    entry.restype = i
    lib.cape_cuda_error_string.argtypes = [i]
    lib.cape_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def band_apply_lib() -> ctypes.CDLL:
    """The band-apply kernel's library (kernel 2), built on first use."""
    # x, blocks, addend, y; dtype, B, rows_in, C, S, T, pad_left, rows_out
    return _load("band_apply", "cape_band_apply", n_ints=8, n_ptrs=4)


@functools.cache
def cheb2_fused_lib() -> ctypes.CDLL:
    """The fused K=2 conv kernel's library (kernels 1 and 4), built on first use."""
    # x, blocks, w0, w1, y; dtype, B, rows_in, C, F, S, T, pad_left, rows_out, group
    return _load("cheb2_fused", "cape_cheb2_fused", n_ints=10, n_ptrs=5)


@functools.cache
def band_apply_bm_lib() -> ctypes.CDLL:
    """The batch-major band-apply kernel's library (kernel 3), built on first use."""
    # x, blocks, y; dtype, B, rows_in, C, S, T, cb, pad_left, n_rows
    return _load("band_apply_bm", "cape_band_apply_bm", n_ints=9, n_ptrs=3)


@functools.cache
def cheb2_ring_lib() -> ctypes.CDLL:
    """The ring fused K=2 conv kernel's library (kernels 5 and 6), built on first use."""
    # x, blocks, w0, w1, y; dtype, B, rows_in, C, F, S, T, pad_left, rows_out, R
    lib = _load("cheb2_ring", "cape_cheb2_ring", n_ints=10, n_ptrs=5)
    # dtype, B, C, S, T, R; int[4] out: cluster size, channels per block, run, bytes
    lib.cape_cheb2_ring_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.cape_cheb2_ring_plan.restype = ctypes.c_int
    return lib
