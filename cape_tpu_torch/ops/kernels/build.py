"""Build and load the native libraries of `cape_tpu_torch/csrc/`.

Each CUDA source (`*.cu`) is compiled with `nvcc` into a shared library
with a plain C interface and loaded with ctypes (no PyTorch headers, so a
build takes seconds); the host C++ source of the mesh BVH (`aabb.cpp`) is
compiled the same way with the host's C++ compiler (`build_host`).
Libraries go to `build/cape_tpu_torch/` at the root of the checkout, named
by the hash of their source and flags, so an edited source is rebuilt at
its next first use and an unchanged one is reused. Nothing is built or
imported from CUDA when this module is imported.
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
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no host C++ compiler (set CXX or put c++ on PATH)")


def _compile(src: Path, compiler, flags: list[str]) -> Path:
    """Compile `src` into a shared library unless one of the same source
    and flags exists; return its path. `compiler` is called for its path
    only when a build is needed. The compiler's output is kept beside the
    library as <lib>.log."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [compiler(), *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"compiling {src} failed:\n{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"{lib.stem}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build(name: str) -> Path:
    """Compile csrc/<name>.cu with nvcc (`_compile`); the log beside the
    library holds ptxas's register and spill report."""
    return _compile(SRC_DIR / f"{name}.cu", _nvcc, NVCC_FLAGS)


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with the host's C++ compiler (`_compile`)."""
    return _compile(SRC_DIR / f"{name}.cpp", _cxx, CXX_FLAGS)


def _bind(lib: ctypes.CDLL, fn: str, n_ints: int, n_ptrs: int, n_floats: int = 0) -> None:
    """Bind the entry `fn` of lib: n_ptrs pointers, then n_ints ints, then
    n_floats floats, then the stream; it returns a cudaError_t."""
    p, i = ctypes.c_void_p, ctypes.c_int
    entry = getattr(lib, fn)
    entry.argtypes = [p] * n_ptrs + [i] * n_ints + [ctypes.c_float] * n_floats + [p]
    entry.restype = i


def _load(name: str, fn: str, n_ints: int, n_ptrs: int, n_floats: int = 0) -> ctypes.CDLL:
    """Build csrc/<name>.cu and bind its entry `fn` (`_bind`) and its error
    string."""
    lib = ctypes.CDLL(str(build(name)))
    _bind(lib, fn, n_ints, n_ptrs, n_floats)
    lib.cape_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cape_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def band_gather_lib() -> ctypes.CDLL:
    """The band-gather kernel's library (kernels 2 and 3), built on first use."""
    # x, cols, vals, addend, y; dtype, B, rows_in, C, W, rows_out
    return _load("band_gather", "cape_band_gather", n_ints=6, n_ptrs=5)


@functools.cache
def cheb2_fused_lib() -> ctypes.CDLL:
    """The fused K=2 conv kernels' library, built on first use: the fused
    kernel (kernels 1 and 4) and the windowed one (kernels 5 and 6)."""
    # x, pack cols, pack vals, w0, w1, y; dtype, B, rows_in, C, F, W, pad_left,
    # rows_out, group, then the plan: BM, BN, BK, stages, rows, smem, grid x, grid y
    lib = _load("cheb2_fused", "cape_cheb2_fused", n_ints=17, n_ptrs=6)
    # x, pack cols, pack vals, pack windows, w0, w1, y; dtype, B, rows_in, C, F,
    # W, pad_left, rows_out, tiles, then the plan: BN, BK, window rows, smem,
    # grid x, grid y
    _bind(lib, "cape_cheb2_window", n_ints=15, n_ptrs=7)
    return lib


@functools.cache
def group_norm_relu_lib() -> ctypes.CDLL:
    """The fused group norm + ReLU kernels' library, built on first use."""
    # x, gamma, beta, y, mean, rstd; dtype, B, V, C, G, n_valid, then the plan:
    # vec, k, p, rows, threads, smem; eps
    lib = _load("group_norm_relu", "cape_group_norm_relu_fwd", n_ints=12, n_ptrs=6, n_floats=1)
    # x, dy, gamma, beta, mean, rstd, dx, part, dgamma, dbeta; the same ints
    _bind(lib, "cape_group_norm_relu_bwd", n_ints=12, n_ptrs=10)
    return lib
