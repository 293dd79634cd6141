"""ctypes binding for the first-party C++ BVH (`cape_tpu_torch/csrc/aabb.cpp`).

Counterpart of `cape_tpu.meshops.native_aabb`. The library is compiled at
first use with the host's C++ compiler into `build/cape_tpu_torch/`, beside
the CUDA kernels (`ops.kernels.build.build_host`); when it cannot be built
or loaded this raises ImportError, so callers (`meshops.transfer`) fall
back to the numpy backend.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from cape_tpu_torch.ops.kernels.build import build_host

    try:
        lib = ctypes.CDLL(str(build_host("aabb")))
    except (RuntimeError, OSError) as e:  # no toolchain / build failure
        raise ImportError(f"cannot build the native AABB library: {e}") from e
    lib.aabb_build.restype = ctypes.c_void_p
    lib.aabb_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.aabb_nearest.restype = None
    lib.aabb_nearest.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]
    lib.aabb_free.restype = None
    lib.aabb_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def nearest_triangles(
    verts: np.ndarray, faces: np.ndarray, queries: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """For each query point: (nearest face index, barycentric coords of the
    closest surface point). Exact BVH search; of faces equally near, the
    first one the traversal reaches wins."""
    lib = _load()
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    queries = np.ascontiguousarray(queries, dtype=np.float64)
    nq = len(queries)
    out_face = np.empty(nq, dtype=np.int32)
    out_bary = np.empty((nq, 3), dtype=np.float64)

    handle = lib.aabb_build(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
    )
    try:
        lib.aabb_nearest(
            handle,
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nq,
            out_face.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_bary.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    finally:
        lib.aabb_free(handle)
    return out_face, out_bary
