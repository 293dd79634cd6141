"""Upsample-matrix construction (deformation transfer between pyramid levels).

For every fine-level vertex, find the nearest point on the coarse mesh
surface and express it in barycentric coordinates of the containing
triangle, yielding a sparse [V_fine, V_coarse] matrix with <= 3 nnz/row
(reference: lib/mesh_sampling.py:67-108, which delegates the nearest-point
query to psbody's C++ AABB tree).

Copy of `cape_tpu.meshops.transfer`, with its two backends:
  * `cape_tpu_torch.meshops.native_aabb`: the C++ BVH (exact, fast), built
    at first use with the host's C++ compiler;
  * numpy fallback, where it cannot be built: exact point-triangle distance
    over KD-tree candidate faces (scipy cKDTree on face centroids).
The two can pick another triangle for a point equidistant from two (the
tie rule is in `_nearest_numpy`). Each upsample matrix logs the backend
that built it (logger `cape_tpu_torch.meshops.transfer`, level INFO). The
port builds upsample matrices only off the canonical plan, whose pyramid
is loaded from the shipped matrices.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.sparse as sp

log = logging.getLogger(__name__)


def closest_point_on_triangles(p: np.ndarray, tri: np.ndarray):
    """Exact closest point from each point to each candidate triangle.

    p: [N, 3] query points; tri: [N, K, 3, 3] candidate triangle corners.
    Returns (dist2 [N, K], bary [N, K, 3]) — squared distances and the
    barycentric coordinates of the closest point (Ericson, RTCD 5.1.5,
    vectorized over N x K).
    """
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    pp = p[:, None, :]
    ab = b - a
    ac = c - a
    ap = pp - a

    d1 = np.einsum("...i,...i->...", ab, ap)
    d2 = np.einsum("...i,...i->...", ac, ap)
    bp = pp - b
    d3 = np.einsum("...i,...i->...", ab, bp)
    d4 = np.einsum("...i,...i->...", ac, bp)
    cp = pp - c
    d5 = np.einsum("...i,...i->...", ab, cp)
    d6 = np.einsum("...i,...i->...", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_face = va + vb + vc
    denom_face = np.where(np.abs(denom_face) < 1e-30, 1.0, denom_face)
    v_face = vb / denom_face
    w_face = vc / denom_face

    # edge AB
    t_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.where(d1 - d3 == 0, 1.0, d1 - d3), 0.0), 0, 1)
    # edge AC
    t_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.where(d2 - d6 == 0, 1.0, d2 - d6), 0.0), 0, 1)
    # edge BC
    denom_bc = (d4 - d3) + (d5 - d6)
    t_bc = np.clip((d4 - d3) / np.where(denom_bc == 0, 1.0, denom_bc), 0, 1)

    bary = np.zeros(p.shape[:1] + tri.shape[1:2] + (3,))
    # region tests, in the standard order
    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = (~in_vert_a) & (~in_vert_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = (~in_vert_a) & (~in_vert_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = (~in_vert_b) & (~in_vert_c) & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    handled = in_vert_a | in_vert_b | in_vert_c | in_edge_ab | in_edge_ac | in_edge_bc

    u = np.where(handled, 0.0, 1.0 - v_face - w_face)
    v = np.where(handled, 0.0, v_face)
    w = np.where(handled, 0.0, w_face)
    u = np.where(in_vert_a, 1.0, u)
    v = np.where(in_vert_b, 1.0, v)
    w = np.where(in_vert_c, 1.0, w)
    u = np.where(in_edge_ab, 1.0 - t_ab, u)
    v = np.where(in_edge_ab, t_ab, v)
    u = np.where(in_edge_ac, 1.0 - t_ac, u)
    w = np.where(in_edge_ac, t_ac, w)
    v = np.where(in_edge_bc, 1.0 - t_bc, v)
    w = np.where(in_edge_bc, t_bc, w)

    bary[..., 0], bary[..., 1], bary[..., 2] = u, v, w
    closest = (
        a * u[..., None] + b * v[..., None] + c * w[..., None]
    )
    diff = pp - closest
    dist2 = np.einsum("...i,...i->...", diff, diff)
    return dist2, bary


def _nearest_numpy(points, verts, faces, k_candidates=64):
    """KD-tree-candidate exact nearest triangle.

    Ties: of triangles equally near a point, the first candidate in KD-tree
    order (by centroid distance) wins (`np.argmin`). The JAX package's C++
    BVH keeps the first face it reaches in its traversal (a strict `<`,
    `native/aabb.cpp`), so at a tie it may pick the other triangle. The two
    closest points then lie equally far from the point but need not
    coincide, so the interpolated vertex can differ."""
    from scipy.spatial import cKDTree

    centroids = verts[faces].mean(axis=1)
    k = min(k_candidates, len(faces))
    _, cand = cKDTree(centroids).query(points, k=k)
    if cand.ndim == 1:
        cand = cand[:, None]
    tri = verts[faces[cand]]                   # [N, K, 3, 3]
    dist2, bary = closest_point_on_triangles(points, tri)
    best = np.argmin(dist2, axis=1)
    rows = np.arange(len(points))
    return cand[rows, best], bary[rows, best]


def build_upsample_matrix(
    coarse_verts: np.ndarray,
    coarse_faces: np.ndarray,
    fine_verts: np.ndarray,
) -> sp.csc_matrix:
    """Sparse barycentric interpolation matrix U: fine = U @ coarse.

    Tries the native C++ BVH first, falls back to the numpy backend."""
    try:
        from cape_tpu_torch.meshops.native_aabb import nearest_triangles

        face_idx, bary = nearest_triangles(coarse_verts, coarse_faces, fine_verts)
        backend = "native"
    except (ImportError, OSError) as e:
        log.info("native BVH unavailable (%s): numpy backend", e)
        face_idx, bary = _nearest_numpy(fine_verts, coarse_verts, coarse_faces)
        backend = "numpy"
    log.info("upsample %d x %d built by the %s backend",
             len(fine_verts), len(coarse_verts), backend)

    nf = len(fine_verts)
    rows = np.repeat(np.arange(nf), 3)
    cols = coarse_faces[face_idx].reshape(-1)
    vals = bary.reshape(-1)
    return sp.csc_matrix(
        (vals, (rows, cols)), shape=(nf, len(coarse_verts))
    )
