"""Quadric-error-metric (QSlim-style) mesh decimation.

First-party replacement for the reference's heap-based decimator
(reference: lib/mesh_sampling.py:40-241), with the same *semantics* —
surviving vertices keep their original positions, so the downsample
transform D is a pure 0/1 vertex-selection matrix — but a different
algorithm shape: instead of rewriting the whole priority queue on every
collapse, we use a union-find vertex remap with lazy heap revalidation.

Runs offline on the host; the result feeds the runtime mesh pyramid.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import scipy.sparse as sp

from cape_tpu_torch.meshops.topology import vertices_per_edge


def vertex_quadrics(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex 4x4 error quadrics, vectorized over faces.

    Each face contributes the outer product of its (normalized) plane
    equation [n, d] to the quadrics of its three vertices.
    """
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    norm = np.where(norm < 1e-30, 1.0, norm)
    n = n / norm
    d = -np.einsum("fi,fi->f", n, v0)
    eq = np.concatenate([n, d[:, None]], axis=1)                  # [F, 4]
    q_face = np.einsum("fi,fj->fij", eq, eq)                      # [F, 4, 4]
    Qv = np.zeros((len(verts), 4, 4))
    for k in range(3):
        np.add.at(Qv, faces[:, k], q_face)
    return Qv


def _pair_cost(Qv: np.ndarray, verts_h: np.ndarray, r: int, c: int):
    """Cost of collapsing edge (r, c) onto one of its endpoints.

    Returns (collapse_cost, keep, destroy, Qsum): the cheaper endpoint
    position survives, matching the reference's endpoint-only placement.
    """
    Qsum = Qv[r] + Qv[c]
    pr, pc = verts_h[r], verts_h[c]
    cost_keep_r = float(pr @ Qsum @ pr)   # destroy c, keep r's position
    cost_keep_c = float(pc @ Qsum @ pc)   # destroy r, keep c's position
    if cost_keep_r < cost_keep_c:
        return cost_keep_r, r, c, Qsum
    return cost_keep_c, c, r, Qsum


def qslim_decimate(
    verts: np.ndarray,
    faces: np.ndarray,
    factor: float | None = None,
    n_verts_desired: int | None = None,
) -> tuple[np.ndarray, sp.csc_matrix]:
    """Decimate a triangle mesh to ~factor * V vertices.

    Returns (new_faces [F',3] reindexed into the surviving vertex set,
    D [V', V] 0/1 selection matrix with the surviving vertices in original
    index order), mirroring the reference's output contract
    (lib/mesh_sampling.py:111-241).
    """
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64).copy()
    nv = len(verts)
    if n_verts_desired is None:
        if factor is None:
            raise ValueError("need factor or n_verts_desired")
        n_verts_desired = math.ceil(nv * factor)

    Qv = vertex_quadrics(verts, faces)
    verts_h = np.concatenate([verts, np.ones((nv, 1))], axis=1)   # homogeneous

    parent = np.arange(nv)

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:            # path compression
            parent[i], i = root, parent[i]
        return root

    heap: list[tuple[float, int, int]] = []
    for r, c in vertices_per_edge(faces, nv):
        cost, _, _, _ = _pair_cost(Qv, verts_h, int(r), int(c))
        heap.append((cost, int(r), int(c)))
    heapq.heapify(heap)

    n_live = len(np.unique(faces))
    eps = 1e-12
    while n_live > n_verts_desired and heap:
        cost0, r0, c0 = heapq.heappop(heap)
        r, c = find(r0), find(c0)
        if r == c:
            continue
        cost, keep, destroy, Qsum = _pair_cost(Qv, verts_h, r, c)
        if cost > cost0 + eps:              # stale entry: revalidate lazily
            heapq.heappush(heap, (cost, r, c))
            continue
        parent[destroy] = keep
        Qv[keep] = Qsum
        Qv[destroy] = Qsum
        faces[faces == destroy] = keep
        degenerate = (
            (faces[:, 0] == faces[:, 1])
            | (faces[:, 1] == faces[:, 2])
            | (faces[:, 2] == faces[:, 0])
        )
        faces = faces[~degenerate]
        n_live = len(np.unique(faces))

    return _selection_transform(faces, nv)


def _selection_transform(faces: np.ndarray, num_original_verts: int):
    """Reindex faces onto the surviving vertices; build the D selection matrix."""
    survivors = np.unique(faces)
    remap = np.zeros(num_original_verts, dtype=np.int64)
    remap[survivors] = np.arange(len(survivors))
    new_faces = remap[faces]
    D = sp.csc_matrix(
        (np.ones(len(survivors)), (np.arange(len(survivors)), survivors)),
        shape=(len(survivors), num_original_verts),
    )
    return new_faces.astype(np.int32), D
