"""Mesh topology extraction: adjacency, edge lists, face incidence.

First-party replacement for psbody-mesh's C++ connectivity helpers
(reference: lib/mesh_sampling.py:120,133,244-251 call psbody
`get_vert_connectivity` / `get_vertices_per_edge`). Pure vectorized numpy —
these run offline during pyramid construction.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def vert_connectivity(faces: np.ndarray, num_verts: int) -> sp.csr_matrix:
    """Vertex-vertex adjacency from a triangle list.

    Entry (i, j) counts the number of faces in which the directed pair (i, j)
    appears as an edge — 2 for interior edges of a closed manifold, matching
    the weights found in the reference's shipped A matrices.
    """
    faces = np.asarray(faces, dtype=np.int64)
    # three directed edges per face, both orientations
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2],
                           faces[:, 1], faces[:, 2], faces[:, 0]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0],
                           faces[:, 0], faces[:, 1], faces[:, 2]])
    data = np.ones(len(rows), dtype=np.float64)
    adj = sp.csr_matrix((data, (rows, cols)), shape=(num_verts, num_verts))
    return adj


def vertices_per_edge(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Unique undirected edges as an [E, 2] int32 array with row[0] < row[1]."""
    faces = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    return e.astype(np.int32)


def faces_by_vertex(faces: np.ndarray, num_verts: int) -> sp.csr_matrix:
    """Sparse [V, F] incidence matrix: entry (v, f) = 1 iff face f uses vertex v.

    Used for vertex-normal estimation (reference: lib/losses.py:83-97).
    """
    faces = np.asarray(faces, dtype=np.int64)
    rows = faces.flatten()
    cols = np.repeat(np.arange(faces.shape[0]), 3)
    data = np.ones(len(rows), dtype=np.float64)
    return sp.csr_matrix((data, (rows, cols)), shape=(num_verts, faces.shape[0]))
