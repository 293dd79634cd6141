"""Toy meshes for tests, dry runs and examples: subdivided octahedron spheres."""

from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """A closed triangulated sphere: octahedron subdivided n times,
    vertices projected to the unit sphere. n=3 gives 258 verts."""
    verts = [
        (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    ]
    faces = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
        dtype=np.int32,
    )
    for _ in range(subdivisions):
        verts, faces = _subdivide(verts, faces)
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)


def _subdivide(verts, faces):
    verts = [tuple(v) for v in verts]
    cache: dict[tuple[int, int], int] = {}

    def midpoint(i: int, j: int) -> int:
        key = (min(i, j), max(i, j))
        if key not in cache:
            v = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2.0
            v = v / np.linalg.norm(v)
            cache[key] = len(verts)
            verts.append(tuple(v))
        return cache[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return verts, np.asarray(new_faces, dtype=np.int32)
