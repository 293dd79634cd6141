"""Minimal Wavefront OBJ mesh IO (vertices + triangular faces only).

Replaces the reference's psbody/trimesh mesh IO dependency
(reference: main.py:14, demos.py:352) with a dependency-free implementation.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file. Returns (vertices [V,3] float64, faces [F,3] int32).

    Only `v` and `f` records are parsed; faces may use the `v/vt/vn` syntax
    (everything after the first `/` is ignored). Faces are 0-indexed on return.
    """
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                parts = line.split()[1:]
                idx = [int(p.split("/")[0]) - 1 for p in parts]
                if len(idx) == 3:
                    faces.append(idx)
                else:  # fan-triangulate polygons
                    for k in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write vertices [V,3] and 0-indexed faces [F,3] as an OBJ file."""
    verts = np.asarray(verts).reshape(-1, 3)
    faces = np.asarray(faces).reshape(-1, 3)
    lines = ["v %.8f %.8f %.8f" % tuple(v) for v in verts]
    lines += ["f %d %d %d" % (f[0] + 1, f[1] + 1, f[2] + 1) for f in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
