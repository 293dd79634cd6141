"""Mesh-resolution pyramid: the multi-level graph structure the model runs on.

Equivalent capability to the reference's `generate_transform_matrices`
(lib/mesh_sampling.py:243-263): chain QSlim decimation and barycentric
upsample construction per downsampling factor. The pyramid can also be
loaded from the shipped golden matrices (reference:
data/transform_matrices/{ds2,for_demo}, loaded at lib/load_data.py:7-32),
which is both the offline-free runtime path and the unit-test oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from cape_tpu_torch.meshops.laplacian import scaled_adjacency
from cape_tpu_torch.meshops.qslim import qslim_decimate
from cape_tpu_torch.meshops.topology import vert_connectivity, vertices_per_edge
from cape_tpu_torch.meshops.transfer import build_upsample_matrix


@dataclasses.dataclass
class MeshPyramid:
    """Host-side (scipy) pyramid. Converted to device form by ops.graphctx.

    Level 0 is the full-resolution mesh. For L levels there are L adjacency
    matrices, L-1 downsample matrices D[i] (level i -> i+1) and L-1 upsample
    matrices U[i] (level i+1 -> i), matching the reference's indexing.
    """

    adjacencies: list[sp.csr_matrix]          # [L] square per level
    downsamples: list[sp.spmatrix]            # [L-1]  D[i]: level i -> i+1
    upsamples: list[sp.spmatrix]              # [L-1]  U[i]: level i+1 -> i
    verts: list[np.ndarray] | None = None     # per-level vertex positions
    faces: list[np.ndarray] | None = None     # per-level faces
    edges: list[np.ndarray] | None = None     # per-level unique edge lists

    @property
    def num_levels(self) -> int:
        return len(self.adjacencies)

    @property
    def level_sizes(self) -> list[int]:
        return [a.shape[0] for a in self.adjacencies]

    def scaled_laplacians(self, lmax: float = 2.0) -> list[sp.csr_matrix]:
        """Rescaled Laplacians L~ per level (== negated normalized adjacency)."""
        return [scaled_adjacency(a, lmax=lmax) for a in self.adjacencies]


def build_pyramid(verts: np.ndarray, faces: np.ndarray, factors: list[int]) -> MeshPyramid:
    """Build a pyramid by successive 1/factor QSlim decimation.

    factors follows the reference convention (main.py:31-36): one entry per
    conv layer; factor 1 keeps the level size (identity D/U), factor k
    decimates to ~V/k vertices.
    """
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int32)

    all_verts = [verts]
    all_faces = [faces]
    adjacencies = [vert_connectivity(faces, len(verts))]
    edges = [vertices_per_edge(faces, len(verts))]
    downsamples: list[sp.spmatrix] = []
    upsamples: list[sp.spmatrix] = []

    for factor in factors:
        cur_v, cur_f = all_verts[-1], all_faces[-1]
        if factor == 1:
            nv = len(cur_v)
            eye = sp.identity(nv, format="csc")
            downsamples.append(eye)
            upsamples.append(eye.copy())
            all_verts.append(cur_v)
            all_faces.append(cur_f)
        else:
            new_f, D = qslim_decimate(cur_v, cur_f, factor=1.0 / factor)
            new_v = D @ cur_v
            downsamples.append(D)
            upsamples.append(build_upsample_matrix(new_v, new_f, cur_v))
            all_verts.append(new_v)
            all_faces.append(new_f)
        adjacencies.append(vert_connectivity(all_faces[-1], len(all_verts[-1])))
        edges.append(vertices_per_edge(all_faces[-1], len(all_verts[-1])))

    return MeshPyramid(
        adjacencies=adjacencies,
        downsamples=downsamples,
        upsamples=upsamples,
        verts=all_verts,
        faces=all_faces,
        edges=edges,
    )


CANONICAL_DS_FACTORS = [1, 2, 1, 2, 1, 2, 1, 1]


def load_or_build(ds_factors) -> MeshPyramid:
    """The VAE pyramid for a downsample plan: the shipped canonical
    matrices when the plan matches the reference default (main.py:31-36
    of the reference), else a fresh QSlim build. Every consumer that
    needs a pyramid consistent with the GraphContext's vertex orderings
    (apps/main.build_context)
    must come through here so the canonical check cannot drift."""
    from cape_tpu_torch.meshops import assets

    if list(ds_factors) == CANONICAL_DS_FACTORS:
        return assets.load_pyramid("for_demo")
    print("building mesh pyramid with QSlim (non-canonical plan)...", flush=True)
    verts, faces = assets.template_mesh()
    return build_pyramid(verts, faces, list(ds_factors))


def pyramid_from_matrices(A: list, D: list, U: list) -> MeshPyramid:
    """Wrap pre-computed (e.g. shipped golden) sparse matrices as a pyramid."""
    return MeshPyramid(
        adjacencies=[sp.csr_matrix(a) for a in A],
        downsamples=[sp.csr_matrix(d) for d in D],
        upsamples=[sp.csr_matrix(u) for u in U],
    )
