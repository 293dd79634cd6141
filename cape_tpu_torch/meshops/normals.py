"""Triangle and vertex normal estimation, on tensors.

Counterpart of `cape_tpu.meshops.normals`: the reference's TF port of
psbody triangle geometry (lib/utils.py:119-152: TriNormals /
TriNormalsScaled / NormalizedNx3) and its faces-by-vertex normal averaging
(lib/losses.py:54-97). Used by the normal-consistency losses.
"""

from __future__ import annotations

import numpy as np
import torch


def face_normals_scaled(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unnormalized face normals (cross products).

    verts: [..., V, 3]; faces: [F, 3] integer. Returns [..., F, 3].
    """
    faces = faces.long()
    v0 = verts.index_select(-2, faces[:, 0])
    v1 = verts.index_select(-2, faces[:, 1])
    v2 = verts.index_select(-2, faces[:, 2])
    return torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    ss = v.square().sum(-1, keepdim=True)
    ss = torch.where(ss == 0.0, torch.ones_like(ss), ss)  # zero-area faces keep zero normals
    return v / torch.sqrt(ss)


def face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unit face normals ([..., F, 3]); zero for degenerate faces."""
    return _safe_normalize(face_normals_scaled(verts, faces))


def vertex_normal_matrix(faces: np.ndarray, num_verts: int):
    """Host-side [V, F] faces-by-vertex averaging matrix (scipy sparse),
    the reference's faces_by_vertex (lib/losses.py:83-97)."""
    from cape_tpu_torch.meshops.topology import faces_by_vertex

    return faces_by_vertex(faces, num_verts)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor, ftov_op=None) -> torch.Tensor:
    """Unit vertex normals by averaging incident unnormalized face normals
    (reference estimate_vertex_normals, lib/losses.py:54-80).

    ftov_op: optional operator for the [V, F] incidence matrix (an
    `ops.sparse` op of vertex_normal_matrix); without one, the face
    normals are summed into their vertices with index_add.
    """
    fn = face_normals_scaled(verts, faces)
    if ftov_op is not None:
        acc = ftov_op(fn)
    else:
        flat_idx = faces.long().reshape(-1)
        fn_rep = fn.repeat_interleave(3, dim=-2)
        acc = fn.new_zeros(verts.shape[:-2] + (verts.shape[-2], 3)).index_add(-2, flat_idx, fn_rep)
    return _safe_normalize(acc)
