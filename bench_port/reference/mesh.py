"""The reference's mesh operators, built from the raw published matrices.

CAPE's graph convolutions run on two pyramids of sparse matrices that the
CAPE release ships (`assets/transform_matrices/{for_demo,ds2}/{A,D,U}.npy`:
adjacencies, downsamplings, upsamplings) and on the SMPL edge table
(`assets/edges_smpl.npy`). The reference reads those files itself and keeps
every operator in the natural (template) vertex order, unpadded: the
rescaled Laplacian L~ = 2 L / lmax - I with lmax = 2 is -D^-1/2 A D^-1/2
(the reference's `lib/mesh_sampling.py`), built in float64 and applied
as a gather, a multiply and an index_add in the dtype of its input.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch


def load_raw(root: str) -> dict:
    """The published matrices under `root` (the repo's assets directory):
    {"A", "D", "U"} of the VAE pyramid, {"A_d", "D_d"} of the
    discriminator's, and "edges" [E, 2]."""
    def mats(which, name):
        path = os.path.join(root, "transform_matrices", which, f"{name}.npy")
        return [sp.csr_matrix(m) for m in np.load(path, allow_pickle=True, encoding="latin1")]

    return {
        "A": mats("for_demo", "A"), "D": mats("for_demo", "D"), "U": mats("for_demo", "U"),
        "A_d": mats("ds2", "A"), "D_d": mats("ds2", "D"),
        "edges": np.load(os.path.join(root, "edges_smpl.npy")).astype(np.int64),
    }


def scaled_laplacian(a: sp.spmatrix) -> sp.csr_matrix:
    a = sp.csr_matrix(a, dtype=np.float64)
    d = np.asarray(a.sum(axis=0)).ravel() + np.spacing(np.float64(0))
    dinv = sp.diags(1.0 / np.sqrt(d))
    return sp.csr_matrix(-(dinv @ a @ dinv))


def is_identity(m: sp.spmatrix) -> bool:
    m = sp.csr_matrix(m)
    if m.shape[0] != m.shape[1] or m.nnz != m.shape[0]:
        return False
    coo = m.tocoo()
    return bool(np.all(coo.row == coo.col) and np.all(coo.data == 1.0))


class SparseOp:
    """y = M x for x [B, n_in, C] -> [B, n_out, C]."""

    def __init__(self, m: sp.spmatrix, device):
        coo = sp.coo_matrix(m)
        self.shape = coo.shape
        self.identity = is_identity(m)
        self.nnz = int(coo.nnz)
        self.rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
        self.cols = torch.as_tensor(coo.col.astype(np.int64), device=device)
        self.vals = torch.as_tensor(coo.data.astype(np.float32), device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return x
        terms = x.index_select(1, self.cols) * self.vals.to(x.dtype)[None, :, None]
        y = x.new_zeros((x.shape[0], self.shape[0], x.shape[2]))
        return y.index_add(1, self.rows, terms)


class RefMesh:
    """Operators of both pyramids and the edge table, on `device`."""

    def __init__(self, raw: dict, device):
        op = lambda m: SparseOp(m, device)
        self.lap = [op(scaled_laplacian(a)) for a in raw["A"]]
        self.down = [op(m) for m in raw["D"]]
        self.up = [op(m) for m in raw["U"]]
        self.lap_d = [op(scaled_laplacian(a)) for a in raw["A_d"]]
        self.down_d = [op(m) for m in raw["D_d"]]
        self.edges = torch.as_tensor(raw["edges"], device=device)
        self.level_sizes = [a.shape[0] for a in raw["A"]]
        self.level_sizes_d = [a.shape[0] for a in raw["A_d"]]
