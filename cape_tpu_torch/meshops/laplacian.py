"""Graph Laplacians for spectral (Chebyshev) mesh convolution.

Semantics match the reference (lib/mesh_sampling.py:10-38): symmetric
normalized Laplacian L = I - D^{-1/2} W D^{-1/2}, then eigenvalue rescale
L~ = 2L/lmax - I with the standard lmax=2 assumption.

TPU-relevant identity exploited by the runtime ops: with lmax=2 the rescaled
Laplacian is exactly the *negated normalized adjacency*
    L~ = -D^{-1/2} W D^{-1/2},
which has the mesh's edge sparsity (max vertex degree <= ~11 on the SMPL
pyramid) — so on-device application is a tiny fixed-width gather, not a
[V, V] matmul.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def normalized_laplacian(W: sp.spmatrix, normalized: bool = True) -> sp.csr_matrix:
    """Graph Laplacian from a (weighted) adjacency matrix."""
    W = sp.csr_matrix(W)
    d = np.asarray(W.sum(axis=0)).ravel()
    if not normalized:
        return (sp.diags(d) - W).tocsr()
    d = d + np.spacing(np.array(0, W.dtype))
    dinv_sqrt = 1.0 / np.sqrt(d)
    Dinv = sp.diags(dinv_sqrt)
    I = sp.identity(W.shape[0], dtype=W.dtype, format="csr")
    return (I - Dinv @ W @ Dinv).tocsr()


def rescale_laplacian(L: sp.spmatrix, lmax: float = 2.0) -> sp.csr_matrix:
    """Rescale eigenvalues into [-1, 1]: L~ = 2L/lmax - I."""
    L = sp.csr_matrix(L, copy=True)
    I = sp.identity(L.shape[0], format="csr", dtype=L.dtype)
    return (L * (2.0 / lmax) - I).tocsr()


def scaled_adjacency(W: sp.spmatrix, lmax: float = 2.0) -> sp.csr_matrix:
    """The rescaled Laplacian computed directly from the adjacency.

    Identical (up to fp rounding) to rescale_laplacian(normalized_laplacian(W))
    but built without forming I - .. - I, so the result has the pure adjacency
    sparsity plus an explicit diagonal only when lmax != 2.
    """
    W = sp.csr_matrix(W)
    d = np.asarray(W.sum(axis=0)).ravel() + np.spacing(np.array(0, W.dtype))
    dinv_sqrt = 1.0 / np.sqrt(d)
    Dinv = sp.diags(dinv_sqrt)
    A_norm = (Dinv @ W @ Dinv).tocsr()
    if lmax == 2.0:
        return (-A_norm).tocsr()
    I = sp.identity(W.shape[0], format="csr", dtype=W.dtype)
    return ((I - A_norm) * (2.0 / lmax) - I).tocsr()
