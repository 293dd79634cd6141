"""Bandwidth-minimizing vertex orderings for the mesh pyramid.

TPU rationale: arbitrary-index gathers along a ~7k vertex axis are slow on
TPU (measured 3-11 ms per Laplacian apply on v5e), while static slices and
batched MXU matmuls are fast. Reverse-Cuthill-McKee reordering makes the
SMPL Laplacian *banded* (half-bandwidth 165 at full resolution), and
ordering each coarser level by its vertices' positions in the finer
level's order keeps every pyramid matrix banded too (measured <= 292 for
Laplacians, <= 539 scaled for pool/unpool). With banded structure, every
sparse apply becomes a few shifted block matmuls over static slices — no
gathers anywhere on the device (see cape_tpu_torch.ops.banded).

The permutation is applied host-side, once: packed data, template,
edge table, masks and per-vertex parameters all live in permuted order;
outputs are unpermuted at the host I/O boundary.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from cape_tpu_torch.meshops.pyramid import MeshPyramid


def _is_identity(m: sp.spmatrix) -> bool:
    m = sp.csr_matrix(m)
    return (
        m.shape[0] == m.shape[1]
        and m.nnz == m.shape[0]
        and (m != sp.identity(m.shape[0], format="csr")).nnz == 0
    )


def pyramid_orderings(
    pyramid: MeshPyramid, base_perm: np.ndarray | None = None
) -> list[np.ndarray]:
    """Per-level permutations: level 0 by RCM (or a given base ordering),
    each coarser level induced by sorting its vertices by the position of
    their selected counterparts in the finer level's order."""
    A0 = sp.csr_matrix(pyramid.adjacencies[0])
    if base_perm is None:
        base_perm = np.asarray(reverse_cuthill_mckee(A0, symmetric_mode=True))
    perms = [np.asarray(base_perm)]
    for D in pyramid.downsamples:
        D = sp.csr_matrix(D)
        if _is_identity(D):
            perms.append(perms[-1].copy())
            continue
        sel = np.asarray(D.argmax(axis=1)).ravel()      # fine vertex per coarse row
        fine_pos = np.empty(D.shape[1], dtype=np.int64)
        fine_pos[perms[-1]] = np.arange(D.shape[1])
        perms.append(np.argsort(fine_pos[sel], kind="stable"))
    return perms


def permute_pyramid(pyramid: MeshPyramid, perms: list[np.ndarray]) -> MeshPyramid:
    """The pyramid with every matrix rewritten in the permuted orderings."""
    A = [
        sp.csr_matrix(a)[perm][:, perm]
        for a, perm in zip(pyramid.adjacencies, perms)
    ]
    D = [
        sp.csr_matrix(d)[perms[i + 1]][:, perms[i]]
        for i, d in enumerate(pyramid.downsamples)
    ]
    U = [
        sp.csr_matrix(u)[perms[i]][:, perms[i + 1]]
        for i, u in enumerate(pyramid.upsamples)
    ]
    return MeshPyramid(adjacencies=A, downsamples=D, upsamples=U)


def permute_edges(edges: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Edge table rewritten in permuted vertex ids (order-preserving rows)."""
    pos = inverse_permutation(perm)
    return pos[np.asarray(edges)].astype(np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(np.asarray(perm))
    inv[np.asarray(perm)] = np.arange(len(perm))
    return inv
