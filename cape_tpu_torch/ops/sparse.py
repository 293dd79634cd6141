"""Device-side mesh operators and the graph context of the model.

Counterpart of `cape_tpu.ops.sparse` in banded mode. The host-side
pyramids, their bandwidth-minimizing orderings and the scaled Laplacians
come from `cape_tpu.meshops` (numpy/scipy) by import; this module packs
them into torch operators: the VAE pyramid, the discriminator's ds2
pyramid and the edge-difference operator of the edge loss. The fused L~@U
operators of the JAX context serve an opt-in path that is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from cape_tpu.meshops.ordering import permute_edges, permute_pyramid, pyramid_orderings
from cape_tpu.meshops.pyramid import MeshPyramid
from cape_tpu_torch.ops.banded import banded_from_scipy


@dataclasses.dataclass
class IdentityOp:
    n_rows: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def to(self, device) -> "IdentityOp":
        return self


def _is_identity(m: sp.spmatrix) -> bool:
    m = sp.csr_matrix(m)
    if m.shape[0] != m.shape[1] or m.nnz != m.shape[0]:
        return False
    coo = m.tocoo()
    return bool(np.all(coo.row == coo.col) and np.allclose(coo.data, 1.0))


def make_op(
    m: sp.spmatrix, dtype=torch.float32, padded: bool = False,
    allow_pallas: bool = True, device="cpu",
):
    """Device representation of a host sparse matrix in banded mode:
    identities are elided, everything else is packed banded."""
    if _is_identity(m):
        return IdentityOp(n_rows=m.shape[0])
    return banded_from_scipy(
        m, dtype=dtype, padded=padded, allow_pallas=allow_pallas, device=device
    )


def _edge_incidence(edges: np.ndarray, n_verts: int, sort_for_band: bool) -> sp.csr_matrix:
    """[E, V] edge-difference operator: row e = +1 at edges[e,0], -1 at
    edges[e,1]. Rows optionally sorted by endpoint position so the matrix
    is banded under a bandwidth-minimizing vertex order."""
    edges = np.asarray(edges)
    if sort_for_band:
        edges = edges[np.argsort(edges.min(axis=1), kind="stable")]
    E = len(edges)
    rows = np.repeat(np.arange(E), 2)
    cols = edges.reshape(-1)
    vals = np.tile([1.0, -1.0], E)
    return sp.csr_matrix((vals, (rows, cols)), shape=(E, n_verts))


@dataclasses.dataclass
class GraphContext:
    """Mesh constants of a CAPE forward and backward pass.

    lap / down / up: per-level operators of the VAE pyramid.
    lap_d / down_d: operators of the discriminator (ds2) pyramid.
    edges: [E, 2] int32 template edge table (permuted vertex ids).
    edge_op: [E, V] edge-difference operator of the edge loss (natural
    layout, band-sorted rows).
    template_verts: [V, 3] template vertex positions.
    loss_mask: [V] per-vertex loss weights, or a 0-d 1.0 (no mask).
    level_sizes / level_sizes_d: natural vertex counts per level of the VAE
    and the discriminator pyramids.
    padded: persistent-padded vertex layout (activations stay at 128-row
    multiples; the model pads once at its input and slices at its output).
    edge_op, template_verts and loss_mask stay in the natural layout.
    perm0: level-0 vertex permutation; device tensors live in permuted
    order and hosts permute at I/O.
    """

    lap: tuple
    down: tuple
    up: tuple
    lap_d: tuple
    down_d: tuple
    edges: torch.Tensor
    edge_op: object
    template_verts: torch.Tensor
    loss_mask: torch.Tensor
    level_sizes: tuple
    level_sizes_d: tuple
    padded: bool = False
    perm0: np.ndarray | None = None

    def to(self, device) -> "GraphContext":
        move = lambda ops: tuple(op.to(device) for op in ops)
        return dataclasses.replace(
            self, lap=move(self.lap), down=move(self.down), up=move(self.up),
            lap_d=move(self.lap_d), down_d=move(self.down_d),
            edges=self.edges.to(device), edge_op=self.edge_op.to(device),
            template_verts=self.template_verts.to(device),
            loss_mask=self.loss_mask.to(device),
        )


def build_graph_context(
    pyramid: MeshPyramid,
    disc_pyramid: MeshPyramid,
    edges: np.ndarray,
    template_verts: np.ndarray,
    loss_mask: np.ndarray | float = 1.0,
    mode: str = "banded",
    dtype: torch.dtype = torch.float32,
    padded: bool = False,
    use_pallas: bool = True,
    device="cpu",
) -> GraphContext:
    """Context of both pyramids, reordered by the RCM/induced orderings of
    `cape_tpu.meshops.ordering` (the orderings the JAX context uses, so
    both packages hold the same operators); the edge table, the template
    and the loss mask are stored permuted. use_pallas=False pins every conv
    to the plain banded apply. The gather (ELL) and dense modes of the JAX
    package are not ported."""
    if mode != "banded":
        raise NotImplementedError(
            f"op_mode={mode!r}: only the banded mode is ported to cape_tpu_torch"
        )
    perms = pyramid_orderings(pyramid)
    perms_d = pyramid_orderings(disc_pyramid, base_perm=perms[0])
    permuted = permute_pyramid(pyramid, perms)
    permuted_d = permute_pyramid(disc_pyramid, perms_d)
    edges = permute_edges(edges, perms[0])
    template_verts = np.asarray(template_verts)[perms[0]]
    if isinstance(loss_mask, np.ndarray) and loss_mask.ndim > 0:
        loss_mask = loss_mask[perms[0]]
    kw = dict(dtype=dtype, padded=padded, allow_pallas=use_pallas, device=device)
    ops = lambda ms: tuple(make_op(m, **kw) for m in ms)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GraphContext(
        lap=ops(permuted.scaled_laplacians()),
        down=ops(permuted.downsamples),
        up=ops(permuted.upsamples),
        lap_d=ops(permuted_d.scaled_laplacians()),
        down_d=ops(permuted_d.downsamples),
        edges=torch.as_tensor(edges, dtype=torch.int32, device=device),
        # the losses take natural-layout predictions: edge_op stays natural
        edge_op=make_op(
            _edge_incidence(edges, len(template_verts), sort_for_band=True),
            dtype=dtype, allow_pallas=use_pallas, device=device,
        ),
        template_verts=f32(template_verts),
        loss_mask=f32(loss_mask),
        level_sizes=tuple(pyramid.level_sizes),
        level_sizes_d=tuple(disc_pyramid.level_sizes),
        padded=padded,
        perm0=np.asarray(perms[0]),
    )
