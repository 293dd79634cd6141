"""Device-side mesh operators and the graph context of the model.

Counterpart of `cape_tpu.ops.sparse`. The host-side pyramids, their
bandwidth-minimizing orderings and the scaled Laplacians come from the
port's `meshops` (numpy/scipy); this module packs them into torch
operators: the VAE pyramid, the discriminator's ds2 pyramid, the
edge-difference operator of the edge loss and, on request, the decoder's
composed L~@U operators. Every operator applies as
`op(x: [..., n_cols, C]) -> [..., n_rows, C]`:

  IdentityOp - factor-1 pyramid levels ship identity D/U; skipped.
  BandedOp   - the production mode (ops.banded), on reordered matrices.
  EllOp      - fixed-width row gather, y[r] = sum_w val[r,w] x[idx[r,w]],
               whose backward is the gather of the transpose (`EllMatvec`):
               autograd's transpose of index_select and multiply would be a
               scatter-add over a [B, rows, width, C] temporary. Width-1
               selections (downsamples) are a plain index_select.
  DenseOp    - the materialized matrix, one matmul.

In JAX only a BandedOp reaches a kernel; the ELL and dense modes stay
plain PyTorch here too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from cape_tpu_torch.meshops.ordering import permute_edges, permute_pyramid, pyramid_orderings
from cape_tpu_torch.meshops.pyramid import MeshPyramid
from cape_tpu_torch.ops.banded import banded_from_scipy


@dataclasses.dataclass
class IdentityOp:
    n_rows: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def to(self, device) -> "IdentityOp":
        return self


def _gather_apply(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """y[..., r, c] = sum_w val[r, w] * x[..., idx[r, w], c], accumulated as
    `width` separate [.., rows, C] gathers (JAX's order)."""
    val = val.to(x.dtype)
    y = val[:, 0, None] * x.index_select(-2, idx[:, 0])
    for w in range(1, idx.shape[1]):
        y = y + val[:, w, None] * x.index_select(-2, idx[:, w])
    return y


class EllMatvec(torch.autograd.Function):
    """y = M x through the ELL pack; dx = M^T g through the transpose's
    pack (JAX's `ell_matvec` custom VJP)."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        if op.select:
            return x.index_select(-2, op.idx[:, 0])
        return _gather_apply(x, op.idx, op.val)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        return _gather_apply(g, op.t_idx, op.t_val), None


@dataclasses.dataclass
class EllOp:
    """Fixed-width (ELL) sparse matrix with its transpose."""

    idx: torch.Tensor                                 # [rows, width] int64
    val: torch.Tensor | None                          # [rows, width]; None for a selection
    t_idx: torch.Tensor                               # [cols, t_width] int64
    t_val: torch.Tensor                               # [cols, t_width]
    n_cols: int
    select: bool = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return EllMatvec.apply(x, self)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.idx.shape[0], self.n_cols)

    def to(self, device) -> "EllOp":
        return dataclasses.replace(
            self, idx=self.idx.to(device), t_idx=self.t_idx.to(device),
            t_val=self.t_val.to(device), val=None if self.val is None else self.val.to(device),
        )


@dataclasses.dataclass
class DenseOp:
    """The materialized matrix [rows, cols], applied by one matmul."""

    mat: torch.Tensor

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.mat.to(x.dtype), x)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.mat.shape)

    def to(self, device) -> "DenseOp":
        return DenseOp(self.mat.to(device))


def _pack_ell(csr: sp.csr_matrix) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> padded (idx, val). Padded slots point at row 0 with weight 0."""
    rows = csr.shape[0]
    row_nnz = np.diff(csr.indptr)
    width = int(max(1, row_nnz.max() if rows else 1))
    idx = np.zeros((rows, width), dtype=np.int64)
    val = np.zeros((rows, width), dtype=np.float32)
    for r in range(rows):
        lo, hi = csr.indptr[r], csr.indptr[r + 1]
        idx[r, : hi - lo] = csr.indices[lo:hi]
        val[r, : hi - lo] = csr.data[lo:hi]
    return idx, val


def ell_from_scipy(m: sp.spmatrix, dtype=torch.float32, device="cpu") -> EllOp:
    """Pack a scipy sparse matrix and its transpose into gather form."""
    csr = sp.csr_matrix(m)
    idx, val = _pack_ell(csr)
    t_idx, t_val = _pack_ell(sp.csr_matrix(csr.T))
    select = bool(idx.shape[1] == 1 and np.all(np.diff(csr.indptr) == 1)
                  and np.allclose(csr.data, 1.0))
    t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
    return EllOp(
        idx=t(idx, torch.int64), val=None if select else t(val, dtype),
        t_idx=t(t_idx, torch.int64), t_val=t(t_val, dtype),
        n_cols=csr.shape[1], select=select,
    )


def dense_from_scipy(m: sp.spmatrix, dtype=torch.float32, device="cpu") -> DenseOp:
    return DenseOp(torch.as_tensor(sp.csr_matrix(m).toarray()).to(device=device, dtype=dtype))


def _is_identity(m: sp.spmatrix) -> bool:
    m = sp.csr_matrix(m)
    if m.shape[0] != m.shape[1] or m.nnz != m.shape[0]:
        return False
    coo = m.tocoo()
    return bool(np.all(coo.row == coo.col) and np.allclose(coo.data, 1.0))


def make_op(
    m: sp.spmatrix, mode: str = "banded", dtype=torch.float32, padded: bool = False,
    allow_pallas: bool = True, device="cpu",
):
    """Device representation of a host sparse matrix: mode 'banded' (a
    pre-permuted banded matrix, the production path), 'ell' or 'dense'.
    Identities are elided except in dense mode, as in JAX."""
    if mode in ("banded", "ell") and _is_identity(m):
        return IdentityOp(n_rows=m.shape[0])
    if mode == "banded":
        return banded_from_scipy(
            m, dtype=dtype, padded=padded, allow_pallas=allow_pallas, device=device
        )
    if mode == "ell":
        return ell_from_scipy(m, dtype, device)
    if mode == "dense":
        return dense_from_scipy(m, dtype, device)
    raise ValueError(f"op_mode={mode!r}: expected 'banded', 'ell' or 'dense'")


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
    layout; in banded mode its rows are sorted to keep it banded).
    template_verts: [V, 3] template vertex positions.
    loss_mask: [V] per-vertex loss weights, or a 0-d 1.0 (no mask).
    level_sizes / level_sizes_d: natural vertex counts per level of the VAE
    and the discriminator pyramids.
    lap_up: lap_up[i] = L~[i] @ U[i], the decoder's unpool composed into the
    conv's operator (cfg.fuse_decoder); empty unless the context was built
    with build_fused=True. Where U[i] is the identity it is lap[i] itself.
    padded: persistent-padded vertex layout (activations stay at 128-row
    multiples; the model pads once at its input and slices at its output).
    edge_op, template_verts and loss_mask stay in the natural layout.
    perm0: level-0 vertex permutation (banded mode); device tensors live in
    permuted order and hosts permute at I/O. None: natural order.
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
    lap_up: tuple = ()
    padded: bool = False
    perm0: np.ndarray | None = None

    def to(self, device) -> "GraphContext":
        move = lambda ops: tuple(op.to(device) for op in ops)
        return dataclasses.replace(
            self, lap=move(self.lap), down=move(self.down), up=move(self.up),
            lap_d=move(self.lap_d), down_d=move(self.down_d), lap_up=move(self.lap_up),
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
    build_fused: bool = False,
    device="cpu",
) -> GraphContext:
    """Context of both pyramids. mode='banded' (the production path)
    reorders them by the RCM/induced orderings of `meshops.ordering` (a
    copy of the orderings the JAX context uses, so both packages hold the
    same operators) and stores the edge table, the template and the loss
    mask permuted; 'ell' and 'dense' keep the natural order (perm0 None).
    padded=True (banded only) builds the persistent-padded layout.
    use_pallas=False pins every conv to the plain banded apply.
    build_fused=True also composes the L~@U decoder operators
    (GraphContext.lap_up) that cfg.fuse_decoder needs."""
    if padded and mode != "banded":
        raise ValueError("padded layout requires mode='banded'")
    template_verts = np.asarray(template_verts)
    perm0 = None
    if mode == "banded":
        perms = pyramid_orderings(pyramid)
        perms_d = pyramid_orderings(disc_pyramid, base_perm=perms[0])
        pyramid = permute_pyramid(pyramid, perms)
        disc_pyramid = permute_pyramid(disc_pyramid, perms_d)
        edges = permute_edges(edges, perms[0])
        template_verts = template_verts[perms[0]]
        if isinstance(loss_mask, np.ndarray) and loss_mask.ndim > 0:
            loss_mask = loss_mask[perms[0]]
        perm0 = np.asarray(perms[0])
    kw = dict(mode=mode, dtype=dtype, padded=padded, allow_pallas=use_pallas, device=device)
    op = lambda m: make_op(m, **kw)
    scaled = pyramid.scaled_laplacians()
    laps = tuple(op(m) for m in scaled)
    lap_ups = ()
    if build_fused:
        lap_ups = tuple(
            laps[i] if _is_identity(U) else op(sp.csr_matrix(scaled[i] @ U))
            for i, U in enumerate(pyramid.upsamples)
        )
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GraphContext(
        lap=laps,
        down=tuple(op(m) for m in pyramid.downsamples),
        up=tuple(op(m) for m in pyramid.upsamples),
        lap_d=tuple(op(m) for m in disc_pyramid.scaled_laplacians()),
        down_d=tuple(op(m) for m in disc_pyramid.downsamples),
        edges=torch.as_tensor(np.asarray(edges), dtype=torch.int32, device=device),
        # the losses take natural-layout predictions: edge_op stays natural
        edge_op=make_op(
            _edge_incidence(edges, len(template_verts), sort_for_band=mode == "banded"),
            mode=mode, dtype=dtype, allow_pallas=use_pallas, device=device,
        ),
        template_verts=f32(template_verts),
        loss_mask=f32(loss_mask),
        level_sizes=tuple(pyramid.level_sizes),
        level_sizes_d=tuple(disc_pyramid.level_sizes),
        lap_up=lap_ups,
        padded=padded,
        perm0=perm0,
    )
