"""Block-banded sparse apply over the RCM-reordered mesh pyramid.

Counterpart of `cape_tpu.ops.banded`. After the bandwidth-minimizing
reordering (`cape_tpu_torch.meshops.ordering`) every pyramid matrix is banded:
the nonzeros of row tile t (128 rows) fall in a fixed column window around
t * col_stride, so the apply is

    y_tiles = sum_k  blocks[k] @ shifted_view_k(x_padded)

with static slices and batched matmuls. In the JAX package this apply is
XLA code, so here it stays plain torch. The band-apply kernel
(`ops.kernels.cheb_kernel.band_apply`) is reached only through the routing
gate in `ops.cheb`, as in JAX.

The apply is a `torch.autograd.Function` whose backward applies the
transpose, packed in the same banded form (`t_blocks`), as the JAX custom
VJP does: autograd's own backward of the shifted einsum would build
layout-transposed copies of every shifted view.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F


def apply_blocks(x, blocks, pad_left, pad_right, n_rows, padded=False):
    """y = M x for banded M packed as shifted blocks; x [..., rows, C].

    padded=False: x has n_cols rows, y is sliced to n_rows.
    padded=True: x has the tile-padded row count and y keeps all T*rb rows
    (tail input rows are annihilated by structurally zero block columns,
    tail output rows are zero)."""
    S, T, rb, cb = blocks.shape
    if padded:
        pad_right = max((T + S - 1) * cb - pad_left - x.shape[-2], 0)
    xp = F.pad(x, (0, 0, pad_left, pad_right))
    blocks = blocks.to(x.dtype)
    lead = x.shape[:-2]
    y = None
    for k in range(S):
        view = xp[..., k * cb : k * cb + T * cb, :].reshape(lead + (T, cb, x.shape[-1]))
        term = torch.einsum("tij,...tjc->...tic", blocks[k], view)
        y = term if y is None else y + term
    y = y.reshape(lead + (T * rb, x.shape[-1]))
    return y if padded else y[..., :n_rows, :]


class BandedMatvec(torch.autograd.Function):
    """y = M x through `apply_blocks`; the backward is dx = M^T g with the
    transpose packing. In the padded layout g's tail rows are zero wherever
    the output feeds a banded op or a slice back to the natural layout
    (both have zero-tail backward passes), as in JAX's `_banded_bwd`."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return apply_blocks(x, op.blocks, op.pad_left, op.pad_right, op.n_rows, op.padded)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        dx = apply_blocks(g, op.t_blocks, op.t_pad_left, op.t_pad_right, op.n_cols, op.padded)
        return dx, None


def padded_size(n: int, block: int = 128) -> int:
    """Row count of the persistent-padded layout for a natural size n."""
    return -(-n // block) * block


@dataclasses.dataclass
class BandedOp:
    """y[..., i, c] = sum_j M[i, j] x[..., j, c] for banded M.

    padded=False: x [.., n_cols, C] -> y [.., n_rows, C] (natural layout).
    padded=True:  x [.., p_cols, C] -> y [.., p_rows, C] (persistent-padded
    layout; tail input rows are ignored, tail output rows are zero).
    """

    blocks: torch.Tensor                               # [S, T, rb, cb]
    t_blocks: torch.Tensor                             # transpose packing
    n_rows: int
    n_cols: int
    row_block: int
    col_block: int                                     # == col stride per row tile
    pad_left: int
    pad_right: int
    t_pad_left: int
    t_pad_right: int
    padded: bool = False
    allow_pallas: bool = True

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.padded and x.shape[-2] != self.p_cols:
            raise ValueError(
                f"padded BandedOp expects {self.p_cols} input rows, "
                f"got {x.shape[-2]} (natural {self.n_cols})"
            )
        return BandedMatvec.apply(x, self)

    @property
    def p_rows(self) -> int:
        return self.blocks.shape[1] * self.row_block

    @property
    def p_cols(self) -> int:
        return self.t_blocks.shape[1] * self.row_block

    @property
    def pallas_eligible(self) -> bool:
        """The band-apply kernel takes square levels with 128x128 blocks
        (all rescaled Laplacians qualify)."""
        return self.n_rows == self.n_cols and self.row_block == 128 and self.col_block == 128

    def to(self, device) -> "BandedOp":
        return dataclasses.replace(
            self, blocks=self.blocks.to(device), t_blocks=self.t_blocks.to(device)
        )


def _pack_blocks(csr: sp.csr_matrix, row_block: int):
    """Pack a banded CSR into (blocks, col_block, pad_left, pad_right)."""
    R, C = csr.shape
    rb = row_block
    T = -(-R // rb)
    cs_num = C * rb
    if cs_num % R != 0:
        cs = max(1, int(round(C * rb / R)))
    else:
        cs = cs_num // R
    cb = cs

    coo = csr.tocoo()
    t = coo.row // rb
    rel = coo.col - t * cs
    lo = int(rel.min()) if coo.nnz else 0
    hi = int(rel.max()) if coo.nnz else 0
    pad_left = ((max(0, -lo) + cb - 1) // cb) * cb
    S = (pad_left + hi) // cb + 1
    window = S * cb
    pad_right = max((T - 1) * cs + window - pad_left - C, 0)

    blocks = np.zeros((S, T, rb, cb), dtype=np.float32)
    r_in = coo.row - t * rb
    shifted = rel + pad_left
    k = shifted // cb
    c_in = shifted - k * cb
    np.add.at(blocks, (k, t, r_in, c_in), coo.data)
    return blocks, cb, int(pad_left), int(pad_right)


def banded_from_scipy(
    m: sp.spmatrix, row_block: int = 128, dtype=torch.float32,
    padded: bool = False, allow_pallas: bool = True, device="cpu",
) -> BandedOp:
    """Pack a (pre-permuted) banded sparse matrix and its transpose into
    shifted block form. padded=True builds the op in the persistent-padded
    layout."""
    csr = sp.csr_matrix(m)
    R, C = csr.shape
    blocks, cb, pad_left, pad_right = _pack_blocks(csr, row_block)
    t_blocks, _, t_pad_left, t_pad_right = _pack_blocks(sp.csr_matrix(m.T), row_block)
    as_tensor = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return BandedOp(
        blocks=as_tensor(blocks),
        t_blocks=as_tensor(t_blocks),
        n_rows=R,
        n_cols=C,
        row_block=row_block,
        col_block=cb,
        pad_left=pad_left,
        pad_right=pad_right,
        t_pad_left=t_pad_left,
        t_pad_right=t_pad_right,
        padded=padded,
        allow_pallas=allow_pallas,
    )
