"""Device-side mesh operators and the graph context of the VAE pyramid.

Counterpart of `cape_tpu.ops.sparse` in banded mode. The host-side
pyramid, its bandwidth-minimizing orderings and the scaled Laplacians come
from `cape_tpu.meshops` (numpy/scipy) by import; this module packs them
into torch operators. Only what the serving path applies is built: the
discriminator's operators, the edge operator and the fused L~@U operators
of the JAX context serve training or opt-in paths and are not ported yet
(their level sizes are kept, since parameter shapes depend on them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from cape_tpu.meshops.ordering import permute_pyramid, pyramid_orderings
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


@dataclasses.dataclass
class GraphContext:
    """Mesh constants of a CAPE forward pass.

    lap / down / up: per-level operators of the VAE pyramid.
    level_sizes / level_sizes_d: natural vertex counts per level of the VAE
    and the discriminator pyramids.
    padded: persistent-padded vertex layout (activations stay at 128-row
    multiples; the model pads once at its input and slices at its output).
    perm0: level-0 vertex permutation; device tensors live in permuted
    order and hosts permute at I/O.
    """

    lap: tuple
    down: tuple
    up: tuple
    level_sizes: tuple
    level_sizes_d: tuple
    padded: bool = False
    perm0: np.ndarray | None = None

    def to(self, device) -> "GraphContext":
        move = lambda ops: tuple(op.to(device) for op in ops)
        return dataclasses.replace(
            self, lap=move(self.lap), down=move(self.down), up=move(self.up)
        )


def build_graph_context(
    pyramid: MeshPyramid,
    disc_pyramid: MeshPyramid,
    mode: str = "banded",
    dtype: torch.dtype = torch.float32,
    padded: bool = False,
    use_pallas: bool = True,
    device="cpu",
) -> GraphContext:
    """Context of the VAE pyramid, reordered by the RCM/induced orderings
    of `cape_tpu.meshops.ordering` (the same orderings the JAX context
    uses, so both packages hold the same operators). use_pallas=False pins
    every conv to the plain banded apply. The gather (ELL) and dense modes
    of the JAX package are not ported."""
    if mode != "banded":
        raise NotImplementedError(
            f"op_mode={mode!r}: only the banded mode is ported to cape_tpu_torch"
        )
    perms = pyramid_orderings(pyramid)
    permuted = permute_pyramid(pyramid, perms)
    kw = dict(dtype=dtype, padded=padded, allow_pallas=use_pallas, device=device)
    return GraphContext(
        lap=tuple(make_op(L, **kw) for L in permuted.scaled_laplacians()),
        down=tuple(make_op(D, **kw) for D in permuted.downsamples),
        up=tuple(make_op(U, **kw) for U in permuted.upsamples),
        level_sizes=tuple(pyramid.level_sizes),
        level_sizes_d=tuple(disc_pyramid.level_sizes),
        padded=padded,
        perm0=np.asarray(perms[0]),
    )
