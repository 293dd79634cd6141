"""Chebyshev spectral graph convolution.

Counterpart of `cape_tpu.ops.cheb`: y = sum_k T_k(L~) x @ W[k] with the
recurrence x_k = 2 L~ x_{k-1} - x_{k-2} unrolled (K is static), accumulated
per order, or in the project-first (Clenshaw) order when Fout < Fin.
Weight layout [K, Fin, Fout], as in JAX.

The routing gate is the JAX package's (`cape_tpu/ops/cheb.py`), with its
constants. A K=2 conv on a kernel-eligible banded Laplacian is allowed a
kernel route when its op allows it (cfg.use_pallas), unless
CAPE_TPU_PALLAS overrides that in either direction (`ops.kernels.
allowed`). An allowed conv takes the large-batch route (v3) once the
batch reaches VM_MIN_BATCH and the merged columns B*C reach VM_MIN_COLS;
below that it takes the small-batch v2 route only when that is opted into
(`ops.kernels.enabled()`) and the op is in the natural layout. Those
thresholds were measured on a TPU; they are kept so that both packages
route the same convs, and are to be recalibrated on the GPU.

Under tensor parallelism (`parallel.mesh2d`) a conv weight may be this
rank's shard: a column-parallel conv copies its input, computes the rank's
output channels and gathers them; a row-parallel one scatters its input
channels, computes a partial output and reduces it. A folded conv does
either once, at its exit. The gate judges each rank's own shapes: B is the
rank's rows and C its input channels (fin for a column shard, its share of
them for a row shard). JAX's gate sees the global array inside one jit, so
the two packages may route a sharded conv differently; both routes compute
the same function.
"""

from __future__ import annotations

import torch

from cape_tpu_torch.ops import kernels
from cape_tpu_torch.ops.banded import BandedOp
from cape_tpu_torch.ops.kernels import cheb_kernel
from cape_tpu_torch.parallel.mesh2d import shard_apply

VM_MIN_COLS = 2048
VM_MIN_BATCH = 32


def cheb_basis(x: torch.Tensor, lap, K: int) -> list[torch.Tensor]:
    """The K Chebyshev basis tensors [x, L~x, 2L~(L~x)-x, ...]."""
    xs = [x]
    if K > 1:
        xs.append(lap(x))
    for _ in range(2, K):
        xs.append(2.0 * lap(xs[-1]) - xs[-2])
    return xs


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def _cheb_conv_projfirst(x: torch.Tensor, lap, weight: torch.Tensor) -> torch.Tensor:
    """Project-first (Clenshaw) ordering of the Chebyshev filter:

        u_k = x @ W[k];  b_k = u_k + 2 L~ b_{k+1} - b_{k+2}  (b_K = b_{K+1} = 0)
        y   = u_0 + L~ b_1 - b_2

    An exact reordering; the K-1 operator applies run on Fout channels."""
    K = weight.shape[0]
    u = [_project(x, weight[k]) for k in range(K)]
    bk1 = bk2 = None
    for k in range(K - 1, 0, -1):
        b = u[k]
        if bk1 is not None:
            b = b + 2.0 * lap(bk1)
        if bk2 is not None:
            b = b - bk2
        bk1, bk2 = b, bk1
    y = u[0]
    if bk1 is not None:
        y = y + lap(bk1)
    if bk2 is not None:
        y = y - bk2
    return y


def cheb_conv(x: torch.Tensor, lap, weight: torch.Tensor) -> torch.Tensor:
    """y = sum_k T_k(L~) x @ W[k]; x: [..., V, Fin], weight [K, Fin, Fout]
    (or this rank's shard of it)."""
    return shard_apply(lambda x, _, w: _cheb_conv(x, lap, w), x, [], weight)


def _cheb_conv(x: torch.Tensor, lap, weight: torch.Tensor) -> torch.Tensor:
    """The routing gate: its routes count in `route.v3` and `route.v2` of
    `kernels.counts`, meta and CPU calls too."""
    K = weight.shape[0]
    if (K == 2 and x.dim() == 3 and isinstance(lap, BandedOp) and lap.pallas_eligible
            and kernels.allowed(lap.allow_pallas)):
        if x.shape[0] >= VM_MIN_BATCH and x.shape[0] * x.shape[2] >= VM_MIN_COLS:
            kernels.counts["route.v3"] += 1
            return cheb_kernel.cheb2_banded_v3(x, lap, weight)
        if kernels.enabled() and not lap.padded:
            kernels.counts["route.v2"] += 1
            return cheb_kernel.cheb2_banded_v2(x, lap, weight)
    if K > 1 and weight.shape[2] < weight.shape[1]:
        return _cheb_conv_projfirst(x, lap, weight)
    acc = None
    for k, xk in enumerate(cheb_basis(x, lap, K)):
        term = _project(xk, weight[k])
        acc = term if acc is None else acc + term
    return acc


def cheb_conv_up(x: torch.Tensor, up, lap_up, weight: torch.Tensor) -> torch.Tensor:
    """K<=2 Chebyshev conv with the decoder's unpool composed into the
    operator: y = sum_k T_k(L~_fine) (U x) W[k], evaluated as

        y = U (x W[0]) + (L~ U) (x W[1])

    with lap_up = L~ @ U (GraphContext.lap_up). An exact reordering: the
    projections run at the coarse vertex count and U x never exists."""
    K = weight.shape[0]
    w = weight.to(x.dtype)
    y = up(_project(x, w[0]))
    if K == 1:
        return y
    if K != 2:
        raise ValueError(f"cheb_conv_up takes K <= 2, got K={K}; use cheb_conv")
    return y + lap_up(_project(x, w[1]))


def cheb_conv_up_folded(
    x: torch.Tensor,
    conds: list[torch.Tensor],
    up,
    lap_up,
    weight: torch.Tensor,
) -> torch.Tensor:
    """cheb_conv_up over concat([x, c (x) 1, ...]) taken before the unpool,
    with the condition channels folded (see cheb_conv_folded): each
    condition term is (T_k(L~) U 1) (x) (c W_c[k])."""
    return shard_apply(lambda x, conds, w: _cheb_conv_up_folded(x, conds, up, lap_up, w),
                       x, conds, weight)


def _cheb_conv_up_folded(x, conds, up, lap_up, weight):
    K, fin_total, fout = weight.shape
    fx = x.shape[-1]
    w = weight.to(x.dtype)
    ones = torch.ones((x.shape[-2], 1), dtype=x.dtype, device=x.device)
    seed_basis = [up(ones)]
    if K == 2:
        seed_basis.append(lap_up(ones))
    V = seed_basis[0].shape[-2]
    # a row shard may hold no channel of x, only conditions
    y = (cheb_conv_up(x, up, lap_up, w[:, :fx, :]) if fx
         else x.new_zeros(x.shape[:-2] + (V, fout)))
    return _add_conditions(y, conds, w, seed_basis, fx, fin_total)


def _add_conditions(y, conds, w, seed_basis, off: int, fin_total: int):
    """y plus each condition's term basis_k (x) (c @ W_c[k]), the
    conditions' weight rows starting at `off`."""
    V = y.shape[-2]
    for c in conds:
        dim = c.shape[-1]
        if not dim:
            continue
        c = c.to(y.dtype)
        for k in range(w.shape[0]):
            proj = c @ w[k, off : off + dim, :]                  # [B, Fout]
            basis = seed_basis[k].reshape((1,) * (y.dim() - 2) + (V, 1))
            y = y + basis * proj[..., None, :]
        off += dim
    if off != fin_total:
        raise ValueError(f"condition channels {off} != weight rows {fin_total}")
    return y


def cheb_conv_folded(
    x: torch.Tensor,
    conds: list[torch.Tensor],
    lap,
    weight: torch.Tensor,
    cond_seed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chebyshev conv over concat([x, c_1 (x) 1, c_2 (x) 1, ...]) without
    materializing the per-vertex condition broadcast:

        T_k(A~)(c (x) u) @ W_c[k]  ==  (T_k(A~) u) (x) (c @ W_c[k])

    cond_seed: the per-vertex coefficient of the broadcast condition
    ([V, 1]); None means ones (fresh concat)."""
    return shard_apply(lambda x, conds, w: _cheb_conv_folded(x, conds, lap, w, cond_seed),
                       x, conds, weight)


def _cheb_conv_folded(x, conds, lap, weight, cond_seed):
    K, fin_total, fout = weight.shape
    fx = x.shape[-1]
    w = weight.to(x.dtype)
    # a row shard may hold no channel of x, only conditions
    y = _cheb_conv(x, lap, w[:, :fx, :]) if fx else x.new_zeros(x.shape[:-1] + (fout,))
    V = y.shape[-2]
    seed = (
        torch.ones((V, 1), dtype=x.dtype, device=x.device)
        if cond_seed is None
        else cond_seed.to(x.dtype)
    )
    seed_basis = cheb_basis(seed, lap, K)        # K x [V, 1]
    return _add_conditions(y, conds, w, seed_basis, fx, fin_total)
