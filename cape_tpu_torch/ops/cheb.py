"""Chebyshev spectral graph convolution.

Counterpart of `cape_tpu.ops.cheb`: y = sum_k T_k(L~) x @ W[k] with the
recurrence x_k = 2 L~ x_{k-1} - x_{k-2} unrolled (K is static), accumulated
per order, or in the project-first (Clenshaw) order when Fout < Fin.
Weight layout [K, Fin, Fout], as in JAX.

The routing gate is the JAX package's (`cape_tpu/ops/cheb.py`), with its
constants. A K=2 conv on a kernel-eligible banded Laplacian is allowed a
kernel route when its op allows it (cfg.use_pallas), unless
CAPE_TPU_PALLAS overrides that in either direction (`ops.kernels.
override`). An allowed conv takes the large-batch route (v3) once the
batch reaches VM_MIN_BATCH and the merged columns B*C reach VM_MIN_COLS;
below that it takes the small-batch v2 route only when that is opted into
(`ops.kernels.enabled()`) and the op is in the natural layout. Those
thresholds were measured on a TPU; they are kept so that both packages
route the same convs, and are to be recalibrated on the GPU.
"""

from __future__ import annotations

import torch

from cape_tpu_torch.ops import kernels
from cape_tpu_torch.ops.banded import BandedOp
from cape_tpu_torch.ops.kernels import cheb_kernel

VM_MIN_COLS = 2048
VM_MIN_BATCH = 32

# convs the gate sent to the v3 route and to the v2 route (count meta and
# CPU calls too)
kernel_routes = 0
v2_routes = 0


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
    """y = sum_k T_k(L~) x @ W[k]; x: [..., V, Fin], weight [K, Fin, Fout]."""
    global kernel_routes, v2_routes
    K = weight.shape[0]
    if K == 2 and x.dim() == 3 and isinstance(lap, BandedOp) and lap.pallas_eligible:
        env = kernels.override()
        if lap.allow_pallas if env is None else env:
            if x.shape[0] >= VM_MIN_BATCH and x.shape[0] * x.shape[2] >= VM_MIN_COLS:
                kernel_routes += 1
                return cheb_kernel.cheb2_banded_v3(x, lap, weight)
            if kernels.enabled() and not lap.padded:
                v2_routes += 1
                return cheb_kernel.cheb2_banded_v2(x, lap, weight)
    if K > 1 and weight.shape[2] < weight.shape[1]:
        return _cheb_conv_projfirst(x, lap, weight)
    acc = None
    for k, xk in enumerate(cheb_basis(x, lap, K)):
        term = _project(xk, weight[k])
        acc = term if acc is None else acc + term
    return acc


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
    K, fin_total, _ = weight.shape
    fx = x.shape[-1]
    w = weight.to(x.dtype)
    y = cheb_conv(x, lap, w[:, :fx, :])

    V = y.shape[-2]
    seed = (
        torch.ones((V, 1), dtype=x.dtype, device=x.device)
        if cond_seed is None
        else cond_seed.to(x.dtype)
    )
    seed_basis = cheb_basis(seed, lap, K)        # K x [V, 1]
    off = fx
    for c in conds:
        dim = c.shape[-1]
        c = c.to(x.dtype)
        for k in range(K):
            proj = c @ w[k, off : off + dim, :]                  # [B, Fout]
            basis = seed_basis[k].reshape((1,) * (y.dim() - 2) + (V, 1))
            y = y + basis * proj[..., None, :]
        off += dim
    if off != fin_total:
        raise ValueError(f"condition channels {off} != weight rows {fin_total}")
    return y
