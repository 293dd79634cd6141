"""Normalization layers.

Counterpart of `cape_tpu.ops.norm`. Group norm as the reference's
GraphCMR-style layer: G = min(32, C) groups of contiguous channels,
statistics over (channels in the group, vertices), per-channel gamma and
beta. The CMR decoder blocks use it.

In the persistent-padded layout (ops.banded) `n_valid` is the natural
vertex count: the statistics then run over the valid rows only, with
`torch.where` (tail rows may hold anything, inf and NaN included, and
inf * 0 is NaN), the static divisor n_valid * C/G and a two-pass variance,
as `jnp.var` computes it. The output's tail rows are garbage, which the
padded layout tolerates: the next banded apply or the output slice drops
them, and their cotangents are zero.

`group_norm_relu` is the CMR decoder's relu(group_norm(...)). On the CPU
and `meta` it is exactly that; on a CUDA tensor it is one launch of the
hand-written kernel `csrc/group_norm_relu.cu` forward and two backward
(`_GroupNormReLU`) in place of ~19 and ~27 operators, or it raises;
each launch counts in `group_norm_relu` of `ops.kernels.counts`.
`group_norm` stays the plain version, and the tests' reference.
"""

from __future__ import annotations

import functools

import torch

from cape_tpu_torch.ops.kernels import (
    DTYPE_CODES, SMEM_MAX, check_cuda, counts, raise_on, stream,
)


def _masked_moments(x: torch.Tensor, dims, mask: torch.Tensor, n: int):
    """Mean and two-pass variance of x over `dims`, counting only where
    `mask` holds (n such elements)."""
    mean = torch.where(mask, x, 0).sum(dim=dims, keepdim=True) / n
    var = torch.where(mask, (x - mean).square(), 0).sum(dim=dims, keepdim=True) / n
    return mean, var


def _groups(C: int, num_groups: int) -> int:
    """G = min(num_groups, C), which must divide C."""
    G = min(num_groups, C)
    if C % G:
        raise ValueError(
            f"group_norm: {C} channels do not divide into {G} groups "
            "(min(32, C) must divide C; adjust nf / nz_cond / nz_cond2)"
        )
    return G


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    n_valid: int | None = None,
) -> torch.Tensor:
    """x: [B, V, C]; gamma, beta: [C]. Returns [B, V, C]. n_valid: the
    natural vertex count when V is the padded length (None: every row)."""
    B, V, C = x.shape
    G = _groups(C, num_groups)
    # [B, V, C] -> [B, C, V] -> [B, G, C/G, V]: group g holds channels
    # g*C/G .. (g+1)*C/G - 1
    xg = x.transpose(1, 2).reshape(B, G, C // G, V)
    if n_valid is None or n_valid == V:
        mean = xg.mean(dim=(2, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(2, 3), keepdim=True)
    else:
        mask = torch.arange(V, device=x.device) < n_valid
        mean, var = _masked_moments(xg, (2, 3), mask, n_valid * (C // G))
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.reshape(B, C, V) * gamma.to(x.dtype)[None, :, None] + beta.to(x.dtype)[None, :, None]
    return out.transpose(1, 2)


# how csrc/group_norm_relu.cu cuts a norm (`norm_plan`): at most 256 threads
# a block and 8 blocks a cluster; a block's part of x (and dy) aims at 64 KB
# of shared memory, and a launch at two blocks on each of the H100's 132 SMs
NORM_THREADS, NORM_CLUSTER_MAX = 256, 8
NORM_PART_BYTES, NORM_MIN_BLOCKS = 64 * 1024, 2 * 132


@functools.cache
def norm_plan(dtype: torch.dtype, B: int, V: int, C: int, G: int, backward: bool,
              aligned: bool) -> tuple | None:
    """How `csrc/group_norm_relu.cu` cuts a norm of x [B, V, C] into G
    groups, forward or backward: (vec, k, p, rows, threads, smem), the
    kernel's plan arguments in order; None if it takes no such norm.

    A block owns one sample, k consecutive groups (W = k C/G channels) and
    `rows` rows; the p blocks of those groups split V and form a cluster.
    vec is the elements of a 16-byte access (1 where x is not 16-byte
    `aligned` or C, W or G does not allow it): k makes W a multiple of vec
    and, where G allows, a row of W at least 32 bytes (a sector). p, a
    power of two up to 8, aims at NORM_PART_BYTES of the part a block and
    at NORM_MIN_BLOCKS blocks. threads = W / vec accesses a row times the
    rows a sweep. smem: the part (x, and dy backward, each rounded up to
    16 bytes), which every pass reads from shared memory, and the f32
    scratch: two trees of threads x vec partials, two exchanges of W and
    two arrays of k. A part that does not fit in SMEM_MAX takes no plan:
    every GraphCMR decoder norm fits, at any batch."""
    es = dtype.itemsize
    cg = C // G
    vec, k = 16 // es, 1
    if aligned and C % vec == 0:
        while (k * cg) % vec:
            k *= 2
        while k * cg * es < 32 and G % (2 * k) == 0:
            k *= 2
    if not aligned or C % vec or G % k:
        vec, k = 1, 1
    W = k * cg
    nv = W // vec
    if nv > NORM_THREADS:
        return None
    threads = nv * (NORM_THREADS // nv)
    arrays = 2 if backward else 1
    want = max(-(-V * W * es * arrays // NORM_PART_BYTES), -(-NORM_MIN_BLOCKS // (B * G // k)))
    p = 1
    while p < min(want, NORM_CLUSTER_MAX):
        p *= 2
    rows = -(-V // p)
    part = arrays * (-(-rows * W * es // 16) * 16)
    smem = part + 4 * (2 * threads * vec + 2 * W + 2 * k)
    if smem > SMEM_MAX:
        return None
    return vec, k, p, rows, threads, smem


def _plan(x: torch.Tensor, G: int, backward: bool, aligned: bool) -> tuple:
    B, V, C = x.shape
    plan = norm_plan(x.dtype, B, V, C, G, backward, aligned)
    if plan is None:
        raise ValueError(f"group_norm_relu: no plan of csrc/group_norm_relu.cu takes x "
                         f"{tuple(x.shape)} in {G} groups")
    return plan


def _param(t: torch.Tensor, x: torch.Tensor, C: int) -> torch.Tensor:
    """gamma or beta as the kernel reads it: [C] float32, contiguous, on x's
    device."""
    if t.shape != (C,) or t.device != x.device:
        raise ValueError(f"group_norm_relu: gamma and beta must be [{C}] on {x.device}, "
                         f"got {tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


@functools.cache
def _entries():
    """The kernel's library and its two entries, bound once."""
    from cape_tpu_torch.ops.kernels.build import group_norm_relu_lib

    lib = group_norm_relu_lib()
    return lib, lib.cape_group_norm_relu_fwd, lib.cape_group_norm_relu_bwd


class _GroupNormReLU(torch.autograd.Function):
    """relu(group_norm(x, gamma, beta, ...)) on `csrc/group_norm_relu.cu`:
    one launch forward, which saves x and each (sample, group)'s mean and
    rstd; two backward, which recompute x^ and the ReLU's mask from them
    and return dx, dgamma and dbeta (dgamma and dbeta summed over the valid
    rows, the padded layout's tail cotangents being zero)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, n_valid):
        x = x.contiguous()
        check_cuda("group_norm_relu", x)
        if x.dim() != 3:
            raise ValueError(f"group_norm_relu: x {tuple(x.shape)} must be [B, V, C]")
        B, V, C = x.shape
        G = _groups(C, num_groups)
        nv = V if n_valid is None else n_valid
        if not 0 < nv <= V:
            raise ValueError(f"group_norm_relu: n_valid={n_valid} for {V} rows")
        code = DTYPE_CODES[x.dtype]
        g, b = _param(gamma, x, C), _param(beta, x, C)
        y = torch.empty_like(x)
        stats = torch.empty((2, B, G), dtype=torch.float32, device=x.device)  # mean, rstd
        plan = _plan(x, G, False, x.data_ptr() % 16 == 0)
        s = stats.data_ptr()
        lib, fwd, _ = _entries()
        err = fwd(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), s, s + 4 * B * G, code,
                  B, V, C, G, nv, *plan, eps, stream(x))
        raise_on("group_norm_relu", lib, err,
                 lambda: f"x {tuple(x.shape)} {x.dtype}, G={G}, n_valid={nv}, plan {plan}")
        counts["group_norm_relu"] += 1
        ctx.save_for_backward(x, g, b, stats)
        ctx.conf = (code, G, nv, gamma.dtype, beta.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, b, stats = ctx.saved_tensors
        code, G, nv, g_dtype, b_dtype = ctx.conf
        B, V, C = x.shape
        dy = dy.contiguous()
        dx = torch.empty_like(x)
        # each sample's dgamma and dbeta terms [B, 2, C], then their sums [2, C]
        buf = torch.empty((B + 1, 2, C), dtype=torch.float32, device=x.device)
        plan = _plan(x, G, True, (x.data_ptr() | dy.data_ptr()) % 16 == 0)
        s, d = stats.data_ptr(), buf.data_ptr() + 8 * B * C
        lib, _, bwd = _entries()
        err = bwd(x.data_ptr(), dy.data_ptr(), g.data_ptr(), b.data_ptr(), s, s + 4 * B * G,
                  dx.data_ptr(), buf.data_ptr(), d, d + 4 * C, code, B, V, C, G, nv, *plan,
                  stream(x))
        raise_on("group_norm_relu_bwd", lib, err,
                 lambda: f"x {tuple(x.shape)} {x.dtype}, G={G}, n_valid={nv}, plan {plan}")
        counts["group_norm_relu"] += 2
        return dx, buf[B, 0].to(g_dtype), buf[B, 1].to(b_dtype), None, None, None


def group_norm_relu(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    n_valid: int | None = None,
) -> torch.Tensor:
    """relu(group_norm(x, gamma, beta, num_groups, eps, n_valid)). CPU and
    meta tensors take exactly that plain version; a CUDA tensor launches
    `csrc/group_norm_relu.cu` (`_GroupNormReLU`: f32 statistics and
    arithmetic, one rounding to x's dtype; float32, bfloat16 or float16),
    counted in `group_norm_relu` of `kernels.counts`, or raises."""
    if x.device.type in ("cpu", "meta"):
        return torch.relu(group_norm(x, gamma, beta, num_groups, eps, n_valid=n_valid))
    return _GroupNormReLU.apply(x, gamma, beta, num_groups, eps, n_valid)


def batch_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    n_valid: int | None = None,
) -> torch.Tensor:
    """Batch statistics over (batch, vertices) per channel: the reference's
    norm_type='batch'. Training-mode statistics only, as in JAX (no running
    averages)."""
    B, V, _ = x.shape
    if n_valid is None or n_valid == V:
        mean = x.mean(dim=(0, 1), keepdim=True)
        var = (x - mean).square().mean(dim=(0, 1), keepdim=True)
    else:
        mask = (torch.arange(V, device=x.device) < n_valid)[None, :, None]
        mean, var = _masked_moments(x, (0, 1), mask, B * n_valid)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * gamma.to(x.dtype) + beta.to(x.dtype)


def normalize(
    x, gamma, beta, kind: str = "group", num_groups: int = 32, eps: float = 1e-5,
    n_valid: int | None = None,
):
    """The reference's gn() norm_type switch: 'group', 'batch' or 'none'."""
    if kind == "none":
        return x
    if kind == "batch":
        return batch_norm(x, gamma, beta, eps, n_valid=n_valid)
    if kind == "group":
        return group_norm(x, gamma, beta, num_groups, eps, n_valid=n_valid)
    raise NotImplementedError(kind)
