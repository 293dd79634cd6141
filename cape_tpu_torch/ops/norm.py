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
"""

from __future__ import annotations

import torch


def _masked_moments(x: torch.Tensor, dims, mask: torch.Tensor, n: int):
    """Mean and two-pass variance of x over `dims`, counting only where
    `mask` holds (n such elements)."""
    mean = torch.where(mask, x, 0).sum(dim=dims, keepdim=True) / n
    var = torch.where(mask, (x - mean).square(), 0).sum(dim=dims, keepdim=True) / n
    return mean, var


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
    G = min(num_groups, C)
    if C % G:
        raise ValueError(
            f"group_norm: {C} channels do not divide into {G} groups "
            "(min(32, C) must divide C; adjust nf / nz_cond / nz_cond2)"
        )
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
