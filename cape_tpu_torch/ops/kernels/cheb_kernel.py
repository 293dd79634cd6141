"""The large-batch K=2 Chebyshev conv and its band-apply kernel.

Counterpart of `cheb2_banded_pallas_v3` in `cape_tpu/ops/pallas/
cheb_kernel.py`: y = x @ W0 + (L~ x) @ W1, as a `torch.autograd.Function`
mirroring the JAX custom VJP (`_v3_fwd` / `_v3_bwd`). The band apply runs
in the hand-written CUDA kernel `csrc/band_apply.cu` in both directions (it
replaces the TPU kernel `_pallas_band_apply_v2`); the projections and the
weight gradients stay `torch.matmul`, as JAX leaves them to XLA. The
kernel reads the batch-major [B, P, C] activations in place, so the
vertex-major transposes and the halo pad of the TPU version are gone; its
masked reads take the place of the pad.
"""

from __future__ import annotations

import torch

from cape_tpu_torch.ops.banded import apply_blocks

RB = 128

# kernel launches of band_apply without an addend (the forward of
# cheb2_banded_v3) and with one (its backward); the CPU/meta plain path
# counts in neither
launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def band_apply_plain(x, blocks, pad_left: int, rows_out: int, addend=None) -> torch.Tensor:
    """Plain PyTorch version of the band-apply kernel, with its numerics:
    f32 accumulation (f64 for f64 inputs, which the kernel does not take),
    the addend added at that precision, one rounding to x's dtype at the
    end.

    y[b, t*128+i, c] = sum_k sum_j blocks[k,t,i,j] x[b, (t+k)*128+j-pad_left, c]
    (+ addend[b, t*128+i, c]) for output rows < rows_out; rows of x outside
    [0, rows_in) read as 0."""
    S, T, rb, cb = blocks.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    pad_right = max((T + S - 1) * cb - pad_left - x.shape[1], 0)
    y = apply_blocks(x.to(acc), blocks.to(acc), pad_left, pad_right, rows_out)
    if addend is not None:
        y = y + addend.to(acc)
    return y.to(x.dtype)


def band_apply(
    x: torch.Tensor, blocks: torch.Tensor, pad_left: int, rows_out: int,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """Band apply of x [B, rows_in, C] with blocks [S, T, 128, 128] of x's
    dtype -> [B, rows_out, C], plus `addend` [B, rows_out, C] if given.
    CUDA tensors launch the kernel; CPU and meta tensors take
    band_apply_plain. A launch with an addend counts in `bwd_launches`
    (only the backward of cheb2_banded_v3 passes one), else in `launches`."""
    global launches, bwd_launches
    if x.device.type in ("cpu", "meta"):
        return band_apply_plain(x, blocks, pad_left, rows_out, addend)
    if x.device.type != "cuda":
        raise ValueError(f"band_apply: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"band_apply: dtype {x.dtype} (kernel takes float32, bfloat16)")
    if blocks.dtype != x.dtype or blocks.device != x.device:
        raise TypeError(
            f"band_apply: blocks {blocks.dtype} on {blocks.device}, "
            f"x {x.dtype} on {x.device}"
        )
    if x.dim() != 3 or blocks.dim() != 4 or tuple(blocks.shape[2:]) != (RB, RB):
        raise ValueError(
            f"band_apply: x {tuple(x.shape)} must be [B, rows, C] and blocks "
            f"{tuple(blocks.shape)} [S, T, {RB}, {RB}]"
        )
    if not (x.is_contiguous() and blocks.is_contiguous()):
        raise ValueError("band_apply: x and blocks must be contiguous")
    S, T = blocks.shape[:2]
    B, rows_in, C = x.shape
    if not 0 < rows_out <= T * RB or pad_left < 0:
        raise ValueError(f"band_apply: rows_out={rows_out}, pad_left={pad_left}, T={T}")
    if addend is not None and (
        tuple(addend.shape) != (B, rows_out, C) or addend.dtype != x.dtype
        or addend.device != x.device or not addend.is_contiguous()
    ):
        raise ValueError(
            f"band_apply: addend {tuple(addend.shape)} {addend.dtype} on {addend.device} "
            f"must be a contiguous [{B}, {rows_out}, {C}] {x.dtype} on {x.device}"
        )
    from cape_tpu_torch.ops.kernels.build import band_apply_lib

    lib = band_apply_lib()
    y = torch.empty((B, rows_out, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.cape_band_apply(
        x.data_ptr(), blocks.data_ptr(), None if addend is None else addend.data_ptr(),
        y.data_ptr(), _DTYPE_CODES[x.dtype], B, rows_in, C, S, T, pad_left, rows_out, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"band_apply launch failed: {lib.cape_cuda_error_string(err).decode()} "
            f"(x {tuple(x.shape)}, blocks {tuple(blocks.shape)})"
        )
    if addend is None:
        launches += 1
    else:
        bwd_launches += 1
    return y


def _band_meta(band_op, x) -> tuple[int, int]:
    """(pad_left, rows_out) of the band apply of x [B, V, C]. Persistent-
    padded ops take x at the tile-padded row count P = T*128 and keep all
    P output rows; natural-layout ops keep n_rows. The right halo of the
    JAX version is implicit: the kernel masks rows past the input."""
    if band_op.padded:
        P = band_op.blocks.shape[1] * RB
        if x.shape[1] != P:
            raise ValueError(f"padded op expects {P} rows, got {x.shape[1]}")
        return band_op.pad_left, P
    return band_op.pad_left, band_op.n_rows


class _Cheb2V3(torch.autograd.Function):
    """y = x @ w0 + (L~ x) @ w1 with the backward of JAX's `_v3_bwd`:

        dW0 = x^T g,  dW1 = (L~ x)^T g,  dx = g w0^T + L~ (g w1^T)

    L~ is symmetric, so dx reuses the forward blocks; its band apply takes
    g w0^T as the kernel's addend, so dx is written once. In the padded
    layout g's tail rows are zero (see ops.banded.BandedMatvec), so the
    tail rows of x, which may hold anything finite, add nothing to dW0."""

    @staticmethod
    def forward(ctx, x, w0, w1, blocks, pad_left, rows_out):
        lx = band_apply(x, blocks, pad_left, rows_out)
        ctx.save_for_backward(x, lx, w0, w1, blocks)
        ctx.band = (pad_left, rows_out)
        return torch.matmul(x, w0) + torch.matmul(lx, w1)

    @staticmethod
    def backward(ctx, g):
        x, lx, w0, w1, blocks = ctx.saved_tensors
        g = g.contiguous()
        flat = lambda a: a.reshape(-1, a.shape[-1])
        dx = dw0 = dw1 = None
        if ctx.needs_input_grad[1]:
            dw0 = flat(x).T @ flat(g)
        if ctx.needs_input_grad[2]:
            dw1 = flat(lx).T @ flat(g)
        if ctx.needs_input_grad[0]:
            gw0 = torch.matmul(g, w0.T).contiguous()
            gw1 = torch.matmul(g, w1.T).contiguous()
            dx = band_apply(gw1, blocks, *ctx.band, addend=gw0)
        return dx, dw0, dw1, None, None, None


def cheb2_banded_v3(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """Large-batch K=2 Chebyshev conv on a square symmetric BandedOp with
    128x128 blocks. x: [B, V, C]; weight: [2, C, F] -> [B, V, F]."""
    pad_left, rows_out = _band_meta(band_op, x)
    w = weight.to(x.dtype)
    x = x.contiguous()  # a no-op unless x is a view (the kernel reads it flat)
    return _Cheb2V3.apply(x, w[0], w[1], band_op.blocks.to(x.dtype), pad_left, rows_out)
