"""The K=2 Chebyshev convs and the band applies that run on hand-written
kernels, with the plain PyTorch version beside each kernel.

Counterparts of the entries of `cape_tpu/ops/pallas/cheb_kernel.py`:

  * `cheb2_banded_v3` (large batch, `cheb2_banded_pallas_v3`): y = x @ W0 +
    (L~ x) @ W1 as a `torch.autograd.Function` mirroring the JAX custom VJP
    (`_v3_fwd` / `_v3_bwd`). The band apply runs in the CUDA kernel
    `csrc/band_apply.cu` in both directions (it replaces the TPU kernel
    `_pallas_band_apply_v2`); the projections and the weight gradients stay
    `torch.matmul`, as JAX leaves them to XLA. The kernel reads the
    batch-major [B, P, C] activations in place, so the vertex-major
    transposes and the halo pad of the TPU version are gone; its masked
    reads take the place of the pad.
  * `cheb2_banded_v2` (the opt-in small-batch route, `cheb2_banded_pallas_v2`):
    the same band-apply kernel forward, projections in `torch.matmul`, the
    plain backward of JAX's `_bwd`.
  * `cheb2_banded` (`cheb2_banded_pallas`, TPU kernel `_pallas_cheb2_impl`)
    and `cheb2_banded_v5` (`cheb2_banded_pallas_v5`, TPU kernel
    `_pallas_cheb2_v5_impl`): the fused conv, in which L~x never reaches
    device memory, in the CUDA kernel `csrc/cheb2_fused.cu` (`fused_cheb2`)
    with G samples per block (1 for the first, v5's group for the second),
    and the plain backward of JAX's `_bwd` (the JAX package has no backward
    kernel for them).
  * `banded_apply_bm` (TPU kernel `banded_apply_bm`): y = M x for a banded M
    with any column block, batch-major, in the CUDA kernel
    `csrc/band_apply_bm.cu`.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from cape_tpu_torch.ops.banded import apply_blocks

RB = 128

# kernel launches of band_apply without an addend (the forward of
# cheb2_banded_v3 and cheb2_banded_v2) and with one (the backward of
# cheb2_banded_v3); of fused_cheb2 with a group of 1 (kernel 1's case) and
# with a larger group (kernel 4's); of banded_apply_bm. The CPU/meta plain
# paths count in none of them.
launches = 0
bwd_launches = 0
fused1_launches = 0
fused_launches = 0
bm_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1, a.shape[-1])


def _stream(x: torch.Tensor) -> int:
    with torch.cuda.device(x.device):
        return torch.cuda.current_stream().cuda_stream


def _check_cuda(name: str, x: torch.Tensor, **others: torch.Tensor | None) -> None:
    """What every kernel wrapper checks before a launch: x is a contiguous
    CUDA tensor of a dtype the kernels take, and each other tensor given
    (not None) is contiguous, of x's dtype and on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} (kernel takes float32, bfloat16)")
    for k, t in {"x": x, **others}.items():
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name}: {k} {t.dtype} on {t.device}, x {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def _raise_on(name: str, lib, err: int, shapes) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.cape_cuda_error_string(err).decode()} ({shapes})"
        )


def band_apply_plain(x, blocks, pad_left: int, rows_out: int, addend=None) -> torch.Tensor:
    """Plain PyTorch version of the band-apply kernel, with its numerics:
    f32 accumulation (f64 for f64 inputs, which the kernel does not take),
    the addend added at that precision, one rounding to x's dtype at the
    end.

    y[b, t*128+i, c] = sum_k sum_j blocks[k,t,i,j] x[b, (t+k)*cb+j-pad_left, c]
    (+ addend[b, t*128+i, c]) for blocks [S, T, 128, cb] and output rows
    < rows_out; rows of x outside [0, rows_in) read as 0."""
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
    _check_cuda("band_apply", x, blocks=blocks, addend=addend)
    if x.dim() != 3 or blocks.dim() != 4 or tuple(blocks.shape[2:]) != (RB, RB):
        raise ValueError(
            f"band_apply: x {tuple(x.shape)} must be [B, rows, C] and blocks "
            f"{tuple(blocks.shape)} [S, T, {RB}, {RB}]"
        )
    S, T = blocks.shape[:2]
    B, rows_in, C = x.shape
    if not 0 < rows_out <= T * RB or pad_left < 0:
        raise ValueError(f"band_apply: rows_out={rows_out}, pad_left={pad_left}, T={T}")
    if addend is not None and tuple(addend.shape) != (B, rows_out, C):
        raise ValueError(f"band_apply: addend {tuple(addend.shape)} must be [{B}, {rows_out}, {C}]")
    from cape_tpu_torch.ops.kernels.build import band_apply_lib

    lib = band_apply_lib()
    y = torch.empty((B, rows_out, C), dtype=x.dtype, device=x.device)
    err = lib.cape_band_apply(
        x.data_ptr(), blocks.data_ptr(), None if addend is None else addend.data_ptr(),
        y.data_ptr(), _DTYPE_CODES[x.dtype], B, rows_in, C, S, T, pad_left, rows_out, _stream(x),
    )
    _raise_on("band_apply", lib, err, f"x {tuple(x.shape)}, blocks {tuple(blocks.shape)}")
    if addend is None:
        launches += 1
    else:
        bwd_launches += 1
    return y


def _band_meta(band_op, x, natural_only: str | None = None) -> tuple[int, int, int]:
    """(pad_left, pad_right, rows_out) of the band apply of x [B, V, C]: JAX's
    `_band_meta`. Natural-layout ops keep n_rows. Persistent-padded ops take
    x at the tile-padded row count P = T*128 and keep all P output rows;
    their stored pad_right is the natural layout's, so the right halo of the
    window is recomputed (the kernels mask rows past the input, so only the
    plain versions read it). `natural_only` names a caller that takes the
    natural layout only; it raises on a padded op."""
    if not band_op.padded:
        return band_op.pad_left, band_op.pad_right, band_op.n_rows
    if natural_only:
        raise ValueError(f"{natural_only} takes the natural layout only (the op is padded)")
    S, T, _, cb = band_op.blocks.shape
    P = T * RB
    if x.shape[1] != P:
        raise ValueError(f"padded op expects {P} rows, got {x.shape[1]}")
    return band_op.pad_left, max((T + S - 1) * cb - band_op.pad_left - P, 0), P


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
        dx = dw0 = dw1 = None
        if ctx.needs_input_grad[1]:
            dw0 = _flat(x).T @ _flat(g)
        if ctx.needs_input_grad[2]:
            dw1 = _flat(lx).T @ _flat(g)
        if ctx.needs_input_grad[0]:
            gw0 = torch.matmul(g, w0.T).contiguous()
            gw1 = torch.matmul(g, w1.T).contiguous()
            dx = band_apply(gw1, blocks, *ctx.band, addend=gw0)
        return dx, dw0, dw1, None, None, None


def cheb2_banded_v3(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """Large-batch K=2 Chebyshev conv on a square symmetric BandedOp with
    128x128 blocks. x: [B, V, C]; weight: [2, C, F] -> [B, V, F]."""
    pad_left, _, rows_out = _band_meta(band_op, x)
    w = weight.to(x.dtype)
    x = x.contiguous()  # a no-op unless x is a view (the kernel reads it flat)
    return _Cheb2V3.apply(x, w[0], w[1], band_op.blocks.to(x.dtype), pad_left, rows_out)


# ------------------------------------------------------- the fused conv (kernels 1, 4)


def _centre(x: torch.Tensor, pad_left: int, rows_out: int) -> torch.Tensor:
    """x's rows under the output rows: the TPU kernels read them as the
    padded row block t + pad_left // 128 of tile t, so output row r takes x
    row r - pad_left % 128 (zero outside x)."""
    shift = pad_left % RB
    return F.pad(x, (0, 0, shift, max(rows_out - shift - x.shape[1], 0)))[:, :rows_out]


def fused_cheb2_plain(x, blocks, pad_left: int, rows_out: int, w0, w1) -> torch.Tensor:
    """Plain PyTorch version of the fused K=2 conv kernel, with the JAX
    kernels' numerics (`_make_kernel`, `_make_kernel_v5`): the band sum L~x
    in f32 (f64 for f64 inputs), rounded to x's dtype before the W1
    product; both products accumulated in f32 from x's dtype and summed;
    one rounding at the end. y [B, rows_out, F] for x [B, rows_in, C],
    blocks [S, T, 128, 128] and w0, w1 [C, F]; rows of x outside
    [0, rows_in) read as 0."""
    acc = torch.promote_types(x.dtype, torch.float32)
    lx = band_apply_plain(x, blocks, pad_left, rows_out)
    xc = _centre(x, pad_left, rows_out)
    y = torch.matmul(xc.to(acc), w0.to(x.dtype).to(acc))
    return (y + torch.matmul(lx.to(acc), w1.to(x.dtype).to(acc))).to(x.dtype)


def fused_cheb2(
    x: torch.Tensor, blocks: torch.Tensor, pad_left: int, rows_out: int,
    w0: torch.Tensor, w1: torch.Tensor, group: int,
) -> torch.Tensor:
    """y = x_c @ w0 + round(L~ x) @ w1 -> [B, rows_out, F] in one kernel, for
    x [B, rows_in, C], blocks [S, T, 128, 128] and w0, w1 [C, F], all of x's
    dtype, with `group` samples per block (B % group == 0; the kernel
    holds group * C <= 1977 channels of L~x in shared memory, 2284 for a
    group of 4 or more). CUDA tensors launch `csrc/cheb2_fused.cu`; CPU
    and meta tensors take fused_cheb2_plain. A launch counts in `fused1_launches` for a group of
    1 (kernel 1's case), else in `fused_launches` (kernel 4's)."""
    global fused_launches, fused1_launches
    B, rows_in, C = x.shape
    if group < 1 or B % group:
        raise ValueError(f"fused_cheb2: batch {B} is not a multiple of group {group}")
    if x.device.type in ("cpu", "meta"):
        return fused_cheb2_plain(x, blocks, pad_left, rows_out, w0, w1)
    _check_cuda("fused_cheb2", x, blocks=blocks, w0=w0, w1=w1)
    if blocks.dim() != 4 or tuple(blocks.shape[2:]) != (RB, RB):
        raise ValueError(f"fused_cheb2: blocks {tuple(blocks.shape)} must be [S, T, {RB}, {RB}]")
    S, T = blocks.shape[:2]
    Fo = w0.shape[-1]
    if tuple(w0.shape) != (C, Fo) or tuple(w1.shape) != (C, Fo):
        raise ValueError(f"fused_cheb2: w0 {tuple(w0.shape)}, w1 {tuple(w1.shape)} for C={C}")
    if not 0 < rows_out <= T * RB or pad_left < 0:
        raise ValueError(f"fused_cheb2: rows_out={rows_out}, pad_left={pad_left}, T={T}")
    from cape_tpu_torch.ops.kernels.build import cheb2_fused_lib

    lib = cheb2_fused_lib()
    y = torch.empty((B, rows_out, Fo), dtype=x.dtype, device=x.device)
    err = lib.cape_cheb2_fused(
        x.data_ptr(), blocks.data_ptr(), w0.data_ptr(), w1.data_ptr(), y.data_ptr(),
        _DTYPE_CODES[x.dtype], B, rows_in, C, Fo, S, T, pad_left, rows_out, group, _stream(x),
    )
    _raise_on("cheb2_fused", lib, err, f"x {tuple(x.shape)}, blocks {tuple(blocks.shape)}, "
              f"F={Fo}, group={group}")
    if group == 1:
        fused1_launches += 1
    else:
        fused_launches += 1
    return y


def _plain_bwd(meta, x, blocks, w0, w1, g, needs):
    """JAX's `_bwd` (cape_tpu/ops/pallas/cheb_kernel.py): L~x recomputed by
    the plain banded apply; dW0 = x^T g, dW1 = (L~x)^T g,
    dx = g w0^T + L~ (g w1^T) with the forward blocks (L~ is symmetric)."""
    pad_left, pad_right, n_rows = meta
    dx = dw0 = dw1 = None
    if needs[1]:
        dw0 = _flat(x).T @ _flat(g)
    if needs[2]:
        dw1 = _flat(apply_blocks(x, blocks, pad_left, pad_right, n_rows)).T @ _flat(g)
    if needs[0]:
        gw1 = torch.matmul(g, w1.T)
        dx = torch.matmul(g, w0.T) + apply_blocks(gw1, blocks, pad_left, pad_right, n_rows)
    return dx, dw0, dw1


class _FusedCheb2(torch.autograd.Function):
    """The fused conv (kernels 1 and 4) forward; JAX's plain `_bwd` backward."""

    @staticmethod
    def forward(ctx, x, w0, w1, blocks, meta, group):
        ctx.save_for_backward(x, w0, w1, blocks)
        ctx.meta = meta
        return fused_cheb2(x, blocks, meta[0], meta[2], w0, w1, group)

    @staticmethod
    def backward(ctx, g):
        x, w0, w1, blocks = ctx.saved_tensors
        dx, dw0, dw1 = _plain_bwd(ctx.meta, x, blocks, w0, w1, g, ctx.needs_input_grad)
        return dx, dw0, dw1, None, None, None


def v5_group(batch: int, group: int = 4) -> int:
    """v5's samples per block: `group`, halved until it divides the batch."""
    while batch % group:
        group //= 2
    return group


def cheb2_banded(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """Fused K=2 Chebyshev conv, one sample per block (kernel 1,
    `cheb2_banded_pallas`), on a square symmetric BandedOp with 128x128
    blocks in the natural layout. x: [B, V, C]; weight: [2, C, F]."""
    _band_meta(band_op, x, natural_only="cheb2_banded")
    return cheb2_banded_v5(x, band_op, weight, group=1)


def cheb2_banded_v5(x: torch.Tensor, band_op, weight: torch.Tensor, group: int = 4) -> torch.Tensor:
    """Fused K=2 Chebyshev conv with G samples per block (kernel 4,
    `cheb2_banded_pallas_v5`), natural or padded layout; G is `group`
    halved until it divides the batch. x: [B, V, C]; weight: [2, C, F]."""
    w = weight.to(x.dtype)
    return _FusedCheb2.apply(
        x.contiguous(), w[0], w[1], band_op.blocks.to(x.dtype), _band_meta(band_op, x),
        v5_group(x.shape[0], group),
    )


class _Cheb2V2(torch.autograd.Function):
    """y = x @ w0 + (L~ x) @ w1 with L~x on the band-apply kernel, each
    product in x's dtype; JAX's plain `_bwd` backward."""

    @staticmethod
    def forward(ctx, x, w0, w1, blocks, meta):
        ctx.save_for_backward(x, w0, w1, blocks)
        ctx.meta = meta
        lx = band_apply(x, blocks, meta[0], meta[2])
        return torch.matmul(x, w0) + torch.matmul(lx, w1)

    @staticmethod
    def backward(ctx, g):
        x, w0, w1, blocks = ctx.saved_tensors
        dx, dw0, dw1 = _plain_bwd(ctx.meta, x, blocks, w0, w1, g, ctx.needs_input_grad)
        return dx, dw0, dw1, None, None


def cheb2_banded_v2(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """The small-batch route (`cheb2_banded_pallas_v2`) on a square symmetric
    BandedOp with 128x128 blocks in the natural layout. x: [B, V, C];
    weight: [2, C, F]."""
    meta = _band_meta(band_op, x, natural_only="cheb2_banded_v2")
    w = weight.to(x.dtype)
    return _Cheb2V2.apply(x.contiguous(), w[0], w[1], band_op.blocks.to(x.dtype), meta)


# -------------------------------------------------- the batch-major band apply (kernel 3)


def banded_apply_bm_plain(x, blocks, pad_left: int, pad_right: int, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the batch-major band apply kernel, with the
    signature of the JAX `banded_apply_bm`: band_apply_plain, whose numerics
    it keeps and which works out the right halo itself."""
    return band_apply_plain(x, blocks, pad_left, n_rows)


def banded_apply_bm(
    x: torch.Tensor, blocks: torch.Tensor, pad_left: int, pad_right: int, n_rows: int,
) -> torch.Tensor:
    """y = M x for a banded M packed as blocks [S, T, 128, cb] with any column
    block cb; x [B, n_cols, C] -> [B, n_rows, C] (the signature of the JAX
    `banded_apply_bm`). CUDA tensors launch `csrc/band_apply_bm.cu`, which
    reads rows outside x as zero, so pad_right only has to reach the end of
    the last window; CPU and meta tensors take banded_apply_bm_plain.
    Each launch counts in `bm_launches`."""
    global bm_launches
    if x.device.type in ("cpu", "meta"):
        return banded_apply_bm_plain(x, blocks, pad_left, pad_right, n_rows)
    _check_cuda("banded_apply_bm", x, blocks=blocks)
    if x.dim() != 3 or blocks.dim() != 4 or blocks.shape[2] != RB:
        raise ValueError(
            f"banded_apply_bm: x {tuple(x.shape)} must be [B, rows, C] and blocks "
            f"{tuple(blocks.shape)} [S, T, {RB}, cb]"
        )
    S, T, _, cb = blocks.shape
    B, rows_in, C = x.shape
    if (not 0 < n_rows <= T * RB or pad_left < 0
            or pad_left + rows_in + pad_right < (T + S - 1) * cb):
        raise ValueError(
            f"banded_apply_bm: n_rows={n_rows}, pad_left={pad_left}, pad_right={pad_right} "
            f"for {rows_in} rows and blocks {tuple(blocks.shape)}"
        )
    from cape_tpu_torch.ops.kernels.build import band_apply_bm_lib

    lib = band_apply_bm_lib()
    y = torch.empty((B, n_rows, C), dtype=x.dtype, device=x.device)
    err = lib.cape_band_apply_bm(
        x.data_ptr(), blocks.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype],
        B, rows_in, C, S, T, cb, pad_left, n_rows, _stream(x),
    )
    _raise_on("band_apply_bm", lib, err, f"x {tuple(x.shape)}, blocks {tuple(blocks.shape)}")
    bm_launches += 1
    return y
