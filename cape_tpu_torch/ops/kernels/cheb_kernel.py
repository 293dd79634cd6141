"""The K=2 Chebyshev convs and the band applies that run on hand-written
kernels, with the plain PyTorch version beside each kernel.

Counterparts of the entries of `cape_tpu/ops/pallas/cheb_kernel.py`:

  * `cheb2_banded_v3` (large batch, `cheb2_banded_pallas_v3`): y = x @ W0 +
    (L~ x) @ W1 as a `torch.autograd.Function` mirroring the JAX custom VJP
    (`_v3_fwd` / `_v3_bwd`). The band apply runs in the CUDA kernel
    `csrc/band_gather.cu` in both directions (it replaces the TPU kernel
    `_pallas_band_apply_v2`), over the op's gather pack (the band's
    non-zeros per output row, `ops.banded.gather_pack`); the projections
    and the weight gradients stay `torch.matmul`, as JAX leaves them to
    XLA. The kernel reads the batch-major [B, P, C] activations in place,
    so the vertex-major transposes and the halo pad of the TPU version are
    gone; its masked reads take the place of the pad.
  * `cheb2_banded_v2` (the opt-in small-batch route, `cheb2_banded_pallas_v2`):
    the same band-apply kernel forward, projections in `torch.matmul`, the
    plain backward of JAX's `_bwd`.
  * `cheb2_banded` (`cheb2_banded_pallas`, TPU kernel `_pallas_cheb2_impl`)
    and `cheb2_banded_v5` (`cheb2_banded_pallas_v5`, TPU kernel
    `_pallas_cheb2_v5_impl`): the fused conv, in which L~x never reaches
    device memory, in the CUDA kernel `csrc/cheb2_fused.cu` (`fused_cheb2`):
    one streamed GEMM per block tile whose L~x operand is gathered from the
    op's gather pack chunk by chunk, with G samples per tile (1 for the
    first, v5's group for the second), tiled by `fused_plan`; and the plain
    backward of JAX's `_bwd` (the JAX package has no backward kernel for
    them).
  * `cheb2_banded_v6` and `cheb2_banded_v7` (`cheb2_banded_pallas_v6` / `_v7`,
    TPU kernels `_pallas_cheb2_v6_impl` and `_pallas_cheb2_v7_impl`): the same
    fused conv in the windowed kernel of `csrc/cheb2_fused.cu` (`ring_cheb2`),
    whose block stages the x rows that one or two row tiles read (their
    window, from the op's gather pack) in shared memory, chunk by chunk, and
    gathers L~x from there; tiled by `ring_plan`; the same plain backward.
  * `banded_apply_bm` (TPU kernel `banded_apply_bm`): y = M x for a banded M
    with any column block, batch-major, in the same band-gather kernel.
  * the plain `BandedOp` applies (`ops.banded.BandedMatvec`, XLA code in
    the JAX package) run `band_apply` too on CUDA, for any column block, in
    both directions (`ops.banded.kernel_apply`).

The band-apply wrappers and the fused conv take the gather pack of their
blocks (`pack=`): a CUDA launch needs it, and the wrappers never build one.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from cape_tpu_torch.ops.banded import WINDOW_TILES, GatherPack, apply_blocks
from cape_tpu_torch.ops.kernels import (
    DTYPE_CODES, SMEM_MAX, check_cuda, check_tensors, counts, raise_on, stream,
)

RB = 128

# the dtypes of the fused and windowed conv kernels (csrc/cheb2_fused.cu)
_FUSED_DTYPES = (torch.float32, torch.bfloat16)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1, a.shape[-1])


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


def band_gather_plain(x, pack: GatherPack, rows_out: int, addend=None) -> torch.Tensor:
    """Plain PyTorch version of the band-gather kernel, with its arithmetic:

        y[b, r, :] = sum_w vals[r, w] x[b, cols[r, w], :]  (+ addend[b, r, :])

    for r < rows_out, rows of x outside [0, rows_in) read as 0; each value
    rounded to x's dtype, the products summed in f32 (f64 for f64 inputs,
    which the kernel does not take), the addend added at that precision,
    one rounding to x's dtype at the end."""
    acc = torch.promote_types(x.dtype, torch.float32)
    cols = pack.cols[:rows_out].to(x.device, torch.int64)
    vals = pack.vals[:rows_out].to(x.device).to(x.dtype).to(acc)
    inside = (cols >= 0) & (cols < x.shape[1])
    g = x.to(acc).index_select(1, torch.where(inside, cols, 0).reshape(-1))
    g = g.reshape(x.shape[0], rows_out, pack.width, x.shape[2])
    y = torch.where(inside[..., None], g * vals[..., None], 0).sum(2)
    if addend is not None:
        y = y + addend.to(acc)
    return y.to(x.dtype)


def _check_pack(name: str, pack: GatherPack | None, blocks: torch.Tensor, pad_left: int,
                x: torch.Tensor) -> None:
    """A launch (x not on the CPU or `meta`) needs the gather pack of
    exactly these blocks at this pad_left, on x's device; the wrappers
    never build one. A pack given to a plain version is checked against the
    blocks too."""
    if pack is None:
        if x.device.type in ("cpu", "meta"):
            return
        raise ValueError(f"{name}: a kernel launch needs the op's gather pack (pack=op.pack)")
    pack.check(name, blocks, pad_left)
    if x.is_cuda and pack.cols.device != x.device:   # the pack's tensors share one device
        raise TypeError(f"{name}: the gather pack is on {pack.cols.device}, x on {x.device}")


def _gather(name: str, x: torch.Tensor, pack: GatherPack, rows_out: int,
            addend: torch.Tensor | None) -> torch.Tensor:
    """Launch `csrc/band_gather.cu` on a checked CUDA x [B, rows_in, C]."""
    B, rows_in, C = x.shape
    from cape_tpu_torch.ops.kernels.build import band_gather_lib

    lib = band_gather_lib()
    y = torch.empty((B, rows_out, C), dtype=x.dtype, device=x.device)
    err = lib.cape_band_gather(
        x.data_ptr(), pack.cols.data_ptr(), pack.vals.data_ptr(),
        None if addend is None else addend.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype],
        B, rows_in, C, pack.width, rows_out, stream(x),
    )
    raise_on(name, lib, err,
             lambda: f"x {tuple(x.shape)}, pack width {pack.width}, rows_out={rows_out}")
    return y


def band_apply(
    x: torch.Tensor, blocks: torch.Tensor, pad_left: int, rows_out: int,
    addend: torch.Tensor | None = None, pack: GatherPack | None = None,
) -> torch.Tensor:
    """Band apply of x [B, rows_in, C] with blocks [S, T, 128, cb] (any
    column block; the kernel reads the pack, not the blocks) -> [B,
    rows_out, C], plus `addend` [B, rows_out, C] if given. CUDA tensors
    launch the band-gather kernel over `pack`, the gather pack of the
    blocks (required there); CPU and meta tensors take band_apply_plain. A
    pack given is checked against the blocks on every device. A launch on
    bf16 (f16) tensors counts in `band_apply.bfloat16` (`.float16`) of
    `kernels.counts`; its callers count it by route (`band_apply.conv`,
    `.conv_bwd`, `.op`)."""
    _check_pack("band_apply", pack, blocks, pad_left, x)
    if x.device.type in ("cpu", "meta"):
        return band_apply_plain(x, blocks, pad_left, rows_out, addend)
    check_cuda("band_apply", x, addend=addend)
    if x.dim() != 3 or blocks.dim() != 4 or blocks.shape[2] != RB:
        raise ValueError(
            f"band_apply: x {tuple(x.shape)} must be [B, rows, C] and blocks "
            f"{tuple(blocks.shape)} [S, T, {RB}, cb]"
        )
    T = blocks.shape[1]
    B, _, C = x.shape
    if not 0 < rows_out <= T * RB or pad_left < 0:
        raise ValueError(f"band_apply: rows_out={rows_out}, pad_left={pad_left}, T={T}")
    if addend is not None and tuple(addend.shape) != (B, rows_out, C):
        raise ValueError(f"band_apply: addend {tuple(addend.shape)} must be [{B}, {rows_out}, {C}]")
    y = _gather("band_apply", x, pack, rows_out, addend)
    if x.dtype != torch.float32:
        counts["band_apply.bfloat16" if x.dtype == torch.bfloat16 else "band_apply.float16"] += 1
    return y


def _band_meta(band_op, x, natural_only: str | None = None) -> tuple[int, int, int]:
    """(pad_left, pad_right, rows_out) of the band apply of x [B, V, C]: JAX's
    `_band_meta`. Natural-layout ops keep n_rows. Persistent-padded ops take
    x at the op's padded column count (`rows_in`, p_cols) and keep all
    p_rows = T*128 output rows (`rows_out`; both T*128 for a square op);
    their stored pad_right is the natural layout's, so the right halo of the
    window is recomputed (the kernels mask rows past the input, so only the
    plain versions read it). `natural_only` names a caller that takes the
    natural layout only; it raises on a padded op."""
    if not band_op.padded:
        return band_op.pad_left, band_op.pad_right, band_op.n_rows
    if natural_only:
        raise ValueError(f"{natural_only} takes the natural layout only (the op is padded)")
    S, T, _, cb = band_op.blocks.shape
    P = band_op.rows_in
    if x.shape[1] != P:
        raise ValueError(f"padded op expects {P} rows, got {x.shape[1]}")
    return band_op.pad_left, max((T + S - 1) * cb - band_op.pad_left - P, 0), band_op.rows_out


class _Cheb2V3(torch.autograd.Function):
    """y = x @ w0 + (L~ x) @ w1 with the backward of JAX's `_v3_bwd`:

        dW0 = x^T g,  dW1 = (L~ x)^T g,  dx = g w0^T + L~ (g w1^T)

    L~ is symmetric, so dx reuses the forward blocks and pack; its band
    apply takes g w0^T as the kernel's addend, so dx is written once. In
    the padded layout g's tail rows are zero (see ops.banded.BandedMatvec),
    so the tail rows of x, which may hold anything finite, add nothing to
    dW0."""

    @staticmethod
    def forward(ctx, x, w0, w1, blocks, pad_left, rows_out, pack):
        lx = band_apply(x, blocks, pad_left, rows_out, pack=pack)
        counts["band_apply.conv"] += x.is_cuda
        ctx.save_for_backward(x, lx, w0, w1, blocks)
        ctx.band = (pad_left, rows_out)
        ctx.pack = pack
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
            dx = band_apply(gw1, blocks, *ctx.band, addend=gw0, pack=ctx.pack)
            counts["band_apply.conv_bwd"] += g.is_cuda
        return dx, dw0, dw1, None, None, None, None


def cheb2_banded_v3(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """Large-batch K=2 Chebyshev conv on a square symmetric BandedOp with
    128x128 blocks. x: [B, V, C]; weight: [2, C, F] -> [B, V, F]."""
    pad_left, _, rows_out = _band_meta(band_op, x)
    w = weight.to(x.dtype)
    x = x.contiguous()  # a no-op unless x is a view (the kernel reads it flat)
    return _Cheb2V3.apply(x, w[0], w[1], band_op.blocks.to(x.dtype), pad_left, rows_out,
                          band_op.pack)


# ------------------------------------------------------- the fused conv (kernels 1, 4)


def _centre(x: torch.Tensor, pad_left: int, rows_out: int) -> torch.Tensor:
    """x's rows under the output rows: the TPU kernels read them as the
    padded row block t + pad_left // 128 of tile t, so output row r takes x
    row r - pad_left % 128 (zero outside x)."""
    shift = pad_left % RB
    return F.pad(x, (0, 0, shift, max(rows_out - shift - x.shape[1], 0)))[:, :rows_out]


def fused_cheb2_plain(x, blocks, pad_left: int, rows_out: int, w0, w1) -> torch.Tensor:
    """Plain PyTorch version of the fused K=2 conv kernels, with the JAX
    kernels' numerics: kernels 1, 4, 5 and 6 (`_make_kernel`,
    `_make_kernel_v5`, `_v6`, `_v7`) compute the same function with the
    same numerics, and so do both kernels of `cheb2_fused.cu`. The band
    sum L~x in f32 (f64 for f64 inputs), rounded to x's dtype before the W1
    product; both products accumulated in f32 from x's dtype and summed;
    one rounding at the end. y [B, rows_out, F] for x [B, rows_in, C],
    blocks [S, T, 128, 128] and w0, w1 [C, F]; rows of x outside
    [0, rows_in) read as 0."""
    acc = torch.promote_types(x.dtype, torch.float32)
    lx = band_apply_plain(x, blocks, pad_left, rows_out)
    xc = _centre(x, pad_left, rows_out)
    y = torch.matmul(xc.to(acc), w0.to(x.dtype).to(acc))
    return (y + torch.matmul(lx.to(acc), w1.to(x.dtype).to(acc))).to(x.dtype)


# the tiling of csrc/cheb2_fused.cu: a block tile of FUSED_BM rows, K chunks
# of FUSED_BK channels (per dtype) through FUSED_STAGES shared-memory stages
FUSED_BM, FUSED_STAGES = 128, 2
FUSED_BK = {torch.float32: 32, torch.bfloat16: 64}


def _product_tile(dtype: torch.dtype, F: int) -> tuple[int, int]:
    """(BN, bytes of one A and one B stage) of csrc/cheb2_fused.cu's product
    tile for F output columns: BN is the least of 128, 64, 32 (and 16 in
    bf16) that is not narrower than F allows; f32 A rows are padded to BK +
    4, bf16 A and B rows by 8 elements."""
    BK = FUSED_BK[dtype]
    if dtype == torch.float32:
        BN = 128 if F > 64 else 64 if F > 32 else 32
        return BN, 4 * (FUSED_BM * (BK + 4) + BK * BN)
    BN = 128 if F > 64 else 64 if F > 32 else 32 if F > 16 else 16
    return BN, 2 * (FUSED_BM * (BK + 8) + BK * (BN + 8))


@functools.cache
def fused_plan(dtype: torch.dtype, B: int, rows_out: int, C: int, F: int, G: int,
               width: int) -> dict | None:
    """How `csrc/cheb2_fused.cu` tiles a fused conv of these sizes, for a
    gather pack `width` pairs wide; None if it takes no such conv.

    A block computes a tile of BM output rows, G samples by `rows` = BM // G
    rows each, and BN output columns; the K loop streams 2C channels in
    chunks of BK through `stages` shared-memory stages. Block x = row tile *
    ceil(F / BN) + column tile, block y = sample group. `smem` is the
    block's dynamic shared memory in bytes: the A and B stages (f32 A rows
    padded to BK + 4, bf16 A and B rows padded by 8 elements), the tile's
    pack pairs (8 bytes each) and a count per row. BN as `_product_tile`."""
    if G < 1 or B % G or G > FUSED_BM or B // G > 65535 or dtype not in FUSED_BK:
        return None
    rows = FUSED_BM // G
    BN, stage = _product_tile(dtype, F)
    smem = FUSED_STAGES * stage + 8 * rows * width + 4 * rows
    if smem > SMEM_MAX:
        return None
    return dict(BM=FUSED_BM, BN=BN, BK=FUSED_BK[dtype], stages=FUSED_STAGES, rows=rows,
                smem=smem, grid=(-(-F // BN) * -(-rows_out // rows), B // G, 1))


def fused_cheb2(
    x: torch.Tensor, blocks: torch.Tensor, pad_left: int, rows_out: int,
    w0: torch.Tensor, w1: torch.Tensor, group: int, pack: GatherPack | None = None,
) -> torch.Tensor:
    """y = x_c @ w0 + round(L~ x) @ w1 -> [B, rows_out, F] in one kernel, for
    x [B, rows_in, C], blocks [S, T, 128, 128] and w0, w1 [C, F], all of x's
    dtype, with `group` samples per block tile (B % group == 0). CUDA
    tensors launch `csrc/cheb2_fused.cu` over `pack`, the gather pack of the
    blocks (required there), tiled by `fused_plan`; CPU and meta tensors
    take fused_cheb2_plain. A pack given is checked against the blocks on
    every device. A launch counts in `cheb2_fused.g1` of `kernels.counts`
    for a group of 1 (kernel 1's case), else in `cheb2_fused` (kernel
    4's)."""
    B, rows_in, C = x.shape
    if group < 1 or B % group:
        raise ValueError(f"fused_cheb2: batch {B} is not a multiple of group {group}")
    _check_pack("fused_cheb2", pack, blocks, pad_left, x)
    if x.device.type in ("cpu", "meta"):
        return fused_cheb2_plain(x, blocks, pad_left, rows_out, w0, w1)
    check_cuda("fused_cheb2", x, _FUSED_DTYPES, blocks=blocks, w0=w0, w1=w1)
    if blocks.dim() != 4 or tuple(blocks.shape[2:]) != (RB, RB):
        raise ValueError(f"fused_cheb2: blocks {tuple(blocks.shape)} must be [S, T, {RB}, {RB}]")
    T = blocks.shape[1]
    Fo = w0.shape[-1]
    if tuple(w0.shape) != (C, Fo) or tuple(w1.shape) != (C, Fo):
        raise ValueError(f"fused_cheb2: w0 {tuple(w0.shape)}, w1 {tuple(w1.shape)} for C={C}")
    if not 0 < rows_out <= T * RB or pad_left < 0:
        raise ValueError(f"fused_cheb2: rows_out={rows_out}, pad_left={pad_left}, T={T}")
    plan = fused_plan(x.dtype, B, rows_out, C, Fo, group, pack.width)
    if plan is None:
        raise ValueError(f"fused_cheb2: no tile of csrc/cheb2_fused.cu takes group={group} at "
                         f"B={B}, pack width {pack.width}")
    from cape_tpu_torch.ops.kernels.build import cheb2_fused_lib

    lib = cheb2_fused_lib()
    y = torch.empty((B, rows_out, Fo), dtype=x.dtype, device=x.device)
    err = lib.cape_cheb2_fused(
        x.data_ptr(), pack.cols.data_ptr(), pack.vals.data_ptr(), w0.data_ptr(), w1.data_ptr(),
        y.data_ptr(), DTYPE_CODES[x.dtype], B, rows_in, C, Fo, pack.width, pad_left, rows_out,
        group, plan["BM"], plan["BN"], plan["BK"], plan["stages"], plan["rows"], plan["smem"],
        *plan["grid"][:2], stream(x),
    )
    raise_on("cheb2_fused", lib, err, lambda: f"x {tuple(x.shape)}, blocks {tuple(blocks.shape)}, "
             f"F={Fo}, group={group}, plan {plan}")
    counts["cheb2_fused.g1" if group == 1 else "cheb2_fused"] += 1
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
    """A fused conv forward, `launch(x, blocks, pad_left, rows_out, w0, w1)`
    (fused_cheb2 for kernels 1 and 4, ring_cheb2 for 5 and 6); JAX's plain
    `_bwd` backward, as the JAX package has no backward kernel for them."""

    @staticmethod
    def forward(ctx, x, w0, w1, blocks, meta, launch):
        ctx.save_for_backward(x, w0, w1, blocks)
        ctx.meta = meta
        return launch(x, blocks, meta[0], meta[2], w0, w1)

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


def _whole_conv(x: torch.Tensor, band_op, weight: torch.Tensor, launch) -> torch.Tensor:
    w = weight.to(x.dtype)
    return _FusedCheb2.apply(
        x.contiguous(), w[0], w[1], band_op.blocks.to(x.dtype), _band_meta(band_op, x), launch,
    )


def cheb2_banded_v5(x: torch.Tensor, band_op, weight: torch.Tensor, group: int = 4) -> torch.Tensor:
    """Fused K=2 Chebyshev conv with G samples per block (kernel 4,
    `cheb2_banded_pallas_v5`), natural or padded layout; G is `group`
    halved until it divides the batch. x: [B, V, C]; weight: [2, C, F]. The
    kernel reads the op's gather pack."""
    return _whole_conv(x, band_op, weight, functools.partial(
        fused_cheb2, group=v5_group(x.shape[0], group), pack=band_op.pack))


def cheb2_banded_v6(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """Rolling-ring fused K=2 Chebyshev conv (kernel 5, `cheb2_banded_pallas_v6`)
    on a square symmetric BandedOp with 128x128 blocks, natural or padded
    layout: `ring_cheb2` with one row tile per block over the op's gather
    pack. x: [B, V, C]; weight: [2, C, F]."""
    return _whole_conv(x, band_op, weight,
                       functools.partial(ring_cheb2, tiles=1, pack=band_op.pack))


def cheb2_banded_v7(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """The ring conv with two row tiles per block (kernel 6,
    `cheb2_banded_pallas_v7`), natural or padded layout. x: [B, V, C];
    weight: [2, C, F]."""
    return _whole_conv(x, band_op, weight,
                       functools.partial(ring_cheb2, tiles=2, pack=band_op.pack))


# ----------------------------------------------- the windowed fused conv (kernels 5, 6)


@functools.cache
def ring_plan(dtype: torch.dtype, B: int, rows_out: int, C: int, F: int, tiles: int,
              window_rows: int, width: int) -> dict | None:
    """How the windowed kernel of `csrc/cheb2_fused.cu` (`cheb2_window_kernel`)
    tiles a fused conv of these sizes, for a gather pack `width` pairs wide
    whose largest window of `tiles` row tiles is `window_rows` x rows; None
    if it takes no such conv.

    A block computes `tiles` consecutive 128-row output tiles of one sample
    (256 threads a tile) by BN output columns (`_product_tile`). Its K loop
    streams the C channels in chunks of BK; per chunk, shared memory holds
    the window's rows (one stage), the L~x chunk of the block's rows (one
    stage), w0's chunk and w1's (two stages). Block x = row group * ceil(F
    / BN) + column tile, block y = sample. `smem` is the block's dynamic
    shared memory in bytes: those stages, the pack pairs of its rows (8
    bytes each) and a count per row."""
    if (tiles not in WINDOW_TILES or dtype not in FUSED_BK or not 0 < B <= 65535
            or window_rows < tiles * FUSED_BM):
        return None
    BK = FUSED_BK[dtype]
    BN, stage = _product_tile(dtype, F)
    el, lda = (4, BK + 4) if dtype == torch.float32 else (2, BK + 8)
    a_stage = el * FUSED_BM * lda
    rows = tiles * FUSED_BM
    smem = (el * window_rows * lda + tiles * a_stage + 3 * (stage - a_stage)
            + 8 * rows * width + 4 * rows)
    if smem > SMEM_MAX:
        return None
    groups = -(-(-(-rows_out // FUSED_BM)) // tiles)
    return dict(BM=FUSED_BM, BN=BN, BK=BK, tiles=tiles, window_rows=window_rows, smem=smem,
                grid=(-(-F // BN) * groups, B, 1))


def ring_cheb2(
    x: torch.Tensor, blocks: torch.Tensor, pad_left: int, rows_out: int,
    w0: torch.Tensor, w1: torch.Tensor, tiles: int, pack: GatherPack | None = None,
) -> torch.Tensor:
    """y = x_c @ w0 + round(L~ x) @ w1 -> [B, rows_out, F] in one kernel, for
    x [B, rows_in, C], blocks [S, T, 128, 128] and w0, w1 [C, F], all of x's
    dtype (float32 or bfloat16) and contiguous; `tiles` 1 (v6) or 2 (v7)
    output row tiles per block. CUDA tensors launch the windowed kernel of
    `csrc/cheb2_fused.cu` over `pack`, the gather pack of the blocks
    (required there), tiled by `ring_plan`; CPU and meta tensors take
    fused_cheb2_plain after the same checks. A pack given is checked
    against the blocks on every device. A shape the plan refuses raises
    ValueError. A launch counts in `cheb2_window.t1` of `kernels.counts`
    (one tile per block, kernel 5's case) or `cheb2_window.t2` (kernel
    6's)."""
    if tiles not in WINDOW_TILES:
        raise ValueError(f"ring_cheb2: tiles={tiles} (the kernel takes {WINDOW_TILES})")
    check_tensors("ring_cheb2", x, _FUSED_DTYPES, blocks=blocks, w0=w0, w1=w1)
    if x.dim() != 3 or blocks.dim() != 4 or tuple(blocks.shape[2:]) != (RB, RB):
        raise ValueError(
            f"ring_cheb2: x {tuple(x.shape)} must be [B, rows, C] and blocks "
            f"{tuple(blocks.shape)} [S, T, {RB}, {RB}]"
        )
    B, rows_in, C = x.shape
    S, T = blocks.shape[:2]
    Fo = w0.shape[-1]
    if tuple(w0.shape) != (C, Fo) or tuple(w1.shape) != (C, Fo):
        raise ValueError(f"ring_cheb2: w0 {tuple(w0.shape)}, w1 {tuple(w1.shape)} for C={C}")
    if not 0 < rows_out <= T * RB or not 0 <= pad_left < S * RB:
        raise ValueError(
            f"ring_cheb2: rows_out={rows_out} must lie in (0, {T * RB}] and pad_left={pad_left} "
            f"in [0, {S * RB}) (the centre tile inside the window of S={S} tiles)"
        )
    _check_pack("ring_cheb2", pack, blocks, pad_left, x)
    if x.device.type in ("cpu", "meta"):
        return fused_cheb2_plain(x, blocks, pad_left, rows_out, w0, w1)
    if x.device.type != "cuda":   # the tensors were checked above
        raise ValueError(f"ring_cheb2: no kernel for device {x.device}")
    windows = pack.windows[tiles - 1]
    plan = ring_plan(x.dtype, B, rows_out, C, Fo, tiles, pack.window_rows[tiles - 1], pack.width)
    if plan is None:
        raise ValueError(
            f"ring_cheb2: the windowed kernel takes no B={B}, tiles={tiles} with a window of "
            f"{pack.window_rows[tiles - 1]} rows and a pack {pack.width} wide in the "
            f"{SMEM_MAX} bytes of shared memory a block may have"
        )
    from cape_tpu_torch.ops.kernels.build import cheb2_fused_lib

    lib = cheb2_fused_lib()
    y = torch.empty((B, rows_out, Fo), dtype=x.dtype, device=x.device)
    err = lib.cape_cheb2_window(
        x.data_ptr(), pack.cols.data_ptr(), pack.vals.data_ptr(), windows.data_ptr(),
        w0.data_ptr(), w1.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype], B, rows_in, C, Fo,
        pack.width, pad_left, rows_out, tiles, plan["BN"], plan["BK"], plan["window_rows"],
        plan["smem"], *plan["grid"][:2], stream(x),
    )
    raise_on("cheb2_window", lib, err, lambda: f"x {tuple(x.shape)}, blocks {tuple(blocks.shape)}, "
             f"F={Fo}, plan {plan}")
    counts[f"cheb2_window.t{tiles}"] += 1
    return y


class _Cheb2V2(torch.autograd.Function):
    """y = x @ w0 + (L~ x) @ w1 with L~x on the band-apply kernel, each
    product in x's dtype; JAX's plain `_bwd` backward."""

    @staticmethod
    def forward(ctx, x, w0, w1, blocks, meta, pack):
        ctx.save_for_backward(x, w0, w1, blocks)
        ctx.meta = meta
        lx = band_apply(x, blocks, meta[0], meta[2], pack=pack)
        counts["band_apply.conv"] += x.is_cuda
        return torch.matmul(x, w0) + torch.matmul(lx, w1)

    @staticmethod
    def backward(ctx, g):
        x, w0, w1, blocks = ctx.saved_tensors
        dx, dw0, dw1 = _plain_bwd(ctx.meta, x, blocks, w0, w1, g, ctx.needs_input_grad)
        return dx, dw0, dw1, None, None, None


def cheb2_banded_v2(x: torch.Tensor, band_op, weight: torch.Tensor) -> torch.Tensor:
    """The small-batch route (`cheb2_banded_pallas_v2`) on a square symmetric
    BandedOp with 128x128 blocks in the natural layout. x: [B, V, C];
    weight: [2, C, F]."""
    meta = _band_meta(band_op, x, natural_only="cheb2_banded_v2")
    w = weight.to(x.dtype)
    return _Cheb2V2.apply(x.contiguous(), w[0], w[1], band_op.blocks.to(x.dtype), meta,
                          band_op.pack)


# -------------------------------------------------- the batch-major band apply (kernel 3)


def banded_apply_bm_plain(x, blocks, pad_left: int, pad_right: int, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the batch-major band apply kernel, with the
    signature of the JAX `banded_apply_bm`: band_apply_plain, whose numerics
    it keeps and which works out the right halo itself."""
    return band_apply_plain(x, blocks, pad_left, n_rows)


def banded_apply_bm(
    x: torch.Tensor, blocks: torch.Tensor, pad_left: int, pad_right: int, n_rows: int,
    pack: GatherPack | None = None,
) -> torch.Tensor:
    """y = M x for a banded M packed as blocks [S, T, 128, cb] with any column
    block cb; x [B, n_cols, C] -> [B, n_rows, C] (the signature of the JAX
    `banded_apply_bm`). CUDA tensors launch the band-gather kernel over
    `pack`, the gather pack of the blocks (required there); it reads rows
    outside x as zero, so pad_right only has to reach the end of the last
    window. CPU and meta tensors take banded_apply_bm_plain. A pack given
    is checked against the blocks on every device. Each launch counts in
    `band_apply_bm` of `kernels.counts`."""
    _check_pack("banded_apply_bm", pack, blocks, pad_left, x)
    if x.device.type in ("cpu", "meta"):
        return banded_apply_bm_plain(x, blocks, pad_left, pad_right, n_rows)
    check_cuda("banded_apply_bm", x)
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
    y = _gather("banded_apply_bm", x, pack, n_rows, None)
    counts["band_apply_bm"] += 1
    return y
