"""Block-banded sparse apply over the RCM-reordered mesh pyramid.

Counterpart of `cape_tpu.ops.banded`. After the bandwidth-minimizing
reordering (`cape_tpu_torch.meshops.ordering`) every pyramid matrix is banded:
the nonzeros of row tile t (128 rows) fall in a fixed column window around
t * col_stride, so the apply is

    y_tiles = sum_k  blocks[k] @ shifted_view_k(x_padded)

with static slices and batched matmuls (`apply_blocks`), the JAX package's
XLA apply. On a CUDA tensor the apply is one launch of the band-gather
kernel (`csrc/band_gather.cu`, through `ops.kernels.cheb_kernel.band_apply`)
over the op's gather pack in place of apply_blocks' ~11 operators
(`BandedMatvec`); CPU and meta tensors, and ops whose config keeps kernels
off, take apply_blocks.

The apply is a `torch.autograd.Function` whose backward applies the
transpose, packed in the same banded form (`t_blocks`, `t_pack`), as the
JAX custom VJP does: autograd's own backward of the shifted einsum would
build layout-transposed copies of every shifted view.

Each op also carries the gather pack of its blocks and of its transpose
(`gather_pack`): the band's non-zeros as a fixed-width list per output
row, which the band-gather kernel reads in place of the dense tiles, and
the x rows that each group of row tiles reads (`row_windows`), which the
windowed conv kernel stages in shared memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from cape_tpu_torch.ops import kernels


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


def on_kernel(x: torch.Tensor, op: BandedOp) -> bool:
    """Whether an apply of `op` to x takes the band-gather kernel: x is a
    non-empty CUDA tensor of a dtype the kernel takes, the op carries its
    gather packs, and it allows kernels (cfg.use_pallas) unless
    CAPE_TPU_PALLAS overrides that either way (`ops.kernels.allowed`)."""
    if (x.device.type != "cuda" or x.dtype not in kernels.DTYPE_CODES or op.pack is None
            or not x.numel()):
        return False
    return kernels.allowed(op.allow_pallas)


def kernel_apply(x: torch.Tensor, blocks: torch.Tensor, pack: GatherPack, pad_left: int,
                 rows_out: int) -> torch.Tensor:
    """y = M x for x [..., rows, C] in one launch of the band-gather kernel
    over `pack`, the gather pack of `blocks` at `pad_left`, keeping
    rows_out rows. The launch goes through `cheb_kernel.band_apply`, looked
    up at call time so that a wrapper put there (bench_port's
    LaunchRecorder) sees it, with x as [B, rows, C]; it counts in
    `band_apply.op` of `kernels.counts`, the conv route's launches in
    `band_apply.conv` and `.conv_bwd`."""
    from cape_tpu_torch.ops.kernels import cheb_kernel

    lead = x.shape[:-2]
    x = x.reshape(-1, *x.shape[-2:]).contiguous()
    y = cheb_kernel.band_apply(x, blocks, pad_left, rows_out, pack=pack)
    kernels.counts["band_apply.op"] += 1
    return y.reshape(*lead, *y.shape[1:])


class BandedMatvec(torch.autograd.Function):
    """y = M x, on the band-gather kernel where `on_kernel` says so and
    through `apply_blocks` elsewhere; the backward is dx = M^T g with the
    transpose packing, routed the same way. In the padded layout g's tail
    rows are zero wherever the output feeds a banded op or a slice back to
    the natural layout (both have zero-tail backward passes), as in JAX's
    `_banded_bwd`; the kernel reads no tail row (the packs hold no entry
    there) and writes zero tail rows."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        if on_kernel(x, op):
            return kernel_apply(x, op.blocks, op.pack, op.pad_left, op.rows_out)
        return apply_blocks(x, op.blocks, op.pad_left, op.pad_right, op.n_rows, op.padded)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        if on_kernel(g, op):
            return kernel_apply(g, op.t_blocks, op.t_pack, op.t_pad_left, op.rows_in), None
        dx = apply_blocks(g, op.t_blocks, op.t_pad_left, op.t_pad_right, op.n_cols, op.padded)
        return dx, None


def padded_size(n: int, block: int = 128) -> int:
    """Row count of the persistent-padded layout for a natural size n."""
    return -(-n // block) * block


# row tiles per block of the windowed conv kernel: 1 (TPU kernel 5, v6)
# and 2 (kernel 6, v7)
WINDOW_TILES = (1, 2)


@dataclasses.dataclass(frozen=True)
class GatherPack:
    """The non-zeros of banded blocks [S, T, rb, cb] as a fixed-width list
    per output row (the ELL layout): output row r = t*rb + i sums
    vals[r, w] * x[cols[r, w]] over w < W, the largest row count of
    non-zeros. Entries are in ascending column order; unused slots hold
    column -1 and value 0. (S, T, cb, pad_left) record the blocks and
    offset the pack was built for. windows[k - 1] is `row_windows` of the
    pack for k = WINDOW_TILES[k - 1] row tiles a group, and
    window_rows[k - 1] its largest window. Its tensors share one device."""

    cols: torch.Tensor                                 # int32 [T*rb, W]
    vals: torch.Tensor                                 # float32 [T*rb, W]
    S: int
    T: int
    cb: int
    pad_left: int
    windows: tuple[torch.Tensor, ...]                  # int32 [ceil(T / k), 2] each
    window_rows: tuple[int, ...]

    def __post_init__(self):
        if any(t.device != self.cols.device for t in (self.vals, *self.windows)):
            raise ValueError("GatherPack: vals and windows must be on cols' device "
                             f"{self.cols.device}")

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    def to(self, device) -> "GatherPack":
        return dataclasses.replace(self, cols=self.cols.to(device), vals=self.vals.to(device),
                                   windows=tuple(w.to(device) for w in self.windows))

    def check(self, name: str, blocks: torch.Tensor, pad_left: int) -> None:
        """Raise unless the pack was built for blocks of this shape at this
        pad_left."""
        built = (self.S, self.T, self.cols.shape[0] // self.T, self.cb)
        if tuple(blocks.shape) != built or pad_left != self.pad_left:
            raise ValueError(
                f"{name}: the gather pack was built for blocks {built} at "
                f"pad_left={self.pad_left}, not blocks {tuple(blocks.shape)} at pad_left={pad_left}"
            )


def gather_pack(blocks: np.ndarray, pad_left: int) -> GatherPack:
    """The gather pack of banded blocks [S, T, rb, cb] (numpy): the entry
    blocks[k, t, i, j] of output row t*rb + i reads x row
    (t+k)*cb + j - pad_left. Entries with a negative column meet the zero
    pad and are dropped; columns past the end of x are kept (the kernel
    masks them at run time). Values in float32. The ELL layout of the JAX
    package's `_pack_ell` (cape_tpu/ops/sparse.py), derived from the band
    blocks; with it the pack's row windows for each of WINDOW_TILES."""
    S, T, rb, cb = blocks.shape
    k, t, i, j = np.unravel_index(np.flatnonzero(blocks != 0), blocks.shape)
    rows = t * rb + i
    cols = (t + k) * cb + j - pad_left
    vals = blocks[k, t, i, j].astype(np.float32)
    keep = cols >= 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=T * rb)
    width = max(1, int(counts.max(initial=0)))
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    pc = np.full((T * rb, width), -1, np.int32)
    pv = np.zeros((T * rb, width), np.float32)
    pc[rows, slot] = cols
    pv[rows, slot] = vals
    windows = [row_windows(pc, rb, pad_left % rb, k) for k in WINDOW_TILES]
    return GatherPack(torch.from_numpy(pc), torch.from_numpy(pv), S, T, cb, int(pad_left),
                      tuple(torch.from_numpy(w) for w in windows),
                      tuple(int((w[:, 1] - w[:, 0]).max()) for w in windows))


def row_windows(cols: np.ndarray, rb: int, shift: int, tiles: int) -> np.ndarray:
    """The x rows [lo, hi) that each group of `tiles` consecutive rb-row
    output tiles reads, int32 [groups, 2], for a pack's columns `cols`
    [T*rb, W]: the span of the group's pack columns and of its centre rows
    [g*tiles*rb - shift, (g+1)*tiles*rb - shift) (output row r's own x row
    is r - shift, shift = pad_left % rb). lo may be negative and hi past
    the end of x: the kernel reads those rows as zero."""
    span = tiles * rb
    groups = -(-cols.shape[0] // span)
    c = np.pad(cols, ((0, groups * span - cols.shape[0]), (0, 0)), constant_values=-1)
    c = c.reshape(groups, -1).astype(np.int64)
    start = np.arange(groups) * span - shift
    lo = np.minimum(start, np.where(c >= 0, c, start[:, None]).min(1))
    hi = np.maximum(start + span, c.max(1) + 1)
    return np.stack([lo, hi], 1).astype(np.int32)


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
    pack: GatherPack | None = None                     # gather pack of blocks
    t_pack: GatherPack | None = None                   # and of t_blocks

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
    def rows_out(self) -> int:
        """Rows of y = M x: p_rows in the padded layout, n_rows in the
        natural one."""
        return self.p_rows if self.padded else self.n_rows

    @property
    def rows_in(self) -> int:
        """Rows of x, and of the transpose's output: p_cols in the padded
        layout, n_cols in the natural one."""
        return self.p_cols if self.padded else self.n_cols

    @property
    def pallas_eligible(self) -> bool:
        """The conv kernel routes take square levels with 128x128 blocks
        (all rescaled Laplacians qualify)."""
        return self.n_rows == self.n_cols and self.row_block == 128 and self.col_block == 128

    def to(self, device) -> "BandedOp":
        move = lambda p: None if p is None else p.to(device)
        return dataclasses.replace(
            self, blocks=self.blocks.to(device), t_blocks=self.t_blocks.to(device),
            pack=move(self.pack), t_pack=move(self.t_pack),
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
    shifted block form, with the gather pack of each. padded=True builds
    the op in the persistent-padded layout. The packs hold the blocks'
    values as `dtype` rounds them."""
    csr = sp.csr_matrix(m)
    R, C = csr.shape
    blocks, cb, pad_left, pad_right = _pack_blocks(csr, row_block)
    t_blocks, _, t_pad_left, t_pad_right = _pack_blocks(sp.csr_matrix(m.T), row_block)
    blocks, t_blocks = (torch.as_tensor(a).to(dtype) for a in (blocks, t_blocks))
    pack = lambda b, pad: gather_pack(b.float().numpy(), pad).to(device)
    return BandedOp(
        blocks=blocks.to(device),
        t_blocks=t_blocks.to(device),
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
        pack=pack(blocks, pad_left),
        t_pack=pack(t_blocks, t_pad_left),
    )
