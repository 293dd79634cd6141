"""The gather pack of the port's banded operators and the plain version of
the band-gather kernel (`cape_tpu_torch/csrc/band_gather.cu`, which runs
TPU kernels 2, 2b and 3) on the CPU.

`gather_pack` lists the band's non-zeros per output row; `band_gather_plain`
repeats the kernel's arithmetic over it. Both are held to the dense band
blocks (`band_apply_plain`) and to the JAX package's Pallas kernels in
interpret mode, on the toy pyramid's operators and on random banded blocks
with column blocks of 64, 128, 256 and the ragged 65 and 254. Inputs come
from numpy seeds. The pack travels with its op, nothing builds one after
the context, and the wrappers refuse a launch without the pack of their
blocks."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# f32 against JAX: the same sums in another order
RTOL = 1e-5


def _bf16_ulp(v: float, dtype=torch.bfloat16) -> float:
    """One ulp of `dtype` (bf16 by default, or f16) at v."""
    bits = 10 if dtype == torch.float16 else 7
    return 2.0 ** (np.floor(np.log2(v)) - bits)


@pytest.fixture(scope="module")
def toy(small_mesh):
    """(JAX natural, JAX padded, port natural, port padded) contexts of the
    toy pyramid of `tests/test_torch_kernels.py`."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, [1, 2, 1, 2, 1, 2, 1, 1])
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    return (
        jax_context(pyr, pyr_d, edges, verts),
        jax_context(pyr, pyr_d, edges, verts, padded=True),
        build_graph_context(pyr, pyr_d, edges, verts),
        build_graph_context(pyr, pyr_d, edges, verts, padded=True),
    )


def _banded_ops(ctx):
    from cape_tpu_torch.ops.banded import BandedOp

    ops = {}
    for field in ("lap", "down", "up", "lap_d", "down_d"):
        for i, op in enumerate(getattr(ctx, field)):
            if isinstance(op, BandedOp):
                ops[f"{field}[{i}]"] = op
    ops["edge_op"] = ctx.edge_op
    return ops


def _random_blocks(seed: int, cb: int, S: int = 3, T: int = 3, per_row: int = 7) -> np.ndarray:
    """Blocks [S, T, 128, cb] with 1 to per_row non-zeros a row at random
    places of the row tile's window, as a mesh operator has."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((S, T, 128, cb), np.float32)
    for t in range(T):
        for i in range(128):
            n = int(rng.integers(1, per_row + 1))
            flat = rng.choice(S * cb, size=n, replace=False)
            blocks[flat // cb, t, i, flat % cb] = rng.standard_normal(n)
    return blocks


# (column block, pad_left) of the random blocks: pad_left from none to more
# than a column block
RANDOM = [(64, 64), (128, 128), (256, 256), (65, 100), (254, 0)]


def _entries(blocks: np.ndarray, pad_left: int):
    """The (row, column) -> value map of the blocks' non-zeros, and the
    count of entries whose column is negative."""
    S, T, rb, cb = blocks.shape
    k, t, i, j = np.nonzero(blocks)
    rows, cols = t * rb + i, (t + k) * cb + j - pad_left
    vals = blocks[k, t, i, j]
    entries = {(int(r), int(c)): float(v) for r, c, v in zip(rows, cols, vals) if c >= 0}
    return entries, int((cols < 0).sum())


def _hold_pack_to_blocks(pack, blocks: np.ndarray, pad_left: int) -> None:
    """The pack scattered back gives every non-zero of the blocks with a
    column >= 0, each in ascending column order in its row, W is the
    largest row count, and the unused slots hold column -1 and value 0."""
    S, T, rb, cb = blocks.shape
    cols, vals = pack.cols.numpy(), pack.vals.numpy()
    assert (pack.S, pack.T, pack.cb, pack.pad_left) == (S, T, cb, pad_left)
    assert cols.shape == vals.shape == (T * rb, pack.width)
    assert cols.dtype == np.int32 and vals.dtype == np.float32
    used = cols >= 0
    assert np.all(cols[~used] == -1) and np.all(vals[~used] == 0)
    # the used slots of a row come first, in ascending column order
    assert np.all(used[:, :-1] | ~used[:, 1:])
    assert np.all(np.where(used[:, 1:], np.diff(cols, axis=1) > 0, True))
    r, w = np.nonzero(used)
    got = {(int(a), int(c)): float(v) for a, c, v in zip(r, cols[r, w], vals[r, w])}
    want, dropped = _entries(blocks, pad_left)
    assert got == want
    counts = np.bincount(r, minlength=T * rb)
    assert pack.width == max(1, counts.max())
    assert len(want) + dropped == np.count_nonzero(blocks)


@pytest.mark.parametrize("cb,pad_left", RANDOM)
def test_gather_pack_scatters_back_to_random_blocks(cb, pad_left):
    from cape_tpu_torch.ops.banded import gather_pack

    blocks = _random_blocks(cb, cb)
    _hold_pack_to_blocks(gather_pack(blocks, pad_left), blocks, pad_left)


def test_gather_pack_scatters_back_to_every_op_of_the_context(toy):
    """The pack and the transpose's pack of every banded op of both
    layouts, the edge operator included; the Laplacians' widths are the
    mesh's row counts of non-zeros, the pools' 1."""
    _, _, ctx, ctx_p = toy
    for c in (ctx, ctx_p):
        ops = _banded_ops(c)
        assert len(ops) >= 15
        for name, op in ops.items():
            _hold_pack_to_blocks(op.pack, op.blocks.numpy(), op.pad_left)
            _hold_pack_to_blocks(op.t_pack, op.t_blocks.numpy(), op.t_pad_left)
        assert all(ops[f"down[{i}]"].pack.width == 1 for i in (1, 3, 5))
        assert 4 <= ops["lap[0]"].pack.width <= 12


def _case(cb: int, pad_left: int, layout: str, dtype, addend: bool, seed: int):
    """Random blocks of x's dtype, their pack, x and (if asked) an addend:
    natural x has 37 rows fewer than the tiles cover, padded x all of
    them; x is shorter than the window at cb = 256 and 254."""
    from cape_tpu_torch.ops.banded import gather_pack

    blocks = _random_blocks(seed, cb)
    S, T, rb, _ = blocks.shape
    rows = T * rb - (37 if layout == "natural" else 0)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((2, rows, 5)).astype(np.float32)).to(dtype)
    r = torch.from_numpy(rng.standard_normal((2, rows, 5)).astype(np.float32)).to(dtype)
    return (torch.from_numpy(blocks).to(dtype), gather_pack(blocks, pad_left), x,
            r if addend else None, rows)


@pytest.mark.parametrize("addend", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("layout", ["natural", "padded"])
@pytest.mark.parametrize("cb,pad_left", RANDOM)
def test_band_gather_plain_equals_band_apply_plain(cb, pad_left, layout, dtype, addend):
    """The gather form against the dense blocks, with the kernel's numerics:
    f32 within 1e-6 * max|ref| (a few products summed in another order),
    bf16 and f16 within one ulp of the dtype at max|ref| (f32 sums in
    another order, rounded once)."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply_plain, band_gather_plain

    blocks, pack, x, r, rows = _case(cb, pad_left, layout, dtype, addend, seed=cb + pad_left)
    got = band_gather_plain(x, pack, rows, r)
    want = band_apply_plain(x, blocks, pad_left, rows, r)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (2, rows, 5)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    limit = 1e-6 * scale if dtype == torch.float32 else _bf16_ulp(scale, dtype)
    assert err <= limit, (err, limit)


def test_band_gather_plain_reads_rows_outside_x_as_zero():
    """Rows of x past rows_in read as 0: a pack whose columns run past a
    300-row x gives exactly the apply of x padded with zero rows to the
    384 rows of the tiles; an addend is added once."""
    from cape_tpu_torch.ops.banded import gather_pack
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_gather_plain

    blocks = _random_blocks(3, 128)
    pack = gather_pack(blocks, 128)
    assert int(pack.cols.max()) >= 300
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 384, 3)).astype(np.float32))
    x[:, 300:] = 0.0
    got = band_gather_plain(x[:, :300].contiguous(), pack, 384)
    torch.testing.assert_close(got, band_gather_plain(x, pack, 384), rtol=0, atol=0)
    add = torch.ones(2, 384, 3)
    torch.testing.assert_close(band_gather_plain(x, pack, 384, add),
                               band_gather_plain(x, pack, 384) + 1, rtol=1e-6, atol=1e-6)


BM_OPS = [("lap", i) for i in range(9)] + [(f, i) for f in ("down", "up") for i in (1, 3, 5)]


@pytest.mark.parametrize("field,idx", BM_OPS)
def test_band_gather_plain_matches_jax_banded_apply_bm(toy, field, idx):
    """Row 3's function: the plain gather over the op's pack against the JAX
    `banded_apply_bm` (interpret mode), f32, every column block of the toy
    pyramid (128, 256, 254, 252, 64, 65)."""
    from cape_tpu.ops.pallas.cheb_kernel import banded_apply_bm as jax_bm
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_gather_plain

    jctx, _, ctx, _ = toy
    jop, op = getattr(jctx, field)[idx], getattr(ctx, field)[idx]
    x = np.random.default_rng(30 + idx).standard_normal((3, op.n_cols, 5)).astype(np.float32)
    want = np.asarray(jax_bm(jnp.asarray(x), jop.blocks, jop.pad_left, jop.pad_right, jop.n_rows))
    got = band_gather_plain(torch.from_numpy(x), op.pack, op.n_rows).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("idx", [0, 2, 4, 6])
def test_band_gather_plain_matches_jax_v3_band_apply(toy, idx, padded):
    """Rows 2 and 2b's function: the plain gather over the op's pack against
    the v3 route's band apply, `_pallas_band_apply_v2` on vertex-major
    merged columns (interpret mode), f32, natural and padded layouts (x's
    tail rows 7.0 in the padded one)."""
    from cape_tpu.ops.pallas.cheb_kernel import _v3_band_vm
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_gather_plain

    jctx_n, jctx_p, ctx_n, ctx_p = toy
    jop, op = (jctx_p.lap[idx], ctx_p.lap[idx]) if padded else (jctx_n.lap[idx], ctx_n.lap[idx])
    S, T, _, cb = op.blocks.shape
    rows = op.p_rows if padded else op.n_rows
    pad_right = max((T + S - 1) * cb - op.pad_left - rows, 0) if padded else op.pad_right
    x = np.random.default_rng(40 + idx).standard_normal((4, rows, 6)).astype(np.float32)
    if padded:
        x[:, op.n_rows:] = 7.0
    xv = jnp.asarray(x.transpose(1, 0, 2).reshape(rows, -1))
    want = np.asarray(_v3_band_vm(xv, jop.blocks, jop.pad_left, pad_right, rows))
    want = want.reshape(rows, 4, 6).transpose(1, 0, 2)
    got = band_gather_plain(torch.from_numpy(x), op.pack, rows).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_the_pack_travels_with_its_op(toy):
    """BandedOp.to and GraphContext.to move both packs with the blocks (to
    the meta device here), keeping what each was built for; the routing
    tests' meta contexts thus carry them, and band_apply takes them there."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply

    _, _, ctx, ctx_p = toy
    op = ctx.lap[0]
    moved = op.to("meta")
    for a, b in ((moved.pack, op.pack), (moved.t_pack, op.t_pack)):
        assert a.cols.device.type == a.vals.device.type == "meta"
        built_for = lambda p: (p.S, p.T, p.cb, p.pad_left, p.cols.shape)
        assert built_for(a) == built_for(b)
    for name, m in _banded_ops(ctx_p.to("meta")).items():
        assert m.pack.cols.device.type == m.t_pack.vals.device.type == "meta", name
    mp = ctx_p.lap[0].to("meta")
    x = torch.empty(32, mp.p_rows, 64, device="meta")
    assert band_apply(x, mp.blocks, mp.pad_left, mp.p_rows, pack=mp.pack).shape == x.shape


def test_two_cpu_train_steps_build_no_pack(small_mesh, monkeypatch):
    """Packs are built with the context, never per call: two train steps on
    the kernel route (the large-batch gate lowered to batch 4, so the v3
    route runs, in the plain version, in both directions) call gather_pack
    no time, and every band apply is given its op's own pack."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu_torch.core.config import CAPEConfig
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops import banded, cheb
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck
    from cape_tpu_torch.ops.sparse import build_graph_context
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    B = 4
    cfg = CAPEConfig(name="torch_gather_test", num_conv_layers=4, nf=8, nz=8, nz_cond=8,
                     nz_cond2=4, use_res_block=False, use_res_block_dec=True, affine=True,
                     reduce_dim=4, batch_size=B, num_epochs=1)
    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, cfg.ds_factors)
    ctx = build_graph_context(pyr, build_pyramid(verts, faces, [2, 2, 2, 2]),
                              vertices_per_edge(faces, len(verts)), verts, padded=True)
    data = synthetic_bodydata(n_train=32, n_test=6, num_verts=len(verts), seed=0, n_val=8)

    built, packs = [], []
    monkeypatch.setattr(banded, "gather_pack", lambda *a: built.append(a))
    real = ck.band_apply
    monkeypatch.setattr(ck, "band_apply",
                        lambda *a, **k: packs.append(k.get("pack")) or real(*a, **k))
    monkeypatch.setattr(cheb, "VM_MIN_BATCH", B)
    monkeypatch.setattr(cheb, "VM_MIN_COLS", B * 3)

    state = TrainState(CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx),
                       Optimizer(cfg, len(data.disp_train) // B))
    sg, sd = BatchStream(len(data.disp_train), B, 0), BatchStream(len(data.disp_train), B, 1)
    rng = np.random.default_rng(9)
    disp = data.disp_train[:, ctx.perm0]
    for _ in range(2):
        ig, idd = sg.next_indices(), sd.next_indices()
        batch = {"disp_g": disp[ig], "pose_g": data.pose_train[ig], "clo_g": data.clo_train[ig],
                 "disp_d": disp[idd], "pose_d": data.pose_train[idd], "clo_d": data.clo_train[idd]}
        eps = rng.standard_normal((B, cfg.nz)).astype(np.float32)
        m, _ = train_step(state, ctx, {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.from_numpy(eps))
        assert all(np.isfinite(float(v)) for v in m.values())
    assert not built
    own = [op.pack for op in ctx.lap + ctx.lap_d]
    # forward and backward applies of every kernel-route conv, each with its op's pack
    assert len(packs) >= 4 and len(packs) % 2 == 0
    assert all(any(p is q for q in own) for p in packs)


def test_the_wrappers_refuse_a_launch_without_the_pack_of_their_blocks(toy):
    """A launch needs the pack, on x's device (the check every CUDA call
    makes first), and a pack given for other blocks, or another pad_left,
    is refused on any device (meta tensors here)."""
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    _, _, ctx, _ = toy
    lap, down = ctx.lap[0].to("meta"), ctx.down[1].to("meta")
    m = lambda *s: torch.empty(s, device="meta")
    on_card = types.SimpleNamespace(device=torch.device("cuda"), is_cuda=True)
    with pytest.raises(ValueError, match="needs the op's gather pack"):
        ck._check_pack("band_apply", None, ctx.lap[0].blocks, ctx.lap[0].pad_left, on_card)
    with pytest.raises(TypeError, match="the gather pack is on cpu, x on cuda"):
        ck._check_pack("band_apply", ctx.lap[0].pack, ctx.lap[0].blocks, ctx.lap[0].pad_left,
                       on_card)
    with pytest.raises(ValueError, match="must be on cols' device"):
        dataclasses.replace(ctx.lap[0].pack, vals=lap.pack.vals)
    ck._check_pack("band_apply", lap.pack, lap.blocks, lap.pad_left, m(1))
    x = m(32, lap.n_rows, 64)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.band_apply(x, lap.blocks, lap.pad_left, lap.n_rows, pack=ctx.lap[2].to("meta").pack)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.band_apply(x, lap.blocks, lap.pad_left + 128, lap.n_rows, pack=lap.pack)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.cheb2_banded_v3(x, dataclasses.replace(lap, pack=ctx.lap[2].to("meta").pack),
                           m(2, 64, 64))
    xd = m(4, down.n_cols, 8)
    args = (down.pad_left, down.pad_right, down.n_rows)
    assert ck.banded_apply_bm(xd, down.blocks, *args, pack=down.pack).shape == (4, down.n_rows, 8)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.banded_apply_bm(xd, down.blocks, *args, pack=lap.pack)
