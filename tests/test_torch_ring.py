"""Parity of the port's ring conv entries (TPU kernels 5 and 6, `cheb2_banded_v6`
and `cheb2_banded_v7`) with the JAX package on the CPU, the port of the JAX
whole-conv parity test (`tests/test_ops.py`, v5/v6/v7 against the plain conv),
and the checks of the ring kernel's wrapper, its tile plan (`ring_plan`) and
the row windows it stages (`row_windows`, built with each gather pack).

On CPU tensors `ring_cheb2` runs its plain version (`fused_cheb2_plain`)
after the kernel's own checks; the JAX functions run their Pallas kernels in
interpret mode. Inputs come from numpy seeds and go to both packages. The
operators are those of the toy icosphere pyramid of `tests/test_ops.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cape_tpu_torch.ops import kernels
from cape_tpu_torch.ops.banded import WINDOW_TILES
from cape_tpu_torch.ops.kernels import cheb_kernel as ck
from test_torch_fused import CONVS, FLAGSHIP_WIDTH, _covered_once

import chip_smoke

torch.set_num_threads(1)

# the largest row window of the flagship's square Laplacians (lap and
# lap_d) at each padded row count P, for 1 and 2 row tiles a block
# (test_flagship_windows_are_the_pinned_ones holds them, and the pack
# width FLAGSHIP_WIDTH, to the context); at 3456 the discriminator's
# lap_d[1] sets the window of 1 tile (639 rows against lap[2]'s 567)
FLAGSHIP_WINDOWS = {1: {6912: 435, 3456: 639, 1792: 519, 896: 375, 512: 218},
                    2: {6912: 553, 3456: 667, 1792: 605, 896: 464, 512: 316}}

# f32 parity: the same sums in another order
RTOL = 1e-5
# the (B, C, F) of the JAX whole-conv test, `tests/test_ops.py`
SHAPES = [(4, 16, 12), (2, 8, 8), (6, 8, 16)]


@pytest.fixture(scope="module")
def toy(small_mesh):
    """(JAX natural, JAX padded, port natural, port padded) lap[0] of the toy
    pyramid's contexts."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, [1, 2, 1, 2, 1, 2, 1, 1])
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    return (
        jax_context(pyr, pyr_d, edges, verts).lap[0],
        jax_context(pyr, pyr_d, edges, verts, padded=True).lap[0],
        build_graph_context(pyr, pyr_d, edges, verts).lap[0],
        build_graph_context(pyr, pyr_d, edges, verts, padded=True).lap[0],
    )


def _counts():
    return tuple(kernels.counts[k] for k in (
        "band_apply.conv", "band_apply.conv_bwd", "cheb2_fused.g1", "cheb2_fused",
        "band_apply_bm", "cheb2_window.t1", "cheb2_window.t2"))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("B,C,F", SHAPES)
@pytest.mark.parametrize("kernel", ["v6", "v7"])
def test_ring_entries_match_jax_pallas(toy, kernel, B, C, F, padded):
    """`cheb2_banded_v6` / `_v7` against `cheb2_banded_pallas_v6` / `_v7`
    (interpret mode): y, dx and dW, f32, natural and padded layouts. In the
    padded layout x's tail rows hold 7.0 and the cotangent's tail is zero,
    as the model's is. No kernel launches on CPU tensors."""
    from cape_tpu.ops.pallas import cheb_kernel as jck
    jop_n, jop_p, op_n, op_p = toy
    jop, op = (jop_p, op_p) if padded else (jop_n, op_n)
    rows = op.p_rows if padded else op.n_rows
    rng = np.random.default_rng(B * 100 + C + padded)
    x = rng.standard_normal((B, rows, C)).astype(np.float32)
    W = (rng.standard_normal((2, C, F)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B, rows, F)).astype(np.float32)
    if padded:
        x[:, op.n_rows:] = 7.0
        g[:, op.n_rows:] = 0.0
    jfn = getattr(jck, f"cheb2_banded_pallas_{kernel}")
    fn = getattr(ck, f"cheb2_banded_{kernel}")
    y, vjp = jax.vjp(lambda x, w: jfn(x, jop, w), jnp.asarray(x), jnp.asarray(W))
    want = [np.asarray(a) for a in (y, *vjp(jnp.asarray(g)))]
    before = _counts()
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(W).requires_grad_()
    yt = fn(xt, op, wt)
    got = [yt, *torch.autograd.grad(yt, (xt, wt), torch.from_numpy(g))]
    assert _counts() == before
    for name, a, b in zip(("y", "dx", "dW"), got, want):
        a = a.detach().numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("kernel", ["v5", "v6", "v7"])
def test_whole_conv_entries_match_the_plain_conv(toy, kernel):
    """The port of `tests/test_ops.py`'s whole-conv test: each entry against
    the port's plain `cheb_conv` (an op with allow_pallas=False), the
    sum(sin(.)) loss and both gradients, natural layout, at batches that
    keep v5's group of 4, fall back to 2 and to 1; then the padded layout
    with zero tails against the natural rows. Its tolerances."""
    from cape_tpu_torch.ops.cheb import cheb_conv
    fused = getattr(ck, f"cheb2_banded_{kernel}")
    _, _, op_n, op_p = toy
    plain = dataclasses.replace(op_n, allow_pallas=False)
    rng = np.random.default_rng(11)
    for B, C, F in SHAPES:
        x = torch.from_numpy(rng.standard_normal((B, op_n.n_rows, C)).astype(np.float32))
        W = torch.from_numpy((rng.standard_normal((2, C, F)) * 0.1).astype(np.float32))
        losses = {}
        for name, fn in (("ref", lambda x, w: cheb_conv(x, plain, w)),
                         ("fused", lambda x, w: fused(x, op_n, w))):
            xg, wg = x.clone().requires_grad_(), W.clone().requires_grad_()
            loss = torch.sin(fn(xg, wg)).sum()
            losses[name] = (loss.item(), *torch.autograd.grad(loss, (xg, wg)))
        (ref, gx_ref, gw_ref), (out, gx, gw) = losses["ref"], losses["fused"]
        np.testing.assert_allclose(out, ref, rtol=1e-5)
        np.testing.assert_allclose(gx.numpy(), gx_ref.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gw.numpy(), gw_ref.numpy(), rtol=1e-4, atol=1e-4)

        # padded layout: zero-padded input tails -> matching natural rows
        xp = torch.nn.functional.pad(x, (0, 0, 0, op_p.p_rows - op_n.n_rows))
        with torch.no_grad():
            got_p = fused(xp, op_p, W)[:, : op_n.n_rows]
            want = cheb_conv(x, plain, W)
        np.testing.assert_allclose(got_p.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_ring_wrapper_refuses_what_the_kernel_does_not_take():
    """ring_cheb2 on CPU tensors takes the plain version, counts no launch,
    and refuses on every device what the kernel does not take: a dtype other
    than float32 and bfloat16, a non-contiguous input, tiles other than 1
    and 2, a centre tile outside the window. A CPU tensor meets no
    kernel (`kernels.check_cuda`); meta tensors compute nothing."""
    rng = np.random.default_rng(31)
    blocks = torch.from_numpy(rng.standard_normal((3, 2, 128, 128)).astype(np.float32) * 0.05)
    x = torch.from_numpy(rng.standard_normal((2, 200, 5)).astype(np.float32))
    w0, w1 = (torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)) for _ in range(2))
    before = _counts()
    for R in (1, 2):
        y = ck.ring_cheb2(x, blocks, 160, 256, w0, w1, R)
        torch.testing.assert_close(y, ck.fused_cheb2_plain(x, blocks, 160, 256, w0, w1),
                                   rtol=0, atol=0)
    assert _counts() == before
    m = lambda *s: torch.empty(s, device="meta")
    assert ck.ring_cheb2(m(4, 300, 8), m(3, 3, 128, 128), 128, 300, m(8, 6), m(8, 6), 2).shape == (4, 300, 6)
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.check_cuda("ring_cheb2", x)
    with pytest.raises(TypeError, match="float32, bfloat16"):
        ck.ring_cheb2(x.double(), blocks.double(), 128, 256, w0.double(), w1.double(), 1)
    with pytest.raises(TypeError, match=r"float16 \(kernel takes float32, bfloat16\)"):
        ck.ring_cheb2(x.half(), blocks.half(), 128, 256, w0.half(), w1.half(), 1)
    with pytest.raises(TypeError, match="w0"):
        ck.ring_cheb2(x, blocks, 128, 256, w0.bfloat16(), w1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ck.ring_cheb2(x.transpose(0, 1), blocks, 128, 256, w0, w1, 1)
    for R in (0, 3):
        with pytest.raises(ValueError, match="tiles"):
            ck.ring_cheb2(x, blocks, 128, 256, w0, w1, R)
    with pytest.raises(ValueError, match="pad_left"):
        ck.ring_cheb2(x, blocks, 3 * 128, 256, w0, w1, 1)
    with pytest.raises(ValueError, match="rows_out"):
        ck.ring_cheb2(x, blocks, 128, 257, w0, w1, 1)


@pytest.mark.parametrize("tiles", WINDOW_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [16, 32])
@pytest.mark.parametrize("P,C,F", CONVS)
def test_ring_plan_covers_every_flagship_conv(P, C, F, B, dtype, tiles):
    """A plan exists at the flagship's largest window, fits the 232448
    bytes of shared memory a block may have, and its grid covers every
    output row (padded and natural layout), sample and column once: block
    x = row group * column tiles + column tile, block y = sample, a row
    group `tiles` tiles of 128 rows."""
    window = FLAGSHIP_WINDOWS[tiles][P]
    for rows_out in (P, P - 22):
        plan = ck.ring_plan(dtype, B, rows_out, C, F, tiles, window, FLAGSHIP_WIDTH)
        assert plan is not None
        assert 0 < plan["smem"] <= ck.SMEM_MAX
        assert plan["window_rows"] == window and plan["BK"] == ck.FUSED_BK[dtype]
        BN, rows = plan["BN"], tiles * plan["BM"]
        n_col, n_group = -(-F // BN), -(-rows_out // rows)
        assert plan["grid"] == (n_col * n_group, B, 1)
        assert _covered_once(np.arange(n_group) * rows, rows, rows_out)
        assert _covered_once(np.arange(n_col) * BN, BN, F)
        assert BN == ck.fused_plan(dtype, B, rows_out, C, F, 1, FLAGSHIP_WIDTH)["BN"]


def test_ring_plan_refuses_what_the_kernel_does_not_take():
    assert ck.ring_plan(torch.float32, 32, 3456, 64, 64, 3, 667, 10) is None     # tiles 1 or 2
    assert ck.ring_plan(torch.float64, 32, 3456, 64, 64, 1, 567, 10) is None     # no f64 kernel
    assert ck.ring_plan(torch.float32, 65536, 3456, 64, 64, 1, 567, 10) is None  # grid y
    assert ck.ring_plan(torch.float32, 32, 3456, 64, 64, 2, 255, 10) is None     # window < tiles
    assert ck.ring_plan(torch.float32, 32, 3456, 64, 64, 1, 1500, 10) is None    # window overflows
    assert ck.ring_plan(torch.bfloat16, 32, 3456, 64, 64, 2, 667, 400) is None   # pairs overflow
    # f32, 128 columns, tiles 1: the window, the L~x stage, three [32, 128]
    # weight stages, the pairs and the counts
    plan = ck.ring_plan(torch.float32, 32, 3456, 64, 128, 1, 567, 10)
    assert plan["smem"] == 4 * (567 * 36 + 128 * 36 + 3 * 32 * 128) + 8 * 128 * 10 + 4 * 128
    assert plan["grid"] == (27, 32, 1)
    assert ck.ring_plan(torch.float32, 32, 3456, 64, 128, 2, 667, 10)["grid"] == (14, 32, 1)


def _square_laps(ctx):
    return [op for op in ctx.lap + ctx.lap_d if op.pallas_eligible and op.pack is not None]


@pytest.mark.parametrize("padded", [False, True])
def test_each_group_window_covers_its_rows(toy, padded):
    """On the toy context, each group's window [lo, hi) holds every pack
    column of its rows inside [0, rows_in) and its centre rows (output row
    r's own x row is r - pad_left % 128), and window_rows is the largest."""
    _, _, op_n, op_p = toy
    op = op_p if padded else op_n
    rows_in = op.p_cols if padded else op.n_cols
    cols = op.pack.cols.numpy()
    shift = op.pad_left % 128
    for tiles, win, most in zip(WINDOW_TILES, op.pack.windows, op.pack.window_rows):
        win = win.numpy()
        span = 128 * tiles
        assert win.shape == (-(-cols.shape[0] // span), 2) and win.dtype == np.int32
        assert most == (win[:, 1] - win[:, 0]).max()
        for g, (lo, hi) in enumerate(win):
            c = cols[g * span:(g + 1) * span]
            c = c[(c >= 0) & (c < rows_in)]
            assert lo <= g * span - shift and hi >= (g + 1) * span - shift
            if len(c):
                assert lo <= c.min() and c.max() < hi


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["natural", "padded"])
def test_window_gather_is_band_gather_plain(toy, layout, dtype):
    """What the windowed kernel computes from its windows, emulated in
    torch: per group, the x rows [lo, hi) (zero outside x), the L~x rows
    gathered from them with cols - lo and the centre rows read at r - shift
    - lo; equal bit for bit to band_gather_plain and to `_centre` on the
    toy context, for both tilings."""
    _, _, op_n, op_p = toy
    op = op_p if layout == "padded" else op_n
    rows = op.p_rows if layout == "padded" else op.n_rows
    rows_in = op.p_cols if layout == "padded" else op.n_cols
    x = torch.randn(3, rows_in, 5, generator=torch.Generator().manual_seed(3)).to(dtype)
    want = ck.band_gather_plain(x, op.pack, rows)
    want_c = ck._centre(x, op.pad_left, rows)
    shift = op.pad_left % 128
    for tiles, win in zip(WINDOW_TILES, op.pack.windows):
        span = 128 * tiles
        got, got_c = torch.empty_like(want), torch.empty_like(want_c)
        for grp, (lo, hi) in enumerate(win.tolist()):
            r0, r1 = grp * span, min((grp + 1) * span, rows)
            if r0 >= rows:
                continue
            window = torch.nn.functional.pad(x[:, max(lo, 0):min(hi, rows_in)],
                                             (0, 0, max(-lo, 0), max(hi - rows_in, 0)))
            assert window.shape[1] == hi - lo
            cols = op.pack.cols[r0:r1].long()
            inside = (cols >= 0) & (cols < rows_in)
            idx = torch.where(inside, cols - lo, 0).reshape(-1)
            vals = op.pack.vals[r0:r1].to(dtype).float()
            gx = window.float().index_select(1, idx).reshape(3, r1 - r0, -1, 5)
            got[:, r0:r1] = torch.where(inside[..., None], gx * vals[..., None], 0).sum(2).to(dtype)
            got_c[:, r0:r1] = window[:, r0 - shift - lo:r1 - shift - lo]
        assert torch.equal(got, want), tiles
        assert torch.equal(got_c, want_c), tiles


def test_flagship_windows_are_the_pinned_ones():
    """FLAGSHIP_WINDOWS and FLAGSHIP_WIDTH against the flagship's graph
    context (built on the CPU): at each P, the largest window over its
    square Laplacians is the pinned one, and no pack is wider."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config

    cfg = load_config(chip_smoke.PRESET, batch_size=32, compute_dtype="float32", name="windows")
    ctx = build_context(cfg, device="cpu")
    largest = {t: {} for t in WINDOW_TILES}
    for op in _square_laps(ctx):
        P = op.blocks.shape[1] * 128
        assert op.pack.width <= FLAGSHIP_WIDTH
        for t, most in zip(WINDOW_TILES, op.pack.window_rows):
            largest[t][P] = max(largest[t].get(P, 0), most)
    assert largest == FLAGSHIP_WINDOWS


@pytest.mark.parametrize("layout", ["natural", "padded"])
@pytest.mark.parametrize("kernel,tiles", [("v6", 1), ("v7", 2)])
def test_ring_entries_hand_the_op_pack_to_the_kernel(toy, monkeypatch, kernel, tiles, layout):
    _, _, op_n, op_p = toy
    op = op_p if layout == "padded" else op_n
    rows = op.p_rows if layout == "padded" else op.n_rows
    seen = []
    real = ck.ring_cheb2

    def record(*a, **k):
        seen.append(k)
        return real(*a, **k)

    monkeypatch.setattr(ck, "ring_cheb2", record)
    y = getattr(ck, f"cheb2_banded_{kernel}")(torch.randn(4, rows, 6), op, torch.randn(2, 6, 5))
    assert y.shape == (4, rows, 5)
    assert len(seen) == 1 and seen[0]["pack"] is op.pack and seen[0]["tiles"] == tiles


def test_ring_checks_a_given_pack_on_the_cpu(toy):
    """A pack given to ring_cheb2 is checked against the blocks and pad_left
    on every device; without one the CPU and meta tensors take the plain
    version (a CUDA launch needs it)."""
    _, _, op, _ = toy
    x, w = torch.randn(2, op.n_rows, 5), torch.randn(2, 5, 3)
    args = (x, op.blocks, op.pad_left, op.n_rows, w[0], w[1], 2)
    torch.testing.assert_close(ck.ring_cheb2(*args, pack=op.pack), ck.ring_cheb2(*args))
    other = dataclasses.replace(op.pack, pad_left=op.pad_left + 128)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.ring_cheb2(*args, pack=other)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.cheb2_banded_v6(x, dataclasses.replace(op, pack=other), w)
    m = op.to("meta")
    xm = torch.empty(2, op.n_rows, 5, device="meta")
    assert ck.ring_cheb2(xm, m.blocks, m.pad_left, m.n_rows, w[0].to("meta"), w[1].to("meta"), 1,
                         pack=m.pack).shape == (2, op.n_rows, 3)
