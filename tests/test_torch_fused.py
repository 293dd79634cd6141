"""The fused K=2 conv kernel's plan and its pack form on the CPU
(`csrc/cheb2_fused.cu`, TPU kernels 1 and 4).

`fused_plan` is checked at every flagship conv shape the kernel is held to
on the card. The function the kernel computes from the op's gather pack
(`band_gather_plain` rounded to x's dtype, `_centre`, the two products in
f32, one rounding) is held to the JAX kernels in interpret mode on the toy
context. The whole-conv entries hand the op's own pack to the kernel, and a
pack given on the CPU is checked."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cape_tpu_torch.ops.kernels import cheb_kernel as ck

torch.set_num_threads(1)

# the widest gather pack of the flagship's Laplacians is 11 pairs
# (tests/test_torch_gather.py holds every lap's width to 4-12)
FLAGSHIP_WIDTH = 12
CONVS = [(P, C, F) for P, convs in chip_smoke.FUSED_CONVS.items() for C, F in convs]


@pytest.fixture(scope="module")
def toy(small_mesh):
    """(JAX natural, JAX padded, port natural, port padded) contexts of the
    toy pyramid of tests/test_torch_kernels.py."""
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


def _covered_once(starts, size, extent) -> bool:
    """Tiles of `size` at `starts` cover [0, extent) once each."""
    idx = (np.asarray(starts)[:, None] + np.arange(size)).ravel()
    return bool((np.bincount(idx[idx < extent], minlength=extent) == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("B", [16, 32])
@pytest.mark.parametrize("P,C,F", CONVS)
def test_fused_plan_covers_every_flagship_conv(P, C, F, B, G, dtype):
    """A plan exists, fits the 232448 bytes of shared memory a block may
    have, and its grid covers every output row (padded and natural
    layout), sample and column once: block x = row tile * column tiles +
    column tile, block y = sample group."""
    for rows_out in (P, P - 22):
        plan = ck.fused_plan(dtype, B, rows_out, C, F, G, FLAGSHIP_WIDTH)
        assert plan is not None
        assert 0 < plan["smem"] <= ck.SMEM_MAX
        R, BN = plan["rows"], plan["BN"]
        assert G * R == plan["BM"] and plan["BK"] == ck.FUSED_BK[dtype]   # R = 128 / G
        n_col, n_row = -(-F // BN), -(-rows_out // R)
        assert plan["grid"] == (n_col * n_row, B // G, 1)
        assert _covered_once(np.arange(n_row) * R, R, rows_out)
        assert _covered_once(np.arange(plan["grid"][1]) * G, G, B)
        assert _covered_once(np.arange(n_col) * BN, BN, F)
        narrowest = 32 if dtype == torch.float32 else 16
        assert (BN >= F or BN == 128) and (BN < 2 * F or BN == narrowest)


def test_fused_plan_refuses_what_the_kernel_does_not_take():
    assert ck.fused_plan(torch.float32, 32, 896, 64, 64, 3, 11) is None      # group must divide B
    assert ck.fused_plan(torch.float64, 32, 896, 64, 64, 1, 11) is None      # no f64 kernel
    assert ck.fused_plan(torch.float32, 256, 896, 64, 64, 256, 11) is None   # group above the tile
    assert ck.fused_plan(torch.float32, 32, 896, 64, 64, 1, 4000) is None  # pairs overflow
    assert ck.fused_plan(torch.float32, 32, 896, 64, 64, 1, 11)["smem"] < ck.SMEM_MAX
    assert ck.fused_plan(torch.float32, 24, 896, 64, 64, 3, 11)["rows"] == 42   # 126 of 128 rows


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def pack_form(x, op, rows_out, w0, w1):
    """What `csrc/cheb2_fused.cu` computes, from the op's gather pack."""
    lx = ck.band_gather_plain(x, op.pack, rows_out)           # rounded to x's dtype
    xc = ck._centre(x, op.pad_left, rows_out)
    y = xc.float() @ w0.float() + lx.float() @ w1.float()
    return y.to(x.dtype)


CASES = [("v1", "natural", "float32"), ("v1", "natural", "bfloat16"),
         ("v5", "natural", "float32"), ("v5", "natural", "bfloat16"),
         ("v5", "padded", "float32"), ("v5", "padded", "bfloat16")]


@pytest.mark.parametrize("entry,layout,dtype", CASES)
def test_pack_form_matches_jax_kernels(toy, entry, layout, dtype):
    """The pack form against `cheb2_banded_pallas` (kernel 1, natural layout
    only) and `cheb2_banded_pallas_v5` (kernel 4) in interpret mode, on the
    toy context. f32 within 1e-5 relative (the same sums in another order);
    bf16 within the limit of test_fused_plain_bf16_matches_jax: one ulp of
    max|y| plus max_f sum_c |w1[c, f]| times one ulp of max|L~x| (L~x
    rounded from f32 sums taken in another order)."""
    from cape_tpu.ops.pallas import cheb_kernel as jck

    jctx_n, jctx_p, ctx_n, ctx_p = toy
    jop, op = (jctx_p.lap[0], ctx_p.lap[0]) if layout == "padded" else (jctx_n.lap[0], ctx_n.lap[0])
    rows = op.p_rows if layout == "padded" else op.n_rows
    rng = np.random.default_rng(31 + len(entry + layout + dtype))
    x = rng.standard_normal((4, rows, 16))
    W = rng.standard_normal((2, 16, 12)) * 0.3
    if dtype == "bfloat16":
        x, W = _bf16(x), _bf16(W)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jfn = jck.cheb2_banded_pallas if entry == "v1" else jck.cheb2_banded_pallas_v5
    want = np.asarray(jfn(jnp.asarray(x, jdt), jop, jnp.asarray(W, jdt)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(np.asarray(x, np.float32)).to(tdt), torch.from_numpy(
        np.asarray(W, np.float32)).to(tdt)
    got = pack_form(xt, op, rows, wt[0], wt[1])
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        lx = ck.band_gather_plain(xt, op.pack, rows).float()
        ulp = lambda v: 2.0 ** (np.floor(np.log2(v)) - 7)
        limit = ulp(np.abs(want).max()) + np.abs(W[1]).sum(0).max() * ulp(lx.abs().max().item())
        assert np.abs(got - want).max() <= limit


@pytest.mark.parametrize("layout", ["natural", "padded"])
def test_pack_form_is_the_plain_version(toy, layout):
    """The pack form and `fused_cheb2_plain` (dense blocks) agree in f32
    within 1e-6 relative and in bf16 within one ulp of max|y| plus the L~x
    term: the kernel is held to the plain version on the card."""
    _, _, ctx_n, ctx_p = toy
    op = ctx_p.lap[2] if layout == "padded" else ctx_n.lap[2]
    rows = op.p_rows if layout == "padded" else op.n_rows
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, rows, 24, generator=g)
    w = torch.randn(2, 24, 7, generator=g) / 5
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), w.to(dt)
        got = pack_form(xd, op, rows, wd[0], wd[1]).float()
        want = ck.fused_cheb2_plain(xd, op.blocks.to(dt), op.pad_left, rows, wd[0], wd[1]).float()
        scale = want.abs().max().item()
        if dt == torch.float32:
            limit = 1e-6 * scale
        else:
            lx = ck.band_apply_plain(xd, op.blocks.to(dt), op.pad_left, rows).float()
            limit = (chip_smoke.bf16_ulp(scale)
                     + wd[1].float().abs().sum(0).max().item() * chip_smoke.bf16_ulp(lx.abs().max().item()))
        assert (got - want).abs().max().item() <= limit, dt


@pytest.mark.parametrize("entry,layout", [("cheb2_banded", "natural"),
                                          ("cheb2_banded_v5", "natural"),
                                          ("cheb2_banded_v5", "padded")])
def test_whole_conv_entries_hand_the_op_pack_to_the_kernel(toy, monkeypatch, entry, layout):
    _, _, ctx_n, ctx_p = toy
    op = ctx_p.lap[0] if layout == "padded" else ctx_n.lap[0]
    rows = op.p_rows if layout == "padded" else op.n_rows
    seen = []
    real = ck.fused_cheb2

    def record(*a, **k):
        seen.append(k)
        return real(*a, **k)

    monkeypatch.setattr(ck, "fused_cheb2", record)
    y = getattr(ck, entry)(torch.randn(4, rows, 6), op, torch.randn(2, 6, 5))
    assert y.shape == (4, rows, 5)
    assert len(seen) == 1 and seen[0]["pack"] is op.pack
    assert seen[0]["group"] == (1 if entry == "cheb2_banded" else 4)


def test_a_given_pack_is_checked_on_the_cpu(toy):
    """A pack given to fused_cheb2 is checked against the blocks and
    pad_left on every device; without one the CPU and meta tensors take the
    plain version (a CUDA launch needs it)."""
    _, _, ctx, _ = toy
    op, other = ctx.lap[0], ctx.lap[2]
    x, w = torch.randn(2, op.n_rows, 5), torch.randn(2, 5, 3)
    args = (x, op.blocks, op.pad_left, op.n_rows, w[0], w[1], 1)
    torch.testing.assert_close(ck.fused_cheb2(*args, pack=op.pack), ck.fused_cheb2(*args))
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.fused_cheb2(x, op.blocks, op.pad_left + 128, op.n_rows, w[0], w[1], 1, pack=op.pack)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.fused_cheb2(*args, pack=other.pack)
    with pytest.raises(ValueError, match="gather pack was built for"):
        ck.cheb2_banded(x, dataclasses.replace(op, pack=other.pack), w)
    m = op.to("meta")
    xm = torch.empty(2, op.n_rows, 5, device="meta")
    assert ck.fused_cheb2(xm, m.blocks, m.pad_left, m.n_rows, w[0].to("meta"), w[1].to("meta"), 2,
                          pack=m.pack).shape == (2, op.n_rows, 3)
