"""Parity of the port's fused conv (TPU kernels 1 and 4), batch-major band
apply (kernel 3) and small-batch v2 route with the JAX package on the CPU,
and the routing override of both packages.

On CPU tensors each kernel wrapper runs its plain PyTorch version; the JAX
functions run their Pallas kernels in interpret mode, as the JAX tests do.
Inputs come from numpy seeds and go to both packages. The operators are
those of the toy icosphere pyramid of `tests/test_ops.py`, in both
packages' contexts (the same orderings, so the same packed blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# f32 parity: the same sums in another order
RTOL = 1e-5


@pytest.fixture(scope="module")
def toy(small_mesh):
    """(JAX natural, JAX padded, port natural, port padded) contexts of the
    toy pyramid."""
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


def _counts():
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    return (ck.launches, ck.bwd_launches, ck.fused1_launches, ck.fused_launches, ck.bm_launches)


def _close(got, want, name, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=name)


def _value_and_grads(jax_fn, torch_fn, x, W, g):
    """(y, dx, dW) of both packages for the cotangent g, f32."""
    y, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(W))
    want = [np.asarray(a) for a in (y, *vjp(jnp.asarray(g)))]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(W).requires_grad_()
    yt = torch_fn(xt, wt)
    got = [yt, *torch.autograd.grad(yt, (xt, wt), torch.from_numpy(g))]
    return got, want


def test_cheb2_banded_matches_jax_pallas(toy):
    """Kernel 1's entry (`cheb2_banded`, group 1) against
    `cheb2_banded_pallas`: y, dx and dW, natural layout, f32."""
    from cape_tpu.ops.pallas.cheb_kernel import cheb2_banded_pallas
    from cape_tpu_torch.ops.kernels.cheb_kernel import cheb2_banded

    jctx, _, ctx, _ = toy
    jop, op = jctx.lap[0], ctx.lap[0]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, op.n_rows, 6)).astype(np.float32)
    W = (rng.standard_normal((2, 6, 5)) * 0.3).astype(np.float32)
    g = rng.standard_normal((3, op.n_rows, 5)).astype(np.float32)
    before = _counts()
    got, want = _value_and_grads(lambda x, w: cheb2_banded_pallas(x, jop, w),
                                 lambda x, w: cheb2_banded(x, op, w), x, W, g)
    assert _counts() == before  # CPU tensors take the plain version
    for name, a, b in zip(("y", "dx", "dW"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("B,C,F,group", [(4, 16, 12, 4), (6, 8, 16, 2), (3, 8, 8, 1)])
def test_cheb2_banded_v5_matches_jax_pallas(toy, padded, B, C, F, group):
    """Kernel 4's entry (`cheb2_banded_v5`) against `cheb2_banded_pallas_v5`:
    y, dx and dW, natural and padded layouts, f32, at batches that keep
    v5's group of 4, fall back to 2 and to 1. In the padded layout x's tail
    rows hold 7.0 and the cotangent's tail is zero, as the model's is."""
    from cape_tpu.ops.pallas.cheb_kernel import cheb2_banded_pallas_v5
    from cape_tpu_torch.ops.kernels.cheb_kernel import cheb2_banded_v5, v5_group

    jctx_n, jctx_p, ctx_n, ctx_p = toy
    jop, op = (jctx_p.lap[0], ctx_p.lap[0]) if padded else (jctx_n.lap[0], ctx_n.lap[0])
    assert v5_group(B) == group
    rows = op.p_rows if padded else op.n_rows
    rng = np.random.default_rng(B * 100 + C)
    x = rng.standard_normal((B, rows, C)).astype(np.float32)
    W = (rng.standard_normal((2, C, F)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B, rows, F)).astype(np.float32)
    if padded:
        x[:, op.n_rows:] = 7.0
        g[:, op.n_rows:] = 0.0
    before = _counts()
    got, want = _value_and_grads(lambda x, w: cheb2_banded_pallas_v5(x, jop, w),
                                 lambda x, w: cheb2_banded_v5(x, op, w), x, W, g)
    assert _counts() == before
    for name, a, b in zip(("y", "dx", "dW"), got, want):
        _close(a, b, name)


def test_cheb2_banded_v2_matches_jax_pallas(toy):
    """The v2 entry (band-apply kernel forward, plain `_bwd`) against
    `cheb2_banded_pallas_v2`: y, dx and dW, natural layout, f32; a padded op
    is refused."""
    from cape_tpu.ops.pallas.cheb_kernel import cheb2_banded_pallas_v2
    from cape_tpu_torch.ops.kernels.cheb_kernel import cheb2_banded_v2

    jctx, _, ctx, ctx_p = toy
    jop, op = jctx.lap[2], ctx.lap[2]
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, op.n_rows, 7)).astype(np.float32)
    W = (rng.standard_normal((2, 7, 4)) * 0.3).astype(np.float32)
    g = rng.standard_normal((2, op.n_rows, 4)).astype(np.float32)
    before = _counts()
    got, want = _value_and_grads(lambda x, w: cheb2_banded_pallas_v2(x, jop, w),
                                 lambda x, w: cheb2_banded_v2(x, op, w), x, W, g)
    assert _counts() == before
    for name, a, b in zip(("y", "dx", "dW"), got, want):
        _close(a, b, name)
    with pytest.raises(ValueError, match="natural layout"):
        cheb2_banded_v2(torch.zeros(2, ctx_p.lap[2].p_rows, 7), ctx_p.lap[2], torch.from_numpy(W))


# every banded lap, down and up op of the toy context: cb = 128, 256/254/252, 64/65
BM_OPS = [("lap", i) for i in range(9)] + [(f, i) for f in ("down", "up") for i in (1, 3, 5)]


@pytest.mark.parametrize("field,idx", BM_OPS)
def test_banded_apply_bm_matches_jax(toy, field, idx):
    """Kernel 3's entry against the JAX `banded_apply_bm` (interpret mode)
    on the op, f32: y [B, n_rows, C] from x [B, n_cols, C]."""
    from cape_tpu.ops.pallas.cheb_kernel import banded_apply_bm as jax_bm
    from cape_tpu_torch.ops.kernels.cheb_kernel import banded_apply_bm

    jctx, _, ctx, _ = toy
    jop, op = getattr(jctx, field)[idx], getattr(ctx, field)[idx]
    np.testing.assert_array_equal(op.blocks.numpy(), np.asarray(jop.blocks))
    rng = np.random.default_rng(idx)
    x = rng.standard_normal((3, op.n_cols, 5)).astype(np.float32)
    args = (op.pad_left, op.pad_right, op.n_rows)
    want = jax_bm(jnp.asarray(x), jop.blocks, *args)
    before = _counts()
    got = banded_apply_bm(torch.from_numpy(x), op.blocks, *args)
    assert _counts() == before
    _close(got, want, f"{field}[{idx}] cb={op.col_block}")
    # and the plain apply of the op itself
    _close(got, op(torch.from_numpy(x)).numpy(), f"{field}[{idx}] vs BandedOp")


def test_bm_ops_cover_every_column_block(toy):
    _, _, ctx, _ = toy
    cbs = {getattr(ctx, f)[i].col_block for f, i in BM_OPS}
    assert cbs == {128, 256, 254, 252, 64, 65}


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("entry", ["v1", "v5"])
def test_fused_plain_bf16_matches_jax(toy, entry):
    """bf16 forwards of the fused conv's plain version against the JAX
    kernels in interpret mode. Limit: one bf16 ulp of max|y| plus
    max_f sum_c |w1[c, f]| times one ulp of max|L~x|. Both round L~x to
    bf16 before the W1 product, from f32 sums taken in different orders,
    so an element at a rounding boundary may round either way; the final
    rounding of y adds at most one ulp."""
    from cape_tpu.ops.pallas import cheb_kernel as jck
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    jctx, _, ctx, _ = toy
    jop, op = jctx.lap[0], ctx.lap[0]
    rng = np.random.default_rng(23)
    x = _bf16(rng.standard_normal((4, op.n_rows, 8)))
    W = _bf16(rng.standard_normal((2, 8, 6)) * 0.3)
    jfn, fn = (jck.cheb2_banded_pallas, ck.cheb2_banded) if entry == "v1" else (
        jck.cheb2_banded_pallas_v5, ck.cheb2_banded_v5)
    want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16), jop, jnp.asarray(W, jnp.bfloat16))
                      .astype(jnp.float32))
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(W).bfloat16()
    got = fn(xt, op, wt)
    assert got.dtype == torch.bfloat16
    lx = ck.band_apply_plain(xt, op.blocks.bfloat16(), op.pad_left, op.n_rows).float()
    ulp = lambda v: 2.0 ** (np.floor(np.log2(v)) - 7)
    limit = ulp(np.abs(want).max()) + np.abs(W[1]).sum(0).max() * ulp(lx.abs().max().item())
    assert np.abs(got.float().numpy() - want).max() <= limit


def test_bf16_control_check_passes_jax_and_refuses_the_controls(toy):
    """chip_smoke.py's bf16 check of the fused kernel: the JAX v5 kernel
    (interpret mode), which keeps the bf16 numerics with f32 sums in its
    own order, lies within CONTROL_SHARE of each control's mean distance
    from the plain version; each control, which drops one of the numerics,
    does not."""
    import chip_smoke
    from cape_tpu.ops.pallas import cheb_kernel as jck
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    jctx, _, ctx, _ = toy
    jop, op = jctx.lap[0], ctx.lap[0]
    rng = np.random.default_rng(25)
    x = _bf16(rng.standard_normal((4, op.n_rows, 16)))
    W = _bf16(rng.standard_normal((2, 16, 12)) / 4)
    jax_y = torch.from_numpy(np.asarray(jck.cheb2_banded_pallas_v5(
        jnp.asarray(x, jnp.bfloat16), jop, jnp.asarray(W, jnp.bfloat16)).astype(jnp.float32)))
    xt, w0, w1 = (torch.from_numpy(a).bfloat16() for a in (x, W[0], W[1]))
    blocks = op.blocks.bfloat16()
    ref = ck.fused_cheb2_plain(xt, blocks, op.pad_left, op.n_rows, w0, w1)
    controls = chip_smoke.bf16_controls(xt, blocks, op.pad_left, op.n_rows, w0, w1)
    ratios = chip_smoke.control_ratios(jax_y.bfloat16(), ref, controls)
    assert max(ratios.values()) <= chip_smoke.CONTROL_SHARE, ratios
    for c in controls.values():
        assert max(chip_smoke.control_ratios(c, ref, controls).values()) > chip_smoke.CONTROL_SHARE


def test_fused_plain_numerics_and_guards():
    """fused_cheb2_plain rounds L~x to x's dtype before the W1 product and y
    once; it reads x's centre rows at pad_left % 128 and masks rows outside
    x. The wrappers refuse a group that does not divide the batch and the
    natural-only entries refuse padded ops; v5's group falls back 4 -> 2 -> 1."""
    from cape_tpu_torch.ops.banded import banded_from_scipy
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    rng = np.random.default_rng(24)
    blocks = torch.from_numpy(rng.standard_normal((3, 2, 128, 128)).astype(np.float32) * 0.05)
    x = torch.from_numpy(rng.standard_normal((2, 200, 5)).astype(np.float32))
    w0, w1 = (torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)) for _ in range(2))
    for pad_left in (128, 160):
        y = ck.fused_cheb2(x, blocks, pad_left, 256, w0, w1, 2)
        shift = pad_left % 128
        xc = torch.zeros(2, 256, 5)
        xc[:, shift:200 + shift] = x[:, : 256 - shift]
        want = xc @ w0 + ck.band_apply_plain(x, blocks, pad_left, 256) @ w1
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    xb, bb, w0b, w1b = x.bfloat16(), blocks.bfloat16(), w0.bfloat16(), w1.bfloat16()
    lx = ck.band_apply_plain(xb, bb, 128, 256)
    assert lx.dtype == torch.bfloat16
    xcb = torch.zeros(2, 256, 5, dtype=torch.bfloat16)
    xcb[:, :200] = xb
    want = (xcb.float() @ w0b.float() + lx.float() @ w1b.float()).bfloat16()
    torch.testing.assert_close(ck.fused_cheb2(xb, bb, 128, 256, w0b, w1b, 1), want, rtol=0, atol=0)

    with pytest.raises(ValueError, match="multiple of group"):
        ck.fused_cheb2(x, blocks, 128, 256, w0, w1, 4)
    assert [ck.v5_group(b) for b in (8, 4, 6, 2, 3, 1)] == [4, 4, 2, 2, 1, 1]
    import scipy.sparse as sp

    op = banded_from_scipy(sp.identity(200, format="csr"), padded=True)
    for fn in (ck.cheb2_banded, ck.cheb2_banded_v2):
        with pytest.raises(ValueError, match="natural layout"):
            fn(torch.zeros(2, op.p_rows, 5), op, torch.zeros(2, 5, 3))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """On a device with no kernel the wrappers raise; they never fall back
    (meta tensors take the plain version, which computes nothing)."""
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    m = lambda *s: torch.empty(s, device="meta")
    assert ck.fused_cheb2(m(4, 300, 8), m(3, 3, 128, 128), 128, 300, m(8, 6), m(8, 6), 4).shape == (4, 300, 6)
    assert ck.banded_apply_bm(m(4, 258, 8), m(1, 2, 128, 256), 0, 254, 129).shape == (4, 129, 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        ck._check_cuda("fused_cheb2", torch.zeros(2))


# ---------------------------------------------------------------- routing


def _spy(monkeypatch, name):
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    calls = []
    real = getattr(ck, name)
    monkeypatch.setattr(ck, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_override_reads_the_variable_live(monkeypatch):
    from cape_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "_enabled", False)
    for value, want in (("0", False), ("1", True), ("yes", None)):
        monkeypatch.setenv("CAPE_TPU_PALLAS", value)
        assert kernels.override() is want
        assert kernels.enabled() is (want is True)
    monkeypatch.delenv("CAPE_TPU_PALLAS")
    assert kernels.override() is None and not kernels.enabled()
    kernels.set_enabled(True)
    assert kernels.enabled()


def test_override_moves_a_batch32_conv_on_and_off_v3(toy, monkeypatch):
    """CAPE_TPU_PALLAS=0 takes a batch-32 conv that the gate sends to v3 off
    it; =1 puts it back on an op with use_pallas=False (meta tensors)."""
    import dataclasses

    from cape_tpu_torch.ops import cheb

    _, _, ctx, _ = toy
    op = ctx.lap[0].to("meta")
    x, w = torch.empty(32, op.n_rows, 64, device="meta"), torch.empty(2, 64, 64, device="meta")
    v3 = _spy(monkeypatch, "cheb2_banded_v3")
    monkeypatch.delenv("CAPE_TPU_PALLAS", raising=False)
    assert cheb.cheb_conv(x, op, w).shape == (32, op.n_rows, 64)
    assert len(v3) == 1
    monkeypatch.setenv("CAPE_TPU_PALLAS", "0")
    cheb.cheb_conv(x, op, w)
    assert len(v3) == 1
    off = dataclasses.replace(op, allow_pallas=False)
    cheb.cheb_conv(x, off, w)
    assert len(v3) == 1
    monkeypatch.setenv("CAPE_TPU_PALLAS", "1")
    cheb.cheb_conv(x, off, w)
    assert len(v3) == 2


def test_set_enabled_routes_small_batch_to_v2(toy, monkeypatch):
    """set_enabled(True) sends a B=2 conv to v2 in both packages
    (`tests/test_ops.py` does so for JAX), with the same value and
    gradients; not in the padded layout, and not by default."""
    from cape_tpu.ops import pallas as jax_kernels
    from cape_tpu.ops.cheb import cheb_conv as jax_cheb_conv
    from cape_tpu_torch.ops import cheb, kernels

    jctx, _, ctx, ctx_p = toy
    jop, op = jctx.lap[0], ctx.lap[0]
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, op.n_rows, 6)).astype(np.float32)
    W = (rng.standard_normal((2, 6, 4)) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, op.n_rows, 4)).astype(np.float32)
    monkeypatch.delenv("CAPE_TPU_PALLAS", raising=False)
    monkeypatch.setattr(kernels, "_enabled", False)
    v2 = _spy(monkeypatch, "cheb2_banded_v2")
    cheb.cheb_conv(torch.from_numpy(x), op, torch.from_numpy(W))
    assert not v2  # off by default

    kernels.set_enabled(True)
    was = jax_kernels.enabled()
    jax_kernels.set_enabled(True)
    try:
        got, want = _value_and_grads(lambda x, w: jax_cheb_conv(x, jop, w),
                                     lambda x, w: cheb.cheb_conv(x, op, w), x, W, g)
    finally:
        jax_kernels.set_enabled(was)
    assert len(v2) == 1
    for name, a, b in zip(("y", "dx", "dW"), got, want):
        _close(a, b, name)
    xp = torch.zeros(2, ctx_p.lap[0].p_rows, 6)
    cheb.cheb_conv(xp, ctx_p.lap[0], torch.from_numpy(W))
    assert len(v2) == 1  # v2 takes the natural layout only


@pytest.mark.parametrize("B", [16, 32])
def test_default_routing_of_the_flagship_is_unchanged(monkeypatch, B):
    """With CAPE_TPU_PALLAS unset and v2 not opted into, no conv of the
    flagship's decode, encode or discriminator reaches v2, and only the
    batch-32 convs reach v3 (7 per decode and encode call, the pred conv
    once), as before the override existed; meta tensors launch nothing."""
    import os

    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops import cheb, kernels

    monkeypatch.delenv("CAPE_TPU_PALLAS", raising=False)
    monkeypatch.setattr(kernels, "_enabled", False)
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml"))
    ctx = build_context(cfg)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to("meta")
    ctx = ctx.to("meta")
    m = lambda *s: torch.empty(s, device="meta")
    y, y2 = m(B, cfg.nz_cond), m(B, cfg.nz_cond2)
    before, v3, counts = cheb.v2_routes, cheb.kernel_routes, _counts()
    model.decode(ctx, m(B, cfg.z_total_dim), y, y2)
    model.encode(ctx, m(B, 6890, 3), y, y2)
    model.discriminate(ctx, m(B, 6890, 3), y, y2)
    assert cheb.v2_routes == before
    assert cheb.kernel_routes - v3 == (15 if B == 32 else 0)
    assert _counts() == counts
