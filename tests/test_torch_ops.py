"""Parity of the PyTorch port's operators with the JAX package on the CPU:
banded packing and apply, the large-batch K=2 conv (the band-apply
kernel's plain version against the JAX Pallas v3 kernel in interpret mode),
the Chebyshev conv routes, and the kernel routing of the flagship model at
full width (on the `meta` device, which computes nothing)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cape_tpu.meshops import assets

torch.set_num_threads(1)

FLAGSHIP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml",
)


def _icosphere_laplacian(small_mesh):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from cape_tpu.meshops.laplacian import scaled_adjacency
    from cape_tpu.meshops.topology import vert_connectivity

    verts, faces = small_mesh
    A = vert_connectivity(faces, len(verts))
    perm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A), symmetric_mode=True))
    return sp.csr_matrix(scaled_adjacency(A))[perm][:, perm]


def _assert_same_packing(jax_op, m):
    from cape_tpu_torch.ops.banded import banded_from_scipy

    op = banded_from_scipy(m)
    np.testing.assert_array_equal(op.blocks.numpy(), np.asarray(jax_op.blocks))
    np.testing.assert_array_equal(op.t_blocks.numpy(), np.asarray(jax_op.t_blocks))
    assert (op.pad_left, op.pad_right, op.col_block, op.n_rows, op.n_cols) == (
        jax_op.pad_left, jax_op.pad_right, jax_op.col_block, jax_op.n_rows, jax_op.n_cols
    )
    assert (op.t_pad_left, op.t_pad_right) == (jax_op.t_pad_left, jax_op.t_pad_right)
    assert op.p_cols == jax_op.p_cols and op.p_rows == jax_op.p_rows
    assert op.pallas_eligible == jax_op.pallas_eligible


def test_pack_blocks_matches_jax_on_every_flagship_operator(flagship_ctx):
    """Every banded operator of the JAX flagship context (VAE pyramid,
    discriminator pyramid, edge operator) packs identically in the port:
    blocks and their transpose packing, S/T/cb, pads."""
    from cape_tpu.meshops.ordering import permute_pyramid, pyramid_orderings
    from cape_tpu.ops.banded import BandedOp as JaxBandedOp
    from cape_tpu.ops.sparse import _edge_incidence
    from cape_tpu_torch.ops.sparse import IdentityOp, build_graph_context

    pyr, pyr_d = assets.load_pyramid("for_demo"), assets.load_pyramid("ds2")
    perms = pyramid_orderings(pyr)
    perms_d = pyramid_orderings(pyr_d, base_perm=perms[0])
    p, p_d = permute_pyramid(pyr, perms), permute_pyramid(pyr_d, perms_d)
    mats = {
        "lap": p.scaled_laplacians(), "down": p.downsamples, "up": p.upsamples,
        "lap_d": p_d.scaled_laplacians(), "down_d": p_d.downsamples,
    }
    n = 0
    for field, ms in mats.items():
        for jax_op, m in zip(getattr(flagship_ctx, field), ms, strict=True):
            if isinstance(jax_op, JaxBandedOp):
                _assert_same_packing(jax_op, m)
                n += 1
    verts, _ = assets.template_mesh()
    edges = np.asarray(flagship_ctx.edges)
    _assert_same_packing(flagship_ctx.edge_op, _edge_incidence(edges, len(verts), True))
    assert n >= 20

    # the port's own context holds the same operators and constants, in the
    # same order
    ctx = build_graph_context(pyr, pyr_d, assets.smpl_edges(), verts)
    np.testing.assert_array_equal(ctx.perm0, np.asarray(flagship_ctx.perm0))
    assert ctx.level_sizes == flagship_ctx.level_sizes
    assert ctx.level_sizes_d == flagship_ctx.level_sizes_d
    np.testing.assert_array_equal(ctx.edges.numpy(), np.asarray(flagship_ctx.edges))
    np.testing.assert_array_equal(ctx.template_verts.numpy(),
                                  np.asarray(flagship_ctx.template_verts))
    np.testing.assert_array_equal(ctx.loss_mask.numpy(), np.asarray(flagship_ctx.loss_mask))
    np.testing.assert_array_equal(ctx.edge_op.blocks.numpy(),
                                  np.asarray(flagship_ctx.edge_op.blocks))
    assert ctx.edge_op.col_block == 43 and not ctx.edge_op.padded
    for field in ("lap", "down", "up", "lap_d", "down_d"):
        for op, jax_op in zip(getattr(ctx, field), getattr(flagship_ctx, field), strict=True):
            if isinstance(op, IdentityOp):
                assert not isinstance(jax_op, JaxBandedOp)
            else:
                np.testing.assert_array_equal(op.blocks.numpy(), np.asarray(jax_op.blocks))


@pytest.mark.parametrize("padded", [False, True])
def test_banded_apply_matches_jax(flagship_ctx, padded):
    """BandedOp apply on a Laplacian, a pool and an unpool operator and on
    a 2-D [V, 1] seed, natural and padded layouts, f32."""
    from cape_tpu.ops.banded import BandedOp as JaxBandedOp
    from cape_tpu_torch.ops.banded import BandedOp

    rng = np.random.default_rng(0)
    ops = [flagship_ctx.lap[4], flagship_ctx.down[5], flagship_ctx.up[3]]
    for jop in ops:
        assert isinstance(jop, JaxBandedOp)
        jop = jop.replace(padded=padded)
        op = BandedOp(
            blocks=torch.tensor(np.asarray(jop.blocks)),
            t_blocks=torch.tensor(np.asarray(jop.t_blocks)), n_rows=jop.n_rows,
            n_cols=jop.n_cols, row_block=jop.row_block, col_block=jop.col_block,
            pad_left=jop.pad_left, pad_right=jop.pad_right,
            t_pad_left=jop.t_pad_left, t_pad_right=jop.t_pad_right, padded=padded,
        )
        rows = jop.p_cols if padded else jop.n_cols
        x = rng.standard_normal((3, rows, 5)).astype(np.float32)
        if padded:
            x[:, jop.n_cols:] = 0.0
        for xi in (x, x[0, :, :1]):
            want = np.asarray(jop(jnp.asarray(xi)))
            got = op(torch.from_numpy(xi)).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("padded", [False, True])
def test_cheb2_banded_v3_matches_jax_pallas(small_mesh, padded):
    """The port's large-batch conv (band-apply plain version on the CPU)
    against the JAX Pallas v3 kernel (interpret mode), on the icosphere."""
    from cape_tpu.ops.banded import banded_from_scipy as jax_banded
    from cape_tpu.ops.pallas.cheb_kernel import cheb2_banded_pallas_v3
    from cape_tpu_torch.ops.banded import banded_from_scipy
    from cape_tpu_torch.ops.kernels import cheb_kernel

    Lt = _icosphere_laplacian(small_mesh)
    jop = jax_banded(Lt, padded=padded)
    op = banded_from_scipy(Lt, padded=padded)
    rng = np.random.default_rng(4)
    rows = op.p_rows if padded else Lt.shape[0]
    x = rng.standard_normal((3, rows, 5)).astype(np.float32)
    W = (rng.standard_normal((2, 5, 4)) * 0.1).astype(np.float32)
    want = np.asarray(cheb2_banded_pallas_v3(jnp.asarray(x), jop, jnp.asarray(W)))
    before = cheb_kernel.launches
    got = cheb_kernel.cheb2_banded_v3(torch.from_numpy(x), op, torch.from_numpy(W)).numpy()
    assert cheb_kernel.launches == before  # CPU tensors take the plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_band_apply_plain_masks_and_rounds_once():
    """The kernel's plain version: rows outside the input read as zero, the
    output keeps rows_out rows, and bf16 inputs accumulate in f32."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply_plain

    rng = np.random.default_rng(1)
    S, T, B, C, pad_left = 3, 4, 2, 7, 128
    blocks = torch.from_numpy(rng.standard_normal((S, T, 128, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, 450, C)).astype(np.float32))
    y = band_apply_plain(x, blocks, pad_left, 500)
    dense = torch.zeros(T * 128, 450)
    for k in range(S):
        for t in range(T):
            for j in range(128):
                r = (t + k) * 128 + j - pad_left
                if 0 <= r < 450:
                    dense[t * 128 : (t + 1) * 128, r] += blocks[k, t, :, j]
    want = torch.einsum("vr,brc->bvc", dense, x)[:, :500]
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-4)
    yb = band_apply_plain(x.bfloat16(), blocks.bfloat16(), pad_left, 500)
    assert yb.dtype == torch.bfloat16
    ref = band_apply_plain(x.bfloat16().float(), blocks.bfloat16().float(), pad_left, 500)
    torch.testing.assert_close(yb, ref.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("K,fin,fout", [(2, 6, 4), (2, 4, 6), (1, 6, 4), (3, 5, 3)])
def test_cheb_conv_routes_match_jax(small_mesh, K, fin, fout):
    """cheb_conv: accumulation (Fout >= Fin), Clenshaw (Fout < Fin), K=1."""
    from cape_tpu.ops.banded import banded_from_scipy as jax_banded
    from cape_tpu.ops.cheb import cheb_conv as jax_cheb_conv
    from cape_tpu_torch.ops.banded import banded_from_scipy
    from cape_tpu_torch.ops.cheb import cheb_conv

    Lt = _icosphere_laplacian(small_mesh)
    rng = np.random.default_rng(K * 100 + fin)
    x = rng.standard_normal((2, Lt.shape[0], fin)).astype(np.float32)
    W = (rng.standard_normal((K, fin, fout)) * 0.3).astype(np.float32)
    want = np.asarray(jax_cheb_conv(jnp.asarray(x), jax_banded(Lt), jnp.asarray(W)))
    got = cheb_conv(torch.from_numpy(x), banded_from_scipy(Lt), torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_cheb_conv_folded_matches_jax(small_mesh):
    from cape_tpu.ops.banded import banded_from_scipy as jax_banded
    from cape_tpu.ops.cheb import cheb_conv_folded as jax_folded
    from cape_tpu_torch.ops.banded import banded_from_scipy
    from cape_tpu_torch.ops.cheb import cheb_conv_folded

    Lt = _icosphere_laplacian(small_mesh)
    rng = np.random.default_rng(11)
    V = Lt.shape[0]
    x = rng.standard_normal((3, V, 4)).astype(np.float32)
    c1 = rng.standard_normal((3, 5)).astype(np.float32)
    c2 = rng.standard_normal((3, 2)).astype(np.float32)
    seed = rng.uniform(0.5, 1.5, (V, 1)).astype(np.float32)
    W = (rng.standard_normal((2, 11, 6)) * 0.3).astype(np.float32)
    want = np.asarray(jax_folded(
        jnp.asarray(x), [jnp.asarray(c1), jnp.asarray(c2)], jax_banded(Lt),
        jnp.asarray(W), cond_seed=jnp.asarray(seed),
    ))
    t = torch.from_numpy
    got = cheb_conv_folded(
        t(x), [t(c1), t(c2)], banded_from_scipy(Lt), t(W), cond_seed=t(seed)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def flagship_meta():
    """The flagship model and context of the port on the meta device."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    cfg = load_config(FLAGSHIP)
    ctx = build_context(cfg)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    return cfg, model.to("meta"), ctx.to("meta")


def _jax_v3_calls(flagship_ctx, B):
    """Pallas v3 calls of one JAX flagship decode and encode at batch B,
    counted by a spy under jax.eval_shape (nothing is computed)."""
    import jax

    import cape_tpu.ops.pallas.cheb_kernel as ck
    from cape_tpu.core.config import load_config
    from cape_tpu.models.cape import CAPE as JaxCAPE

    cfg = load_config(FLAGSHIP)
    model = JaxCAPE(cfg)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0), flagship_ctx)
    S = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    y, y2 = S(B, cfg.nz_cond), S(B, cfg.nz_cond2)
    calls = []
    real = ck.cheb2_banded_pallas_v3
    ck.cheb2_banded_pallas_v3 = lambda *a: (calls.append(1), real(*a))[1]
    try:
        jax.eval_shape(model.decode, params, flagship_ctx, S(B, cfg.z_total_dim), y, y2)
        n_decode = len(calls)
        jax.eval_shape(model.encode, params, flagship_ctx, S(B, 6890, 3), y, y2)
    finally:
        ck.cheb2_banded_pallas_v3 = real
    return n_decode, len(calls) - n_decode


@pytest.mark.parametrize("B,n_decode,n_encode", [(16, 0, 0), (32, 7, 7), (64, 9, 7)])
def test_flagship_kernel_routes(flagship_ctx, flagship_meta, B, n_decode, n_encode):
    """At full width, the port's gate sends as many convs per device call
    to the kernel as the JAX package sends to Pallas v3 (0/7/9 decode and
    0/7/7 encode at batch 16/32/64)."""
    from cape_tpu_torch.ops import cheb
    from cape_tpu_torch.ops.kernels import cheb_kernel

    assert _jax_v3_calls(flagship_ctx, B) == (n_decode, n_encode)
    cfg, model, ctx = flagship_meta
    m = lambda *s: torch.empty(s, device="meta")
    y, y2 = m(B, cfg.nz_cond), m(B, cfg.nz_cond2)
    launches = cheb_kernel.launches
    start = cheb.kernel_routes
    out = model.decode(ctx, m(B, cfg.z_total_dim), y, y2)
    assert out.shape == (B, 6890, 3)
    assert cheb.kernel_routes - start == n_decode
    start = cheb.kernel_routes
    zm, zl = model.encode(ctx, m(B, 6890, 3), y, y2)
    assert zm.shape == zl.shape == (B, cfg.nz)
    assert cheb.kernel_routes - start == n_encode
    assert cheb_kernel.launches == launches  # meta tensors launch nothing


def _torch_op(jop):
    from cape_tpu_torch.ops.banded import BandedOp

    t = lambda a: torch.tensor(np.asarray(a))
    return BandedOp(
        blocks=t(jop.blocks), t_blocks=t(jop.t_blocks), n_rows=jop.n_rows,
        n_cols=jop.n_cols, row_block=jop.row_block, col_block=jop.col_block,
        pad_left=jop.pad_left, pad_right=jop.pad_right, t_pad_left=jop.t_pad_left,
        t_pad_right=jop.t_pad_right, padded=jop.padded,
    )


@pytest.mark.parametrize("padded", [False, True])
def test_banded_backward_matches_jax_vjp(flagship_ctx, padded):
    """The transpose apply of the port's BandedOp (its autograd backward)
    against jax.vjp of banded_matvec, on a Laplacian, a pool, an unpool, a
    discriminator pool and the edge operator (natural layout only), f32,
    tolerance 1e-5 relative. Padded cotangents have zero tail rows, as the
    model's make them."""
    import jax

    rng = np.random.default_rng(2)
    ops = [flagship_ctx.lap[3], flagship_ctx.down[5], flagship_ctx.up[3], flagship_ctx.down_d[1]]
    if not padded:
        ops.append(flagship_ctx.edge_op)
    for jop in ops:
        jop = jop.replace(padded=padded)
        op = _torch_op(jop)
        x = rng.standard_normal((2, jop.p_cols if padded else jop.n_cols, 3)).astype(np.float32)
        y, vjp = jax.vjp(jop, jnp.asarray(x))
        g = rng.standard_normal(y.shape).astype(np.float32)
        if padded:
            g[:, jop.n_rows:] = 0.0
        (want,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_()
        (got,) = torch.autograd.grad(op(xt), xt, torch.from_numpy(g))
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("padded", [False, True])
def test_cheb2_banded_v3_grads_match_jax_pallas(small_mesh, padded):
    """The port's large-batch conv as an autograd Function (forward and
    backward on the band-apply plain version) against jax.grad of the JAX
    Pallas v3 kernel (interpret mode): y, dx, dW0 and dW1, f32, tolerance
    1e-5 relative. In the padded layout x's tail rows hold garbage, which
    the zero tail rows of the cotangent must cancel in dW."""
    import jax

    from cape_tpu.ops.banded import banded_from_scipy as jax_banded
    from cape_tpu.ops.pallas.cheb_kernel import cheb2_banded_pallas_v3
    from cape_tpu_torch.ops.banded import banded_from_scipy
    from cape_tpu_torch.ops.kernels import cheb_kernel

    Lt = _icosphere_laplacian(small_mesh)
    jop, op = jax_banded(Lt, padded=padded), banded_from_scipy(Lt, padded=padded)
    rng = np.random.default_rng(6)
    rows = op.p_rows if padded else Lt.shape[0]
    x = rng.standard_normal((3, rows, 5)).astype(np.float32)
    W = (rng.standard_normal((2, 5, 4)) * 0.3).astype(np.float32)
    g = rng.standard_normal((3, rows, 4)).astype(np.float32)
    if padded:
        x[:, Lt.shape[0]:] = 7.0
        g[:, Lt.shape[0]:] = 0.0
    y, vjp = jax.vjp(lambda x, w: cheb2_banded_pallas_v3(x, jop, w), jnp.asarray(x), jnp.asarray(W))
    want = [np.asarray(a) for a in (y, *vjp(jnp.asarray(g)))]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(W).requires_grad_()
    before = (cheb_kernel.launches, cheb_kernel.bwd_launches)
    yt = cheb_kernel.cheb2_banded_v3(xt, op, wt)
    got = [yt, *torch.autograd.grad(yt, (xt, wt), torch.from_numpy(g))]
    assert (cheb_kernel.launches, cheb_kernel.bwd_launches) == before  # CPU: plain version
    for name, a, b in zip(("y", "dx", "dW"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_band_apply_plain_addend_and_f64_gradcheck(small_mesh):
    """band_apply_plain with an addend is the apply plus the addend (one
    rounding in bf16), and the conv's Function passes gradcheck in f64 on
    the plain route, with and without an input gradient."""
    from cape_tpu_torch.ops.banded import banded_from_scipy
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply_plain, cheb2_banded_v3

    rng = np.random.default_rng(3)
    blocks = torch.from_numpy(rng.standard_normal((3, 4, 128, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 450, 7)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 500, 7)).astype(np.float32))
    torch.testing.assert_close(band_apply_plain(x, blocks, 128, 500, r),
                               band_apply_plain(x, blocks, 128, 500) + r, rtol=1e-6, atol=1e-5)
    xb, bb, rb = x.bfloat16(), blocks.bfloat16(), r.bfloat16()
    want = (band_apply_plain(xb.float(), bb.float(), 128, 500) + rb.float()).bfloat16()
    torch.testing.assert_close(band_apply_plain(xb, bb, 128, 500, rb), want, rtol=0, atol=0)

    op = banded_from_scipy(_icosphere_laplacian(small_mesh), dtype=torch.float64, padded=True)
    xd = torch.from_numpy(rng.standard_normal((1, op.p_rows, 2))).requires_grad_()
    wd = torch.from_numpy(rng.standard_normal((2, 2, 2))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, w: cheb2_banded_v3(a, op, w), (xd, wd))
    assert torch.autograd.gradcheck(lambda w: cheb2_banded_v3(xd.detach(), op, w), (wd,))
