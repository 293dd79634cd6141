"""Parity of the PyTorch port's model with the JAX package on the CPU: the
parameter bridge, the initializers' distributions, and the condition nets,
encoder, decoder and reparameterization on the icosphere at nf=8, batch 4,
with the kernel route taken in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cape_tpu.core.config import CAPEConfig as JaxConfig
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu_torch.core.bridge import from_jax_params, to_jax_params
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.models.cape import CAPE

torch.set_num_threads(1)

# the flagship family (affine decoder, folded conditions, padded banded
# layout) cut to nf=8; cond_encoder exercises the folded first encoder conv
SMALL = dict(
    nz=8, nz_cond=8, nz_cond2=4, nf=8, use_res_block=False,
    use_res_block_dec=True, affine=True, reduce_dim=8,
)


@pytest.fixture(scope="module")
def pyramids(small_mesh):
    from cape_tpu.meshops.pyramid import build_pyramid

    verts, faces = small_mesh
    cfg = CAPEConfig(**SMALL)
    return build_pyramid(verts, faces, cfg.ds_factors), build_pyramid(verts, faces, [2, 2, 2, 2])


def _jax_ctx(small_mesh, pyramids, padded=True):
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr, pyr_d = pyramids
    return build_graph_context(
        pyr, pyr_d, vertices_per_edge(faces, len(verts)), verts, padded=padded
    )


def _ctx(small_mesh, pyramids, **kw):
    """The port's context of the icosphere pyramids (padded layout)."""
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    return build_graph_context(
        *pyramids, vertices_per_edge(faces, len(verts)), verts, padded=True, **kw
    )


def _jax_params(model, ctx, seed):
    """A JAX param tree of the model's structure (jax.eval_shape of its
    init), filled with numpy draws: cheaper than running the init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0), ctx)
    return jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype), shapes
    )


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_bridge_round_trip_is_bit_equal(small_mesh, pyramids):
    """JAX params -> port state dict -> module -> JAX layout, bit for bit,
    over every leaf (the discriminator's included)."""
    jctx = _jax_ctx(small_mesh, pyramids)
    jparams = _jax_params(JaxCAPE(JaxConfig(**SMALL)), jctx, 3)
    ctx = _ctx(small_mesh, pyramids)
    model = CAPE(CAPEConfig(**SMALL)).init_params(torch.Generator().manual_seed(0), ctx)
    missing, unexpected = model.load_state_dict(from_jax_params(jparams), strict=True)
    assert not missing and not unexpected
    back = _flat(to_jax_params(model))
    want = _flat(jparams)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype and back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_initializer_distributions():
    """Truncated normal 0.1 in +-2 sigma and glorot-uniform: range, mean and
    standard deviation (the bits differ from jax.random by design)."""
    from cape_tpu_torch.core.params import conv_weight, dense_init

    g = torch.Generator().manual_seed(0)
    w = conv_weight(g, 2, 300, 200)
    assert w.shape == (2, 300, 200) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 0.2
    # N(0, 1) truncated at +-2 has std 0.87962
    assert abs(float(w.mean())) < 1e-3
    assert abs(float(w.std()) - 0.1 * 0.87962) < 1e-3
    d = dense_init(g, 400, 600)
    limit = (6.0 / 1000) ** 0.5
    assert float(d["kernel"].abs().max()) <= limit
    assert abs(float(d["kernel"].std()) - limit / 3**0.5) < 1e-3
    assert float(d["bias"].abs().max()) == 0.0
    # and the same draws for the same seed
    torch.testing.assert_close(conv_weight(torch.Generator().manual_seed(5), 2, 3, 4),
                               conv_weight(torch.Generator().manual_seed(5), 2, 3, 4),
                               rtol=0, atol=0)


@pytest.mark.parametrize("cond_encoder", [False, True])
def test_model_matches_jax_on_kernel_route(small_mesh, pyramids, monkeypatch, cond_encoder):
    """embed_conditions, encode, sample_z (explicit eps) and decode of the
    port against JAX, f32, with the large-batch route lowered to batch 4 in
    both packages (JAX runs Pallas v3 in interpret mode; the port its
    band-apply plain version). Tolerance 1e-4 * max|ref|."""
    import cape_tpu.ops.cheb as jax_cheb
    from cape_tpu_torch.ops import cheb
    from cape_tpu_torch.ops.kernels import cheb_kernel

    B = 4
    for mod in (jax_cheb, cheb):
        monkeypatch.setattr(mod, "VM_MIN_BATCH", B)
        monkeypatch.setattr(mod, "VM_MIN_COLS", B * 3)
    kw = dict(SMALL, cond_encoder=cond_encoder)
    jctx = _jax_ctx(small_mesh, pyramids)
    jmodel = JaxCAPE(JaxConfig(**kw))
    jparams = _jax_params(jmodel, jctx, 1)
    ctx = _ctx(small_mesh, pyramids)
    model = CAPE(CAPEConfig(**kw)).init_params(torch.Generator().manual_seed(0), ctx)
    model.load_state_dict(from_jax_params(jparams))

    rng = np.random.default_rng(7)
    nv = ctx.level_sizes[0]
    x = rng.standard_normal((B, nv, 3)).astype(np.float32)
    pose = rng.standard_normal((B, 126)).astype(np.float32)
    clo = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    eps = rng.standard_normal((B, kw["nz"])).astype(np.float32)

    @jax.jit
    def forward(params, ctx, x, pose, clo, eps):
        y, y2 = jmodel.embed_conditions(params, pose, clo)
        zm, zl = jmodel.encode(params, ctx, x, y, y2)
        z = zm + jnp.exp(0.5 * jnp.clip(zl, -30.0, 30.0)) * eps
        return y, y2, zm, zl, z, jmodel.decode(params, ctx, jnp.concatenate([z, y, y2], -1), y, y2)

    want = [np.asarray(a) for a in forward(jparams, jctx, x, pose, clo, eps)]

    routes, launches = cheb.kernel_routes, cheb_kernel.launches
    t = torch.from_numpy
    with torch.no_grad():
        ty, ty2 = model.embed_conditions(t(pose), t(clo))
        tzm, tzl = model.encode(ctx, t(x), ty, ty2)
        tz = model.sample_z(tzm, tzl, t(eps))
        tout = model.decode(ctx, torch.cat([tz, ty, ty2], -1), ty, ty2)
    assert cheb.kernel_routes - routes == 17  # 8 encoder + 8 decoder + out conv
    assert cheb_kernel.launches == launches
    for name, g, w in zip(("y", "y2", "z_mean", "z_logvar", "z", "out"),
                          (ty, ty2, tzm, tzl, tz, tout), want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name
        )


@pytest.mark.parametrize("kernel_route", [False, True])
def test_bf16_forward_tracks_f32(small_mesh, pyramids, monkeypatch, kernel_route):
    """compute_dtype=bfloat16 (bf16 activations and band blocks) on either
    route stays within 5% of max|f32| of the f32 forward: the rounding of
    bf16 (8 mantissa bits) over ~20 layers, not a wrong path."""
    from cape_tpu_torch.models.cape import DTYPES
    from cape_tpu_torch.ops import cheb

    if kernel_route:
        monkeypatch.setattr(cheb, "VM_MIN_BATCH", 2)
        monkeypatch.setattr(cheb, "VM_MIN_COLS", 1)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = CAPEConfig(**SMALL, compute_dtype=dtype)
        ctx = _ctx(small_mesh, pyramids, dtype=DTYPES[dtype])
        model = CAPE(cfg).init_params(torch.Generator().manual_seed(4), ctx)
        rng = np.random.default_rng(5)
        x = torch.from_numpy((0.05 * rng.standard_normal((2, ctx.level_sizes[0], 3))).astype(np.float32))
        pose = torch.from_numpy(rng.standard_normal((2, 126)).astype(np.float32))
        clo = torch.eye(4)[:2]
        with torch.no_grad():
            y, y2 = model.embed_conditions(pose, clo)
            zm, _ = model.encode(ctx, x, y, y2)
            out = model.decode(ctx, torch.cat([zm, y, y2], -1), y, y2)
        assert out.dtype == DTYPES[dtype]
        outs[dtype] = (zm.float().numpy(), out.float().numpy())
    for a, b in zip(outs["bfloat16"], outs["float32"]):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-2 * np.abs(b).max())


@pytest.mark.parametrize(
    "change",
    [
        {"op_mode": "ell"}, {"use_res_block": True}, {"affine": False},
        {"use_res_block_dec": False}, {"fuse_decoder": True},
        {"fold_conditions": False}, {"remat": True},
    ],
)
def test_unported_configs_raise(change):
    with pytest.raises(NotImplementedError, match="not ported"):
        CAPE(CAPEConfig(**dict(SMALL, **change)))


def test_discriminate_raises(small_mesh, pyramids):
    """discriminate refuses a mesh whose vertex count is not the context's
    (the padded operators check their row counts) instead of computing on
    misaligned rows."""
    ctx = _ctx(small_mesh, pyramids)
    model = CAPE(CAPEConfig(**SMALL)).init_params(torch.Generator().manual_seed(0), ctx)
    y, y2 = torch.zeros(2, SMALL["nz_cond"]), torch.zeros(2, SMALL["nz_cond2"])
    assert model.discriminate(ctx, torch.zeros(2, ctx.level_sizes[0], 3), y, y2).shape == (
        2, ctx.level_sizes_d[-1], 1)
    with pytest.raises(ValueError, match="padded BandedOp expects"):
        model.discriminate(ctx, torch.zeros(2, ctx.level_sizes[0] + 200, 3), y, y2)
