"""Parity of the port's model families with the JAX package on the CPU: the
normalization layers, the ELL and dense operators, every block form, and
encode / decode / discriminate / generate of the plain, affine and
residual-CMR families (natural and padded layouts, folded and materialized
conditions, the fused decoder, the ELL and dense modes), the kernel route,
remat, the CMR train step, the kernel routing at full width, bf16, and the
architecture table of every preset.

Each test feeds the same numpy parameters and inputs to `cape_tpu` and
`cape_tpu_torch`, on the icosphere `small_mesh`. The JAX Pallas kernels run
in interpret mode; the port's kernel wrappers run their plain versions on
CPU tensors."""

import glob
import os

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
CMR_PRESET = os.path.join(ROOT, "configs", "CAPE_nz18_pose24_clotype8_male.yaml")
DEFAULT_PRESET = os.path.join(ROOT, "configs", "default_config.yaml")
FLAGSHIP = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")

# JAX's `_SMALL_CONFIGS` of tests/test_model.py: the three block families
# at test scale (the CMR family at nf=32 so that every group-normed channel
# count divides into min(32, C) groups)
FAMILIES = {
    "plain": dict(
        nz=8, nz_cond=8, nz_cond2=4, nf=8, use_res_block=False,
        use_res_block_dec=False, affine=False, reduce_dim=8,
    ),
    "affine_folded": dict(
        nz=8, nz_cond=8, nz_cond2=4, nf=8, use_res_block=False,
        use_res_block_dec=True, affine=True, reduce_dim=8,
    ),
    "res_cmr": dict(
        nz=8, nz_cond=24, nz_cond2=8, nf=32, use_res_block=True,
        use_res_block_dec=True, affine=False, reduce_dim=32, cond_encoder=True,
    ),
}
B = 4
# f32 parity of one op or block, and of a whole model
RTOL_OP, RTOL_MODEL = 1e-5, 1e-4


class EpsCAPE(JaxCAPE):
    """The JAX model with the reparameterization noise given by the caller
    (the `rng` argument carries eps)."""

    def sample_z(self, rng, z_mean, z_logvar):
        return z_mean + jnp.exp(0.5 * jnp.clip(z_logvar, -30.0, 30.0)) * rng


@pytest.fixture(scope="module")
def contexts(small_mesh):
    """contexts(mode, padded) -> (JAX context, port context) of the
    icosphere's 8-layer and ds2 pyramids, the composed L~@U operators
    included; built once each."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, CAPEConfig().ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    cache = {}

    def get(mode="banded", padded=False, dtype=torch.float32):
        key = (mode, padded, dtype)
        if key not in cache:
            kw = dict(mode=mode, padded=padded, build_fused=True)
            cache[key] = (jax_context(pyr, pyr_d, edges, verts, **kw),
                          build_graph_context(pyr, pyr_d, edges, verts, dtype=dtype, **kw))
        return cache[key]

    return get


def _close(got, want, name, rtol=RTOL_OP):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(want).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _random_like(shapes, rng):
    """A tree of numpy draws shaped like `shapes`: weights 0.3 N(0, 1),
    group-norm gammas 1 + 0.1 N(0, 1)."""
    def draw(path, s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        return 1.0 + 0.1 * z if jax.tree_util.keystr(path).endswith("['gamma']") else 0.3 * z
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ------------------------------------------------------------- normalization
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kind", ["group", "batch"])
def test_norm_matches_jax(padded, kind):
    """group_norm and batch_norm (through normalize) against cape_tpu.ops.norm,
    f32, 1e-5 relative, natural and padded. Padded, the tail rows hold inf
    and NaN in the forward check, which must not reach the valid rows'
    statistics, and finite garbage in the gradient check (the padded
    layout's contract: a non-finite tail would poison the backward pass in
    both packages). Gradients of a random projection of the valid rows with
    respect to x, gamma and beta."""
    from cape_tpu.ops.norm import normalize as jax_normalize
    from cape_tpu_torch.ops.norm import normalize

    rng = np.random.default_rng(3)
    V, n_valid, C = 140, 118, 96
    x = (2.0 + rng.standard_normal((3, V, C))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w = rng.standard_normal((3, V, C)).astype(np.float32)
    nv = n_valid if padded else None
    valid = slice(0, n_valid if padded else V)
    if padded:
        w[:, n_valid:] = 0.0
        x_bad = x.copy()
        x_bad[:, n_valid:] = np.inf
        x_bad[0, n_valid + 1] = np.nan
        want = jax_normalize(*map(jnp.asarray, (x_bad, gamma, beta)), kind=kind, n_valid=nv)
        got = normalize(*map(torch.from_numpy, (x_bad, gamma, beta)), kind=kind, n_valid=nv)
        _close(got[:, valid], np.asarray(want)[:, valid], "y, non-finite tail")
        x[:, n_valid:] = 1e3

    def jfn(x, g, b):
        y = jax_normalize(x, g, b, kind=kind, n_valid=nv)
        return jnp.sum(y * w), y

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    t = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    y = normalize(*t, kind=kind, n_valid=nv)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), t)
    _close(y[:, valid], np.asarray(want)[:, valid], "y")
    for name, g, jg in zip(("dx", "dgamma", "dbeta"), grads, jgrads):
        jg = np.asarray(jg)
        _close(g[:, valid] if name == "dx" else g, jg[:, valid] if name == "dx" else jg, name)


def test_group_norm_groups_contiguous_channels_and_checks_divisibility():
    """Group g holds channels g*C/G .. (g+1)*C/G - 1 (a strided grouping
    still looks normalized, so this checks the statistics group by group),
    and a channel count that min(32, C) does not divide raises with the
    numbers, as in JAX."""
    from cape_tpu_torch.ops.norm import group_norm

    x = torch.randn(2, 50, 64, generator=torch.Generator().manual_seed(0))
    x[..., :2] += 10.0  # the first group (channels 0 and 1) only
    y = group_norm(x, torch.ones(64), torch.zeros(64))
    for g in range(32):
        part = y[:, :, 2 * g : 2 * g + 2]
        torch.testing.assert_close(part.mean(dim=(1, 2)), torch.zeros(2), atol=1e-5, rtol=0)
        torch.testing.assert_close(part.var(dim=(1, 2), unbiased=False), torch.ones(2),
                                   atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="48 channels do not divide into 32 groups"):
        group_norm(torch.zeros(1, 4, 48), torch.ones(48), torch.zeros(48))


# ------------------------------------------------------------------ operators
@pytest.mark.parametrize("mode", ["ell", "dense"])
def test_ell_and_dense_ops_match_jax(contexts, mode):
    """Every operator of the ELL / dense context (Laplacians, selections,
    upsamples, the edge operator, the composed L~@U) against JAX's, on
    [B, V, C] and on a [V, 1] seed; the gradient with respect to x against
    a dense autograd reference (M^T g), 1e-5 relative; the selection fast
    path and the context's natural order."""
    from cape_tpu_torch.ops.sparse import DenseOp, EllMatvec, EllOp, IdentityOp

    jctx, ctx = contexts(mode)
    assert ctx.perm0 is None and jctx.perm0 is None and not ctx.padded
    rng = np.random.default_rng(5)
    n = 0
    for field in ("lap", "down", "up", "lap_d", "down_d", "lap_up"):
        for op, jop in zip(getattr(ctx, field), getattr(jctx, field), strict=True):
            if isinstance(op, IdentityOp):
                assert mode == "ell" and type(jop).__name__ == "IdentityOp"
                continue
            assert isinstance(op, EllOp if mode == "ell" else DenseOp)
            rows, cols = op.shape
            assert (rows, cols) == tuple(jop.shape)
            x = rng.standard_normal((B, cols, 5)).astype(np.float32)
            for xi in (x, x[0, :, :1]):
                _close(op(torch.from_numpy(xi)), jop(jnp.asarray(xi)), f"{field} {xi.shape}")
            dense = torch.from_numpy(np.asarray(jax.device_get(
                jop(jnp.eye(cols, dtype=jnp.float32)))))   # M, [rows, cols]
            xt = torch.from_numpy(x).requires_grad_()
            g = torch.from_numpy(rng.standard_normal((B, rows, 5)).astype(np.float32))
            (dx,) = torch.autograd.grad((op(xt) * g).sum(), xt)
            _close(dx, (dense.T @ g).numpy(), f"{field} dx")
            n += 1
    assert n >= 12
    # the edge operator, in the natural order (no band sort outside banded)
    x = rng.standard_normal((B, ctx.level_sizes[0], 3)).astype(np.float32)
    _close(ctx.edge_op(torch.from_numpy(x)), jctx.edge_op(jnp.asarray(x)), "edge_op")
    if mode == "ell":
        sel = [op for op in ctx.down if isinstance(op, EllOp) and op.select]
        assert sel and all(op.val is None for op in sel)
        # the backward is the transpose gather, not autograd's scatter-add
        xt = torch.from_numpy(x).requires_grad_()
        assert type(sel[0](xt).grad_fn).__name__ == EllMatvec.__name__ + "Backward"


def test_graph_context_modes_and_fused_operators(contexts):
    """The padded layout is refused outside banded mode; lap_up is empty
    unless asked for, reuses the Laplacian where the upsample is the
    identity, and moves with the context."""
    from cape_tpu_torch.ops.sparse import IdentityOp, build_graph_context

    _, ctx = contexts("banded")
    for i, (up, lu) in enumerate(zip(ctx.up, ctx.lap_up, strict=True)):
        assert (lu is ctx.lap[i]) == isinstance(up, IdentityOp)
    moved = ctx.to("meta")
    assert all(a.blocks.device.type == "meta" for a in moved.lap_up)
    with pytest.raises(ValueError, match="padded layout requires mode='banded'"):
        build_graph_context(None, None, None, None, mode="ell", padded=True)


# --------------------------------------------------------------------- blocks
def _block_case(name, jctx, ctx, rng):
    """(JAX fn, port fn, JAX init, inputs) of one block form on the
    icosphere; each fn maps (params, x, y, y2) to the block's output."""
    import cape_tpu.models.blocks as jb
    import cape_tpu.ops.cheb as jc

    import cape_tpu_torch.models.blocks as tb
    import cape_tpu_torch.ops.cheb as tc

    act = lambda m: jax.nn.leaky_relu if m is jb else torch.nn.functional.leaky_relu
    K = 2
    lvl = 5                    # a level whose upsample is not the identity
    assert type(ctx.up[lvl]).__name__ != "IdentityOp"
    nv_fine, nv_coarse = ctx.level_sizes[lvl], ctx.level_sizes[lvl + 1]
    ops = lambda c: (c.lap[lvl], c.down[lvl], c.up[lvl], c.lap_up[lvl])
    fin, fout = 6, 8
    cases = {
        # name: (jax fn, port fn, init (jax), x rows, x channels)
        "deconv": (lambda m, c: lambda p, x, y, y2: m.deconv_block_apply(p, x, ops(c)[0], ops(c)[2], act(m)),
                   lambda k: jb.conv_block_init(k, K, fin, fout), nv_coarse, fin),
        "res_proj": (lambda m, c: lambda p, x, y, y2: m.res_block_apply(p, x, ops(c)[0], ops(c)[1], act(m)),
                     lambda k: jb.res_block_init(k, K, fin, fout), nv_fine, fin),
        "res_identity": (lambda m, c: lambda p, x, y, y2: m.res_block_apply(p, x, ops(c)[0], ops(c)[1], act(m)),
                         lambda k: jb.res_block_init(k, K, fout, fout), nv_fine, fout),
        "res_folded_proj": (lambda m, c: lambda p, x, y, y2: m.res_block_folded_apply(
            p, x, [y, y2], ops(c)[0], ops(c)[1], act(m)),
            lambda k: jb.res_block_init(k, K, fin + 5, fout), nv_fine, fin),
        "res_folded_identity": (lambda m, c: lambda p, x, y, y2: m.res_block_folded_apply(
            p, x, [y, y2], ops(c)[0], ops(c)[1], act(m)),
            lambda k: jb.res_block_init(k, K, 3 + 5, 3 + 5), nv_fine, 3),
        "cmr": (lambda m, c: lambda p, x, y, y2: m.cmr_block_apply(p, x, ops(c)[0], ops(c)[2]),
                lambda k: jb.cmr_block_init(k, K, 64, 128), nv_coarse, 64),
        "cmr_identity": (lambda m, c: lambda p, x, y, y2: m.cmr_block_apply(p, x, ops(c)[0], ops(c)[2]),
                         lambda k: jb.cmr_block_init(k, K, 64, 64), nv_coarse, 64),
        "affine": (lambda m, c: lambda p, x, y, y2: m.affine_block_apply(p, x, ops(c)[0], ops(c)[2]),
                   lambda k: jb.affine_block_init(k, K, fin, fout), nv_coarse, fin),
        "deconv_folded": (lambda m, c: lambda p, x, y, y2: m.deconv_block_folded_apply(
            p, x, [y, y2], ops(c)[0], ops(c)[2], act(m)),
            lambda k: jb.conv_block_init(k, K, fin + 5, fout), nv_coarse, fin),
        "deconv_fused": (lambda m, c: lambda p, x, y, y2: m.deconv_block_fused_apply(
            p, x, [y, y2], ops(c)[2], ops(c)[3], act(m)),
            lambda k: jb.conv_block_init(k, K, fin + 5, fout), nv_coarse, fin),
        "affine_fused": (lambda m, c: lambda p, x, y, y2: m.affine_block_fused_apply(
            p, x, [y, y2], ops(c)[2], ops(c)[3]),
            lambda k: jb.affine_block_init(k, K, fin + 5, fout), nv_coarse, fin),
        "cheb_conv_up_folded": (lambda m, c: lambda p, x, y, y2: (
            jc if m is jb else tc).cheb_conv_up_folded(x, [y, y2], ops(c)[2], ops(c)[3], p["w"]),
            lambda k: {"w": jb.conv1x1_init(k, fin + 5, fout)["w"].repeat(2, 0)}, nv_coarse, fin),
        "concat_conditions": (lambda m, c: lambda p, x, y, y2: m.concat_conditions(x, y, y2) * p["s"],
                              lambda k: {"s": jnp.ones((fin + 5,))}, nv_coarse, fin),
    }
    fn, init, rows, ch = cases[name]
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    params = _random_like(shapes, rng)
    x = rng.standard_normal((B, rows, ch)).astype(np.float32)
    y = rng.standard_normal((B, 4)).astype(np.float32)
    y2 = rng.standard_normal((B, 1)).astype(np.float32)
    return fn(jb, jctx), fn(tb, ctx), params, (x, y, y2)


BLOCKS = ["deconv", "res_proj", "res_identity", "res_folded_proj", "res_folded_identity",
          "cmr", "cmr_identity", "affine", "deconv_folded", "deconv_fused", "affine_fused",
          "cheb_conv_up_folded", "concat_conditions"]


@pytest.mark.parametrize("name", BLOCKS)
def test_block_forms_match_jax(contexts, name):
    """Each block form of the port against cape_tpu.models.blocks on the
    icosphere's banded operators (natural layout): the output and the
    gradients of a random projection of it with respect to x, the
    conditions and every parameter, f32, 1e-5 relative. The port's init
    gives JAX's key paths and shapes."""
    import cape_tpu_torch.models.blocks as tb

    jctx, ctx = contexts("banded")
    rng = np.random.default_rng(BLOCKS.index(name))
    jfn, tfn, params, inputs = _block_case(name, jctx, ctx, rng)
    jargs = (jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, inputs))
    want, vjp = jax.vjp(jfn, *jargs)
    g = rng.standard_normal(want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g))

    tparams = {k: torch.from_numpy(np.asarray(v)).requires_grad_() for k, v in _flat(params).items()}
    nested = {}
    for k, v in tparams.items():
        node = nested
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = tfn(nested, *tin)
    _close(got, want, "y")
    grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), [*tparams.values(), *tin],
                                allow_unused=True)
    jflat = _flat(jgrads[0])
    for k, gr in zip(tparams, grads):
        _close(gr if gr is not None else torch.zeros_like(tparams[k]), jflat[k], f"d/{k}")
    for i, (gr, t) in enumerate(zip(grads[len(tparams):], tin)):
        _close(torch.zeros_like(t) if gr is None else gr, jgrads[1 + i], f"d/input{i}")

    # the port's init: JAX's key paths and shapes
    inits = {"deconv": ("conv_block_init", 6, 8), "res_proj": ("res_block_init", 6, 8),
             "res_identity": ("res_block_init", 8, 8), "cmr": ("cmr_block_init", 64, 128),
             "cmr_identity": ("cmr_block_init", 64, 64), "affine": ("affine_block_init", 6, 8)}
    if name in inits:
        fname, fin, fout = inits[name]
        mine = _flat(getattr(tb, fname)(torch.Generator().manual_seed(0), 2, fin, fout))
        assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in _flat(params).items()}


def test_cmr_block_padded_statistics_use_valid_rows(contexts):
    """cmr_block_apply in the padded layout with n_valid = the unpooled
    level's natural row count equals the natural-layout block on the valid
    rows, with garbage (finite, as the padded contract allows) in the input's
    tail rows; so does JAX's."""
    import cape_tpu.models.blocks as jb

    import cape_tpu_torch.models.blocks as tb

    _, ctx = contexts("banded")
    jctx_p, ctx_p = contexts("banded", padded=True)
    lvl = 5
    rng = np.random.default_rng(11)
    params = _random_like(jax.eval_shape(lambda k: jb.cmr_block_init(k, 2, 64, 128),
                                         jax.random.PRNGKey(0)), rng)
    tparams = {k: {n: torch.from_numpy(np.asarray(v)) for n, v in d.items()}
               for k, d in params.items()}
    n_in, n_out = ctx.level_sizes[lvl + 1], ctx.level_sizes[lvl]
    x = rng.standard_normal((B, n_in, 64)).astype(np.float32)
    xp = np.full((B, ctx_p.up[lvl].p_cols, 64), 1e3, np.float32)
    xp[:, :n_in] = x
    want = tb.cmr_block_apply(tparams, torch.from_numpy(x), ctx.lap[lvl], ctx.up[lvl])
    got = tb.cmr_block_apply(tparams, torch.from_numpy(xp), ctx_p.lap[lvl], ctx_p.up[lvl],
                             n_valid=ctx_p.lap[lvl].n_rows)
    assert ctx_p.lap[lvl].n_rows == n_out and got.shape[1] > n_out
    _close(got[:, :n_out], want.numpy(), "padded port")
    jgot = jb.cmr_block_apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xp),
                              jctx_p.lap[lvl], jctx_p.up[lvl], n_valid=n_out)
    _close(got[:, :n_out], np.asarray(jgot)[:, :n_out], "padded JAX")


# ---------------------------------------------------------------------- model
def _models(kw, jctx, ctx, seed=1):
    """JAX and port models of config kw with the same numpy parameters."""
    jmodel = EpsCAPE(JaxConfig(**kw))
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0), jctx)
    params = _random_like(shapes, np.random.default_rng(seed))
    params = jax.tree_util.tree_map(lambda a: (a / 3).astype(np.float32), params)
    model = CAPE(CAPEConfig(**kw)).init_params(torch.Generator().manual_seed(0), ctx)
    missing, unexpected = model.load_state_dict(from_jax_params(params), strict=True)
    assert not missing and not unexpected
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model


def _inputs(cfg, nv, seed=7):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, nv, 3))).astype(np.float32)
    pose = rng.standard_normal((B, cfg.cond_dim)).astype(np.float32)
    clo = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    eps = rng.standard_normal((B, cfg.nz)).astype(np.float32)
    z = rng.standard_normal((B, cfg.z_total_dim)).astype(np.float32)
    return x, pose, clo, eps, z


def _model_parity(jmodel, jparams, jctx, model, ctx, cfg):
    """encode, decode, discriminate and generate of both packages, held to
    1e-4 * max|ref|. JAX's generate is its encode, sample_z (with eps) and
    decode; it runs once, and the port's decode is held to its decode."""
    x, pose, clo, eps, _ = _inputs(cfg, ctx.level_sizes[0])

    @jax.jit
    def forward(params, ctx, x, pose, clo, eps):
        y, y2 = jmodel.embed_conditions(params, pose, clo)
        return (*jmodel.generate(params, ctx, x, y, y2, eps),
                jmodel.discriminate(params, ctx, x, y, y2))

    x_hat, zm, zl, z, d = forward(jparams, jctx, *map(jnp.asarray, (x, pose, clo, eps)))
    t = torch.from_numpy
    with torch.no_grad():
        y, y2 = model.embed_conditions(t(pose), t(clo))
        got = (*model.generate(ctx, t(x), y, y2, t(eps)), *model.encode(ctx, t(x), y, y2),
               model.decode(ctx, torch.cat([t(np.asarray(z)), y, y2], -1), y, y2),
               model.discriminate(ctx, t(x), y, y2))
    want = (x_hat, zm, zl, z, zm, zl, x_hat, d)
    names = ("x_hat", "z_mean", "z_logvar", "z", "encode z_mean", "encode z_logvar", "decode",
             "discriminate")
    for name, g, w in zip(names, got, want, strict=True):
        _close(g, w, name, RTOL_MODEL)


MODEL_CASES = [
    (family, mode, padded, fold, fuse)
    for family in FAMILIES
    for mode, padded in (("banded", False), ("banded", True))
    for fold, fuse in ((True, False), (False, False), (True, True))
] + [(family, mode, False, True, False) for family in FAMILIES for mode in ("ell", "dense")]


@pytest.mark.parametrize(
    "family,mode,padded,fold,fuse", MODEL_CASES,
    ids=[f"{f}-{m}{'-padded' if p else ''}-{'fold' if fo else 'concat'}{'-fuse' if fu else ''}"
         for f, m, p, fo, fu in MODEL_CASES])
def test_model_matches_jax(contexts, family, mode, padded, fold, fuse):
    """encode, decode, discriminate and generate (explicit eps) of the port
    against JAX for each small family, f32, batch 4, 1e-4 * max|ref|: both
    layouts, folded and materialized conditions, the fused decoder, and the
    ELL and dense modes. (The CMR decoder keeps its concat whatever
    fold_conditions says, and so takes no fused path.)"""
    kw = dict(FAMILIES[family], op_mode=mode, fold_conditions=fold, fuse_decoder=fuse)
    jctx, ctx = contexts(mode, padded)
    jmodel, jparams, model = _models(kw, jctx, ctx)
    _model_parity(jmodel, jparams, jctx, model, ctx, CAPEConfig(**kw))


def test_fused_decoder_needs_the_composed_operators(small_mesh):
    """fuse_decoder on a context built without build_fused raises, as in JAX."""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, faces = small_mesh
    kw = dict(FAMILIES["affine_folded"], fuse_decoder=True)
    cfg = CAPEConfig(**kw)
    ctx = build_graph_context(build_pyramid(verts, faces, cfg.ds_factors),
                              build_pyramid(verts, faces, [2, 2, 2, 2]),
                              vertices_per_edge(faces, len(verts)), verts)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    with pytest.raises(ValueError, match="build_fused=True"):
        model.decode(ctx, torch.zeros(2, cfg.z_total_dim), torch.zeros(2, 8), torch.zeros(2, 4))


@pytest.mark.parametrize("fold", [True, False])
def test_res_cmr_matches_jax_on_kernel_route(contexts, monkeypatch, fold):
    """The residual-CMR family, padded, with the large-batch route lowered to
    batch 4 in both packages (JAX runs Pallas v3 in interpret mode, the port
    its band-apply plain version): the same model outputs, 1e-4 * max|ref|,
    and as many convs on the route as the gate implies."""
    import cape_tpu.ops.cheb as jax_cheb
    from cape_tpu_torch.ops import cheb, kernels

    for mod in (jax_cheb, cheb):
        monkeypatch.setattr(mod, "VM_MIN_BATCH", B)
        monkeypatch.setattr(mod, "VM_MIN_COLS", B * 3)
    kw = dict(FAMILIES["res_cmr"], fold_conditions=fold)
    jctx, ctx = contexts("banded", True)
    jmodel, jparams, model = _models(kw, jctx, ctx)
    routes, launches = kernels.counts["route.v3"], kernels.counts["band_apply.conv"]
    _model_parity(jmodel, jparams, jctx, model, ctx, CAPEConfig(**kw))
    # generate, then encode and decode: 16 convs per encode (8 res blocks of two
    # K=2 convs), 9 per decode (8 CMR convs and the output conv);
    # discriminate: the pred conv (its layers have Kd=3)
    assert kernels.counts["route.v3"] - routes == 2 * (16 + 9) + 1
    assert kernels.counts["band_apply.conv"] == launches


@pytest.mark.parametrize("family", ["res_cmr", "affine_folded"])
def test_remat_gradients_equal_gradients_without_it(contexts, monkeypatch, family):
    """remat=True (torch.utils.checkpoint around every block) gives the same
    loss and parameter gradients as remat=False, and recomputes: with the
    kernel route lowered to batch 4, the backward pass sends the
    checkpointed blocks' convs to the route again."""
    from cape_tpu_torch.ops import cheb, kernels

    monkeypatch.setattr(cheb, "VM_MIN_BATCH", B)
    monkeypatch.setattr(cheb, "VM_MIN_COLS", B * 3)
    jctx, ctx = contexts("banded", True)
    cfg = CAPEConfig(**FAMILIES[family])
    x, pose, clo, eps, _ = _inputs(cfg, ctx.level_sizes[0])
    t = torch.from_numpy
    out = {}
    for remat in (False, True):
        kw = dict(FAMILIES[family], fold_conditions=False, remat=remat)
        _, _, model = _models(kw, jctx, ctx)
        y, y2 = model.embed_conditions(t(pose), t(clo))
        x_hat, zm, zl, _ = model.generate(ctx, t(x), y, y2, t(eps))
        d = model.discriminate(ctx, x_hat, y, y2)
        loss = x_hat.abs().mean() + zm.square().mean() + zl.mean() + d.mean()
        named = dict(model.named_parameters())
        routes = kernels.counts["route.v3"]
        grads = torch.autograd.grad(loss, list(named.values()))
        out[remat] = (loss.detach(), dict(zip(named, grads)), kernels.counts["route.v3"] - routes)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    assert out[False][2] == 0 and out[True][2] > 0
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=0,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12, msg=k)


# ---------------------------------------------------------------- train step
def test_cmr_train_step_matches_jax_over_three_steps(small_mesh, monkeypatch):
    """Three GAN train steps of the CMR family (the CMR release preset's
    blocks cut to 4 layers, nf=32) of the port (train_step) and of JAX's
    jitted build_train_step from the same parameters (the port's seed-0
    init through the bridge), batches and eps, on the kernel route lowered
    to batch 4 in both packages: the eight metrics of every step within
    1e-4 relative, every leaf's update within 1e-3 * max|update_jax|, as in
    tests/test_torch_train.py. The updates compared are the optimizers'
    (train_step's and optax's, the step of tests/make_torch_golden.py), not
    p_after - p_before: at step 1 the updates are near the float32 spacing
    of the parameters, so that difference is rounded to it."""
    import cape_tpu.ops.cheb as jax_cheb
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu.train.optim import TrainState as JaxTrainState
    from cape_tpu.train.optim import build_optimizer, create_train_state
    from cape_tpu.train.step import _gan_losses
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.ops import cheb
    from cape_tpu_torch.ops.sparse import build_graph_context
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    for mod in (jax_cheb, cheb):
        monkeypatch.setattr(mod, "VM_MIN_BATCH", B)
        monkeypatch.setattr(mod, "VM_MIN_COLS", B * 3)
    tiny = dict(name="torch_cmr_train_test", num_conv_layers=4, nf=32, nz=8, nz_cond=24,
                nz_cond2=8, use_res_block=False, use_res_block_dec=True, affine=False,
                reduce_dim=4, batch_size=B, num_epochs=1)
    cfg, jcfg = CAPEConfig(**tiny), JaxConfig(**tiny)
    verts, faces = small_mesh
    pyr = build_pyramid(verts, faces, cfg.ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = vertices_per_edge(faces, len(verts))
    jctx = jax_context(pyr, pyr_d, edges, verts, padded=True)
    ctx = build_graph_context(pyr, pyr_d, edges, verts, padded=True)
    data = synthetic_bodydata(n_train=32, n_test=6, num_verts=len(verts), seed=0, n_val=8)

    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    assert "generator.decoder.layer0.gn0.gamma" in model.state_dict()
    spe = len(data.disp_train) // B
    tx, _, _ = build_optimizer(jcfg, steps_per_epoch=spe)
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, to_jax_params(model)), tx)
    jmodel = EpsCAPE(jcfg)

    @jax.jit
    def jstep(state, ctx, batch, eps):
        # cape_tpu.train.step.build_train_step, returning the updates too
        (_, metrics), grads = jax.value_and_grad(
            lambda p: _gan_losses(jmodel, jcfg, p, ctx, batch, eps), has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates)
        return JaxTrainState(step=state.step + 1, params=params, opt_state=opt_state), metrics, updates

    state = TrainState(model, Optimizer(cfg, spe))
    sg, sd = BatchStream(len(data.disp_train), B, 0), BatchStream(len(data.disp_train), B, 1)
    rng = np.random.default_rng(9)
    disp = data.disp_train[:, ctx.perm0]
    for step in range(3):
        ig, idd = sg.next_indices(), sd.next_indices()
        batch = {"disp_g": disp[ig], "pose_g": data.pose_train[ig], "clo_g": data.clo_train[ig],
                 "disp_d": disp[idd], "pose_d": data.pose_train[idd],
                 "clo_d": data.clo_train[idd]}
        eps = rng.standard_normal((B, cfg.nz)).astype(np.float32)
        jstate, jm, jupdates = jstep(jstate, jctx, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jnp.asarray(eps))
        m, updates = train_step(state, ctx, {k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.from_numpy(eps))
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{step} {k}")
        jupdates = _flat(jax.device_get(jupdates))
        assert updates.keys() == jupdates.keys()
        for k, dj in jupdates.items():
            assert np.abs(dj).max() > 0, f"step {step}: {k} did not move"
            np.testing.assert_allclose(updates[k].numpy(), dj, rtol=0,
                                       atol=1e-3 * np.abs(dj).max(), err_msg=f"step {step} {k}")
    assert state.step == 3 and int(jstate.step) == 3


# ------------------------------------------------------- full width, routing
@pytest.fixture(scope="module")
def full_contexts():
    """The port's full-template contexts (the 8-layer pyramid every preset
    uses) on the meta device: banded with the composed operators, ELL and
    dense."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config

    cfg = load_config(CMR_PRESET)
    return {
        "banded": build_context(cfg.replace(fuse_decoder=True)).to("meta"),
        "ell": build_context(cfg.replace(op_mode="ell"), device="meta"),
        "dense": build_context(cfg.replace(op_mode="dense"), device="meta"),
    }


ROUTING_ROWS = {
    # v3 convs per encode, decode and discriminator call at batch 32, as
    # JAX's gate routes them (held to JAX's count below)
    "cmr_preset": (CMR_PRESET, {}, 7, 7, 1),
    "default_config": (DEFAULT_PRESET, {}, 15, 7, 1),
    "flagship_concat": (FLAGSHIP, {"fold_conditions": False}, 7, 9, 1),
    "flagship_fused": (FLAGSHIP, {"fuse_decoder": True}, 7, 0, 1),
    "cmr_preset_ell": (CMR_PRESET, {"op_mode": "ell"}, 0, 0, 0),
    "cmr_preset_dense": (CMR_PRESET, {"op_mode": "dense"}, 0, 0, 0),
}


@pytest.mark.parametrize("row", list(ROUTING_ROWS))
def test_full_width_kernel_routes(full_contexts, row):
    """At full width and batch 32, on meta tensors (nothing is computed,
    nothing launched), the port's gate sends as many convs per encode,
    decode and discriminator call to the kernel as JAX's gate sends to
    Pallas v3 (counted in JAX under jax.eval_shape with a spy)."""
    import cape_tpu.ops.pallas.cheb_kernel as ck
    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.ops import kernels

    path, change, n_enc, n_dec, n_disc = ROUTING_ROWS[row]
    cfg = load_config(path, batch_size=32, **change)
    ctx = full_contexts[cfg.op_mode]
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to("meta")
    m = lambda *s: torch.empty(s, device="meta")
    Bf = 32
    y, y2 = m(Bf, cfg.nz_cond), m(Bf, cfg.nz_cond2)
    counts, launches = [], kernels.counts["band_apply.conv"]
    for call in (lambda: model.encode(ctx, m(Bf, 6890, 3), y, y2),
                 lambda: model.decode(ctx, m(Bf, cfg.z_total_dim), y, y2),
                 lambda: model.discriminate(ctx, m(Bf, 6890, 3), y, y2)):
        start = kernels.counts["route.v3"]
        call()
        counts.append(kernels.counts["route.v3"] - start)
    assert counts == [n_enc, n_dec, n_disc]
    assert kernels.counts["band_apply.conv"] == launches

    # JAX's gate at the same configuration (banded rows; ELL and dense
    # contexts route nothing by construction: only a BandedOp is eligible)
    if cfg.op_mode != "banded":
        return
    jcfg = jax_load_config(path, batch_size=32, **change)
    jctx = jax_build_context(jcfg)
    jmodel = JaxCAPE(jcfg)
    params = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0), jctx)
    S = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    calls, real = [], ck.cheb2_banded_pallas_v3
    ck.cheb2_banded_pallas_v3 = lambda *a: (calls.append(1), real(*a))[1]
    try:
        jcounts = []
        for fn, args in ((jmodel.encode, (S(Bf, 6890, 3),)), (jmodel.decode, (S(Bf, jcfg.z_total_dim),)),
                         (jmodel.discriminate, (S(Bf, 6890, 3),))):
            n0 = len(calls)
            jax.eval_shape(fn, params, jctx, *args, S(Bf, jcfg.nz_cond), S(Bf, jcfg.nz_cond2))
            jcounts.append(len(calls) - n0)
    finally:
        ck.cheb2_banded_pallas_v3 = real
    assert jcounts == counts


# ----------------------------------------------------------------------- bf16
@pytest.mark.parametrize("kernel_route", [False, True])
def test_bf16_cmr_forward_tracks_f32(contexts, monkeypatch, kernel_route):
    """The residual-CMR family in compute_dtype=bfloat16 (bf16 activations and
    band blocks, group norms included) on either route stays within 5% of
    max|f32| of the f32 forward, as the flagship's bf16 test holds it."""
    from cape_tpu_torch.models.cape import DTYPES
    from cape_tpu_torch.ops import cheb

    if kernel_route:
        monkeypatch.setattr(cheb, "VM_MIN_BATCH", 2)
        monkeypatch.setattr(cheb, "VM_MIN_COLS", 1)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = CAPEConfig(**FAMILIES["res_cmr"], compute_dtype=dtype)
        _, ctx = contexts("banded", True, DTYPES[dtype])
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


# --------------------------------------------------- presets and the summary
@pytest.fixture(scope="module")
def full_ctx():
    """The port's full-template banded context on the CPU (every preset has
    8 layers, so one pyramid serves them all)."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config

    return build_context(load_config(CMR_PRESET))


@pytest.mark.parametrize("preset", [os.path.basename(p) for p in CONFIGS] + ["CAPEConfig()"])
def test_every_preset_builds_with_jax_parameters_and_summary(flagship_ctx, full_ctx, preset):
    """For every file in configs/ and for CAPEConfig(): the port builds the
    model (unsupported() is empty), its parameter tree has the JAX tree's
    key paths and shapes, and models.summary.describe prints the JAX
    package's table, line for line, parameter counts included."""
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.models.summary import describe as jax_describe
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import unsupported
    from cape_tpu_torch.models.summary import describe

    if preset == "CAPEConfig()":
        cfg, jcfg = CAPEConfig(), JaxConfig()
    else:
        path = os.path.join(ROOT, "configs", preset)
        cfg, jcfg = load_config(path), jax_load_config(path)
    assert unsupported(cfg) == []
    jmodel = JaxCAPE(jcfg)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0), flagship_ctx)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), full_ctx)
    want = {jax.tree_util.keystr(p)[2:-2].replace("']['", "."): tuple(s.shape)
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert describe(model, full_ctx, model.params) == jax_describe(jmodel, flagship_ctx, shapes)


def test_float16_is_the_only_refusal():
    """unsupported() names only a compute_dtype outside float32, bfloat16
    and float16 (float16, once refused, is ported); every other option of
    the JAX config builds."""
    from cape_tpu_torch.models.cape import unsupported

    kw = dict(FAMILIES["res_cmr"], op_mode="dense", fold_conditions=False, fuse_decoder=True,
              remat=True, use_res_block_dec=False)
    assert unsupported(CAPEConfig(**kw)) == []
    for dtype in ("float32", "bfloat16", "float16"):
        assert unsupported(CAPEConfig(**kw, compute_dtype=dtype)) == []
    assert unsupported(CAPEConfig(compute_dtype="float64")) == [
        "compute_dtype='float64' (float32, bfloat16 or float16)"]


def test_cmr_preset_server_cli_serves(tmp_path):
    """`python -m cape_tpu_torch.apps.server --config <the CMR release
    preset> --fresh-init` on the CPU, its widths cut to nf=32 (the full
    template pyramid, the CMR decoder's group norms): it prints its port,
    answers /health and a /sample of finite meshes, and exits 0 on
    SIGTERM."""
    import json
    import signal
    import subprocess
    import sys
    import threading
    import urllib.request

    cmd = [sys.executable, "-m", "cape_tpu_torch.apps.server", "--config", CMR_PRESET,
           "--name", "cmr_cli", "--fresh-init", "--device", "cpu", "--port", "0",
           "--batch_size", "2", "--nf", "32", "--reduce_dim", "32"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    watchdog = threading.Timer(180, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving cmr_cli on http://"), lines
        base = lines[-1].split(" on ")[1].strip()
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            info = json.loads(resp.read())
        assert info["num_verts"] == 6890 and info["nz"] == 18
        body = json.dumps({"pose": [[0.0] * 126], "clo": [[1.0, 0.0, 0.0, 0.0]], "n": 2,
                           "seed": 0}).encode()
        req = urllib.request.Request(base + "/sample", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            disp = np.asarray(json.loads(resp.read())["disp"])
        assert disp.shape == (2, 6890, 3) and np.isfinite(disp).all()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_ell_mode_lays_out_fc1_in_natural_vertex_order(contexts, small_mesh):
    """The banded mode permutes every level's vertices, the ELL mode keeps
    the natural order, and the decoder's fc1 output and per-vertex bias are
    laid out by them: the same parameters decode differently in the two
    modes, and alike once fc1's columns and the bias rows are permuted by
    the coarsest and finest levels' orderings. (So an ELL decode has a JAX
    golden of its own.)"""
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu_torch.meshops.ordering import pyramid_orderings

    verts, faces = small_mesh
    perms = pyramid_orderings(build_pyramid(verts, faces, CAPEConfig().ds_factors))
    jctx, ctx = contexts("banded")
    _, ectx = contexts("ell")
    kw = FAMILIES["affine_folded"]
    _, _, banded = _models(kw, jctx, ctx)
    _, _, ell = _models(dict(kw, op_mode="ell"), jctx, ectx)
    cfg = CAPEConfig(**kw)
    _, pose, clo, _, z = _inputs(cfg, ctx.level_sizes[0])
    t = torch.from_numpy
    with torch.no_grad():
        y, y2 = banded.embed_conditions(t(pose), t(clo))
        want = banded.decode(ctx, t(z), y, y2)[:, np.argsort(perms[0])]   # natural order
        assert (ell.decode(ectx, t(z), y, y2) - want).abs().max() > 1e-2 * want.abs().max()
        fc1 = ell.generator.decoder.fc1
        n_last, c = ctx.level_sizes[-1], fc1.kernel.shape[1] // ctx.level_sizes[-1]
        cols = (np.argsort(perms[-1])[:, None] * c + np.arange(c)).reshape(-1)
        fc1.kernel.copy_(fc1.kernel[:, cols])
        fc1.bias.copy_(fc1.bias[cols])
        out = ell.generator.decoder.out
        out.b.copy_(out.b[np.argsort(perms[0])])
        got = ell.decode(ectx, t(z), y, y2)
    assert n_last * c == fc1.kernel.shape[1]
    _close(got, want.numpy(), "ELL decode, fc1 and bias permuted", RTOL_MODEL)
