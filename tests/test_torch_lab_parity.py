"""The lab's `chain` and `parts` against the JAX package on the CPU, on the
same numpy inputs and parameters: the chain's batch-major arm against a
chain of `cape_tpu.ops.cheb.cheb_conv` + bias + leaky ReLU at level 0 of
the flagship context (its two channels-first arms against batch-major),
and the parts' losses and carrier gradients against JAX's
`encode/decode/discriminate` at the flagship's widths on the icosphere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _close(got: torch.Tensor, want, rel: float, name: str) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def test_chain_matches_jax():
    """Level 0 of the flagship context (padded), B = 2, C = 8, depth 2,
    K = 2, f32: the batch-major arm's output (natural rows, as JAX's lab
    compares) and its input gradient d sum(chain(x)) / dx within 1e-5 of
    max|ref| of JAX's chain; the cf and cfv arms within 1e-5 of bm."""
    from cape_tpu.meshops import assets
    from cape_tpu.ops.cheb import cheb_conv
    from cape_tpu.ops.sparse import build_graph_context
    from cape_tpu_torch.tools import perf_lab

    B, C, K, N = 2, 8, 2, 2
    verts, _ = assets.template_mesh()
    jlap = build_graph_context(assets.load_pyramid("for_demo"), assets.load_pyramid("ds2"),
                               assets.smpl_edges(), verts, padded=True).lap[0]
    lap = perf_lab._flagship_ctx("float32", True, "cpu").lap[0]
    assert (lap.p_cols, lap.n_rows) == (jlap.p_cols, jlap.n_rows)
    rng = np.random.default_rng(0)
    ws = (0.3 * rng.standard_normal((N, K, C, C))).astype(np.float32)
    bs = (0.1 * rng.standard_normal((N, C))).astype(np.float32)
    x = rng.standard_normal((B, lap.p_cols, C)).astype(np.float32)

    def jax_chain(x):
        for i in range(N):
            x = jax.nn.leaky_relu(cheb_conv(x, jlap, ws[i]) + bs[i], 0.2)
        return x

    want = np.asarray(jax.jit(jax_chain)(x))
    want_dx = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jax_chain(x))))(x))
    arms = perf_lab.chain_arms(lap, torch.from_numpy(ws), torch.from_numpy(bs))
    nat = lap.n_rows
    xt = torch.from_numpy(x)
    out = {"bm": arms["bm"](xt)}
    dx = {"bm": perf_lab._input_grad(arms["bm"], xt)}
    _close(out["bm"][:, :nat], want[:, :nat], 1e-5, "bm forward against JAX")
    _close(dx["bm"], want_dx, 1e-5, "bm input gradient against JAX")
    xcf = xt.transpose(1, 2).contiguous()
    for name in ("cf", "cfv"):
        _close(arms[name](xcf).transpose(1, 2)[:, :nat], out["bm"][:, :nat].numpy(), 1e-5,
               f"{name} forward against bm")
        _close(perf_lab._input_grad(arms[name], xcf).transpose(1, 2), dx["bm"].numpy(), 1e-5,
               f"{name} input gradient against bm")


def test_parts_match_jax(small_mesh):
    """enc, dec and disc of `perf_lab.part_outputs` at the flagship's widths
    (tools.flagship.FLAGSHIP) on the icosphere's natural-layout contexts,
    batch 2, with JAX's parameters through core/bridge.py: each part's loss
    sum(out**2) and its gradient with respect to the carrier u at u = 0
    within 1e-4 of max|ref| of JAX's own parts (`cape_tpu/tools/perf_lab.py`
    cmd_parts), f32."""
    from cape_tpu.core.config import CAPEConfig as JaxConfig
    from cape_tpu.meshops.pyramid import build_pyramid
    from cape_tpu.meshops.topology import vertices_per_edge
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu.ops.sparse import build_graph_context as jax_context
    from cape_tpu_torch.core.bridge import from_jax_params
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.sparse import build_graph_context
    from cape_tpu_torch.tools import perf_lab
    from cape_tpu_torch.tools.flagship import FLAGSHIP, flagship_config

    verts, faces = small_mesh
    cfg = flagship_config(batch_size=2, padded_layout=False)
    pyrs = (build_pyramid(verts, faces, cfg.ds_factors), build_pyramid(verts, faces, [2, 2, 2, 2]))
    edges = vertices_per_edge(faces, len(verts))
    jctx = jax_context(*pyrs, edges, verts)
    ctx = build_graph_context(*pyrs, edges, verts)
    jmodel = JaxCAPE(JaxConfig(**{**FLAGSHIP, "batch_size": 2, "padded_layout": False}))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0), jctx)
    jparams = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype), shapes)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    model.load_state_dict(from_jax_params(jparams), strict=True)

    B = 2
    x = rng.standard_normal((B, len(verts), 3)).astype(np.float32)
    y = rng.standard_normal((B, cfg.nz_cond)).astype(np.float32)
    y2 = rng.standard_normal((B, cfg.nz_cond2)).astype(np.float32)
    zt = rng.standard_normal((B, cfg.nz + cfg.nz_cond + cfg.nz_cond2)).astype(np.float32)
    jax_parts = {   # cape_tpu/tools/perf_lab.py cmd_parts
        "enc": lambda u: jnp.sum(jmodel.encode(jparams, jctx, x + u, y, y2)[0] ** 2),
        "dec": lambda u: jnp.sum(jmodel.decode(jparams, jctx, zt + jnp.sum(u) * 1e-9, y, y2) ** 2),
        "disc": lambda u: jnp.sum(jmodel.discriminate(jparams, jctx, x + u, y, y2) ** 2),
    }
    t = torch.from_numpy
    parts = perf_lab.part_outputs(model, ctx, t(x), t(y), t(y2), t(zt))
    assert list(parts) == list(jax_parts)
    u0 = np.zeros_like(x)
    for name, jloss in jax_parts.items():
        want, want_du = jax.jit(jax.value_and_grad(jloss))(u0)
        u = torch.zeros(x.shape, requires_grad=True)
        loss = (parts[name](u) ** 2).sum()
        (du,) = torch.autograd.grad(loss, u)
        _close(loss, want, 1e-4, f"{name} loss")
        _close(du, want_du, 1e-4, f"{name} carrier gradient")
        assert np.abs(np.asarray(want_du)).max() > 0, name
