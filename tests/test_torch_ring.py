"""Parity of the port's ring conv entries (TPU kernels 5 and 6, `cheb2_banded_v6`
and `cheb2_banded_v7`) with the JAX package on the CPU, the port of the JAX
whole-conv parity test (`tests/test_ops.py`, v5/v6/v7 against the plain conv),
and the checks of the ring kernel's wrapper.

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

torch.set_num_threads(1)

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
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

    return (ck.launches, ck.bwd_launches, ck.fused1_launches, ck.fused_launches,
            ck.bm_launches, ck.ring_launches, ck.ring2_launches)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("B,C,F", SHAPES)
@pytest.mark.parametrize("kernel", ["v6", "v7"])
def test_ring_entries_match_jax_pallas(toy, kernel, B, C, F, padded):
    """`cheb2_banded_v6` / `_v7` against `cheb2_banded_pallas_v6` / `_v7`
    (interpret mode): y, dx and dW, f32, natural and padded layouts. In the
    padded layout x's tail rows hold 7.0 and the cotangent's tail is zero,
    as the model's is. No kernel launches on CPU tensors."""
    from cape_tpu.ops.pallas import cheb_kernel as jck
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

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
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

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
    than float32 and bfloat16, a non-contiguous input, rows_per_step other
    than 1 and 2, a centre tile outside the window. A CPU tensor meets no
    kernel (`_check_cuda`); meta tensors compute nothing."""
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck

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
        ck._check_cuda("ring_cheb2", x)
    with pytest.raises(TypeError, match="float32, bfloat16"):
        ck.ring_cheb2(x.double(), blocks.double(), 128, 256, w0.double(), w1.double(), 1)
    with pytest.raises(TypeError, match="w0"):
        ck.ring_cheb2(x, blocks, 128, 256, w0.bfloat16(), w1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ck.ring_cheb2(x.transpose(0, 1), blocks, 128, 256, w0, w1, 1)
    for R in (0, 3):
        with pytest.raises(ValueError, match="rows_per_step"):
            ck.ring_cheb2(x, blocks, 128, 256, w0, w1, R)
    with pytest.raises(ValueError, match="pad_left"):
        ck.ring_cheb2(x, blocks, 3 * 128, 256, w0, w1, 1)
    with pytest.raises(ValueError, match="rows_out"):
        ck.ring_cheb2(x, blocks, 128, 257, w0, w1, 1)
