"""The fused group norm + ReLU (`ops.norm.group_norm_relu`, CUDA kernel
`csrc/group_norm_relu.cu`) against its plain version, relu(group_norm(...)).

On the CPU (and `meta`) the function is the plain version, bit for bit,
gradients included, and launches nothing; the kernel's plan (`norm_plan`)
takes every norm of the GraphCMR decoder; nothing is built without a card.
The tests marked `card` hold the kernel to the plain version at the
decoder's 24 norm shapes on a GPU:

    pytest tests/test_torch_norm_kernel.py -m card --noconftest

This file imports no JAX: it compares the port with itself."""

import os

import numpy as np
import pytest
import torch

from cape_tpu_torch.ops import kernels, norm
from cape_tpu_torch.ops.norm import group_norm, group_norm_relu, norm_plan

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMR = os.path.join(ROOT, "configs", "CAPE_nz18_pose24_clotype8_male.yaml")
DEFAULT = os.path.join(ROOT, "configs", "default_config.yaml")
FLAGSHIP = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")

# (padded rows V, natural rows n_valid, channels C) of the GraphCMR decoder's
# 24 norms, in the order a forward runs them, for the CMR release preset
# and default_config.yaml alike (8 blocks of gn0, gn1, gn2; padded layout)
DECODER_NORMS = [
    (896, 862, 544), (896, 862, 256), (896, 862, 256),
    (896, 862, 544), (896, 862, 256), (896, 862, 256),
    (1792, 1723, 544), (1792, 1723, 128), (1792, 1723, 128),
    (1792, 1723, 288), (1792, 1723, 128), (1792, 1723, 128),
    (3456, 3445, 288), (3456, 3445, 64), (3456, 3445, 64),
    (3456, 3445, 160), (3456, 3445, 64), (3456, 3445, 64),
    (6912, 6890, 160), (6912, 6890, 32), (6912, 6890, 32),
    (6912, 6890, 96), (6912, 6890, 32), (6912, 6890, 32),
]
SHAPES = sorted(set(DECODER_NORMS))
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
DTYPE_IDS = ["float32", "bfloat16", "float16"]
# kernel launches of one train step of a GraphCMR-decoder preset: 24 norms,
# one launch each forward and two each backward
STEP_LAUNCHES = 24 * 3


def _inputs(B, V, C, n_valid, seed, tail=None, dtype=torch.float32, device="cpu"):
    """x [B, V, C] (tail rows past n_valid: `tail`, or finite values), gamma,
    beta, and a cotangent whose tail rows are zero, as the padded layout's
    are."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, V, C)) * 2 + 0.5).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.3 * rng.standard_normal(C)).astype(np.float32))
    beta = torch.from_numpy((0.2 * rng.standard_normal(C)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, V, C)).astype(np.float32))
    if n_valid is not None:
        dy[:, n_valid:] = 0
        if tail is not None:
            x[:, n_valid:] = tail
    x, dy = x.to(dtype).to(device), dy.to(dtype).to(device)
    return x, gamma.to(device), beta.to(device), dy


def _value_and_grads(fn, x, gamma, beta, dy, **kw):
    x, gamma, beta = (t.detach().clone().requires_grad_() for t in (x, gamma, beta))
    y = fn(x, gamma, beta, **kw)
    return (y, *torch.autograd.grad(y, (x, gamma, beta), dy))


def _plain(x, gamma, beta, **kw):
    return torch.relu(group_norm(x, gamma, beta, **kw))


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("V, n_valid, C", [(40, 33, 32), (40, None, 96), (24, 17, 544),
                                           (12, 12, 64), (9, 5, 24)])
def test_on_the_cpu_it_is_the_plain_version(V, n_valid, C, dtype):
    """group_norm_relu on CPU tensors is relu(group_norm(...)) bit for bit,
    forward and dx, dgamma, dbeta, at C/G = 1, 3 and 17 and a C under 32
    (G = C), n_valid set, None and equal to V; no launch is counted."""
    x, gamma, beta, dy = _inputs(2, V, C, n_valid, seed=C + V, dtype=dtype)
    before = kernels.counts["group_norm_relu"]
    got = _value_and_grads(group_norm_relu, x, gamma, beta, dy, n_valid=n_valid)
    want = _value_and_grads(_plain, x, gamma, beta, dy, n_valid=n_valid)
    for g, w, name in zip(got, want, ("y", "dx", "dgamma", "dbeta")):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert kernels.counts["group_norm_relu"] == before


def test_on_the_cpu_non_finite_tails_stay_out_of_the_valid_rows():
    """Tail rows of inf and NaN leave the valid rows of the CPU forward
    untouched, as in the plain version whose arithmetic it is."""
    x, gamma, beta, _ = _inputs(2, 30, 64, 21, seed=3)
    xt = x.clone()
    xt[:, 21:25] = float("inf")
    xt[:, 25:] = float("nan")
    xt[0, 28] = -float("inf")
    got = group_norm_relu(xt, gamma, beta, n_valid=21)
    assert torch.equal(got[:, :21], group_norm_relu(x, gamma, beta, n_valid=21)[:, :21])
    torch.testing.assert_close(got, _plain(xt, gamma, beta, n_valid=21), rtol=0, atol=0,
                               equal_nan=True)


def test_on_meta_it_is_the_plain_version():
    x = torch.empty((16, 6912, 96), device="meta")
    y = group_norm_relu(x, torch.empty(96, device="meta"), torch.empty(96, device="meta"),
                        n_valid=6890)
    assert y.device.type == "meta" and y.shape == x.shape


@pytest.mark.parametrize("preset", [CMR, DEFAULT], ids=["cmr", "default_config"])
def test_the_decoder_norms_are_these(monkeypatch, preset):
    """A batch-16 GAN step's forward on `meta` calls group_norm_relu at
    DECODER_NORMS, in order, with the natural row counts as n_valid; the
    plain version (ops.norm.group_norm) is reached only through it."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models import blocks
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.train.step import gan_losses

    seen = []

    def spy(x, gamma, beta, num_groups=32, eps=1e-5, n_valid=None):
        seen.append((x.shape[1], n_valid, x.shape[2], num_groups, eps, x.shape[0]))
        return group_norm_relu(x, gamma, beta, num_groups, eps, n_valid)

    monkeypatch.setattr(blocks, "group_norm_relu", spy)
    cfg = load_config(preset)
    ctx = build_context(cfg)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to("meta")
    ctx = ctx.to("meta")
    m = lambda *s: torch.empty(s, device="meta")
    batch = {f"{k}_{p}": m(16, *s) for p in "gd"
             for k, s in (("disp", (6890, 3)), ("pose", (cfg.cond_dim,)), ("clo", (cfg.cond2_dim,)))}
    gan_losses(model, cfg, ctx, batch, m(16, cfg.nz))
    assert [s[:3] for s in seen] == DECODER_NORMS
    assert {s[3:] for s in seen} == {(32, 1e-5, 16)}


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_the_plan_takes_every_decoder_norm(dtype, backward):
    """norm_plan at every decoder norm, batch 16 and 1: a plan (the part
    fits in shared memory), and one that holds to what csrc/group_norm_relu.cu
    checks (W a multiple of the 16-byte access, and a sector wide where
    the groups allow; threads a whole number of row sweeps; clusters of 1,
    2, 4 or 8 that cover the rows; shared memory as the kernel lays it
    out and within the H100's)."""
    es = dtype.itemsize
    arrays = 2 if backward else 1
    for B in (16, 1):
        for V, _, C in SHAPES:
            G = 32
            vec, k, p, rows, threads, smem = norm_plan(dtype, B, V, C, G, backward, True)
            W = k * (C // G)
            assert vec == 16 // es and W % vec == 0 and G % k == 0 and C % vec == 0
            assert W * es >= 32 or G % (2 * k), (V, C, k)
            assert threads <= norm.NORM_THREADS and threads % (W // vec) == 0
            assert p in (1, 2, 4, 8) and rows * p >= V > rows * (p - 1)
            part = arrays * (-(-rows * W * es // 16) * 16)
            assert smem == part + 4 * (2 * threads * vec + 2 * W + 2 * k) <= norm.SMEM_MAX
            blocks = B * (G // k) * p
            assert p == norm.NORM_CLUSTER_MAX or blocks >= norm.NORM_MIN_BLOCKS, (B, V, C)


def test_the_plan_falls_back_to_scalar_accesses_and_device_memory():
    """An x not 16-byte aligned, or a C the access does not divide, takes one
    element an access (vec 1, one group a block); a part too large for
    shared memory even in a cluster of 8, and a group wider than a block's
    sweep, take no plan (the wrapper raises: every pass reads the part
    from shared memory)."""
    assert norm_plan(torch.float32, 16, 6912, 96, 32, False, False)[:2] == (1, 1)
    assert norm_plan(torch.bfloat16, 16, 6912, 36, 18, True, True)[:2] == (1, 1)
    assert norm_plan(torch.float32, 2, 40000, 544, 32, True, True) is None
    assert norm_plan(torch.float32, 2, 40000, 544, 32, False, True) is None
    assert norm_plan(torch.float32, 1, 10, 32 * 1028, 32, False, False) is None


def test_it_imports_and_the_model_builds_without_nvcc(monkeypatch):
    """With no nvcc and no card, the module (imported with this file) and a
    GraphCMR model need nothing built: the model builds and its decoder
    runs its norms on the CPU, and no library is compiled or loaded."""
    from cape_tpu_torch.core.config import CAPEConfig
    from cape_tpu_torch.meshops.pyramid import build_pyramid
    from cape_tpu_torch.meshops.topology import vertices_per_edge
    from cape_tpu_torch.meshops.toy import icosphere
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import build
    from cape_tpu_torch.ops.sparse import build_graph_context

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no_cuda_here"))
    monkeypatch.setenv("PATH", "")
    cfg = CAPEConfig(name="norm_no_nvcc", num_conv_layers=4, nf=32, nz=8, nz_cond=24, nz_cond2=8,
                     use_res_block=False, use_res_block_dec=True, affine=False, reduce_dim=4,
                     batch_size=2)
    verts, faces = icosphere(3)
    ctx = build_graph_context(build_pyramid(verts, faces, cfg.ds_factors),
                              build_pyramid(verts, faces, [2, 2, 2, 2]),
                              vertices_per_edge(faces, len(verts)), verts, padded=True)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    y, y2 = model.embed_conditions(torch.zeros(2, cfg.cond_dim), torch.zeros(2, cfg.cond2_dim))
    z = torch.zeros(2, cfg.nz + y.shape[-1] + y2.shape[-1])
    out = model.decode(ctx, z, y, y2)
    assert out.shape == (2, len(verts), 3) and torch.isfinite(out).all()
    assert build.group_norm_relu_lib.cache_info().currsize == 0
    assert norm._entries.cache_info().currsize == 0


# ------------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# f32: the kernel against the plain version's autograd, the same arithmetic
# with the sums taken in another order (y and dx: 1e-5 of max|ref|; dgamma
# and dbeta, sums over up to 16 x 6890 x 17 terms: 1e-4); 16-bit: one ulp
# of the dtype at max|ref| against the plain version's f32 arithmetic on
# the same inputs (the kernel rounds once; the plain 16-bit path rounds
# after every operator, and chip_smoke.py's norm phase prints its gap)
F32_TOL = {"y": 1e-5, "dx": 1e-5, "dgamma": 1e-4, "dbeta": 1e-4}
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _ulp(dtype, v: float) -> float:
    return ULP[dtype] * 2.0 ** np.floor(np.log2(v))


def _check(got, want, dtype, tail_from=None):
    """Each of y, dx, dgamma, dbeta within its limit of the reference;
    where tail_from is given, y's and dx's rows past it are left out."""
    for g, w, name in zip(got, want, ("y", "dx", "dgamma", "dbeta")):
        if tail_from is not None and name in ("y", "dx"):
            g, w = g[:, :tail_from], w[:, :tail_from]
        g, w = g.double(), w.double()
        scale = float(w.detach().abs().max())
        if dtype == torch.float32 or name in ("dgamma", "dbeta"):
            limit = F32_TOL[name] * scale
        else:
            limit = _ulp(dtype, scale)
        err = float((g - w).detach().abs().max())
        assert err <= limit, (name, err, limit)


def _reference(x, gamma, beta, dy, dtype, n_valid):
    """The plain version's f32 arithmetic on the kernel's inputs: x and dy as
    the kernel reads them, gamma and beta rounded to x's dtype."""
    r = lambda t: t.to(dtype).float()
    return _value_and_grads(_plain, x.float(), r(gamma), r(beta), dy.float(), n_valid=n_valid)


# the cotangent is zeroed where the value before the ReLU lies within this
# share of max|z| of 0: the two sides' statistics differ in their last bits
# (y, which is z where positive, by up to ~2e-7 of max|z| on the card), so
# either may put such an element on the other side of the kink, and its dx
# with it; chip_smoke.py's norm phase shows that dx's worst element lies in
# this window when the cotangent is left whole
KINK = 1e-5


def _off_the_kink(x, gamma, beta, dy, n_valid):
    """dy with the elements within KINK * max|z| of the ReLU's kink zeroed;
    the count zeroed is printed (a few in 10^5)."""
    r = lambda t: t.to(x.dtype).float()
    z = group_norm(x.float(), r(gamma), r(beta), n_valid=n_valid)
    near = z.abs() < KINK * float(z[:, :n_valid].abs().max())
    print(f"{tuple(x.shape)} {x.dtype} n_valid={n_valid}: {int(near.sum())} of {near.numel()} "
          "cotangents zeroed at the kink")
    return torch.where(near, 0, dy)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_the_kernel_matches_plain_at_the_decoder_norms(card, dtype):
    """Every decoder norm shape at batch 16 (C/G = 1, 2, 3, 4, 5, 8, 9 and
    17), n_valid set with finite tails and with n_valid None: y, dx, dgamma
    and dbeta within their limits, three launches each."""
    for i, (V, n_valid, C) in enumerate(SHAPES):
        for nv in (n_valid, None):
            x, gamma, beta, dy = _inputs(16, V, C, nv, seed=i, dtype=dtype, device=card)
            dy = _off_the_kink(x, gamma, beta, dy, nv)
            before = kernels.counts["group_norm_relu"]
            got = _value_and_grads(group_norm_relu, x, gamma, beta, dy, n_valid=nv)
            torch.cuda.synchronize()
            assert kernels.counts["group_norm_relu"] - before == 3
            assert got[0].dtype == dtype and got[2].dtype == torch.float32
            _check(got, _reference(x, gamma, beta, dy, dtype, nv), dtype)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_non_finite_tails_reach_no_valid_row(card, dtype):
    """Tail rows of inf, -inf and NaN: y equals the plain version's on every
    row (NaN where it is NaN); dx on the valid rows, dgamma and dbeta equal
    the plain version's with the tail rows zeroed (the plain backward itself
    turns NaN: 0 * NaN in its masked variance), and the tail rows' dx is
    zero, their cotangents being zero."""
    V, n_valid, C = 6912, 6890, 96
    x, gamma, beta, dy = _inputs(16, V, C, n_valid, seed=5, dtype=dtype, device=card)
    dy = _off_the_kink(x, gamma, beta, dy, n_valid)
    xt = x.clone()
    xt[:, n_valid:n_valid + 7] = float("inf")
    xt[:, n_valid + 7:n_valid + 15] = float("nan")
    xt[:, n_valid + 15:] = -float("inf")
    got = _value_and_grads(group_norm_relu, xt, gamma, beta, dy, n_valid=n_valid)
    want = _reference(x, gamma, beta, dy, dtype, n_valid)
    _check(got, want, dtype, tail_from=n_valid)
    plain_tail = _plain(xt.float(), gamma.to(dtype).float(), beta.to(dtype).float(),
                        n_valid=n_valid)[:, n_valid:]
    # every tail element is inf, 0 or NaN on both sides
    torch.testing.assert_close(got[0][:, n_valid:].float(), plain_tail, rtol=0, atol=0,
                               equal_nan=True)
    assert not got[1][:, n_valid:].any()


@pytest.mark.card
def test_scalar_accesses_and_a_part_too_large(card):
    """The plans' fallbacks on the card: an x 4 bytes off a 16-byte boundary
    (one element an access) and 24 channels in 24 groups, each within the
    f32 limits; a part too large for shared memory raises."""
    x, gamma, beta, dy = _inputs(4, 3456, 160, 3445, seed=7, device=card)
    dy = _off_the_kink(x, gamma, beta, dy, 3445)
    flat = torch.empty(x.numel() + 1, device=card)
    xo = flat[1:].view_as(x)
    xo.copy_(x)
    assert xo.data_ptr() % 16 == 4
    got = _value_and_grads(group_norm_relu, xo, gamma, beta, dy, n_valid=3445)
    _check(got, _reference(x, gamma, beta, dy, torch.float32, 3445), torch.float32)
    x, gamma, beta, dy = _inputs(4, 896, 24, 862, seed=24, device=card)
    dy = _off_the_kink(x, gamma, beta, dy, 862)
    got = _value_and_grads(group_norm_relu, x, gamma, beta, dy, n_valid=862)
    _check(got, _reference(x, gamma, beta, dy, torch.float32, 862), torch.float32)
    x = torch.zeros((2, 40000, 544), device=card)
    with pytest.raises(ValueError, match="no plan"):
        group_norm_relu(x, torch.ones(544, device=card), torch.zeros(544, device=card),
                        n_valid=39000)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_two_runs_are_bitwise_equal(card, dtype):
    """The same inputs twice: y, dx, dgamma and dbeta bit for bit (no
    atomics; every sum in a fixed order), at the finest level's widest norm
    and the coarse level's 17-channel groups."""
    for V, n_valid, C in ((6912, 6890, 160), (1792, 1723, 544)):
        x, gamma, beta, dy = _inputs(16, V, C, n_valid, seed=11, dtype=dtype, device=card)
        a = _value_and_grads(group_norm_relu, x, gamma, beta, dy, n_valid=n_valid)
        b = _value_and_grads(group_norm_relu, x, gamma, beta, dy, n_valid=n_valid)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.card
@pytest.mark.parametrize("preset, B, launches", [(CMR, 16, STEP_LAUNCHES),
                                                 (DEFAULT, 16, STEP_LAUNCHES),
                                                 (FLAGSHIP, 32, 0)],
                         ids=["cmr", "default_config", "affine"])
def test_a_train_step_counts_its_norm_launches(card, preset, B, launches):
    """One train step on the card: the GraphCMR decoder's 24 norms launch
    the kernel once forward and twice backward (72); the affine decoder
    runs none."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    cfg = load_config(preset)
    ctx = build_context(cfg, device=card)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to(card)
    state = TrainState(model, Optimizer(cfg, 100))
    gen = torch.Generator().manual_seed(1)
    r = lambda *s: (0.01 * torch.randn(s, generator=gen)).to(card)
    batch = {f"{k}_{p}": r(B, *s) for p in "gd"
             for k, s in (("disp", (6890, 3)), ("pose", (cfg.cond_dim,)), ("clo", (cfg.cond2_dim,)))}
    before = kernels.counts["group_norm_relu"]
    metrics, _ = train_step(state, ctx, batch, r(B, cfg.nz))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in metrics.values())
    assert kernels.counts["group_norm_relu"] - before == launches
