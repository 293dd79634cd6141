"""The plain `BandedOp` applies on the band-gather kernel: the CUDA route of
`ops.banded.BandedMatvec`, one launch of `csrc/band_gather.cu` per apply
and direction through `cheb_kernel.band_apply`.

On the CPU: the route's arithmetic and row metadata (`band_gather_plain`
over each op's packs against `apply_blocks`, on every operator of the
flagship's and the CMR preset's context, in both layouts, forward and
transpose, C of 1, 3 and 64 and the 2-D input), the route's choice
(`on_kernel`: plain on the CPU, on `meta`, under use_pallas=0 and under
CAPE_TPU_PALLAS=0), and its entry: band_apply keeps the signature that
bench_port's LaunchRecorder wraps, and a wrapper of that signature sees
every apply of a train step. Tests marked `card` run the kernel itself
and skip without a CUDA card:

    python -m pytest tests/test_torch_band_route.py -q -m card --noconftest   # on a card

This file imports no JAX, so that it runs on the card's machine, where
`--noconftest` leaves out tests/conftest.py (it imports JAX)."""

import collections
import dataclasses
import inspect
import os
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
CMR = os.path.join(ROOT, "configs", "CAPE_nz18_pose24_clotype8_male.yaml")
# plain BandedOp applies of one train step, forward and backward (counted
# on `meta`): the flagship at batch 32, whose 17 K=2 convs take the conv
# route, and the CMR preset at batch 16, where none does
STEP_APPLIES = {"affine": (FLAGSHIP, 32, 120), "cmr": (CMR, 16, 137)}
# the conv route's band_apply launches of a flagship step at batch 32
CONV_ROUTE = 17


@pytest.fixture(scope="module")
def contexts():
    """{layout: {name: op}}: every BandedOp of the port's full-template
    context with the fused decoder's L~U operators, in the natural and the
    padded layout (the edge operator stays natural, as the model uses it).
    The flagship's and the CMR preset's contexts hold the same operators."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.ops.banded import BandedOp

    flagship, cmr = load_config(FLAGSHIP), load_config(CMR)
    assert flagship.ds_factors == cmr.ds_factors
    assert (flagship.compute_dtype, flagship.op_mode) == (cmr.compute_dtype, cmr.op_mode)
    ctx = build_context(dataclasses.replace(flagship, padded_layout=False, fuse_decoder=True))
    ops = {}
    for field in ("lap", "down", "up", "lap_d", "down_d", "lap_up"):
        for i, op in enumerate(getattr(ctx, field)):
            if isinstance(op, BandedOp):
                ops[f"{field}[{i}]"] = op
    assert {k.split("[")[0] for k in ops} == {"lap", "down", "up", "lap_d", "down_d", "lap_up"}
    padded = {k: dataclasses.replace(op, padded=True) for k, op in ops.items()}
    ops["edge_op"] = padded["edge_op"] = ctx.edge_op
    return {"natural": ops, "padded": padded}


def _x(rng, op, transpose: bool, C: int, B: int = 2, dtype=torch.float32) -> torch.Tensor:
    """Inputs of the apply (or of its transpose), tail rows included: the
    padded layout's hold finite values that no entry reads."""
    rows = op.rows_out if transpose else op.rows_in
    shape = (rows, C) if B == 0 else (B, rows, C)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _plain(op, x, transpose: bool) -> torch.Tensor:
    from cape_tpu_torch.ops.banded import apply_blocks

    if transpose:
        return apply_blocks(x, op.t_blocks, op.t_pad_left, op.t_pad_right, op.n_cols, op.padded)
    return apply_blocks(x, op.blocks, op.pad_left, op.pad_right, op.n_rows, op.padded)


def _close(got, want, rtol=1e-5):
    assert got.shape == want.shape
    scale = float(want.abs().max()) or 1.0
    np.testing.assert_allclose(got.detach().double().cpu().numpy(), want.double().cpu().numpy(),
                               rtol=rtol, atol=rtol * scale)


# C of the applies: one channel (the folded condition seed), three (the
# mesh's coordinates), 64 (the flagship's width); B = 0 is a 2-D [rows, C]
CASES = [(2, 1), (2, 3), (2, 64), (0, 1)]


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
@pytest.mark.parametrize("layout", ["natural", "padded"])
def test_plain_gather_over_the_packs_equals_apply_blocks(contexts, layout, transpose):
    """band_gather_plain over op.pack (op.t_pack for the transpose), at the
    route's rows, equals apply_blocks within f32 round-off on every op:
    Laplacians, pools, unpools, the discriminator's pyramid, the fused
    decoder's operators and the edge operator, whose column blocks are 128
    and 43, 64, 256 (384 in the transpose of the edge operator)."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_gather_plain

    rng = np.random.default_rng(20)
    blocks = set()
    for name, op in contexts[layout].items():
        pack = op.t_pack if transpose else op.pack
        rows = op.rows_in if transpose else op.rows_out
        blocks.add((op.t_blocks if transpose else op.blocks).shape[3])
        for B, C in CASES:
            x = _x(rng, op, transpose, C, B)
            got = band_gather_plain(x.reshape(-1, *x.shape[-2:]), pack, rows)
            _close(got.reshape(*x.shape[:-2], *got.shape[1:]), _plain(op, x, transpose))
    assert blocks == ({64, 128, 256, 384} if transpose else {43, 64, 128, 256})


def _stand_in(device: str = "cuda", dtype=torch.float32, numel: int = 1):
    """What on_kernel reads of a tensor, for a device this machine may lack."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, numel=lambda: numel)


@pytest.mark.parametrize("case,want", [
    ("cuda", True), ("use_pallas=0", False), ("CAPE_TPU_PALLAS=0", False),
    ("use_pallas=0, CAPE_TPU_PALLAS=1", True), ("bfloat16", True), ("float16", True),
    ("float64", False), ("cpu", False), ("meta", False), ("no pack", False), ("empty", False),
])
def test_on_kernel_decides_from_device_dtype_pack_and_config(contexts, monkeypatch, case, want):
    from cape_tpu_torch.ops.banded import on_kernel

    op = contexts["padded"]["down[1]"]
    monkeypatch.delenv("CAPE_TPU_PALLAS", raising=False)
    x = _stand_in()
    if case.startswith("use_pallas=0"):
        op = dataclasses.replace(op, allow_pallas=False)
    if case.endswith("CAPE_TPU_PALLAS=0"):
        monkeypatch.setenv("CAPE_TPU_PALLAS", "0")
    if case.endswith("CAPE_TPU_PALLAS=1"):
        monkeypatch.setenv("CAPE_TPU_PALLAS", "1")
    if case in ("bfloat16", "float16", "float64"):
        x = _stand_in(dtype=getattr(torch, case))
    if case in ("cpu", "meta"):
        x = _stand_in(case)
    if case == "no pack":
        op = dataclasses.replace(op, pack=None, t_pack=None)
    if case == "empty":
        x = _stand_in(numel=0)
    assert on_kernel(x, op) is want


@pytest.mark.parametrize("env", [None, "0", "1"], ids=["unset", "0", "1"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["use_pallas=1", "use_pallas=0"])
def test_one_predicate_decides_both_kernel_routes(contexts, monkeypatch, env, use_pallas):
    """kernels.allowed is CAPE_TPU_PALLAS where it is set, else the op's
    use_pallas; on_kernel (the plain BandedOp applies) and the conv gate of
    ops.cheb (a batch-32 K=2 conv on `meta`, counted in route.v3) both
    follow it."""
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.ops.banded import on_kernel
    from cape_tpu_torch.ops.cheb import cheb_conv

    if env is None:
        monkeypatch.delenv("CAPE_TPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("CAPE_TPU_PALLAS", env)
    want = use_pallas if env is None else env == "1"
    assert kernels.allowed(use_pallas) is want
    op = dataclasses.replace(contexts["padded"]["lap[3]"], allow_pallas=use_pallas)
    assert on_kernel(_stand_in(), op) is want
    op = op.to("meta")
    routes = kernels.counts["route.v3"]
    y = cheb_conv(torch.empty((32, op.rows_in, 64), device="meta"), op,
                  torch.empty((2, 64, 8), device="meta"))
    assert y.shape == (32, op.rows_out, 8)
    assert kernels.counts["route.v3"] - routes == int(want)


@pytest.fixture
def refuse_band_apply(monkeypatch):
    """band_apply replaced by a stand-in that fails the test if called."""
    from cape_tpu_torch.ops.kernels import cheb_kernel

    def band_apply(*a, **k):
        raise AssertionError("band_apply called off the kernel route")

    monkeypatch.setattr(cheb_kernel, "band_apply", band_apply)


def _counts():
    from cape_tpu_torch.ops.kernels import counts

    return tuple(counts[k] for k in ("band_apply.op", "band_apply.conv", "band_apply.conv_bwd",
                                     "band_apply.bfloat16", "band_apply.float16"))


@pytest.mark.parametrize("case", ["cpu", "meta", "use_pallas=0", "CAPE_TPU_PALLAS=0"])
def test_banded_matvec_stays_plain_off_the_card(contexts, refuse_band_apply, monkeypatch, case):
    """Off CUDA, and with kernels turned off, BandedMatvec takes
    apply_blocks in both directions and counts nothing."""
    rng = np.random.default_rng(21)
    before = _counts()
    for name in ("lap[0]", "down[1]", "up[3]", "edge_op"):
        op = contexts["padded"][name]
        if case == "use_pallas=0":
            op = dataclasses.replace(op, allow_pallas=False)
        if case == "CAPE_TPU_PALLAS=0":
            monkeypatch.setenv("CAPE_TPU_PALLAS", "0")
        x = _x(rng, op, False, 3)
        g = _x(rng, op, True, 3)
        if case == "meta":
            op, x, g = op.to("meta"), x.to("meta"), g.to("meta")
        x.requires_grad_()
        y = op(x)
        (dx,) = torch.autograd.grad(y, x, g)
        if case == "meta":
            assert (y.shape, dx.shape) == (g.shape, x.shape)
        else:
            _close(y, _plain(op, x.detach(), False))
            _close(dx, _plain(op, g, True))
    assert _counts() == before


def test_band_apply_keeps_the_signature_the_launch_recorder_wraps():
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.ops.kernels import cheb_kernel

    params = inspect.signature(cheb_kernel.band_apply).parameters
    assert list(params) == ["x", "blocks", "pad_left", "rows_out", "addend", "pack"]
    assert params["addend"].default is None and params["pack"].default is None
    assert set(kernels.DTYPE_CODES) == {torch.float32, torch.bfloat16, torch.float16}


@pytest.fixture
def routed(monkeypatch):
    """The kernel route taken on any device, through a wrapper with the
    signature of bench_port's LaunchRecorder put on cheb_kernel.band_apply.
    It records each call as (x shape, rows_out, pack) and computes what the
    kernel computes, band_gather_plain over the pack given (an empty
    result on `meta`), for the plain BandedOp applies and the conv route's
    calls alike."""
    from cape_tpu_torch.ops import banded
    from cape_tpu_torch.ops.kernels import cheb_kernel

    calls = []

    def band_apply(x, blocks, pad_left, rows_out, addend=None, pack=None):
        calls.append((tuple(x.shape), rows_out, pack))
        pack.check("band_apply", blocks, pad_left)
        if x.device.type == "meta":
            return x.new_empty((x.shape[0], rows_out, x.shape[2]))
        return cheb_kernel.band_gather_plain(x, pack, rows_out, addend)

    monkeypatch.setattr(banded, "on_kernel", lambda x, op: True)
    monkeypatch.setattr(cheb_kernel, "band_apply", band_apply)
    return calls


@pytest.mark.parametrize("layout", ["natural", "padded"])
def test_the_kernel_route_launches_once_per_apply_through_band_apply(contexts, routed, layout):
    """On the route, each apply of every op is one band_apply call of
    x [B, rows, C] (the 2-D input as [1, rows, C]) over op.pack forward and
    op.t_pack backward, equal to apply_blocks, counted in band_apply.op
    and not in the conv route's keys."""
    rng = np.random.default_rng(22)
    k0, *rest = _counts()
    n = 0
    for name, op in contexts[layout].items():
        for B, C in CASES[1:]:
            x = _x(rng, op, False, C, B).requires_grad_()
            g = _x(rng, op, True, C, B)
            del routed[:]
            y = op(x)
            (dx,) = torch.autograd.grad(y, x, g)
            _close(y, _plain(op, x.detach(), False))
            _close(dx, _plain(op, g, True))
            b = max(B, 1)
            assert [(shape, rows) for shape, rows, _ in routed] == [
                ((b, op.rows_in, C), op.rows_out), ((b, op.rows_out, C), op.rows_in)
            ], name
            assert routed[0][2] is op.pack and routed[1][2] is op.t_pack
            n += 2
    assert _counts() == (k0 + n, *rest)


@pytest.mark.parametrize("preset", sorted(STEP_APPLIES))
def test_a_train_step_sends_every_plain_apply_through_band_apply(preset, routed):
    """A full-width train step on `meta`, the route taken: the wrapper sees
    every plain apply (120 a flagship step at batch 32, 137 a CMR step at
    16), each counted in band_apply.op, beside the conv route's 17 + 17
    calls on the flagship, which keep their own keys (they count only on
    the card)."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.train.step import gan_losses

    path, B, applies = STEP_APPLIES[preset]
    cfg = load_config(path)
    ctx = build_context(cfg)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to("meta")
    ctx = ctx.to("meta")
    m = lambda *s: torch.empty(s, device="meta")
    batch = {f"{k}_{p}": m(B, *s) for p in "gd"
             for k, s in (("disp", (6890, 3)), ("pose", (cfg.cond_dim,)), ("clo", (cfg.cond2_dim,)))}
    k0, *rest = _counts()
    routes = kernels.counts["route.v3"]
    params = list(model.parameters())
    total, _ = gan_losses(model, cfg, ctx, batch, m(B, cfg.nz))
    torch.autograd.grad(total, params, allow_unused=True)
    conv = CONV_ROUTE if B == 32 else 0
    assert len(routed) == applies + 2 * conv
    assert all(len(shape) == 3 for shape, *_ in routed)
    assert _counts() == (k0 + applies, *rest)
    assert kernels.counts["route.v3"] - routes == conv


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what the conv route's
    launch counts read of x, for a device this machine may lack."""

    is_cuda = True


@pytest.mark.parametrize("device", ["cuda", "cpu", "meta"])
def test_the_conv_route_counts_its_launches_on_the_card_only(contexts, device):
    """cheb2_banded_v3 through autograd: its forward band apply of x on the
    card counts in `band_apply.conv`, its backward's in
    `band_apply.conv_bwd`; the plain versions on the CPU and `meta` count
    nowhere, and no other key moves."""
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.ops.kernels import cheb_kernel

    op = contexts["padded"]["lap[3]"]
    rng = np.random.default_rng(23)
    x, g = _x(rng, op, False, 3, 2), _x(rng, op, True, 4, 2)
    w = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    if device == "meta":
        op, x, g, w = op.to("meta"), x.to("meta"), g.to("meta"), w.to("meta")
    if device == "cuda":
        x, g = x.as_subclass(_OnCard), g.as_subclass(_OnCard)
    before = collections.Counter(kernels.counts)
    x.requires_grad_()
    torch.autograd.grad(cheb_kernel.cheb2_banded_v3(x, op, w), x, g)
    on = int(device == "cuda")
    assert kernels.counts - before == collections.Counter(
        {"band_apply.conv": on, "band_apply.conv_bwd": on})


# ------------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the kernel against band_gather_plain (the same arithmetic, another order
# of the f32 sums): f32 round-off, or one ulp of the 16-bit dtype at max|y|
ULP = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["float32", "bfloat16", "float16"])
def test_the_kernel_route_matches_plain_on_the_card(card, contexts, dtype):
    """BandedMatvec on the card, forward and backward, for every op and
    layout: one band_apply.op each, equal to band_gather_plain over the
    same pack within one ulp of the dtype, and in f32 to apply_blocks; no
    conv-route launch."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_gather_plain

    rng = np.random.default_rng(23)
    k0, *rest = _counts()
    n = 0
    for layout in ("natural", "padded"):
        for name, op in contexts[layout].items():
            op = op.to(card)
            for B, C in CASES:
                x = _x(rng, op, False, C, B, dtype).to(card).requires_grad_()
                g = _x(rng, op, True, C, B, dtype).to(card)
                y = op(x)
                (dx,) = torch.autograd.grad(y, x, g)
                x3, g3 = x.detach().reshape(-1, *x.shape[-2:]), g.reshape(-1, *g.shape[-2:])
                want_y = band_gather_plain(x3, op.pack, op.rows_out).reshape(y.shape)
                want_dx = band_gather_plain(g3, op.t_pack, op.rows_in).reshape(dx.shape)
                _close(y, want_y, ULP[dtype])
                _close(dx, want_dx, ULP[dtype])
                if dtype == torch.float32:
                    _close(y, _plain(op, x.detach(), False))
                    _close(dx, _plain(op, g, True))
                n += 2
    torch.cuda.synchronize()
    half = {torch.bfloat16: 3, torch.float16: 4}.get(dtype)
    want = [k0 + n, *rest]
    if half:
        want[half] += n
    assert list(_counts()) == want


@pytest.mark.card
@pytest.mark.parametrize("preset", sorted(STEP_APPLIES))
def test_a_train_step_on_the_card_counts_both_routes(card, preset):
    """One train step at the cell's batch on the card: the conv route keeps
    its 17 + 17 launches on the flagship (none on the CMR preset at 16),
    and every plain apply takes the kernel (`band_apply.op`)."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import cheb_kernel
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    path, B, applies = STEP_APPLIES[preset]
    cfg = load_config(path)
    ctx = build_context(cfg, device=card)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to(card)
    state = TrainState(model, Optimizer(cfg, 100))
    gen = torch.Generator().manual_seed(1)
    r = lambda *s: (0.01 * torch.randn(s, generator=gen)).to(card)
    batch = {f"{k}_{p}": r(B, *s) for p in "gd"
             for k, s in (("disp", (6890, 3)), ("pose", (cfg.cond_dim,)), ("clo", (cfg.cond2_dim,)))}
    k0, f0, b0, *_ = _counts()
    metrics, _ = train_step(state, ctx, batch, r(B, cfg.nz))
    torch.cuda.synchronize()
    k1, f1, b1, *_ = _counts()
    assert all(torch.isfinite(v) for v in metrics.values())
    conv = CONV_ROUTE if B == 32 else 0
    assert (f1 - f0, b1 - b0, k1 - k0) == (conv, conv, applies)
