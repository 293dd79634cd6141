"""The lab: CUDA-event microbenchmarks of one K=2 Chebyshev conv, one band
apply and a conv chain at the flagship's shapes, and timers of the
flagship's parts, train step, serving and HTTP stack, on an NVIDIA GPU.

Counterpart of `cape_tpu/tools/perf_lab.py`, every subcommand:

  python -m cape_tpu_torch.tools.perf_lab conv     # one conv: plain vs v2, v5 (and v1)
  python -m cape_tpu_torch.tools.perf_lab layout   # batch-major vs vertex-major
  python -m cape_tpu_torch.tools.perf_lab fuse     # stacked-GEMM and project-first variants
  python -m cape_tpu_torch.tools.perf_lab bmapply  # bare band apply: plain vs kernel 3
  python -m cape_tpu_torch.tools.perf_lab chain    # stacked convs: batch-major vs channels-first
  python -m cape_tpu_torch.tools.perf_lab parts    # enc/dec/disc fwd vs fwd+bwd
  python -m cape_tpu_torch.tools.perf_lab step     # the GAN train step at --batch/--dtype/--k
  python -m cape_tpu_torch.tools.perf_lab serve    # decode latency / recon throughput, batch 1/16/64
  python -m cape_tpu_torch.tools.perf_lab trace    # a profiled train step, attributed
  python -m cape_tpu_torch.tools.perf_lab artifact model.capex [--batch B]
                                                   # an exported artifact's decode
  python -m cape_tpu_torch.tools.perf_lab http --url http://127.0.0.1:8080
                                                   # a live server's latency per wire
  python -m cape_tpu_torch.tools.perf_lab concurrency --url ...  # a live server under load

They take the JAX subcommands' options and defaults (batch 16, channels 64,
level 0, ...), and `--device` (default `cuda`; without a GPU the tool
raises; `--device cpu` runs on the CPU, where the kernel wrappers take
their plain versions). Each prints the JAX subcommand's JSON line (per
dtype, and for `fuse` per variant; `trace`, `http` and `concurrency` also
its `#` lines), unrounded, with these keys renamed:

  xla_*          -> plain_*      the plain PyTorch route
  pallas_*       -> v2_*         cheb2_banded_v2 (band-apply kernel, row 2)
  pallas5_*      -> v5_*         cheb2_banded_v5 (fused conv kernel, row 4)
  pallas_bm_ms   -> bm_ms        banded_apply_bm (kernel 3)
  vm_pallas_*    -> vm_kernel_*  the band-apply kernel on vertex-major [V, B*C]
  device_ms_per_step -> cpu_op_self_ms_per_step   `trace --device cpu`

and these added: `device` (the GPU's name) in every line but `http` and
`concurrency`'s; in `conv`, `max_rel_err_v2` and kernel 1's `v1_fwd_ms`,
`v1_fwdbwd_ms` and `max_rel_err_v1` (the fused conv with one sample per
block, which no JAX subcommand times); in `layout`, `max_rel_err_vm_kernel`;
in `fuse`, each variant's `max_rel_err`; in `bmapply`, `max_rel_err_cf`; in
`chain`, `max_rel_err_cfv` (the transposed-backward arm against
batch-major); in `parts`, `max_rel_err` (the part's output against the
plain route's); in `serve`, `launches_per_decode_call` (kernel launches of
one engine decode call); in `trace`, `wall_ms_per_step`,
`untraced_wall_ms_per_step`, `kernels_per_step` (`ops_per_step` on the
CPU), `padded` and `time` (what was attributed);
`http` prints one JSON line of its quantiles (JAX's prints `#` lines only).
Errors are max|got - ref| / max|ref| against the plain route on the same
inputs. In `conv`, `layout`, `fuse` and `bmapply` the plain route is built
from the plain functions themselves, so CAPE_TPU_PALLAS cannot put it on
a kernel; `parts` builds it on a use_pallas=False context and refuses
CAPE_TPU_PALLAS=1.

Timing (`time_routes`): CUDA events; the routes of a line take turns, each
timing runs of back-to-back calls between one pair of events, and report
the median over rounds of the mean per call. The JAX tool chains calls in a
`fori_loop` to beat a remote TPU's ~29 ms sync; a local GPU needs no
chaining: `--inner` (`chain`, `serve`, `artifact`) is the calls between one
pair of events. Fwd+bwd is one gradient step on x of sum(y**2), as in JAX
(`chain`: the gradient of sum(chain(x))). `step` and the single-call
latencies are host-clock times around synchronized calls; `http` and
`concurrency` are client-side host-clock times.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# train steps per timed group of `step`, after one group of warm-up
STEP_GROUPS = 6
# the batches `serve` times
SERVE_BATCHES = (1, 16, 64)
# `trace`: warm-up steps, then the steps under the profiler
TRACE_WARMUP, TRACE_STEPS = 3, 4


def time_routes(routes: dict, warmup: int = 3, rounds: int = 10, calls: int = 10) -> dict:
    """ms per call of each route (a name -> a callable) by CUDA events.
    After `warmup` calls of each, `rounds` rounds in which the routes take
    turns, in reverse order every other round; in each, a route times
    `calls` back-to-back calls between one pair of events. Returns each
    route's median over the rounds of its mean per call. Raises without a
    GPU: the lab reports device times only."""
    if not torch.cuda.is_available():
        raise RuntimeError("perf_lab times with CUDA events: it needs a CUDA GPU")
    for fn in routes.values():
        for _ in range(warmup):
            fn()
    names, times = list(routes), {name: [] for name in routes}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            fn = routes[name]
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def _fwd(fn, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return fn(x)


def _timed_fwd_bwd(routes: dict) -> dict:
    """`{name}_fwd_ms` and `{name}_fwdbwd_ms` of each route (a name -> a
    function and its input x), all timed in turns."""
    timed = {}
    for name, (fn, x) in routes.items():
        timed[f"{name}_fwd_ms"] = functools.partial(_fwd, fn, x)
        timed[f"{name}_fwdbwd_ms"] = functools.partial(_grad_step, fn, x)
    return time_routes(timed)


def _plain_conv(x: torch.Tensor, lap, w: torch.Tensor) -> torch.Tensor:
    """The plain route of one K=2 conv, y = x W0 + (L~ x) W1 with the plain
    banded apply: cheb_conv's sum of orders without its routing gate, so
    neither the op's config nor CAPE_TPU_PALLAS can put it on a kernel."""
    return torch.matmul(x, w[0]) + torch.matmul(lap(x), w[1])


def _grad_step(fn, x: torch.Tensor) -> torch.Tensor:
    """x - 1e-6 * d sum(fn(x)**2) / dx: the JAX lab's fwd+bwd unit."""
    xr = x.detach().requires_grad_()
    (g,) = torch.autograd.grad((fn(xr) ** 2).sum(), xr)
    return x - 1e-6 * g


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-9))


@functools.cache
def _flagship_ctx(dtype_name: str, padded: bool, device: str):
    """The flagship's graph context (`tools.flagship`) in `dtype_name`, on
    `device`."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.tools.flagship import flagship_config

    cfg = flagship_config(compute_dtype=dtype_name, padded_layout=padded)
    return build_context(cfg, device=device)


def _inputs(rng, shape, dtype, device, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=dtype, device=device)


def _device_name(device: str) -> str:
    return torch.cuda.get_device_name(torch.device(device)) if device.startswith("cuda") else device


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def cmd_conv(args):
    """One K=2 Chebyshev conv at a flagship level: the plain route against
    v2 (band-apply kernel), v5 (fused kernel, v5's group) and v1 (fused
    kernel, one sample per block), fwd and fwd+bwd, f32 and bf16. v2 and
    v1 take the natural layout only, as in JAX."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import cheb2_banded, cheb2_banded_v2, cheb2_banded_v5

    B, C, Fo = args.batch, args.channels, args.channels
    padded = bool(args.padded)
    for dtype_name, dt in DTYPES.items():
        ctx = _flagship_ctx(dtype_name, padded, args.device)
        lap = ctx.lap[args.level]
        V = lap.p_rows if padded else lap.n_rows
        rng = np.random.default_rng(0)
        x = _inputs(rng, (B, V, C), dt, args.device)
        w = _inputs(rng, (2, C, Fo), dt, args.device, scale=0.1)
        routes = {
            "plain": lambda x: _plain_conv(x, lap, w),
            "v5": lambda x: cheb2_banded_v5(x, lap, w),
        }
        if not padded:  # v2 and v1 predate the padded layout
            routes["v2"] = lambda x: cheb2_banded_v2(x, lap, w)
            routes["v1"] = lambda x: cheb2_banded(x, lap, w)
        r = _timed_fwd_bwd({name: (fn, x) for name, fn in routes.items()})
        with torch.no_grad():
            ref = routes["plain"](x)[:, : lap.n_rows]
            for name in routes:
                if name != "plain":
                    r[f"max_rel_err_{name}"] = _rel_err(routes[name](x)[:, : lap.n_rows], ref)
        _emit({"conv": dtype_name, "B": B, "C": C, "level": args.level, "padded": padded,
               **r, "device": _device_name(args.device)})


class _BandVM(torch.autograd.Function):
    """L~ applied to vertex-major x [V, M] by the band-apply kernel over the
    op's gather pack; the backward is the same apply (the rescaled
    Laplacian is symmetric)."""

    @staticmethod
    def forward(ctx, xv, blocks, pad_left, pack):
        from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply

        ctx.save_for_backward(blocks)
        ctx.pad_left, ctx.pack = pad_left, pack
        return band_apply(xv.contiguous()[None], blocks, pad_left, xv.shape[0], pack=pack)[0]

    @staticmethod
    def backward(ctx, g):
        (blocks,) = ctx.saved_tensors
        return _BandVM.apply(g, blocks, ctx.pad_left, ctx.pack), None, None, None


def cmd_layout(args):
    """The activation layout of one K=2 conv at flagship level 0:
    batch-major [B, V, C] (the plain route) against vertex-major [V, B*C]
    (the band einsum becomes T [128,128] @ [128, B*C] products, the
    projection one [V*B, C] @ [C, F] product), in plain PyTorch and with
    the band apply on the band-apply kernel, fwd and fwd+bwd."""
    B, C, Fo = args.batch, args.channels, args.channels
    for dtype_name, dt in DTYPES.items():
        ctx = _flagship_ctx(dtype_name, False, args.device)
        lap = ctx.lap[0]
        V = lap.n_rows
        S, T, rb, cb = lap.blocks.shape
        pl_, pr_ = lap.pad_left, lap.pad_right
        blocks = lap.blocks.contiguous()
        rng = np.random.default_rng(0)
        xb = _inputs(rng, (B, V, C), dt, args.device)        # batch-major
        xv = _inputs(rng, (V, B * C), dt, args.device)       # vertex-major
        w = _inputs(rng, (2, C, Fo), dt, args.device, scale=0.1)

        def project(xv, lx):
            y = torch.matmul(xv.reshape(V, B, C), w[0]) + torch.matmul(lx.reshape(V, B, C), w[1])
            return y.reshape(V, B * Fo)

        def conv_vm(xv):
            """K=2 conv, vertex-major merged columns, plain PyTorch."""
            xt = F.pad(xv, (0, 0, pl_, pr_)).reshape(T + S - 1, cb, -1)
            lx = sum(torch.einsum("tij,tjm->tim", blocks[k], xt[k : k + T]) for k in range(S))
            return project(xv, lx.reshape(T * rb, -1)[:V])

        def conv_vm_kernel(xv):
            return project(xv, _BandVM.apply(xv, blocks, pl_, lap.pack))

        r = _timed_fwd_bwd({"bm": (lambda x: _plain_conv(x, lap, w), xb), "vm": (conv_vm, xv),
                            "vm_kernel": (conv_vm_kernel, xv)})
        # vertex-major must match batch-major on the same input
        with torch.no_grad():
            ref = _plain_conv(xb, lap, w)
            xv_same = xb.transpose(0, 1).reshape(V, B * C)
            back = lambda y: y.reshape(V, B, Fo).transpose(0, 1)
            r["max_rel_err"] = _rel_err(back(conv_vm(xv_same)), ref)
            r["max_rel_err_vm_kernel"] = _rel_err(back(conv_vm_kernel(xv_same)), ref)
        _emit({"layout": dtype_name, "B": B, "C": C, **r, "device": _device_name(args.device)})


def cmd_fuse(args):
    """Fusion variants of one K=2 conv: (a) the S shifted band einsums as one
    batched GEMM against blocks concatenated to [T, rb, S*cb]; (b) the
    project-first order y = x W0 + L~(x W1), which applies L~ on F channels
    instead of C; and both. Per variant fwd and fwd+bwd at (C, F)."""
    from cape_tpu_torch.ops.cheb import cheb_conv

    B, C, Fo = args.batch, args.channels, args.fout or args.channels
    names = tuple(DTYPES) if args.dtype == "both" else (args.dtype,)
    for dtype_name in names:
        dt = DTYPES[dtype_name]
        ctx = _flagship_ctx(dtype_name, False, args.device)
        lap = ctx.lap[args.level]
        V = lap.n_rows
        S, T, rb, cb = lap.blocks.shape
        pl_, pr_ = lap.pad_left, lap.pad_right
        rng = np.random.default_rng(0)
        x = _inputs(rng, (B, V, C), dt, args.device)
        w = _inputs(rng, (2, C, Fo), dt, args.device, scale=0.1)
        blocks_cat = lap.blocks.permute(1, 2, 0, 3).reshape(T, rb, S * cb).contiguous()

        def apply_stacked(u):
            """One batched GEMM: win[b, t, m, c] = xp[b, t*cb + m, c], m < S*cb."""
            xp = F.pad(u, (0, 0, pl_, pr_))
            win = torch.cat(
                [xp[:, k * cb : (k + T) * cb].reshape(B, T, cb, -1) for k in range(S)], dim=2
            )
            return torch.einsum("tim,btmc->btic", blocks_cat, win).reshape(B, T * rb, -1)[:, :V]

        variants = {
            "prod": lambda x: cheb_conv(x, lap, w),
            "stacked": lambda x: torch.matmul(x, w[0]) + torch.matmul(apply_stacked(x), w[1]),
            "projfirst": lambda x: torch.matmul(x, w[0]) + lap(torch.matmul(x, w[1])),
            "projfirst_stacked": lambda x: torch.matmul(x, w[0]) + apply_stacked(torch.matmul(x, w[1])),
        }
        errs = {}
        with torch.no_grad():
            ref = variants["prod"](x)
            for name, fn in variants.items():
                errs[name] = _rel_err(fn(x), ref)
                if not errs[name] < 5e-2:
                    raise AssertionError(f"fuse {name}: {errs[name]} against prod")
        t = _timed_fwd_bwd({name: (fn, x) for name, fn in variants.items()})
        for name in variants:
            _emit({"fuse": dtype_name, "B": B, "C": C, "F": Fo, "level": args.level, "S": int(S),
                   "variant": name, "fwd_ms": t[f"{name}_fwd_ms"],
                   "fwdbwd_ms": t[f"{name}_fwdbwd_ms"], "max_rel_err": errs[name],
                   "device": _device_name(args.device)})


def cmd_bmapply(args):
    """The bare band apply, forward only: the plain BandedOp apply against
    the batch-major kernel (kernel 3) and a channels-first [B, C, V] plain
    einsum."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import banded_apply_bm

    B, C = args.batch, args.channels
    names = tuple(DTYPES) if args.dtype == "both" else (args.dtype,)
    for dtype_name in names:
        dt = DTYPES[dtype_name]
        ctx = _flagship_ctx(dtype_name, False, args.device)
        lap = ctx.lap[args.level]
        V = lap.n_rows
        S, T, rb, cb = lap.blocks.shape
        pl_, pr_ = lap.pad_left, lap.pad_right
        blocks = lap.blocks.contiguous()
        x = _inputs(np.random.default_rng(0), (B, V, C), dt, args.device)
        xcf = x.transpose(1, 2).contiguous()

        def kernel_apply(x):
            return banded_apply_bm(x, blocks, pl_, pr_, V, pack=lap.pack)

        def apply_cf(xcf):
            """Channels-first [B, C, V]: the vertex axis minor."""
            xp = F.pad(xcf, (pl_, pr_))
            y = sum(
                torch.einsum("tij,bctj->bcti", blocks[k], xp[..., k * cb : k * cb + T * cb].reshape(B, C, T, cb))
                for k in range(S)
            )
            return y.reshape(B, C, T * rb)[..., :V]

        with torch.no_grad():
            ref = lap(x)
            err = _rel_err(kernel_apply(x), ref)
            err_cf = _rel_err(apply_cf(xcf).transpose(1, 2), ref)
            if not (err < 5e-2 and err_cf < 5e-2):
                raise AssertionError(f"bmapply: kernel {err}, channels-first {err_cf} against plain")
            r = time_routes({"plain_ms": lambda: lap(x), "bm_ms": lambda: kernel_apply(x),
                             "cf_ms": lambda: apply_cf(xcf)})
        r.update(max_rel_err=err, max_rel_err_cf=err_cf)
        _emit({"bmapply": dtype_name, "B": B, "C": C, "level": args.level, "S": S, **r,
               "device": _device_name(args.device)})


def cmd_artifact(args):
    """Decode latency of an exported artifact (`tools.export_model`) on the
    device: ms per call by `time_routes` (`--inner` back-to-back calls per
    event pair), and the single-call latency with dispatch (host clock,
    synchronized, median of 16). Primary use: a compressed export (int8
    weights, bf16 constants) against its f32 twin, or against the live
    engine's decode."""
    from cape_tpu_torch.tools.export_model import ExportedModel

    em = ExportedModel.load(args.path, device=args.device)
    m = em.meta
    if args.batch and not m.get("symbolic_batch"):
        raise SystemExit(
            f"--batch {args.batch} has no effect: {args.path} is a fixed-batch artifact "
            f"(batch_size={m['batch_size']}); only --symbolic-batch exports run at other sizes"
        )
    B = args.batch or m["batch_size"]
    rng = np.random.default_rng(0)
    zt = _inputs(rng, (B, m["nz"] + m["nz_cond"] + m["nz_cond2"]), torch.float32, args.device)
    y = _inputs(rng, (B, m["nz_cond"]), torch.float32, args.device)
    y2 = _inputs(rng, (B, m["nz_cond2"]), torch.float32, args.device)
    call = em._calls["decode"]
    with torch.inference_mode():
        ms = time_routes({"decode": lambda: call(zt, y, y2)}, calls=args.inner)["decode"]
        lats = []
        for i in range(3 + 16):
            t0 = time.perf_counter()
            float(call(zt, y, y2).sum())  # waits for the device
            if i >= 3:
                lats.append(time.perf_counter() - t0)
    lats.sort()
    _emit({"bench": "artifact", "path": args.path, "batch": B, "quantize": m.get("quantize"),
           "constants_dtype": m.get("constants_dtype"), "inner": args.inner,
           "decode_ms_per_call": ms, "decode_meshes_per_sec": B / (ms / 1000.0),
           "single_call_decode_ms_incl_dispatch": 1000.0 * lats[len(lats) // 2],
           "device": _device_name(args.device)})


def _input_grad(fn, x: torch.Tensor) -> torch.Tensor:
    """d sum(fn(x)) / dx: the chain's fwd+bwd unit, as JAX's `bwd_*`."""
    xr = x.detach().requires_grad_()
    (g,) = torch.autograd.grad(fn(xr).sum(), xr)
    return g


def _cf_apply(xcf: torch.Tensor, blocks: torch.Tensor, pad_left: int) -> torch.Tensor:
    """A band apply on channels-first [B, C, P] over the shifted blocks
    [S, T, rb, cb]: the halo padded on the vertex (minor) axis, each
    window already cb-minor, so consecutive convs convert no layout."""
    S, T, rb, cb = blocks.shape
    pad_right = max((T + S - 1) * cb - pad_left - xcf.shape[-1], 0)
    xp = F.pad(xcf, (pad_left, pad_right))
    y = None
    for k in range(S):
        view = xp[..., k * cb : k * cb + T * cb].reshape(*xcf.shape[:-1], T, cb)
        term = torch.einsum("tij,bctj->bcti", blocks[k].to(xcf.dtype), view)
        y = term if y is None else y + term
    return y.reshape(*xcf.shape[:-1], T * rb)


class _BandCF(torch.autograd.Function):
    """`_cf_apply` whose backward is the transposed apply over the op's
    `t_blocks`, the hand-written backward of the production BandedOp, in
    place of autograd through the pad and the windows (JAX's `cf_banded`
    custom VJP)."""

    @staticmethod
    def forward(ctx, xcf, op):
        ctx.op = op
        return _cf_apply(xcf, op.blocks, op.pad_left)

    @staticmethod
    def backward(ctx, g):
        return _cf_apply(g, ctx.op.t_blocks, ctx.op.t_pad_left), None


def chain_arms(lap, ws: torch.Tensor, bs: torch.Tensor) -> dict:
    """The chain's three arms: N = len(ws) stacked K-order convs (weights
    ws [N, K, C, C], biases bs [N, C]), each + bias and leaky ReLU 0.2, in
    the persistent-padded layout of `lap` (a padded BandedOp).
      bm:  batch-major [B, P, C] through `ops.cheb.cheb_conv`, so the
           routing gate sends each conv where production sends it;
      cf:  channels-first [B, C, P] over `lap.blocks`, plain torch, autograd
           through the pad and the windows;
      cfv: cf with the transposed apply as its backward (`_BandCF`)."""
    from cape_tpu_torch.ops.cheb import cheb_conv

    def bm(x):
        for w, b in zip(ws, bs):
            x = F.leaky_relu(cheb_conv(x, lap, w) + b, 0.2)
        return x

    def cheb_cf(xcf, apply, w):
        xs = [xcf]
        if w.shape[0] > 1:
            xs.append(apply(xcf))
        for _ in range(2, w.shape[0]):
            xs.append(2.0 * apply(xs[-1]) - xs[-2])
        return sum(torch.einsum("bcv,co->bov", xk, w[k].to(xcf.dtype)) for k, xk in enumerate(xs))

    def cf_chain(apply):
        def run(xcf):
            for w, b in zip(ws, bs):
                xcf = F.leaky_relu(cheb_cf(xcf, apply, w) + b[None, :, None], 0.2)
            return xcf
        return run

    return {"bm": bm, "cf": cf_chain(lambda v: _cf_apply(v, lap.blocks, lap.pad_left)),
            "cfv": cf_chain(lambda v: _BandCF.apply(v, lap))}


def cmd_chain(args):
    """Cross-op layout A/B: `--depth` stacked K-order convs (+ bias + leaky
    ReLU) with resident activations at a flagship level, padded, in the
    three arms of `chain_arms`. Both channels-first arms are held to
    batch-major (padded tails excluded, 5e-2 as in JAX). Times: each arm's
    forward and fwd+bwd (d sum(chain(x)) / dx), in turns."""
    B, C, K, N = args.batch, args.channels, args.k, args.depth
    names = tuple(DTYPES) if args.dtype == "both" else (args.dtype,)
    for dtype_name in names:
        dt = DTYPES[dtype_name]
        lap = _flagship_ctx(dtype_name, True, args.device).lap[args.level]
        rng = np.random.default_rng(0)
        ws = _inputs(rng, (N, K, C, C), dt, args.device, scale=0.3)
        bs = _inputs(rng, (N, C), dt, args.device, scale=0.1)
        x_bm = _inputs(rng, (B, lap.p_cols, C), dt, args.device)
        x_cf = x_bm.transpose(1, 2).contiguous()
        arms = chain_arms(lap, ws, bs)
        nat = lap.n_rows
        with torch.no_grad():
            out_bm = arms["bm"](x_bm)[:, :nat]
            errs = {name: _rel_err(arms[name](x_cf).transpose(1, 2)[:, :nat], out_bm)
                    for name in ("cf", "cfv")}
        if not all(e < 5e-2 for e in errs.values()):
            raise AssertionError(f"chain: channels-first arms {errs} against batch-major")
        r = time_routes({
            "bm_fwd_ms": functools.partial(_fwd, arms["bm"], x_bm),
            "cf_fwd_ms": functools.partial(_fwd, arms["cf"], x_cf),
            "bm_fwdbwd_ms": functools.partial(_input_grad, arms["bm"], x_bm),
            "cf_fwdbwd_ms": functools.partial(_input_grad, arms["cf"], x_cf),
            "cfv_fwdbwd_ms": functools.partial(_input_grad, arms["cfv"], x_cf),
        }, calls=args.inner)
        _emit({"chain": dtype_name, "B": B, "C": C, "K": K, "depth": N, "level": args.level,
               **r, "max_rel_err": errs["cf"], "max_rel_err_cfv": errs["cfv"],
               "device": _device_name(args.device)})


def part_outputs(model, ctx, x, y, y2, zt) -> dict:
    """The lab's three parts as functions of a carrier u shaped like x, each
    returning the output whose sum of squares is the part's loss (JAX's
    `parts`): enc, the encoder's z_mean on x + u; dec, the decoder's mesh
    on zt + 1e-9 sum(u) (the carrier makes every call depend on u); disc,
    the discriminator's logits on x + u."""
    return {
        "enc": lambda u: model.encode(ctx, x + u, y, y2)[0],
        "dec": lambda u: model.decode(ctx, zt + u.sum() * 1e-9, y, y2),
        "disc": lambda u: model.discriminate(ctx, x + u, y, y2),
    }


def cmd_parts(args):
    """Encoder, decoder and discriminator of the flagship (natural layout,
    as JAX's), forward against forward+backward with respect to the
    carrier (`part_outputs`), the six in turns. Each part's loss is held
    to the plain route's (`max_rel_err` of its output, which bounds its
    loss's): the same model on a context built with use_pallas=False.
    CAPE_TPU_PALLAS=1 would put that context's convs on the kernels too,
    so `parts` refuses it, as the export does."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.tools.flagship import flagship_setup

    if kernels.override() is True:
        raise ValueError("parts: CAPE_TPU_PALLAS=1 puts the plain reference on the kernels "
                         "too; unset it")
    B = args.batch
    cfg, model, ctx = flagship_setup(args.dtype, args.device, name="perflab", batch_size=B,
                                     padded_layout=False)
    ctx_plain = build_context(cfg.replace(use_pallas=False), device=args.device)
    rng = np.random.default_rng(0)
    f32 = torch.float32
    x = _inputs(rng, (B, ctx.level_sizes[0], 3), f32, args.device)
    y = _inputs(rng, (B, cfg.nz_cond), f32, args.device)
    y2 = _inputs(rng, (B, cfg.nz_cond2), f32, args.device)
    zt = _inputs(rng, (B, cfg.nz + cfg.nz_cond + cfg.nz_cond2), f32, args.device)
    u0 = torch.zeros_like(x)
    parts = part_outputs(model, ctx, x, y, y2, zt)
    plain = part_outputs(model, ctx_plain, x, y, y2, zt)
    t = _timed_fwd_bwd({name: (fn, u0) for name, fn in parts.items()})
    out = {}
    with torch.no_grad():
        for name, fn in parts.items():
            fwd, fwdbwd = t[f"{name}_fwd_ms"], t[f"{name}_fwdbwd_ms"]
            out[name] = {"fwd_ms": fwd, "fwdbwd_ms": fwdbwd, "ratio": fwdbwd / fwd,
                         "max_rel_err": _rel_err(fn(u0), plain[name](u0))}
            _emit({"part": name, "dtype": args.dtype, **out[name],
                   "device": _device_name(args.device)})
    return out


def _trainer(args, name: str, **overrides):
    """The flagship's Trainer at --batch and --dtype on synthetic data, and
    its G and D index streams: what `step` and `trace` drive. Its step
    noise is JAX's lab's, fold_in(PRNGKey(0), step)."""
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.tools.flagship import flagship_setup
    from cape_tpu_torch.train.loop import Trainer

    # seed 0: the JAX lab's parameters and step noise, PRNGKey(0)
    cfg, model, ctx = flagship_setup(args.dtype, args.device, name=name, batch_size=args.batch,
                                     padded_layout=bool(args.padded), seed=0, **overrides)
    data = synthetic_bodydata(n_train=max(256, 2 * args.batch) + 64, n_test=8,
                              num_verts=ctx.level_sizes[0], seed=0)
    trainer = Trainer(cfg, model, ctx, data)
    n = len(data.disp_train)
    return trainer, BatchStream(n, args.batch, 0), BatchStream(n, args.batch, 1)


def cmd_step(args):
    """The flagship GAN train step at --batch and --dtype (--padded,
    --remat, --fuse): groups of --k steps back to back with one host sync
    at the end (the port's meaning of steps_per_dispatch), one group of
    warm-up, then STEP_GROUPS timed on the host clock; the median ms per
    step. Every metric of the last step must be finite."""
    trainer, sg, sd = _trainer(args, "perflab_step", remat=bool(args.remat),
                               fuse_decoder=bool(args.fuse))
    K = args.k
    float(trainer.run_steps(K, sg, sd)[-1]["loss_g"])
    times = []
    for _ in range(STEP_GROUPS):
        t0 = time.perf_counter()
        metrics = trainer.run_steps(K, sg, sd)[-1]
        float(metrics["loss_g"])  # waits for the device
        times.append((time.perf_counter() - t0) / K)
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"step: non-finite metrics {m}")
    ms = 1000.0 * statistics.median(times)
    line = {"step_ms": ms, "steps_per_sec": 1000.0 / ms, "dtype": args.dtype,
            "batch": args.batch, "steps_per_dispatch": K, "padded": bool(args.padded),
            "fuse_decoder": bool(args.fuse), "device": _device_name(args.device)}
    _emit(line)
    return line


def cmd_serve(args):
    """Serving on the flagship at batches SERVE_BATCHES: the decode call
    and the reconstruction (encode + decode) call on device-resident
    inputs, timed in turns by `time_routes` (--inner calls per event
    pair); then one InferenceEngine.decode call, as a server makes it
    (numpy in and out, host copies and the vertex permutation included),
    on the host clock: the median of 16 after 3 warm-up calls, and the
    kernel launches it made."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.ops.kernels import counts
    from cape_tpu_torch.tools.flagship import flagship_setup

    cfg, model, ctx = flagship_setup(args.dtype, args.device, name="perflab_serve",
                                     padded_layout=bool(args.padded))
    # n_train covers the largest batch after the default val carve-out
    data = synthetic_bodydata(n_train=160, n_test=8, num_verts=ctx.level_sizes[0], seed=0)
    perm = ctx.perm0
    rng = np.random.default_rng(0)
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=args.device)
    lines = []
    for B in SERVE_BATCHES:
        disp = data.disp_train[:B] if perm is None else data.disp_train[:B][:, perm]
        x = dev(disp)
        z = _inputs(rng, (B, cfg.nz), torch.float32, args.device)
        with torch.inference_mode():
            y, y2 = model.embed_conditions(dev(data.pose_train[:B]), dev(data.clo_train[:B]))
            zt = torch.cat([z, y, y2], -1)

            def reconstruct():
                z_mean, _ = model.encode(ctx, x, y, y2)
                return model.decode(ctx, torch.cat([z_mean, y, y2], -1), y, y2)

            t = time_routes({"decode": lambda: model.decode(ctx, zt, y, y2),
                             "reconstruct": reconstruct}, calls=args.inner)
        engine = InferenceEngine(model, ctx, B, device=args.device)
        host = [a.float().cpu().numpy() for a in (zt, y, y2)]
        before = counts["band_apply.conv"]
        engine.decode(*host)
        launches = counts["band_apply.conv"] - before
        lats = []
        for i in range(3 + 16):
            t0 = time.perf_counter()
            engine.decode(*host)  # numpy out: waits for the device
            if i >= 3:
                lats.append(time.perf_counter() - t0)
        line = {"bench": "serve", "batch": B, "dtype": args.dtype, "padded": bool(args.padded),
                "inner": args.inner, "decode_ms_per_call": t["decode"],
                "decode_meshes_per_sec": B / (t["decode"] / 1000.0),
                "reconstruct_ms_per_call": t["reconstruct"],
                "reconstruct_samples_per_sec": B / (t["reconstruct"] / 1000.0),
                "single_call_decode_ms_incl_dispatch": 1000.0 * statistics.median(lats),
                "launches_per_decode_call": launches, "device": _device_name(args.device)}
        _emit(line)
        lines.append(line)
    return lines


# kernel-name fragments of the port's CUDA kernels (cape_tpu_torch/csrc/)
PORT_KERNELS = ("band_gather_kernel", "cheb2_fused_kernel", "cheb2_window_kernel")
_GEMM = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "splitkreduce",
         "aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::linear", "aten::einsum")
_COPY = ("copy", "memset", "memcpy", "fill", "aten::cat", "aten::clone", "aten::contiguous",
         "aten::constant_pad_nd", "aten::zero_", "aten::index_select", "aten::stack")
_REDUCE = ("reduce", "norm", "softmax", "aten::sum", "aten::mean", "aten::max", "aten::min",
           "aten::amax", "aten::var", "aten::std", "aten::logsumexp")
_ELEMENTWISE = ("elementwise", "aten::add", "aten::sub", "aten::mul", "aten::div",
                "aten::leaky_relu", "aten::relu", "aten::where", "aten::abs", "aten::neg",
                "aten::exp", "aten::log", "aten::pow", "aten::sqrt", "aten::rsqrt",
                "aten::tanh", "aten::sigmoid", "aten::clamp", "aten::threshold_backward",
                "aten::sgn", "aten::lerp", "aten::maximum", "aten::minimum", "aten::gt",
                "aten::lt", "aten::ge", "aten::le", "aten::eq")


def category(name: str, cat: str = "kernel") -> str:
    """The trace's category of a device kernel (by its name and trace
    category) or, on the CPU, of an aten operator, first match wins:
      port kernel  the port's CUDA kernels (`PORT_KERNELS`);
      copy/memset  memcpy and memset events, copy and fill kernels; on the
                   CPU cat, clone, pad, index_select, zero_;
      gemm         cuBLAS and CUTLASS kernels (gemm, gemv, cutlass, xmma,
                   nvjet, splitKreduce); on the CPU mm, bmm, addmm, matmul,
                   einsum;
      reduction    reduce kernels, norms, softmax; on the CPU sum, mean, ...;
      elementwise  PyTorch's elementwise kernels; on the CPU the pointwise
                   arithmetic operators;
      other        the rest (indexing, scatter, sort, views ...)."""
    n = name.lower()
    if any(s in n for s in PORT_KERNELS):
        return "port kernel"
    if cat in ("gpu_memcpy", "gpu_memset") or any(s in n for s in _COPY):
        return "copy/memset"
    for label, keys in (("gemm", _GEMM), ("reduction", _REDUCE), ("elementwise", _ELEMENTWISE)):
        if any(s in n for s in keys):
            return label
    return "other"


def kernel_family(name: str) -> str:
    """A kernel's name without its template arguments, argument list,
    leading `void` and anonymous namespaces."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


def _frame(name: str) -> str | None:
    """A python_function event's frame, from `cape_tpu_torch/` on; None
    for a frame outside the port."""
    i = name.find("cape_tpu_torch/")
    return None if i < 0 else name[i:]


def _sweep(events: list) -> dict:
    """One pass over a thread's X events in time order. For every cpu_op
    and cuda_runtime/cuda_driver event: the innermost enclosing cpu_op
    (name) and the innermost enclosing python frame under cape_tpu_torch/.
    For every cpu_op also its self time (its duration less its direct
    child operators'). Returns id(event) -> [operator, frame, self_us]."""
    out = {}
    stack: list = []   # open (end, event) of python frames and operators
    for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
        while stack and stack[-1][0] <= e["ts"]:
            stack.pop()
        cat = e.get("cat")
        if cat != "python_function":
            op = next((s for _, s in reversed(stack) if s.get("cat") == "cpu_op"), None)
            frame = next((f for f in (_frame(s["name"]) for _, s in reversed(stack)
                                      if s.get("cat") == "python_function") if f), None)
            out[id(e)] = [op["name"] if op else None, frame, e.get("dur", 0)]
            if cat == "cpu_op" and op is not None:
                out[id(op)][2] -= e.get("dur", 0)
        if cat in ("cpu_op", "python_function"):
            stack.append((e["ts"] + e.get("dur", 0), e))
    return out


def attribute(events: list, n_steps: int, top: int = 20, device_time: bool = True) -> dict:
    """Attribution of a torch.profiler Chrome trace's events (`traceEvents`)
    over n_steps steps. device_time=True: every device event (cat kernel,
    gpu_memcpy, gpu_memset) with its device duration; each is linked by its
    `correlation` to the cudaLaunchKernel (or driver) call that issued it,
    and from there to the innermost aten operator and the innermost
    cape_tpu_torch frame enclosing that call on its host thread (a kernel
    launched from Python through ctypes has no operator: "-"). False (a
    CPU-only trace): every cpu_op with its self time. Returns
      ms_per_step, events_per_step,
      by_category: [(category, us/step, count/step)], by total time;
      by_operator: [(operator, frame, us/step, count/step)], top `top`;
      by_kernel:   [(kernel_family, operator, us/step, count/step)], top `top`;
      family_counts: {kernel_family: count/step}, every family.
    No byte or operation counts: the trace carries none, so no rates."""
    import collections

    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    threads = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") in ("cpu_op", "python_function", "cuda_runtime", "cuda_driver"):
            threads[(e.get("pid"), e.get("tid"))].append(e)
    where = {}
    for evs in threads.values():
        where.update(_sweep(evs))
    if device_time:
        launch = {e["args"]["correlation"]: where[id(e)] for e in xs
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        units = []
        for e in xs:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                op, frame, _ = launch.get(e.get("args", {}).get("correlation"), (None, None, 0))
                units.append((e["name"], e.get("cat"), op, frame, e.get("dur", 0)))
    else:
        units = [(e["name"], "cpu_op", e["name"], where[id(e)][1], where[id(e)][2])
                 for e in xs if e.get("cat") == "cpu_op"]
    by_cat = collections.defaultdict(lambda: [0.0, 0])
    by_op = collections.defaultdict(lambda: [0.0, 0])
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    families = collections.Counter()
    for name, cat, op, frame, us in units:
        for table, key in ((by_cat, category(name, cat)), (by_op, (op or "-", frame or "-")),
                           (by_kernel, (kernel_family(name), op or "-"))):
            table[key][0] += us
            table[key][1] += 1
        families[kernel_family(name)] += 1
    rank = lambda table, n=None: sorted(table.items(), key=lambda kv: -kv[1][0])[:n]
    per = lambda v: (v[0] / n_steps, v[1] / n_steps)
    return {
        "ms_per_step": sum(u[-1] for u in units) / 1000.0 / n_steps,
        "events_per_step": len(units) / n_steps,
        "by_category": [(k, *per(v)) for k, v in rank(by_cat)],
        "by_operator": [(*k, *per(v)) for k, v in rank(by_op, top)],
        "by_kernel": [(*k, *per(v)) for k, v in rank(by_kernel, top)],
        "family_counts": {k: v / n_steps for k, v in families.items()},
    }


def cmd_trace(args):
    """A torch.profiler trace of TRACE_STEPS flagship train steps (after
    TRACE_WARMUP warm-up steps), CPU and, on a GPU, CUDA activity, with
    Python stacks; the Chrome trace goes to <--out>/trace.json (a temp
    directory by default). Prints one JSON line (device ms per step; the
    host window around the traced steps as wall_ms_per_step, which holds
    the profiler's own host overhead, and around as many steps just before
    them, untraced, as untraced_wall_ms_per_step: device ms over the
    untraced window is the device's busy share) and then `#` lines of
    `attribute`: by category, by launching operator and frame, by kernel
    name. On --device cpu it attributes CPU operator self time instead
    (cpu_op_self_ms_per_step)."""
    import tempfile

    on_device = torch.device(args.device).type == "cuda"
    trainer, sg, sd = _trainer(args, "perflab_trace")
    float(trainer.run_steps(TRACE_WARMUP, sg, sd)[-1]["loss_g"])
    t0 = time.perf_counter()
    float(trainer.run_steps(TRACE_STEPS, sg, sd)[-1]["loss_g"])
    untraced_ms = 1000.0 * (time.perf_counter() - t0) / TRACE_STEPS
    log_dir = args.out or tempfile.mkdtemp(prefix="cape_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_device:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, with_stack=True) as prof:
        t0 = time.perf_counter()
        float(trainer.run_steps(TRACE_STEPS, sg, sd)[-1]["loss_g"])  # waits for the device
        wall_ms = 1000.0 * (time.perf_counter() - t0) / TRACE_STEPS
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        payload = json.load(f)
    events = payload if isinstance(payload, list) else payload.get("traceEvents", [])
    att = attribute(events, TRACE_STEPS, args.top, device_time=on_device)
    timed = "device" if on_device else "cpu_op_self"
    unit = "kernels" if on_device else "ops"
    line = {f"{timed}_ms_per_step": att["ms_per_step"], "wall_ms_per_step": wall_ms,
            "untraced_wall_ms_per_step": untraced_ms,
            f"{unit}_per_step": att["events_per_step"], "batch": args.batch,
            "dtype": args.dtype, "padded": bool(args.padded), "trace_dir": log_dir,
            "time": "device kernel time" if on_device else "cpu operator self time (no device)",
            "device": _device_name(args.device)}
    _emit(line)
    print("# by category (us/step, count/step; no GB/s: the trace has no byte counts):")
    for cat, us, n in att["by_category"]:
        print(f"#  {us:10.1f} {n:7.1f}  {cat}")
    print("# by launching operator and innermost cape_tpu_torch frame (us/step, count/step):")
    for op, frame, us, n in att["by_operator"]:
        print(f"#  {us:10.1f} {n:7.1f}  {op:36.36s} {frame}")
    print("# by kernel name (us/step, count/step, name, launching operator):")
    for name, op, us, n in att["by_kernel"]:
        print(f"#  {us:10.1f} {n:7.1f}  {name:60.60s} {op}")
    sys.stdout.flush()
    return {**line, **att}


def _quantile(sorted_ms: list, p: float) -> float:
    return sorted_ms[min(len(sorted_ms) - 1, int(p * len(sorted_ms)))]


def cmd_http(args):
    """End-to-end serving latency through the HTTP stack against a live
    server (`python -m cape_tpu_torch.apps.server ...`): what a remote
    client sees, JSON or npz encode + socket + device work + decode. Its
    difference from `serve`'s single-call latency is the server stack's
    share. Prints client-side p50/p95 per wire and endpoint, the server's
    own /stats quantiles, and one JSON line of the same numbers."""
    from cape_tpu_torch.apps.client import CapeClient

    wires = ("npz", "json") if args.wire == "both" else (args.wire,)
    probe = CapeClient(args.url)
    h = probe.health()
    print(f"# target {args.url}: model={h['model']} batch={h['batch_size']} "
          f"dtype={h['compute_dtype']}")
    rng = np.random.default_rng(0)
    pose = np.zeros((1, h["cond_dim"]), np.float32)
    clo = np.zeros((1, h["cond2_dim"]), np.float32)
    disp = (rng.standard_normal((args.batch, h["num_verts"], 3)) * 0.01).astype(np.float32)
    pose_b = np.repeat(pose, args.batch, 0)
    clo_b = np.repeat(clo, args.batch, 0)

    def bench(label, fn):
        for _ in range(3):
            fn()
        lats = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            lats.append(1000.0 * (time.perf_counter() - t0))
        lats.sort()
        p50, p95 = _quantile(lats, 0.50), _quantile(lats, 0.95)
        print(f"#  {label:<34} p50 {p50:8.2f} ms  p95 {p95:8.2f} ms  "
              f"({args.batch / (p50 / 1000.0):8.1f} mesh/s at p50)")
        return {"p50_ms": p50, "p95_ms": p95}

    out = {"bench": "http", "batch": args.batch, "reps": args.reps}
    for wire in wires:
        c = CapeClient(args.url, wire=wire)
        out[wire] = {
            "sample": bench(f"[{wire}] sample n={args.batch}",
                            lambda: c.sample(pose, clo, n=args.batch, seed=1)),
            "reconstruct": bench(f"[{wire}] reconstruct batch={args.batch}",
                                 lambda: c.reconstruct(disp, pose_b, clo_b)),
        }
    print("# server-side /stats (device work + parse, excl. socket+client):")
    out["server"] = {}
    for ep, s in probe.stats().items():
        if "requests" not in s:
            continue  # the "(micro_batch)" counts
        print(f"#  {ep:<20} n={s['requests']:<5} p50 {s['latency_ms_p50']} ms "
              f"p95 {s['latency_ms_p95']} ms")
        out["server"][ep] = {k: s[k] for k in ("requests", "latency_ms_p50", "latency_ms_p95")}
    _emit(out)
    return out


def cmd_concurrency(args):
    """Aggregate serving throughput under concurrent load against a live
    server: --threads clients each send /sample requests (--rows meshes
    each) for --seconds. Reports req/s, mesh/s, client latency quantiles
    and, from the "(micro_batch)" block of /stats, the decode requests per
    device call. A/B: run against a default server, then one started with
    --no-micro-batch."""
    import concurrent.futures

    from cape_tpu_torch.apps.client import CapeClient

    probe = CapeClient(args.url)
    h = probe.health()
    print(f"# target {args.url}: model={h['model']} batch={h['batch_size']} "
          f"dtype={h['compute_dtype']} threads={args.threads} rows={args.rows}")
    pose = np.zeros((1, h["cond_dim"]), np.float32)
    clo = np.zeros((1, h["cond2_dim"]), np.float32)
    probe.sample(pose, clo, n=args.rows, seed=0)  # warm-up
    mb0 = probe.stats().get("(micro_batch)")
    stop_at = time.monotonic() + args.seconds

    def worker(i):
        c = CapeClient(args.url)
        lats, errors = [], 0
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            try:
                c.sample(pose, clo, n=args.rows, seed=i)
            except Exception:
                errors += 1  # a load bench keeps partial results on failures
                continue
            lats.append(1000.0 * (time.perf_counter() - t0))
        return lats, errors

    t_start = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(args.threads) as ex:
        results = list(ex.map(worker, range(args.threads)))
    elapsed = max(time.monotonic() - t_start, 1e-9)
    all_lats = sorted(v for lats, _ in results for v in lats)
    n_err = sum(e for _, e in results)
    if not all_lats:
        raise SystemExit(f"no request completed ({n_err} errors): is the server up?")
    out = {
        "bench": "concurrency", "threads": args.threads, "rows": args.rows,
        "seconds": elapsed, "requests": len(all_lats), "errors": n_err,
        "req_per_sec": len(all_lats) / elapsed,
        "meshes_per_sec": len(all_lats) * args.rows / elapsed,
        "latency_ms_p50": _quantile(all_lats, 0.50), "latency_ms_p95": _quantile(all_lats, 0.95),
    }
    mb1 = probe.stats().get("(micro_batch)")
    if mb0 and mb1:
        dreq = mb1["decode_requests"] - mb0["decode_requests"]
        dcall = mb1["decode_calls"] - mb0["decode_calls"]
        out["decode_requests_per_device_call"] = dreq / max(1, dcall)
    _emit(out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m cape_tpu_torch.tools.perf_lab")
    p.add_argument("--device", default="cuda")
    sub = p.add_subparsers(dest="cmd")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=argparse.SUPPRESS)
    pc = sub.add_parser("conv", parents=[dev])
    pc.add_argument("--batch", type=int, default=16)
    pc.add_argument("--channels", type=int, default=64)
    pc.add_argument("--level", type=int, default=0)
    pc.add_argument("--padded", type=int, default=0)
    pl = sub.add_parser("layout", parents=[dev])
    pl.add_argument("--batch", type=int, default=16)
    pl.add_argument("--channels", type=int, default=64)
    pf = sub.add_parser("fuse", parents=[dev])
    pf.add_argument("--batch", type=int, default=16)
    pf.add_argument("--channels", type=int, default=64)
    pf.add_argument("--fout", type=int, default=None)
    pf.add_argument("--level", type=int, default=0)
    pf.add_argument("--dtype", default="both", choices=("both", *DTYPES))
    pb = sub.add_parser("bmapply", parents=[dev])
    pb.add_argument("--batch", type=int, default=16)
    pb.add_argument("--channels", type=int, default=64)
    pb.add_argument("--level", type=int, default=0)
    pb.add_argument("--dtype", default="bfloat16", choices=("both", *DTYPES))
    pch = sub.add_parser("chain", parents=[dev])
    pch.add_argument("--batch", type=int, default=16)
    pch.add_argument("--channels", type=int, default=64)
    pch.add_argument("--k", type=int, default=2)
    pch.add_argument("--depth", type=int, default=4)
    pch.add_argument("--level", type=int, default=0)
    pch.add_argument("--dtype", default="bfloat16", choices=("both", *DTYPES))
    pch.add_argument("--inner", type=int, default=10)
    pp = sub.add_parser("parts", parents=[dev])
    pp.add_argument("--batch", type=int, default=16)
    pp.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ps = sub.add_parser("step", parents=[dev])
    ps.add_argument("--batch", type=int, default=16)
    ps.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ps.add_argument("--k", type=int, default=8, help="steps per host sync")
    ps.add_argument("--padded", type=int, default=0, help="persistent-padded layout")
    ps.add_argument("--remat", type=int, default=0, help="checkpoint each block")
    ps.add_argument("--fuse", type=int, default=0, help="fused decoder unpool (cfg.fuse_decoder)")
    pt = sub.add_parser("trace", parents=[dev])
    pt.add_argument("--batch", type=int, default=16)
    pt.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    pt.add_argument("--out", default=None, help="trace output dir")
    pt.add_argument("--top", type=int, default=20)
    pt.add_argument("--padded", type=int, default=0, help="persistent-padded layout")
    pv = sub.add_parser("serve", parents=[dev])
    pv.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    pv.add_argument("--padded", type=int, default=1, help="persistent-padded layout")
    pv.add_argument("--inner", type=int, default=10)
    ph = sub.add_parser("http", parents=[dev])
    ph.add_argument("--url", default="http://127.0.0.1:8080")
    ph.add_argument("--batch", type=int, default=16)
    ph.add_argument("--reps", type=int, default=50)
    ph.add_argument("--wire", default="both", choices=("both", "npz", "json"))
    pa = sub.add_parser("artifact", parents=[dev])
    pa.add_argument("path", help=".capex artifact to time")
    pa.add_argument("--batch", type=int, default=None,
                    help="batch size (symbolic-batch artifacts only)")
    pa.add_argument("--inner", type=int, default=10)
    pn = sub.add_parser("concurrency", parents=[dev])
    pn.add_argument("--url", default="http://127.0.0.1:8080")
    pn.add_argument("--threads", type=int, default=16)
    pn.add_argument("--rows", type=int, default=1, help="meshes per request")
    pn.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"perf_lab --device {args.device}: no CUDA GPU; the lab times the GPU "
            "unless --device cpu asks for the CPU"
        )
    if args.cmd is None:
        p.error(f"choose a subcommand: {', '.join(COMMANDS)}")
    return COMMANDS[args.cmd](args)


COMMANDS = {"conv": cmd_conv, "layout": cmd_layout, "fuse": cmd_fuse, "bmapply": cmd_bmapply,
            "chain": cmd_chain, "parts": cmd_parts, "step": cmd_step, "serve": cmd_serve,
            "trace": cmd_trace, "http": cmd_http, "artifact": cmd_artifact,
            "concurrency": cmd_concurrency}


if __name__ == "__main__":
    main()
