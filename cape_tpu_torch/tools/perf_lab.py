"""The kernel lab: CUDA-event microbenchmarks of one K=2 Chebyshev conv and
of one band apply at the flagship's shapes, on an NVIDIA GPU.

Counterpart of the kernel subcommands of `cape_tpu/tools/perf_lab.py`:

  python -m cape_tpu_torch.tools.perf_lab conv     # one conv: plain vs v2, v5 (and v1)
  python -m cape_tpu_torch.tools.perf_lab layout   # batch-major vs vertex-major
  python -m cape_tpu_torch.tools.perf_lab fuse     # stacked-GEMM and project-first variants
  python -m cape_tpu_torch.tools.perf_lab bmapply  # bare band apply: plain vs kernel 3

They take the JAX subcommands' options and defaults (batch 16, channels 64,
level 0), and `--device` (default `cuda`; without a GPU the tool raises).
Each prints the JAX subcommand's JSON line, per dtype (and, for `fuse`, per
variant), with these keys renamed:

  xla_*          -> plain_*      the plain PyTorch route
  pallas_*       -> v2_*         cheb2_banded_v2 (band-apply kernel, row 2)
  pallas5_*      -> v5_*         cheb2_banded_v5 (fused conv kernel, row 4)
  pallas_bm_ms   -> bm_ms        banded_apply_bm (kernel 3)
  vm_pallas_*    -> vm_kernel_*  the band-apply kernel on vertex-major [V, B*C]

and these added: `device` (the GPU's name); in `conv`, `max_rel_err_v2` and
kernel 1's `v1_fwd_ms`, `v1_fwdbwd_ms` and `max_rel_err_v1` (the fused conv
with one sample per block, which no JAX subcommand times); in `layout`,
`max_rel_err_vm_kernel`; in `fuse`, each variant's `max_rel_err`; in
`bmapply`, `max_rel_err_cf`. Errors are max|got - ref| / max|ref| against
the plain route on the same inputs. The plain route is built from the plain
functions themselves, so CAPE_TPU_PALLAS cannot put it on a kernel. Numbers
are printed unrounded.

Timing (`time_routes`): CUDA events; the routes of a line take turns, each
timing runs of back-to-back calls between one pair of events, and report
the median over rounds of the mean per call. The JAX tool chains calls in a
`fori_loop` to beat a remote TPU's ~29 ms sync; a local GPU needs no
chaining. Fwd+bwd is one gradient step on x of sum(y**2), as in JAX. The
other JAX subcommands (chain, parts, step, trace, serve, http, artifact,
concurrency) are not ported yet: ROADMAP.md lists them, and `main` refuses
them by name.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
UNPORTED = ("chain", "parts", "step", "trace", "serve", "http", "artifact", "concurrency")


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
    """The port's flagship context: the for_demo and ds2 pyramids of
    `meshops.assets`, in `dtype_name`, on `device`."""
    from cape_tpu_torch.meshops import assets
    from cape_tpu_torch.ops.sparse import build_graph_context

    verts, _ = assets.template_mesh()
    return build_graph_context(
        assets.load_pyramid("for_demo"), assets.load_pyramid("ds2"), assets.smpl_edges(),
        verts, dtype=DTYPES[dtype_name], padded=padded, device=device,
    )


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
    """L~ applied to vertex-major x [V, M] by the band-apply kernel; the
    backward is the same apply (the rescaled Laplacian is symmetric)."""

    @staticmethod
    def forward(ctx, xv, blocks, pad_left):
        from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply

        ctx.save_for_backward(blocks)
        ctx.pad_left = pad_left
        return band_apply(xv.contiguous()[None], blocks, pad_left, xv.shape[0])[0]

    @staticmethod
    def backward(ctx, g):
        (blocks,) = ctx.saved_tensors
        return _BandVM.apply(g, blocks, ctx.pad_left), None, None


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
            return project(xv, _BandVM.apply(xv, blocks, pl_))

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
            return banded_apply_bm(x, blocks, pl_, pr_, V)

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
    for name in UNPORTED:
        sub.add_parser(name)
    args, rest = p.parse_known_args(argv)
    if args.cmd in UNPORTED:
        raise NotImplementedError(
            f"perf_lab {args.cmd}: not ported to cape_tpu_torch yet (ROADMAP.md lists it)"
        )
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"perf_lab --device {args.device}: no CUDA GPU; the lab times the GPU only"
        )
    if args.cmd is None:
        p.error("choose a subcommand: conv, layout, fuse or bmapply")
    {"conv": cmd_conv, "layout": cmd_layout, "fuse": cmd_fuse, "bmapply": cmd_bmapply}[args.cmd](args)


if __name__ == "__main__":
    main()
