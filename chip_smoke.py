"""Drive the PyTorch port of CAPE (serving and training) once on a CUDA GPU.

    python3 chip_smoke.py       # one GPU; needs the checkout around it

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device: a CUDA GPU must be present (there is no CPU path); TF32 off.
  2. build: compile the four sources of csrc/ with nvcc, all at once;
     log ptxas's registers and spills.
  3. kernel: the band-apply kernel against its plain PyTorch version at
     every batch-32 and batch-64 shape of the flagship serving path, one
     natural-layout and one ragged-column case, in f32 and bf16; then its
     addend variant (the backward pass of the conv) at every batch-32
     shape of the train step, the discriminator's [32, 512, 128] included,
     in f32 and bf16, with times against plain and against one library call
     (torch.sparse.mm of the operator as a CSR matrix; addmm with the
     addend), which the port never calls.
  4. serve: the flagship preset (f32, batch 32, parameters from
     torch.Generator seed 0) behind the port's HTTP server on 127.0.0.1:0;
     /health, /sample (n=40: two padded decode calls), /encode, /decode,
     /reconstruct, /stats. The kernel must have run exactly 7 times per
     decode and per encode device call.
  5. plain route: the same requests with use_pallas=False, held to the
     kernel route; no kernel launch.
  6. golden: the batch-32 decode of tests/data/torch_golden_flagship.npz
     (written by the JAX package) held to 1e-4 * max|ref|.
  7. times: per-shape kernel against plain, and the batch-32 decode call on
     both routes. Every time in this script is `perf_lab.time_routes`'s:
     CUDA events, the routes in turns, each event pair around back-to-back
     calls, the median over rounds of the mean per call.
  8. train step: two flagship GAN steps at batch 32 (f32, seed-0
     parameters, the synthetic batches and eps of
     tests/data/torch_golden_train.npz) on the kernel route, 17 forward
     and 17 backward launches per step; the same steps on the plain route
     with none; both held to each other and to the JAX golden (metrics
     1e-4 relative, step-2 updates per leaf, see hold_updates).
  9. train time: both routes in turns, 6 rounds of 2 steps.
 10. train mode: apps.main.run (synthetic n_train=64, 2 epochs of one
     step); restore_params reads its checkpoint bit-equal, and decodes.
 11. fused (after phase 3): the fused conv kernel (rows 1 and 4) against
     its plain version at each flagship K=2 conv shape and C = F = 64, at
     every square Laplacian, B = 16 and 32, groups 1, 2 and 4, natural and
     padded, f32 and bf16 (bf16 also against two controls that each drop
     one of its numerics); times against plain, the v3 route and a copy of
     L~x, the routes in turns, each event pair around 10 calls.
 12. bm (after phase 11): the batch-major band-apply kernel (row 3) against
     its plain version on every banded lap, down, up and down_d op, B = 16
     and 32, C = 64, f32 and bf16, with times taken as in phase 11 (and
     the library call in f32).
 13. ring (after phase 12): the ring conv kernel (rows 5 and 6, one and two
     row tiles per step) against its plain version at every FUSED_CONVS
     shape, B = 16 and 32, f32 and bf16, natural and padded, with the fused
     phase's limits; a shape whose ring no cluster holds must have C > 64
     and must be refused with ValueError. Times at B = 32, padded, both
     dtypes: both ring kernels, the plain version, the fused kernel at
     group 1 and the v3 route. Then its main path, counts at 0 just before
     and read just after: cheb2_banded_v6 and _v7 once each through
     autograd at [32, 6912, 64] -> 64, padded, f32, held to the plain
     conv's autograd (y, dx, dW within 1e-5 relative); one launch each in
     the forward, none in the backward.
 14. lab (last): the kernel lab's conv, conv --padded 1, layout, fuse and
     bmapply with the counts at 0 just before; its errors within their
     limits; the v2, v1, v5 and bm kernels launched.
Every timed record carries `bound_ms`, the least time the card could take
for the same work (see `bound`). The per-case records go to
build/chip_smoke_kernels.json. The last two lines are a JSON summary of
the kernels and the device line.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESET = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_flagship.npz")
GOLDEN_TRAIN = os.path.join(ROOT, "tests", "data", "torch_golden_train.npz")
KERNEL_SOURCE = "cape_tpu_torch/csrc/band_apply.cu"
FUSED_SOURCE = "cape_tpu_torch/csrc/cheb2_fused.cu"
BM_SOURCE = "cape_tpu_torch/csrc/band_apply_bm.cu"
RING_SOURCE = "cape_tpu_torch/csrc/cheb2_ring.cu"
REPLACES = "cape_tpu/ops/pallas/cheb_kernel.py:168"  # _pallas_band_apply_v2
REPLACES_BWD = "cape_tpu/ops/pallas/cheb_kernel.py:268"  # the apply in _v3_bwd
REPLACES_V1 = "cape_tpu/ops/pallas/cheb_kernel.py:68"  # _pallas_cheb2_impl (kernel 1)
REPLACES_BM = "cape_tpu/ops/pallas/cheb_kernel.py:310"  # banded_apply_bm (kernel 3)
REPLACES_V5 = "cape_tpu/ops/pallas/cheb_kernel.py:379"  # _pallas_cheb2_v5_impl (kernel 4)
REPLACES_V6 = "cape_tpu/ops/pallas/cheb_kernel.py:502"  # _pallas_cheb2_v6_impl (kernel 5)
REPLACES_V7 = "cape_tpu/ops/pallas/cheb_kernel.py:597"  # _pallas_cheb2_v7_impl (kernel 6)
RECORDS = os.path.join(ROOT, "build", "chip_smoke_kernels.json")

# (padded rows P, channels C) of the seven band applies of one batch-32
# flagship decode (and encode) call; batch 64 adds C=32 at P=6912
ON_PATH = [(896, 512), (896, 256), (1792, 256), (1792, 128), (3456, 128), (3456, 64), (6912, 64)]
# the discriminator's pred conv on the 431-vertex ds2 level (one per
# discriminator call, three per train step)
PRED = (512, 128)
# applies per batch-32 train step in each direction: encoder and decoder
# each run the seven ON_PATH shapes, the three discriminator calls PRED
TRAIN_APPLIES = {**{pc: 2 for pc in ON_PATH}, PRED: 3}
FWD_PER_STEP = BWD_PER_STEP = sum(TRAIN_APPLIES.values())   # 17
FWD_PER_EVAL = 14   # encode + decode of one eval batch
# (C, F) of the flagship's K=2 convs at each padded row count P (encoder and
# decoder; at 512 the discriminator's pred conv), and C = F = 64 at each P:
# the shapes the fused conv kernel is held to its plain version at
FUSED_CONVS = {
    6912: [(3, 64), (64, 64), (64, 32), (32, 32), (32, 3)],
    3456: [(64, 128), (128, 128), (128, 64), (64, 64)],
    1792: [(128, 256), (256, 256), (256, 128), (128, 128), (64, 64)],
    896: [(256, 512), (512, 512), (512, 256), (256, 256), (64, 64)],
    512: [(128, 1), (64, 64)],
}
# the fused phase's bf16 check: the kernel's mean error at most this share
# of the mean distance of a control that drops one of its bf16 numerics
CONTROL_SHARE = 0.05
# the H100 SXM's published peaks at its full 700 W (NVIDIA's data sheet):
# device memory, and per input dtype f32 outside the tensor cores and dense
# bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# the ring phase's autograd main path: [B, P, C] -> F, padded, f32
RING_MAIN = (32, 6912, 64, 64)
# the lab's subcommands, as `python -m cape_tpu_torch.tools.perf_lab` takes them
LAB_RUNS = [["conv"], ["conv", "--padded", "1"], ["layout"], ["fuse"], ["bmapply"]]


def log(*a):
    print(*a, flush=True)


# the launch counts of the kernel wrappers (cape_tpu_torch.ops.kernels.cheb_kernel)
COUNTS = ("launches", "bwd_launches", "fused1_launches", "fused_launches", "bm_launches",
          "ring_launches", "ring2_launches")


def zero_counts() -> None:
    from cape_tpu_torch.ops.kernels import cheb_kernel

    for k in COUNTS:
        setattr(cheb_kernel, k, 0)


def read_counts() -> dict:
    from cape_tpu_torch.ops.kernels import cheb_kernel

    return {k: getattr(cheb_kernel, k) for k in COUNTS}


def only(counts: dict, *names) -> bool:
    """No kernel but `names` launched."""
    return not any(v for k, v in counts.items() if k not in names)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi name,power.limit: {smi}")
    log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def build_phase():
    """Compile every kernel source at once (one nvcc each), bind each
    library, and log ptxas's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from cape_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    names = ("band_apply", "cheb2_fused", "band_apply_bm", "cheb2_ring")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    build.band_apply_lib()
    build.cheb2_fused_lib()
    build.band_apply_bm_lib()
    build.cheb2_ring_lib()
    log(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        ptxas = (lib.parent / f"{lib.stem}.log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"ptxas {lib.stem}:", line.strip())


def bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take for a call: the larger of the
    bytes it must move over the memory rate and its operations over the peak
    rate for its dtype (`HBM_BYTES_PER_S`, `PEAK_FLOP_PER_S`); which of the
    two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[_name(dtype)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nnz(blocks) -> int:
    return int((blocks != 0).sum().item())


def apply_bound(blocks, B: int, rows_in: int, rows_out: int, C: int, dtype, addend=False) -> dict:
    """`bound` of a band apply y = M x (+ r): x read once, y written once (r
    read once), the band as its non-zero values with a 4-byte column index
    each; 2 operations per non-zero entry, sample and channel (and one add
    per element of r)."""
    el = torch.empty((), dtype=dtype).element_size()
    rows = rows_in + rows_out * (2 if addend else 1)
    nnz = _nnz(blocks)
    return bound(el * B * C * rows + nnz * (el + 4),
                 2 * nnz * B * C + (B * rows_out * C if addend else 0), dtype)


def conv_bound(blocks, B: int, rows_in: int, rows_out: int, C: int, F: int, dtype) -> dict:
    """`bound` of the fused K=2 conv: x read once, y written once, w0 and w1
    and the band (as in apply_bound) read once; the band sum (2 per non-zero
    entry, sample and channel) and both projections (4 C F per output row
    and sample)."""
    el = torch.empty((), dtype=dtype).element_size()
    nnz = _nnz(blocks)
    return bound(el * (B * rows_in * C + B * rows_out * F + 2 * C * F) + nnz * (el + 4),
                 2 * nnz * B * C + 4 * B * rows_out * C * F, dtype)


def summed_bound(records, weight=lambda r: 1) -> dict:
    """The bounds of several calls summed, set by what sets most of the sum."""
    by = {"bytes": 0.0, "operations": 0.0}
    for r in records:
        by[r["bound_by"]] += weight(r) * r["bound_ms"]
    return {"bound_ms": sum(by.values()), "bound_by": max(by, key=by.get)}


def csr_operator(blocks, pad_left: int, rows_in: int, rows_out: int) -> torch.Tensor:
    """The banded operator as one sparse CSR matrix [rows_out, rows_in], the
    operand of the library call timed beside the band-apply kernels (the
    port never calls it)."""
    rb, cb = blocks.shape[2:]
    k, t, i, j = blocks.nonzero(as_tuple=True)
    rows, cols = t * rb + i, (t + k) * cb + j - pad_left
    keep = (rows < rows_out) & (cols >= 0) & (cols < rows_in)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  blocks[k, t, i, j][keep], (rows_out, rows_in))
    return coo.coalesce().to_sparse_csr()


def vertex_major(x: torch.Tensor) -> torch.Tensor:
    """[B, V, C] -> [V, B*C], the layout of the library call's dense operand."""
    return x.transpose(0, 1).reshape(x.shape[1], -1).contiguous()


def _laps(ctx) -> dict:
    """A Laplacian of the context for each padded row count P."""
    laps = {}
    for op in ctx.lap + ctx.lap_d:
        laps.setdefault(op.blocks.shape[1] * 128, op)
    return laps


def kernel_phase(ctx, smi):
    """Kernel against plain at every case; returns the per-case records."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply, band_apply_plain
    from cape_tpu_torch.tools.perf_lab import time_routes

    laps = _laps(ctx)
    cases = [(32, P, C, True) for P, C in ON_PATH + [PRED]]
    cases += [(64, P, C, True) for P, C in ON_PATH + [(6912, 32)]]
    cases += [(32, 6890, 64, False), (32, 6912, 35, True)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, P, C, padded in cases:
            op = laps[P if padded else 6912]
            blocks = op.blocks.to(dtype).contiguous()
            rows_out = P if padded else op.n_rows
            x = torch.randn((B, P, C), generator=gen, device="cuda").to(dtype)
            y = band_apply(x, blocks, op.pad_left, rows_out)
            ref = band_apply_plain(x, blocks, op.pad_left, rows_out)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            limit = 1e-5 * scale + 1e-6 if dtype == torch.float32 else bf16_ulp(scale)
            S, T = blocks.shape[:2]
            nz = (blocks.float().reshape(S, T, 128, 4, 32).abs().amax(dim=(2, 4)) > 0)
            rec = dict(dtype=str(dtype).replace("torch.", ""), B=B, P=P, C=C, S=S, T=T,
                       layout="padded" if padded else "natural", max_abs_err=err,
                       max_rel_err=err / scale, limit=limit,
                       nonzero_slabs=nz.float().mean().item())
            log(f"kernel vs plain {rec['dtype']} x[{B},{P},{C}] blocks[{S},{T}] "
                f"{rec['layout']}: max_abs_err {err:.3e} rel {err / scale:.3e} "
                f"(limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"band_apply disagrees with its plain version: {rec}")
            if B == 32 and padded and (P, C) in TRAIN_APPLIES:
                routes = {
                    "ms": lambda: band_apply(x, blocks, op.pad_left, rows_out),
                    "plain_ms": lambda: band_apply_plain(x, blocks, op.pad_left, rows_out),
                }
                if dtype == torch.float32:
                    A, xv = csr_operator(blocks, op.pad_left, P, rows_out), vertex_major(x)
                    routes["library_ms"] = lambda: torch.sparse.mm(A, xv)
                rec.update(time_routes(routes))
                rec.update(apply_bound(blocks, B, P, rows_out, C, dtype))
                rec["dense_gflop"] = 2 * S * 128 * P * B * C / 1e9
                lib = f", library {rec['library_ms']:.4f}" if "library_ms" in rec else ""
                log(f"  time [{smi}]: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms{lib}, "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                    f"dense {rec['dense_gflop']:.2f} GFLOP -> "
                    f"{rec['dense_gflop'] / rec['ms']:.1f} TFLOP/s dense-equivalent, "
                    f"non-zero 128x32 slabs {rec['nonzero_slabs']:.3f}")
            records.append(rec)
    return records


def addend_phase(ctx, smi):
    """The kernel's addend variant, y = L~x + r, which the backward pass of
    the conv launches for dx, against its plain version at every batch-32
    shape of the train step, in f32 and bf16; f32 times. Returns the
    per-case records."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply, band_apply_plain
    from cape_tpu_torch.tools.perf_lab import time_routes

    laps = _laps(ctx)
    gen = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for P, C in TRAIN_APPLIES:
            op = laps[P]
            blocks = op.blocks.to(dtype).contiguous()
            x = torch.randn((32, P, C), generator=gen, device="cuda").to(dtype)
            r = torch.randn((32, P, C), generator=gen, device="cuda").to(dtype)
            y = band_apply(x, blocks, op.pad_left, P, addend=r)
            ref = band_apply_plain(x, blocks, op.pad_left, P, r)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            limit = 1e-5 * scale + 1e-6 if dtype == torch.float32 else bf16_ulp(scale)
            rec = dict(dtype=str(dtype).replace("torch.", ""), B=32, P=P, C=C,
                       S=blocks.shape[0], T=blocks.shape[1], max_abs_err=err,
                       max_rel_err=err / scale, limit=limit)
            log(f"addend kernel vs plain {rec['dtype']} x[32,{P},{C}] "
                f"blocks[{rec['S']},{rec['T']}]: max_abs_err {err:.3e} rel {err / scale:.3e} "
                f"(limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"band_apply with addend disagrees with plain: {rec}")
            if dtype == torch.float32:
                A, xv, rv = csr_operator(blocks, op.pad_left, P, P), vertex_major(x), vertex_major(r)
                rec.update(time_routes({
                    "ms": lambda: band_apply(x, blocks, op.pad_left, P, addend=r),
                    "plain_ms": lambda: band_apply_plain(x, blocks, op.pad_left, P, r),
                    "library_ms": lambda: torch.sparse.addmm(rv, A, xv),
                }))
                rec.update(apply_bound(blocks, 32, P, P, C, dtype, addend=True))
                log(f"  time [{smi}]: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                    f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
            records.append(rec)
    return records


def _err(y, ref) -> tuple[float, float]:
    torch.cuda.synchronize()
    return (y.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()


def bf16_controls(x, blocks, pad_left: int, rows: int, w0, w1) -> dict:
    """Two plain versions of the fused conv on bf16 inputs, each without one
    of the kernel's bf16 numerics: `lx_f32` takes L~x to the W1 product in
    f32 (no rounding of L~x); `rounded_products` rounds x W0 and (L~x) W1
    to bf16 each before the sum (the v2 route's numerics)."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import fused_cheb2_plain

    f = lambda t: t.float()
    zero = torch.zeros_like(w0)
    p0 = fused_cheb2_plain(x, blocks, pad_left, rows, w0, zero)
    p1 = fused_cheb2_plain(x, blocks, pad_left, rows, zero, w1)
    return {
        "lx_f32": fused_cheb2_plain(f(x), f(blocks), pad_left, rows, f(w0), f(w1)).to(x.dtype),
        "rounded_products": (p0.float() + p1.float()).to(x.dtype),
    }


def control_ratios(y, ref, controls: dict) -> dict:
    """mean|y - ref| over mean|c - ref| for each control c. A kernel that
    dropped one of the bf16 numerics would sit as far from ref as that
    control does (a ratio near 1); one that keeps them differs from ref
    only where f32 sums in another order round the other way."""
    d = (y.float() - ref.float()).abs().mean().item()
    ratios = {}
    for k, c in controls.items():
        dc = (c.float() - ref.float()).abs().mean().item()
        if not dc > 0:
            raise AssertionError(f"control {k} is indistinguishable from the plain version")
        ratios[k] = d / dc
    return ratios


def fused_phase(ctx, smi):
    """The fused conv kernel (rows 1 and 4) against its plain version at
    every FUSED_CONVS shape, B = 16 and 32, groups 1, 2 and 4, natural and
    padded layouts, f32 and bf16; in the padded layout, times (routes in
    turns, `time_routes`) of the kernel at v5's group and at group 1
    against the plain version, the v3 route (band-apply kernel plus two
    matmuls) and a device copy of L~x, which moves the bytes of the round
    trip through device memory that the fused kernel saves. Returns the
    per-case records.

    Limits: f32, 1e-5 * max|ref| + 1e-6 (the same sums in another order).
    bf16, two: max|err| within one ulp of max|ref| (the final rounding of
    sums that differ in f32 rounding) plus max_f sum_c |w1[c, f]| times
    one ulp of max|L~x| (an element of L~x whose f32 sum lies at a rounding
    boundary may round the other way); and mean|err| within CONTROL_SHARE
    of the mean distance of each of `bf16_controls` from the plain version,
    which a kernel that skipped the rounding of L~x, or rounded the
    products before the sum, would not meet."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import (
        band_apply, band_apply_plain, cheb2_banded_v3, fused_cheb2, fused_cheb2_plain, v5_group,
    )
    from cape_tpu_torch.tools.perf_lab import time_routes

    laps = _laps(ctx)
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = []
    for P, convs in FUSED_CONVS.items():
        op = laps[P]
        for C, F in convs:
            for B in (16, 32):
                for dtype in (torch.float32, torch.bfloat16):
                    name = str(dtype).replace("torch.", "")
                    blocks = op.blocks.to(dtype).contiguous()
                    w = (torch.randn((2, C, F), generator=gen, device="cuda") / math.sqrt(C)).to(dtype)
                    w0, w1 = w[0], w[1]
                    worst, worst_ratio = 0.0, 0.0
                    for layout in ("natural", "padded"):
                        rows = P if layout == "padded" else op.n_rows
                        x = torch.randn((B, rows, C), generator=gen, device="cuda").to(dtype)
                        ref = fused_cheb2_plain(x, blocks, op.pad_left, rows, w0, w1)
                        scale = ref.float().abs().max().item()
                        if dtype == torch.float32:
                            limit, controls = 1e-5 * scale + 1e-6, None
                        else:
                            lx = band_apply_plain(x, blocks, op.pad_left, rows).float()
                            w1_l1 = w1.float().abs().sum(0).max().item()
                            limit = bf16_ulp(scale) + w1_l1 * bf16_ulp(lx.abs().max().item())
                            controls = bf16_controls(x, blocks, op.pad_left, rows, w0, w1)
                        for G in (1, 2, 4):
                            y = fused_cheb2(x, blocks, op.pad_left, rows, w0, w1, G)
                            err, _ = _err(y, ref)
                            rec = dict(dtype=name, B=B, P=P, C=C, F=F, G=G, layout=layout,
                                       max_abs_err=err, max_rel_err=err / scale, limit=limit)
                            if controls is not None:
                                rec["control_ratios"] = ratios = control_ratios(y, ref, controls)
                                worst_ratio = max(worst_ratio, *ratios.values())
                            if not (err <= limit and worst_ratio <= CONTROL_SHARE):
                                raise AssertionError(f"cheb2_fused disagrees with its plain version: {rec}")
                            worst = max(worst, err / scale)
                            records.append(rec)
                    # padded layout, last x: times at v5's group and at group 1
                    op_d = dataclasses.replace(op, blocks=blocks)
                    G5 = v5_group(B)
                    with torch.no_grad():
                        lx = band_apply(x, blocks, op.pad_left, P)
                        lx_to = torch.empty_like(lx)
                        t = time_routes({
                            "ms": lambda: fused_cheb2(x, blocks, op.pad_left, P, w0, w1, G5),
                            "g1_ms": lambda: fused_cheb2(x, blocks, op.pad_left, P, w0, w1, 1),
                            "plain_ms": lambda: fused_cheb2_plain(x, blocks, op.pad_left, P, w0, w1),
                            "v3_ms": lambda: cheb2_banded_v3(x, op_d, w),
                            "lx_copy_ms": lambda: lx_to.copy_(lx),
                        })
                    records.append(dict(dtype=name, B=B, P=P, C=C, F=F, G=G5, layout="padded", **t,
                                        **conv_bound(blocks, B, P, P, C, F, dtype)))
                    ratio = f", mean err/control {worst_ratio:.3f}" if dtype == torch.bfloat16 else ""
                    log(f"fused {name} x[{B},{P},{C}] F={F} blocks[{blocks.shape[0]},{blocks.shape[1]}]: "
                        f"worst rel err {worst:.2e}{ratio} over G=1,2,4 x natural,padded; [{smi}] "
                        f"G={G5} {t['ms']:.4f} ms, G=1 {t['g1_ms']:.4f}, plain {t['plain_ms']:.4f}, "
                        f"v3 route {t['v3_ms']:.4f}, copy of L~x {t['lx_copy_ms']:.4f}")
    return records


def bm_phase(ctx, smi):
    """The batch-major band-apply kernel (row 3) against its plain version
    on every banded lap, down, up and down_d op of the flagship context
    (cb = 128, 256 and 64), B = 16 and 32, C = 64, natural layout, f32 and
    bf16, with times (routes in turns, `time_routes`). Limits: f32 1e-5 *
    max|ref| + 1e-6, bf16 one ulp of max|ref| (the same f32 sums in another
    order, one rounding). Returns the per-case records."""
    from cape_tpu_torch.ops.banded import BandedOp
    from cape_tpu_torch.ops.kernels.cheb_kernel import banded_apply_bm, banded_apply_bm_plain
    from cape_tpu_torch.tools.perf_lab import time_routes

    gen = torch.Generator(device="cuda").manual_seed(3)
    records = []
    for field in ("lap", "down", "up", "down_d"):
        for idx, op in enumerate(getattr(ctx, field)):
            if not isinstance(op, BandedOp):
                continue
            S, T, _, cb = op.blocks.shape
            args = (op.pad_left, op.pad_right, op.n_rows)
            for dtype in (torch.float32, torch.bfloat16):
                blocks = op.blocks.to(dtype).contiguous()
                for B in (16, 32):
                    x = torch.randn((B, op.n_cols, 64), generator=gen, device="cuda").to(dtype)
                    err, scale = _err(banded_apply_bm(x, blocks, *args),
                                      banded_apply_bm_plain(x, blocks, *args))
                    limit = 1e-5 * scale + 1e-6 if dtype == torch.float32 else bf16_ulp(scale)
                    rec = dict(op=f"{field}[{idx}]", dtype=str(dtype).replace("torch.", ""), B=B,
                               C=64, S=S, T=T, cb=cb, n_cols=op.n_cols, n_rows=op.n_rows,
                               max_abs_err=err, max_rel_err=err / scale, limit=limit)
                    if not err <= limit:
                        raise AssertionError(f"banded_apply_bm disagrees with its plain version: {rec}")
                    routes = {
                        "ms": lambda: banded_apply_bm(x, blocks, *args),
                        "plain_ms": lambda: banded_apply_bm_plain(x, blocks, *args),
                    }
                    if dtype == torch.float32:
                        A, xv = csr_operator(blocks, op.pad_left, op.n_cols, op.n_rows), vertex_major(x)
                        routes["library_ms"] = lambda: torch.sparse.mm(A, xv)
                    rec.update(time_routes(routes))
                    rec.update(apply_bound(blocks, B, op.n_cols, op.n_rows, 64, dtype))
                    lib = f", library {rec['library_ms']:.4f}" if "library_ms" in rec else ""
                    log(f"bm {rec['op']} {rec['dtype']} x[{B},{op.n_cols},64] blocks[{S},{T},128,{cb}]: "
                        f"rel err {err / scale:.2e} (limit {limit:.2e}); [{smi}] "
                        f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms{lib}, "
                        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
                    records.append(rec)
    return records


def ring_phase(ctx, smi):
    """The ring conv kernel (rows 5 and 6: `ring_cheb2` with one and two row
    tiles per step) against its plain version at every FUSED_CONVS shape,
    B = 16 and 32, f32 and bf16, natural and padded, with the fused phase's
    limits. A shape whose ring no cluster of blocks holds (`ring_plan` is
    None) must have C > 64 and must be refused with ValueError; it is
    recorded. At B = 32, padded, both dtypes: times (routes in turns) of
    both ring kernels, the plain version, the fused kernel at group 1 and
    the v3 route, and the bound. Then the main path of rows 5 and 6, with
    every count at 0 just before and read just after: `cheb2_banded_v6` and
    `cheb2_banded_v7` once each through autograd at RING_MAIN (padded, f32,
    x's tail rows 7.0, the cotangent's tail zero), held to the plain conv's
    autograd, y, dx and dW within 1e-5 * max|ref|; one launch each in the
    forward, none in the backward. Returns the records, the refused shapes
    and the main path's counts."""
    from cape_tpu_torch.ops.cheb import cheb_conv
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck
    from cape_tpu_torch.tools.perf_lab import time_routes

    t_phase = time.perf_counter()
    laps = _laps(ctx)
    gen = torch.Generator(device="cuda").manual_seed(4)
    records, refused = [], []
    for P, convs in FUSED_CONVS.items():
        op = laps[P]
        S, T = op.blocks.shape[:2]
        for C, F in convs:
            for B in (16, 32):
                for dtype in (torch.float32, torch.bfloat16):
                    name = _name(dtype)
                    blocks = op.blocks.to(dtype).contiguous()
                    w = (torch.randn((2, C, F), generator=gen, device="cuda") / math.sqrt(C)).to(dtype)
                    w0, w1 = w[0], w[1]
                    plans = {R: ck.ring_plan(dtype, B, C, S, T, R) for R in (1, 2)}
                    for R, plan in plans.items():
                        if plan is None:
                            refused.append(dict(dtype=name, B=B, P=P, C=C, F=F, R=R))
                            if C <= 64:
                                raise AssertionError(f"cheb2_ring refuses C={C} <= 64: {refused[-1]}")
                    worst, worst_ratio = 0.0, 0.0
                    for layout in ("natural", "padded"):
                        rows = P if layout == "padded" else op.n_rows
                        x = torch.randn((B, rows, C), generator=gen, device="cuda").to(dtype)
                        ref = ck.fused_cheb2_plain(x, blocks, op.pad_left, rows, w0, w1)
                        scale = ref.float().abs().max().item()
                        if dtype == torch.float32:
                            limit, controls = 1e-5 * scale + 1e-6, None
                        else:
                            lx = ck.band_apply_plain(x, blocks, op.pad_left, rows).float()
                            w1_l1 = w1.float().abs().sum(0).max().item()
                            limit = bf16_ulp(scale) + w1_l1 * bf16_ulp(lx.abs().max().item())
                            controls = bf16_controls(x, blocks, op.pad_left, rows, w0, w1)
                        for R, plan in plans.items():
                            if plan is None:
                                try:
                                    ck.ring_cheb2(x, blocks, op.pad_left, rows, w0, w1, R)
                                except ValueError:
                                    continue
                                raise AssertionError(f"cheb2_ring ran a shape its plan refuses: "
                                                     f"{refused[-1]}")
                            y = ck.ring_cheb2(x, blocks, op.pad_left, rows, w0, w1, R)
                            err, _ = _err(y, ref)
                            rec = dict(dtype=name, B=B, P=P, C=C, F=F, R=R, layout=layout, **plan,
                                       max_abs_err=err, max_rel_err=err / scale, limit=limit)
                            if controls is not None:
                                rec["control_ratios"] = ratios = control_ratios(y, ref, controls)
                                worst_ratio = max(worst_ratio, *ratios.values())
                            if not (err <= limit and worst_ratio <= CONTROL_SHARE):
                                raise AssertionError(f"cheb2_ring disagrees with its plain version: {rec}")
                            worst = max(worst, err / scale)
                            records.append(rec)
                    if B != 32:
                        continue
                    # padded layout, last x: times of both ring kernels and their yardsticks
                    op_d = dataclasses.replace(op, blocks=blocks)
                    routes = {"plain_ms": lambda: ck.fused_cheb2_plain(x, blocks, op.pad_left, P, w0, w1),
                              "g1_ms": lambda: ck.fused_cheb2(x, blocks, op.pad_left, P, w0, w1, 1),
                              "v3_ms": lambda: ck.cheb2_banded_v3(x, op_d, w)}
                    for R, key in ((1, "ms"), (2, "r2_ms")):
                        if plans[R] is not None:
                            routes[key] = functools.partial(ck.ring_cheb2, x, blocks, op.pad_left, P,
                                                            w0, w1, R)
                    with torch.no_grad():
                        tm = time_routes(routes)
                    records.append(dict(dtype=name, B=B, P=P, C=C, F=F, layout="padded", **tm,
                                        **conv_bound(blocks, B, P, P, C, F, dtype)))
                    ring = " ".join(f"R={R} {tm[k]:.4f}" for R, k in ((1, "ms"), (2, "r2_ms")) if k in tm)
                    plan_s = "; ".join(f"R={R} cluster {p['cluster']} x {p['channels']} channels, run "
                                       f"{p['run']} tiles (x read {p['x_read_factor']:.3f}x), "
                                       f"{p['smem']} B" if p else f"R={R} refused"
                                       for R, p in plans.items())
                    ratio = f", mean err/control {worst_ratio:.3f}" if dtype == torch.bfloat16 else ""
                    log(f"ring {name} x[{B},{P},{C}] F={F} blocks[{S},{T}]: worst rel err {worst:.2e}"
                        f"{ratio} over R=1,2 x natural,padded (B=16 too); {plan_s}; [{smi}] "
                        f"ms: ring {ring}, plain {tm['plain_ms']:.4f}, G=1 {tm['g1_ms']:.4f}, "
                        f"v3 route {tm['v3_ms']:.4f}, bound {records[-1]['bound_ms']:.4f} "
                        f"({records[-1]['bound_by']})")
    log(f"ring: refused {len(refused)} cases: {json.dumps(refused)}")

    # ---- the main path of rows 5 and 6: every count at 0 just before, read just after
    B, P, C, F = RING_MAIN
    op = laps[P]
    x = torch.randn((B, P, C), generator=gen, device="cuda")
    x[:, op.n_rows:] = 7.0
    g = torch.randn((B, P, F), generator=gen, device="cuda")
    g[:, op.n_rows:] = 0.0
    W = torch.randn((2, C, F), generator=gen, device="cuda") / math.sqrt(C)
    plain = dataclasses.replace(op, allow_pallas=False)

    def value_and_grads(fn):
        xg, wg = x.clone().requires_grad_(), W.clone().requires_grad_()
        y = fn(xg, wg)
        forward = (ck.ring_launches, ck.ring2_launches)
        dx, dw = torch.autograd.grad(y, (xg, wg), g)
        torch.cuda.synchronize()
        return (y, dx, dw), forward

    want, _ = value_and_grads(lambda x, w: cheb_conv(x, plain, w))
    counts = {}
    zero_counts()
    for entry in ("cheb2_banded_v6", "cheb2_banded_v7"):
        got, forward = value_and_grads(lambda x, w: getattr(ck, entry)(x, op, w))
        for name, a, b in zip(("y", "dx", "dW"), got, want):
            held_to(f"{entry} autograd {name} vs the plain conv, x[{B},{P},{C}] F={F} padded f32",
                    a.detach().cpu().numpy(), b.detach().cpu().numpy(), rel=1e-5)
        counts[f"{entry} forward"] = forward
    after = read_counts()
    counts.update(cheb2_ring=after["ring_launches"], cheb2_ring2=after["ring2_launches"])
    log(f"ring main path: launches {json.dumps(counts)}; phase {time.perf_counter() - t_phase:.2f} s")
    if (counts["cheb2_banded_v6 forward"] != (1, 0) or counts["cheb2_banded_v7 forward"] != (1, 1)
            or counts["cheb2_ring"] != 1 or counts["cheb2_ring2"] != 1
            or not only(after, "ring_launches", "ring2_launches")):
        raise AssertionError(f"ring main path: launches {counts}, expected one of each ring "
                             "kernel in the forwards and none in the backwards")
    return records, refused, counts


def lab_phase(smi):
    """The kernel lab, the main path of kernels 1, 3 and 4: each LAB_RUNS
    entry through `perf_lab.main`, as `python -m cape_tpu_torch.tools.perf_lab`
    runs it, in this process, with every kernel count set to 0 just before
    and read just after. Each printed error must be within its limit (f32:
    1e-5, the same sums in another order; bf16: the JAX lab's own 5e-2),
    and v2 (band_apply), v1, v5 and bm must have launched. Returns the
    lines and the counts."""
    from contextlib import redirect_stdout

    from cape_tpu_torch.ops.kernels import cheb_kernel as ck
    from cape_tpu_torch.tools import perf_lab

    lines = []
    # ---- the lab's main path: every count at 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    for argv in LAB_RUNS:
        buf = io.StringIO()
        with redirect_stdout(buf):
            perf_lab.main(argv)
        for text in buf.getvalue().splitlines():
            log(f"lab {' '.join(argv)} [{smi}]: {text}")
            lines.append(json.loads(text))
    counts = {"band_apply": ck.launches, "band_apply_bwd": ck.bwd_launches,
              "cheb2_fused_g1": ck.fused1_launches, "cheb2_fused": ck.fused_launches,
              "band_apply_bm": ck.bm_launches}
    log(f"lab: {time.perf_counter() - t0:.2f} s, kernel launches {json.dumps(counts)}")
    for line in lines:
        dtype = next(line[k] for k in ("conv", "layout", "fuse", "bmapply") if k in line)
        limit = 1e-5 if dtype == "float32" else 5e-2
        for k, v in line.items():
            if k.startswith("max_rel_err") and not 0.0 <= v <= limit:
                raise AssertionError(f"lab {k} = {v} exceeds {limit}: {line}")
    for k in ("band_apply", "cheb2_fused_g1", "cheb2_fused", "band_apply_bm"):
        if counts[k] == 0:
            raise AssertionError(f"the lab launched no {k} kernel: {counts}")
    return lines, counts


class Client:
    def __init__(self, base: str):
        self.base = base

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=300) as resp:
            assert resp.status == 200, (path, resp.status)
            return json.loads(resp.read())

    def post(self, path, body, npz=True):
        if npz:
            buf = io.BytesIO()
            np.savez(buf, **body)
            data, ctype = buf.getvalue(), "application/x-npz"
        else:
            data = json.dumps({k: np.asarray(v).tolist() for k, v in body.items()}).encode()
            ctype = "application/json"
        req = urllib.request.Request(self.base + path, data=data, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200, (path, resp.status)
            raw = resp.read()
        if npz:
            with np.load(io.BytesIO(raw)) as z:
                return {k: z[k] for k in z}
        return {k: np.asarray(v, np.float32) for k, v in json.loads(raw).items()}


def start_server(engine):
    from cape_tpu_torch.apps.server import serve

    httpd, ms = serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, ms, Client(f"http://127.0.0.1:{httpd.server_address[1]}")


def stop_server(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")


def check_mesh(name, disp, n):
    if disp.shape != (n, 6890, 3) or not np.isfinite(disp).all():
        raise AssertionError(f"{name}: shape {disp.shape}, finite {np.isfinite(disp).all()}")


def requests(client, pose, clo):
    """The request plan of the serve phase; returns the responses."""
    out = {"sample": client.post("/sample", {"pose": pose[:1], "clo": clo[:1], "n": 40, "seed": 0})}
    check_mesh("/sample", out["sample"]["disp"], 40)
    meshes = out["sample"]["disp"][:3]
    out["encode"] = client.post("/encode", {"disp": meshes, "pose": pose[:3], "clo": clo[:3]},
                                npz=False)
    if not np.isfinite(out["encode"]["z_mean"]).all():
        raise AssertionError("/encode: non-finite z_mean")
    out["decode"] = client.post("/decode", {"z": out["encode"]["z_mean"], "pose": pose[:3],
                                            "clo": clo[:3]})
    check_mesh("/decode", out["decode"]["disp"], 3)
    out["reconstruct"] = client.post("/reconstruct", {"disp": meshes, "pose": pose[:3],
                                                      "clo": clo[:3]})
    check_mesh("/reconstruct", out["reconstruct"]["disp"], 3)
    return out


def held_to(name, got, ref, rel=1e-4):
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    log(f"{name}: max_abs_err {err:.3e}, max|ref| {scale:.4g}, rel {err / scale:.3e} (limit {rel})")
    if not err <= rel * scale:
        raise AssertionError(f"{name} exceeds {rel} * max|ref|")
    return err


def held_metrics(name, got: dict, ref: dict, rel=1e-4):
    """Every metric within `rel` relative of the reference's."""
    worst = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ref)
    log(f"{name}: metrics worst relative error {worst:.3e} (limit {rel}); "
        + " ".join(f"{k}={got[k]:.7g}/{ref[k]:.7g}" for k in ref))
    if not worst <= rel:
        raise AssertionError(f"{name}: metrics exceed {rel} relative")


def hold_updates(name, got: dict, keys, summary, whole, rel=1e-3, tie_rel=0.25):
    """Per-leaf step-2 updates against a reference given as per-leaf
    [sum, sum of squares, max|.|] and, where present, whole arrays.

    Per leaf: max|.| within rel of the reference's, the sum of squares
    within 2 * rel of its own, the sum within rel * sqrt(n * sum of
    squares) (the sum of a leaf can cancel to ~0), and each element of a
    whole leaf within rel * max|ref|, except at most max(4, n / 10^4)
    elements within tie_rel * max|ref|. Those are ties: a pre-activation
    within f32 rounding of a leaky-ReLU kink, or an L1 residual within
    rounding of 0, takes the other branch in the other summation order
    and moves one sample's share of the element (seen on an NVIDIA H100
    80GB HBM3 at 700 W: 2 of the decoder's fc1 kernel's 662K elements at
    1.6e-3, kernel route vs plain route). The five worst leaves, and every leaf out of bounds, are
    logged before a failure is raised."""
    rows = []
    for k, (r_sum, r_sq, r_max) in zip(keys, summary):
        u = got[k].astype(np.float64)
        errs = {
            "max": abs(np.abs(u).max() - r_max) / r_max,
            "sumsq": abs(np.square(u).sum() - r_sq) / (2 * r_sq),
            "sum": abs(u.sum() - r_sum) / np.sqrt(u.size * r_sq),
        }
        ok = max(errs.values()) <= rel
        if k in whole:
            diff = np.abs(u - whole[k]) / r_max
            errs["elem"] = diff.max()
            errs["n_elem_out"] = n_out = int((diff > rel).sum())
            ok = ok and n_out <= max(4, u.size // 10_000) and errs["elem"] <= tie_rel
            # rank by the elements inside the bound: the ties are counted
            errs["elem_in"] = float(np.sort(diff.ravel())[-n_out - 1])
        rows.append((max(v for n, v in errs.items() if n not in ("elem", "n_elem_out")),
                     k, errs, ok))
    rows.sort(key=lambda r: r[0], reverse=True)
    bad = [k for _, k, _, ok in rows if not ok]
    shown = rows[:5] + [r for r in rows[5:] if not r[3]]
    for _, k, errs, _ in shown:
        log(f"  {name} {k}: " + " ".join(f"{n} {v:.3g}" for n, v in errs.items()))
    ties = sum(r[2].get("n_elem_out", 0) for r in rows)
    log(f"{name}: {len(keys)} leaves ({len(whole)} whole), worst {rows[0][0]:.3e} at "
        f"{rows[0][1]} (bound {rel}, relative to the leaf's max|update|); "
        f"{ties} tie elements in all")
    if bad:
        raise AssertionError(f"{name}: updates of {bad} exceed the bound")


def golden_batches(golden, perm):
    """The train golden's batch recipe on the device: synthetic data from
    its seed in the context's vertex order, G and D index streams seeded
    seed and seed + 1."""
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.data.synthetic import synthetic_bodydata

    seed = int(golden["seed"])
    data = synthetic_bodydata(n_train=int(golden["n_train"]), n_test=int(golden["n_test"]),
                              num_verts=6890, seed=seed)
    n = len(data.disp_train)
    if n // 32 != int(golden["steps_per_epoch"]):
        raise AssertionError(f"{n} train rows: not the golden's steps per epoch")
    sg, sd = BatchStream(n, 32, seed), BatchStream(n, 32, seed + 1)
    disp = data.disp_train[:, perm]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    batches = []
    for _ in range(len(golden["eps"])):
        ig, idd = sg.next_indices(), sd.next_indices()
        batches.append({
            "disp_g": dev(disp[ig]), "pose_g": dev(data.pose_train[ig]),
            "clo_g": dev(data.clo_train[ig]), "disp_d": dev(disp[idd]),
            "pose_d": dev(data.pose_train[idd]), "clo_d": dev(data.clo_train[idd]),
        })
    return batches, n // 32


def train_phase(cfg, ctx, ctx_plain, smi):
    """Two GAN steps of the flagship at batch 32 on each route, from the
    seed-0 parameters and the golden's batches and eps; launch counts per
    step; both routes held to each other and to the JAX golden; then the
    step time on both routes. Returns the step times."""
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import cheb_kernel
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.tools.perf_lab import time_routes
    from cape_tpu_torch.train.step import TrainState, train_step

    golden = np.load(GOLDEN_TRAIN)
    names = [str(k) for k in golden["metric_names"]]
    keys = [str(k) for k in golden["param_keys"]]
    whole = {k[len("update/"):]: golden[k] for k in golden.files if k.startswith("update/")}
    eps = torch.from_numpy(golden["eps"]).cuda()
    batches, spe = golden_batches(golden, ctx.perm0)
    runs = {}
    for route, c in (("kernel", ctx), ("plain", ctx_plain)):
        model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), c)
        sd = model.state_dict()
        sums = np.array([sd[k].double().sum().item() for k in keys])
        if sorted(sd) != keys or not np.allclose(sums, golden["param_sums"], rtol=1e-6, atol=1e-6):
            raise AssertionError("parameters from seed 0 differ from the train golden's")
        state = TrainState(model.to("cuda"), Optimizer(cfg, spe))
        metrics, counts = [], []
        for batch, e in zip(batches, eps):
            f0, b0 = cheb_kernel.launches, cheb_kernel.bwd_launches
            m, updates = train_step(state, c, batch, e)
            torch.cuda.synchronize()
            counts.append((cheb_kernel.launches - f0, cheb_kernel.bwd_launches - b0))
            metrics.append({k: float(m[k]) for k in names})
        updates = {k: v.cpu().numpy() for k, v in updates.items()}
        log(f"train step, {route} route: band_apply launches (forward, backward) per step "
            f"{counts}; step 1 " + " ".join(f"{k}={v:.6g}" for k, v in metrics[0].items()))
        want = [(FWD_PER_STEP, BWD_PER_STEP)] * 2 if route == "kernel" else [(0, 0)] * 2
        if counts != want:
            raise AssertionError(f"{route} route: launches {counts}, expected {want}")
        for i, m in enumerate(metrics):
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{route} route step {i + 1}: non-finite metrics {m}")
        runs[route] = (state, c, metrics, updates)

    kernel, plain = runs["kernel"], runs["plain"]
    for i in range(2):
        ref = dict(zip(names, golden["metrics"][i]))
        held_metrics(f"train step {i + 1}, kernel route vs plain route", kernel[2][i], plain[2][i])
        held_metrics(f"train step {i + 1}, kernel route vs JAX golden", kernel[2][i], ref)
        held_metrics(f"train step {i + 1}, plain route vs JAX golden", plain[2][i], ref)
    plain_summary = np.stack([[u.sum(), np.square(u).sum(), np.abs(u).max()]
                              for u in (plain[3][k].astype(np.float64) for k in keys)])
    hold_updates("step-2 updates, kernel route vs plain route", kernel[3], keys,
                 plain_summary, plain[3])
    hold_updates("step-2 updates, kernel route vs JAX golden", kernel[3], keys,
                 golden["update_summary"], whole)

    step = lambda state, c: train_step(state, c, batches[0], eps[0])
    times = time_routes({route: functools.partial(step, *runs[route][:2]) for route in runs},
                        rounds=6, calls=2)
    for route, t in times.items():
        log(f"batch-32 flagship train step, {route} route [{smi}]: {t:.3f} ms "
            f"(CUDA events, routes in turns, median of 6 rounds of 2 steps)")
    return times


def run_phase(cfg):
    """The train mode through apps.main.run on synthetic data (n_train=64:
    32 train rows after the val split, one step per epoch, two epochs),
    with the kernel counts set to 0 just before and read just after; its
    checkpoint restored bit-equal through restore_params; one decode from
    the restored model. Returns the (forward, backward) launch counts."""
    from cape_tpu_torch.apps.main import restore_params, run
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.models.cape import CAPE

    run_cfg = cfg.replace(name="chip_smoke_train", mode="train", num_epochs=2)
    data = synthetic_bodydata(n_train=64, n_test=32, num_verts=6890, seed=cfg.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        # ---- the train main path: every count at 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        trainer = run(run_cfg, workdir, device="cuda", data=data)
        torch.cuda.synchronize()
        after = read_counts()
        counts = (after["launches"], after["bwd_launches"])
        steps = trainer.state.step
        evals = run_cfg.num_epochs + 1   # one val batch per epoch, one test batch
        want = (FWD_PER_STEP * steps + FWD_PER_EVAL * evals, BWD_PER_STEP * steps)
        log(f"train mode run(): {time.perf_counter() - t0:.2f} s, {steps} steps, "
            f"{evals} eval batches, band_apply launches (forward, backward) {counts}; "
            f"all counts {json.dumps(after)}")
        if steps != 2 or counts != want or not only(after, "launches", "bwd_launches"):
            raise AssertionError(f"run(): {steps} steps, launches {counts}, expected {want}")
        restored = restore_params(run_cfg, CAPE(run_cfg), trainer.ctx, workdir)
        trained = trainer.model.state_dict()
        for k, v in restored.state_dict().items():
            if not torch.equal(v, trained[k].cpu()):
                raise AssertionError(f"restored {k} differs from the trained parameter")
        log(f"restore_params: {len(trained)} leaves bit-equal to the trained parameters")
        golden = np.load(GOLDEN)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        restored.to("cuda")
        with torch.inference_mode():
            y, y2 = restored.embed_conditions(dev(golden["pose"]), dev(golden["clo"]))
            zt = torch.cat([dev(golden["z"]), y, y2], -1)
            disp = restored.decode(trainer.ctx, zt, y, y2)
            ref = trainer.model.decode(trainer.ctx, zt, y, y2)
        check_mesh("decode from the restored checkpoint", disp.cpu().numpy(), 32)
        held_to("decode, restored vs trained model", disp.cpu().numpy(), ref.cpu().numpy(),
                rel=1e-6)
        return counts
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main():
    t_start = time.perf_counter()
    smi = device_phase()
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import cheb_kernel
    from cape_tpu_torch.tools.perf_lab import time_routes

    build_phase()
    cfg = load_config(PRESET, batch_size=32, compute_dtype="float32", name="chip_smoke")
    t0 = time.perf_counter()
    ctx = build_context(cfg, device="cuda")
    ctx_plain = build_context(cfg.replace(use_pallas=False), device="cuda")
    log(f"graph contexts built in {time.perf_counter() - t0:.2f} s")
    records = kernel_phase(ctx, smi)
    on_path = [r for r in records if "ms" in r and r["dtype"] == "float32"
               and (r["P"], r["C"]) in ON_PATH]
    bwd_records = addend_phase(ctx, smi)
    bwd_f32 = [r for r in bwd_records if r["dtype"] == "float32"]
    fused_records = fused_phase(ctx, smi)
    bm_records = bm_phase(ctx, smi)
    ring_records, ring_refused, ring_counts = ring_phase(ctx, smi)

    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    engine = InferenceEngine(model, ctx, cfg.batch_size)
    httpd, thread, ms, client = start_server(engine)
    log(f"serving {cfg.name} ({n_params} parameters) on {client.base}; "
        f"warmup {ms.warmup():.2f} s")
    golden = np.load(GOLDEN)
    pose, clo = golden["pose"], golden["clo"]

    # ---- the main path: every count at 0 just before, read just after
    zero_counts()
    engine.calls = dict.fromkeys(engine.calls, 0)
    t0 = time.perf_counter()
    health = client.get("/health")
    served = requests(client, pose, clo)
    stats = client.get("/stats")
    serve_counts = read_counts()
    launches = serve_counts["launches"]
    calls = dict(engine.calls)
    log(f"main path: {time.perf_counter() - t0:.2f} s, device calls {calls}, "
        f"band_apply launches {launches}; all counts {json.dumps(serve_counts)}")
    log(f"/health {json.dumps(health)}")
    log(f"/stats {json.dumps(stats)}")
    stop_server(httpd, thread)
    if health["batch_size"] != 32 or health["num_verts"] != 6890:
        raise AssertionError(f"/health: {health}")
    if calls["decode"] != 4 or calls["encode"] != 2:
        raise AssertionError(f"expected 4 decode and 2 encode device calls, got {calls}")
    if launches != 7 * (calls["decode"] + calls["encode"]) or not only(serve_counts, "launches"):
        raise AssertionError(f"{serve_counts} launches for {calls}: expected 7 band_apply per "
                             "decode/encode call and no other kernel")

    # ---- the plain route on the same requests
    engine_plain = InferenceEngine(model, ctx_plain, cfg.batch_size)
    httpd, thread, _, client = start_server(engine_plain)
    before = cheb_kernel.launches
    plain = requests(client, pose, clo)
    stop_server(httpd, thread)
    if cheb_kernel.launches != before:
        raise AssertionError("the use_pallas=False route launched the kernel")
    for name in ("sample", "decode", "reconstruct"):
        held_to(f"kernel route vs plain route /{name}", served[name]["disp"], plain[name]["disp"])

    # ---- the JAX package's decode at full width
    sd = model.state_dict()
    keys = sorted(sd)
    sums = np.array([sd[k].double().sum().item() for k in keys])
    # the per-leaf sums tests/make_torch_golden.py recorded
    if keys != list(golden["param_keys"]) or not np.allclose(sums, golden["param_sums"],
                                                             rtol=1e-6, atol=1e-6):
        raise AssertionError("parameters from seed 0 differ from the golden file's")
    y, y2 = engine.encode_only_condition(pose, clo)
    disp = engine.decode(np.concatenate([golden["z"], y, y2], -1), y, y2)
    check_mesh("golden decode", disp, 32)
    held_to("kernel route vs JAX golden (batch-32 decode)", disp[: len(golden["disp"])],
            golden["disp"])

    # ---- decode device-call latency, both routes
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    zt, ty, ty2 = dev(np.concatenate([golden["z"], y, y2], -1)), dev(y), dev(y2)
    with torch.inference_mode():
        t = time_routes({name: functools.partial(model.decode, c, zt, ty, ty2)
                         for name, c in (("kernel", ctx), ("plain", ctx_plain))})
    for name, ms in t.items():
        log(f"batch-32 decode device call, {name} route [{smi}]: {ms:.3f} ms")

    # ---- training: the step on both routes, then the train mode
    train_times = train_phase(cfg, ctx, ctx_plain, smi)
    run_fwd, run_bwd = run_phase(cfg)
    log(f"main paths: serve {launches} band_apply launches; train mode {run_fwd} "
        f"band_apply and {run_bwd} band_apply_bwd launches")
    log(f"train step times [{smi}]: " + json.dumps(train_times))
    lab_lines, lab_counts = lab_phase(smi)
    os.makedirs(os.path.dirname(RECORDS), exist_ok=True)
    with open(RECORDS, "w") as f:
        json.dump({"device": smi, "band_apply": records, "band_apply_bwd": bwd_records,
                   "cheb2_fused": fused_records, "band_apply_bm": bm_records,
                   "cheb2_ring": {"records": ring_records, "refused": ring_refused,
                                  "main_path_launches": ring_counts},
                   "lab": lab_lines, "lab_launches": lab_counts}, f)

    per_step = lambda recs, key: sum(TRAIN_APPLIES[(r["P"], r["C"])] * r[key] for r in recs)
    summary = [{
        "name": "band_apply",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        # the serve and train-mode main paths' forward launches
        "launches": launches + run_fwd,
        # worst f32 error over the batch-32 shapes of serving and training;
        # times and bounds summed over the seven band applies of one
        # batch-32 decode
        "max_abs_err": max(r["max_abs_err"] for r in records
                           if "ms" in r and r["dtype"] == "float32"),
        "ms": sum(r["ms"] for r in on_path),
        "plain_ms": sum(r["plain_ms"] for r in on_path),
        **summed_bound(on_path),
        "library_ms": sum(r["library_ms"] for r in on_path),
    }, {
        "name": "band_apply_bwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES_BWD,
        "launches": run_bwd,
        # worst f32 error of the addend variant over the train step's
        # shapes; times and bounds summed over the 17 backward applies of
        # one step
        "max_abs_err": max(r["max_abs_err"] for r in bwd_f32),
        "ms": per_step(bwd_f32, "ms"),
        "plain_ms": per_step(bwd_f32, "plain_ms"),
        **summed_bound(bwd_f32, lambda r: TRAIN_APPLIES[(r["P"], r["C"])]),
        "library_ms": per_step(bwd_f32, "library_ms"),
    }]
    # rows 1, 4, 3, 5 and 6: launches from the lab (rows 1, 3, 4) and from
    # the ring phase's main path (rows 5, 6); the worst f32 error over their
    # phases; times and bounds summed over the batch-32 f32 cases (every
    # FUSED_CONVS shape, padded, that the kernel ran; every banded op). No
    # single library call computes the fused conv.
    fused_err = lambda g: max(r["max_abs_err"] for r in fused_records
                              if r["dtype"] == "float32" and "max_abs_err" in r and (r["G"] == 1) == g)
    fused_t = [r for r in fused_records if "ms" in r and r["dtype"] == "float32" and r["B"] == 32]
    bm_f32 = [r for r in bm_records if r["dtype"] == "float32"]
    bm_t = [r for r in bm_f32 if r["B"] == 32]

    def ring_row(name, replaces, R, key):
        timed = [r for r in ring_records if key in r and r["dtype"] == "float32" and r["B"] == 32]
        return {
            "name": name, "route": "cuda", "source": RING_SOURCE, "replaces": replaces,
            "launches": ring_counts["cheb2_ring" if R == 1 else "cheb2_ring2"],
            "max_abs_err": max(r["max_abs_err"] for r in ring_records
                               if r.get("R") == R and r["dtype"] == "float32"),
            "ms": sum(r[key] for r in timed), "plain_ms": sum(r["plain_ms"] for r in timed),
            **summed_bound(timed), "library_ms": None,
        }

    summary += [{
        "name": "cheb2_fused (group 1)", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": REPLACES_V1, "launches": lab_counts["cheb2_fused_g1"],
        "max_abs_err": fused_err(True),
        "ms": sum(r["g1_ms"] for r in fused_t), "plain_ms": sum(r["plain_ms"] for r in fused_t),
        **summed_bound(fused_t), "library_ms": None,
    }, {
        "name": "band_apply_bm", "route": "cuda", "source": BM_SOURCE,
        "replaces": REPLACES_BM, "launches": lab_counts["band_apply_bm"],
        "max_abs_err": max(r["max_abs_err"] for r in bm_f32),
        "ms": sum(r["ms"] for r in bm_t), "plain_ms": sum(r["plain_ms"] for r in bm_t),
        **summed_bound(bm_t), "library_ms": sum(r["library_ms"] for r in bm_t),
    }, {
        "name": "cheb2_fused (v5 group)", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": REPLACES_V5, "launches": lab_counts["cheb2_fused"],
        "max_abs_err": fused_err(False),
        "ms": sum(r["ms"] for r in fused_t), "plain_ms": sum(r["plain_ms"] for r in fused_t),
        **summed_bound(fused_t), "library_ms": None,
    }, ring_row("cheb2_ring (v6, R=1)", REPLACES_V6, 1, "ms"),
        ring_row("cheb2_ring (v7, R=2)", REPLACES_V7, 2, "r2_ms")]
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.2f} s in all")
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
