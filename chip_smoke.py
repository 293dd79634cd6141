"""Drive the PyTorch port of CAPE (serving and training) once on a CUDA GPU.

    python3 chip_smoke.py       # one GPU; needs the checkout around it

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device: a CUDA GPU must be present (there is no CPU path); TF32 off.
  2. build: compile the two sources of csrc/ with nvcc, both at once;
     log ptxas's registers and spills.
  3. kernel: the band-apply kernel (csrc/band_gather.cu over the op's
     gather pack) against its plain PyTorch version at every batch-32 and
     batch-64 shape of the flagship serving path and every batch-32 shape
     the families phase adds (C = 96 at P = 6912; C = 576, 320, 192 and
     128 of the unfolded decode), one natural-layout and
     one ragged-column case, in f32 and bf16; then its
     addend variant (the backward pass of the conv) at every batch-32
     shape of the train step, the discriminator's [32, 512, 128] included,
     in f32 and bf16, with times against plain and against one library call
     (torch.sparse.mm of the operator as a CSR matrix; addmm with the
     addend), which the port never calls, and the achieved GB/s and share
     of the bound.
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
     step), which ends with the DemoSuite (test_model, then 6 demo poses
     and 4 clothing types); the launches count its device calls too;
     restore_params reads its checkpoint bit-equal, and decodes.
 15. microbatch (after phase 10): the server's default mode, dynamic
     micro-batching, on the flagship (f32, batch 32, seed-0 parameters):
     64 single-mesh /sample requests (distinct seeds, and one seed
     repeated 8 times) and 16 deterministic /reconstruct requests from 16
     threads, counts at 0 just before and read just after. Every response
     within 1e-5 * max|ref| of the same request answered by a
     micro_batch=False server on the same engine; the repeated seed
     bit-equal; decode_calls < decode_requests; band_apply launches exactly
     7 per encode and decode device call, no other kernel; /metrics has the
     cape_microbatch_* counters, /viewer answers 200 with the template
     embedded; drain() returns True. Then request p50/p95 under this load
     in both modes, in turns, 3 rounds (host clock, per request), with the
     device lock's busy share (host seconds inside the engine's calls over
     the wall time).
 16. demo (after phase 15): the nz18 release preset at batch 32 (f32,
     seed-0 parameters, synthetic data), held to
     tests/data/torch_golden_demo.npz: apps.main.run in --mode test
     (test_model's errors within 1e-4 relative, its first two
     reconstructions within 1e-4 * max|ref|) and --mode demo (OBJ files),
     counts at 0 just before and read just after each, 7 launches per
     encode and decode call; a fresh DemoSuite's GMM-prior draw (z within
     1e-6, bodies within 1e-4 * max|ref|); /sample prior="gmm" through the
     server (z bit-equal, meshes within 1e-4 * max|ref|).
 11. fused (after phase 3): the fused conv kernel (rows 1 and 4,
     csrc/cheb2_fused.cu: one streamed GEMM per block tile whose L~x
     operand is gathered from the op's gather pack through shared memory,
     f32 on the CUDA cores, bf16 on the tensor cores) against its plain
     version at each flagship K=2 conv shape and C = F = 64, at every
     square Laplacian, B = 16 and 32, groups 1, 2 and 4, natural and
     padded, f32 and bf16 (bf16 also against two controls that each drop
     one of its numerics); a call without the pack must raise; each
     shape's tile plan (`fused_plan`); times
     against plain, the v3 route and a copy of L~x, the routes in turns,
     each event pair around 10 calls; the B = 32 sums per dtype.
 12. bm (after phase 11): the batch-major band apply (row 3, the same
     band-gather kernel) against its plain version on every banded lap,
     down, up and down_d op, B = 16 and 32, C = 64, f32 and bf16, with
     times taken as in phase 11 (and the library call in f32).
 13. ring (after phase 12): the windowed conv kernel (rows 5 and 6,
     csrc/cheb2_fused.cu's `cheb2_window_kernel`: one and two row tiles a
     block, their x window staged in shared memory) against its plain
     version at every FUSED_CONVS shape, B = 16 and 32, f32 and bf16,
     natural and padded, with the fused phase's limits; its tile plan
     (`ring_plan`) must take every case; a call without the pack must
     raise. Times at B = 32, padded, both dtypes: both tilings, the plain
     version, the fused kernel at group 1 and the v3 route; the B = 32
     sums per dtype. Then its main path, counts at 0 just before
     and read just after: cheb2_banded_v6 and _v7 once each through
     autograd at [32, 6912, 64] -> 64, padded, f32, held to the plain
     conv's autograd (y, dx, dW within 1e-5 relative); one launch each in
     the forward, none in the backward.
 17. families (after phase 16): the model families past the flagship,
     f32, batch 32, seed-0 parameters, each main path with the counts at 0
     just before and read just after, held to
     tests/data/torch_golden_families.npz (written by the JAX package).
     (1) The CMR release preset (GraphCMR group-norm decoder, unfolded
     output conv on 64 + 32 channels) behind the HTTP server: the serve
     phase's requests, 7 band_apply launches per encode and decode device
     call and no other kernel; the same requests on the plain route, no
     launch, held to the kernel route; the golden's decode (1e-4 *
     max|ref|) and encode (z_mean, z_logvar); two GAN steps on the kernel
     and the plain route (17 + 17 and 0 + 0 launches a step) held to the
     golden (metrics 1e-4 relative, updates by hold_updates); the same
     steps with remat=True held to those without it (metrics 1e-5
     relative, updates within 1e-5 of each leaf's max|update|), its extra
     forward launches logged; the decode call and the train step timed on
     both routes (3 rounds of 2 steps); the train mode through
     apps.main.run, as phase 10. (2) default_config.yaml (residual
     encoder, CMR decoder): encode (15 launches) and decode (7) held to the
     golden, two GAN steps (25 + 25 launches a step) held to it. (3) The
     flagship's knobs, one batch-32 decode each through InferenceEngine
     held within 1e-4 * max|ref| to tests/data/torch_golden_flagship.npz:
     fold_conditions=False (9 launches), fuse_decoder=True (0); and to
     the families golden's natural-order decode (JAX's ELL mode; the
     coarsest level's vertex order lays out fc1's output, and only the
     banded mode permutes it): op_mode="ell" (0) and op_mode="dense" (0).
     Phase 3 holds the new apply shapes (FAMILY_APPLIES) to the plain
     version.
 18. train-prod (after phase 17): the JAX package's production training
     setup on the flagship, held to tests/data/torch_golden_bf16.npz
     (written by the JAX package: its bf16 steps beside its f32 steps on
     the same inputs, and the bounds derived from the difference), each
     main path with the counts at 0 just before and read just after.
     (a) bf16 compute at batch 32: two GAN steps on the kernel route, 17 +
     17 band_apply launches a step, all bf16 (`bf16_launches`), and on the
     plain route with none; each held to JAX's bf16 steps (every metric
     within its bound and of JAX's dtype, each leaf's step-2 update summary
     within its player's bound) and to each other by bounds of their own
     (every metric within two bf16 ulps, every leaf's update summary and
     each routed conv's update whole within 5e-2 of its max|update|).
     (b) bf16 at batch 16, JAX's headline: no launch, held to its golden.
     (c) bf16 optimizer state at batch 32, held to its golden; the steps'
     peak device memory (torch.cuda.max_memory_allocated) and the state's
     bytes beside the f32 state's. (d) apps.main.run in bf16 at batch 32 (synthetic n_train=64,
     one step an epoch): 2 epochs with profile_steps=2, and 1 epoch resumed
     with restart=False for 1 more: the final checkpoints within 1e-6 *
     max|leaf| (bit-equal expected), the TensorBoard events read back
     (loss_g scalars, parameter histograms), the profiler trace naming the
     band-gather kernel. (e) the step times of bf16 at batch 16, bf16 at
     batch 32 on both routes and f32 at batch 16, in turns, 6 rounds of 2.
 14. lab (last): the kernel lab's conv, conv --padded 1, layout, fuse and
     bmapply with the counts at 0 just before; its errors within their
     limits; the v2, v1, v5 and bm kernels launched.
Every timed record carries `bound_ms`, the least time the card could take
for the same work (see `bound`). The per-case records go to
build/chip_smoke_kernels.json. The last two lines are a JSON summary of
the kernels and the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
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
PRESET_NZ18 = os.path.join(ROOT, "configs", "CAPE-affineconv_nz18_pose24_clotype8_male.yaml")
GOLDEN_DEMO = os.path.join(ROOT, "tests", "data", "torch_golden_demo.npz")
PRESET_CMR = os.path.join(ROOT, "configs", "CAPE_nz18_pose24_clotype8_male.yaml")
PRESET_DEFAULT = os.path.join(ROOT, "configs", "default_config.yaml")
GOLDEN_FAMILIES = os.path.join(ROOT, "tests", "data", "torch_golden_families.npz")
GOLDEN_BF16 = os.path.join(ROOT, "tests", "data", "torch_golden_bf16.npz")
# no SMPL model file: the demo suites export unposed meshes
NO_SMPL = os.path.join(ROOT, "build", "no_smpl_model")
GATHER_SOURCE = "cape_tpu_torch/csrc/band_gather.cu"   # rows 2, 2b and 3
FUSED_SOURCE = "cape_tpu_torch/csrc/cheb2_fused.cu"   # rows 1, 4, 5 and 6
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
# (P, C) of the band applies the families phase adds: the CMR decoder's
# unfolded output conv (64 block + 32 condition channels), and the
# flagship's decode with fold_conditions=False (conditions concatenated
# before every conv)
FAMILY_APPLIES = [(6912, 96), (896, 576), (896, 320), (1792, 320), (1792, 192), (3456, 192),
                  (6912, 128)]
# the band applies of one batch-32 decode call: the CMR preset's (and
# default_config.yaml's), and the flagship's with fold_conditions=False
CMR_DECODE = [(896, 256), (896, 256), (1792, 128), (1792, 128), (3456, 64), (3456, 64),
              (6912, 96)]
CONCAT_DECODE = [(896, 576), (896, 320), (1792, 320), (1792, 192), (3456, 192), (3456, 128),
                 (6912, 128), (6912, 96), (6912, 96)]
# applies per batch-32 train step in each direction: encoder and decoder
# each run the seven ON_PATH shapes, the three discriminator calls PRED
TRAIN_APPLIES = {**{pc: 2 for pc in ON_PATH}, PRED: 3}
FWD_PER_STEP = BWD_PER_STEP = sum(TRAIN_APPLIES.values())   # 17
FWD_PER_EVAL = 14   # encode + decode of one eval batch
# phase 18's bf16 kernel route against its plain route. They run the same
# code but rows 2 and 2b, which round once where the plain apply rounds
# each term, and cuBLAS's summation order: every metric within two bf16
# ulps of the plain route's (relative); every leaf's step-2 update summary,
# and the whole update of each routed conv's leaves, within
# BF16_ROUTES_UPDATE of the leaf's max|update| (hold_updates). Seen on an
# NVIDIA H100 80GB HBM3 at 700 W: metrics one ulp apart at most (6.9e-3 at
# kl), leaf summaries 1.44e-2 apart at most, the routed leaves' elements
# 1.68e-2 (an unrouted dense leaf's reach 4.5e-2: rounding noise carried
# through the chain).
BF16_ROUTES_METRIC = 2.0 ** -6
BF16_ROUTES_UPDATE = 5e-2
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
COUNTS = ("launches", "bwd_launches", "bf16_launches", "fused1_launches", "fused_launches",
          "bm_launches", "ring_launches", "ring2_launches")


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
    names = ("band_gather", "cheb2_fused")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    build.band_gather_lib()
    build.cheb2_fused_lib()
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
    per element of r). `bytes` is that byte count."""
    el = torch.empty((), dtype=dtype).element_size()
    rows = rows_in + rows_out * (2 if addend else 1)
    nnz = _nnz(blocks)
    nbytes = el * B * C * rows + nnz * (el + 4)
    return {**bound(nbytes, 2 * nnz * B * C + (B * rows_out * C if addend else 0), dtype),
            "bytes": nbytes}


def rate(rec: dict) -> str:
    """A timed band apply's achieved rate: its bound's bytes over its time,
    and its share of the bound."""
    return (f"{rec['bytes'] / rec['ms'] / 1e6:.0f} GB/s, "
            f"{rec['bound_ms'] / rec['ms']:.1%} of the bound")


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
    cases = [(32, P, C, True) for P, C in ON_PATH + [PRED] + FAMILY_APPLIES]
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
            y = band_apply(x, blocks, op.pad_left, rows_out, pack=op.pack)
            ref = band_apply_plain(x, blocks, op.pad_left, rows_out)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            limit = 1e-5 * scale + 1e-6 if dtype == torch.float32 else bf16_ulp(scale)
            S, T = blocks.shape[:2]
            rec = dict(dtype=str(dtype).replace("torch.", ""), B=B, P=P, C=C, S=S, T=T,
                       W=op.pack.width, layout="padded" if padded else "natural",
                       max_abs_err=err, max_rel_err=err / scale, limit=limit)
            log(f"kernel vs plain {rec['dtype']} x[{B},{P},{C}] blocks[{S},{T}] W={rec['W']} "
                f"{rec['layout']}: max_abs_err {err:.3e} rel {err / scale:.3e} "
                f"(limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"band_apply disagrees with its plain version: {rec}")
            if B == 32 and padded and ((P, C) in TRAIN_APPLIES or (P, C) in FAMILY_APPLIES):
                routes = {
                    "ms": lambda: band_apply(x, blocks, op.pad_left, rows_out, pack=op.pack),
                    "plain_ms": lambda: band_apply_plain(x, blocks, op.pad_left, rows_out),
                }
                if dtype == torch.float32:
                    A, xv = csr_operator(blocks, op.pad_left, P, rows_out), vertex_major(x)
                    routes["library_ms"] = lambda: torch.sparse.mm(A, xv)
                rec.update(time_routes(routes))
                rec.update(apply_bound(blocks, B, P, rows_out, C, dtype))
                lib = f", library {rec['library_ms']:.4f}" if "library_ms" in rec else ""
                log(f"  time [{smi}]: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms{lib}, "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); {rate(rec)}")
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
        for P, C in [*TRAIN_APPLIES, FAMILY_APPLIES[0]]:
            op = laps[P]
            blocks = op.blocks.to(dtype).contiguous()
            x = torch.randn((32, P, C), generator=gen, device="cuda").to(dtype)
            r = torch.randn((32, P, C), generator=gen, device="cuda").to(dtype)
            y = band_apply(x, blocks, op.pad_left, P, addend=r, pack=op.pack)
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
                    "ms": lambda: band_apply(x, blocks, op.pad_left, P, addend=r, pack=op.pack),
                    "plain_ms": lambda: band_apply_plain(x, blocks, op.pad_left, P, r),
                    "library_ms": lambda: torch.sparse.addmm(rv, A, xv),
                }))
                rec.update(apply_bound(blocks, 32, P, P, C, dtype, addend=True))
                log(f"  time [{smi}]: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                    f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']}); {rate(rec)}")
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
        band_apply, band_apply_plain, cheb2_banded_v3, fused_cheb2, fused_cheb2_plain, fused_plan,
        v5_group,
    )
    from cape_tpu_torch.tools.perf_lab import time_routes

    laps = _laps(ctx)
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = []
    op, x, w = laps[512], torch.zeros(2, 512, 8, device="cuda"), torch.zeros(8, 4, device="cuda")
    try:
        fused_cheb2(x, op.blocks, op.pad_left, 512, w, w, 1)
    except ValueError as e:
        log(f"fused_cheb2 on a CUDA tensor without the gather pack raises: {e}")
    else:
        raise AssertionError("fused_cheb2 launched on a CUDA tensor without the gather pack")
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
                            y = fused_cheb2(x, blocks, op.pad_left, rows, w0, w1, G, pack=op.pack)
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
                    fused = functools.partial(fused_cheb2, x, blocks, op.pad_left, P, w0, w1,
                                              pack=op.pack)
                    plans = {G: fused_plan(dtype, B, P, C, F, G, op.pack.width) for G in (G5, 1)}
                    with torch.no_grad():
                        lx = band_apply(x, blocks, op.pad_left, P, pack=op.pack)
                        lx_to = torch.empty_like(lx)
                        t = time_routes({
                            "ms": lambda: fused(G5),
                            "g1_ms": lambda: fused(1),
                            "plain_ms": lambda: fused_cheb2_plain(x, blocks, op.pad_left, P, w0, w1),
                            "v3_ms": lambda: cheb2_banded_v3(x, op_d, w),
                            "lx_copy_ms": lambda: lx_to.copy_(lx),
                        })
                    records.append(dict(dtype=name, B=B, P=P, C=C, F=F, G=G5, layout="padded", **t,
                                        **conv_bound(blocks, B, P, P, C, F, dtype),
                                        plan={f"G{G}": p for G, p in plans.items()}))
                    ratio = f", mean err/control {worst_ratio:.3f}" if dtype == torch.bfloat16 else ""
                    plan_s = "; ".join(f"G={G} BN {p['BN']}, {p['rows']} rows x {G}, "
                                       f"{p['smem']} B, grid {p['grid'][:2]}" for G, p in plans.items())
                    log(f"fused {name} x[{B},{P},{C}] F={F} blocks[{blocks.shape[0]},{blocks.shape[1]}]: "
                        f"worst rel err {worst:.2e}{ratio} over G=1,2,4 x natural,padded; {plan_s}; "
                        f"[{smi}] G={G5} {t['ms']:.4f} ms, G=1 {t['g1_ms']:.4f}, "
                        f"plain {t['plain_ms']:.4f}, v3 route {t['v3_ms']:.4f}, "
                        f"copy of L~x {t['lx_copy_ms']:.4f}, bound {records[-1]['bound_ms']:.4f} "
                        f"({records[-1]['bound_by']})")
    for name in ("float32", "bfloat16"):
        timed = [r for r in records if "ms" in r and r["dtype"] == name and r["B"] == 32]
        sums = {k: sum(r[k] for r in timed) for k in ("ms", "g1_ms", "plain_ms", "v3_ms")}
        bnd = summed_bound(timed)
        log(f"fused {name} B=32 padded, summed over {len(timed)} shapes [{smi}]: "
            f"v5 group {sums['ms']:.4f} ms, G=1 {sums['g1_ms']:.4f}, plain {sums['plain_ms']:.4f}, "
            f"v3 route {sums['v3_ms']:.4f}, bound {bnd['bound_ms']:.4f} ({bnd['bound_by']}); "
            f"bound / kernel: v5 group {bnd['bound_ms'] / sums['ms']:.1%}, "
            f"G=1 {bnd['bound_ms'] / sums['g1_ms']:.1%}")
    return records


def bm_phase(ctx, smi):
    """The batch-major band apply (row 3, on the band-gather kernel over
    each op's gather pack) against its plain version on every banded lap,
    down, up and down_d op of the flagship context (cb = 128, 256 and 64),
    B = 16 and 32, C = 64, natural layout, f32 and bf16, with times (routes
    in turns, `time_routes`) and the achieved GB/s. Limits: f32 1e-5 *
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
            apply = functools.partial(banded_apply_bm, pack=op.pack)
            for dtype in (torch.float32, torch.bfloat16):
                blocks = op.blocks.to(dtype).contiguous()
                for B in (16, 32):
                    x = torch.randn((B, op.n_cols, 64), generator=gen, device="cuda").to(dtype)
                    err, scale = _err(apply(x, blocks, *args),
                                      banded_apply_bm_plain(x, blocks, *args))
                    limit = 1e-5 * scale + 1e-6 if dtype == torch.float32 else bf16_ulp(scale)
                    rec = dict(op=f"{field}[{idx}]", dtype=str(dtype).replace("torch.", ""), B=B,
                               C=64, S=S, T=T, cb=cb, n_cols=op.n_cols, n_rows=op.n_rows,
                               max_abs_err=err, max_rel_err=err / scale, limit=limit)
                    if not err <= limit:
                        raise AssertionError(f"banded_apply_bm disagrees with its plain version: {rec}")
                    routes = {
                        "ms": lambda: apply(x, blocks, *args),
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
                        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); {rate(rec)}")
                    records.append(rec)
    return records


def ring_phase(ctx, smi):
    """The windowed conv kernel (rows 5 and 6: `ring_cheb2` with one and two
    row tiles a block) against its plain version at every FUSED_CONVS
    shape, B = 16 and 32, f32 and bf16, natural and padded, with the fused
    phase's limits. Its plan (`ring_plan`, at the op's largest window) must
    take every case, and a CUDA call without the gather pack must raise.
    Each record carries the plan's window rows, BN, shared-memory bytes and
    grid, and the x rows the windows read over P (`x_read`). At B = 32,
    padded, both dtypes: times (routes in turns) of both tilings, the plain
    version, the fused kernel at group 1 and the v3 route, and the bound.
    Then the main path of rows 5 and 6, with every count at 0 just before
    and read just after: `cheb2_banded_v6` and `cheb2_banded_v7` once each
    through autograd at RING_MAIN (padded, f32, x's tail rows 7.0, the
    cotangent's tail zero), held to the plain conv's autograd, y, dx and dW
    within 1e-5 * max|ref|; one launch each in the forward, none in the
    backward. Returns the records and the main path's counts."""
    from cape_tpu_torch.ops.banded import WINDOW_TILES
    from cape_tpu_torch.ops.cheb import cheb_conv
    from cape_tpu_torch.ops.kernels import cheb_kernel as ck
    from cape_tpu_torch.tools.perf_lab import time_routes

    t_phase = time.perf_counter()
    laps = _laps(ctx)
    gen = torch.Generator(device="cuda").manual_seed(4)
    records = []
    op, x, w = laps[512], torch.zeros(2, 512, 8, device="cuda"), torch.zeros(8, 4, device="cuda")
    try:
        ck.ring_cheb2(x, op.blocks, op.pad_left, 512, w, w, 1)
    except ValueError as e:
        log(f"ring_cheb2 on a CUDA tensor without the gather pack raises: {e}")
    else:
        raise AssertionError("ring_cheb2 launched on a CUDA tensor without the gather pack")
    for P, convs in FUSED_CONVS.items():
        op = laps[P]
        S, T = op.blocks.shape[:2]
        x_read = {t: (w[:, 1] - w[:, 0]).sum().item() / P
                  for t, w in zip(WINDOW_TILES, op.pack.windows)}
        for C, F in convs:
            for B in (16, 32):
                for dtype in (torch.float32, torch.bfloat16):
                    name = _name(dtype)
                    blocks = op.blocks.to(dtype).contiguous()
                    w = (torch.randn((2, C, F), generator=gen, device="cuda") / math.sqrt(C)).to(dtype)
                    w0, w1 = w[0], w[1]
                    worst, worst_ratio = 0.0, 0.0
                    for layout in ("natural", "padded"):
                        rows = P if layout == "padded" else op.n_rows
                        plans = {t: ck.ring_plan(dtype, B, rows, C, F, t, op.pack.window_rows[t - 1],
                                                 op.pack.width) for t in WINDOW_TILES}
                        if None in plans.values():
                            raise AssertionError(f"ring_plan refuses {name} B={B} x[{rows},{C}] F={F}: "
                                                 f"{plans}")
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
                        for t, plan in plans.items():
                            y = ck.ring_cheb2(x, blocks, op.pad_left, rows, w0, w1, t, pack=op.pack)
                            err, _ = _err(y, ref)
                            rec = dict(dtype=name, B=B, P=P, C=C, F=F, layout=layout,
                                       x_read=x_read[t], **plan, max_abs_err=err,
                                       max_rel_err=err / scale, limit=limit)
                            if controls is not None:
                                rec["control_ratios"] = ratios = control_ratios(y, ref, controls)
                                worst_ratio = max(worst_ratio, *ratios.values())
                            if not (err <= limit and worst_ratio <= CONTROL_SHARE):
                                raise AssertionError(f"cheb2_window disagrees with its plain version: {rec}")
                            worst = max(worst, err / scale)
                            records.append(rec)
                    if B != 32:
                        continue
                    # padded layout, last x: times of both tilings and their yardsticks
                    op_d = dataclasses.replace(op, blocks=blocks)
                    ring = functools.partial(ck.ring_cheb2, x, blocks, op.pad_left, P, w0, w1,
                                             pack=op.pack)
                    with torch.no_grad():
                        tm = time_routes({
                            "ms": lambda: ring(1),
                            "r2_ms": lambda: ring(2),
                            "plain_ms": lambda: ck.fused_cheb2_plain(x, blocks, op.pad_left, P, w0, w1),
                            "g1_ms": lambda: ck.fused_cheb2(x, blocks, op.pad_left, P, w0, w1, 1,
                                                            pack=op.pack),
                            "v3_ms": lambda: ck.cheb2_banded_v3(x, op_d, w),
                        })
                    records.append(dict(dtype=name, B=B, P=P, C=C, F=F, layout="padded", **tm,
                                        **conv_bound(blocks, B, P, P, C, F, dtype)))
                    plan_s = "; ".join(f"tiles {t}: window {p['window_rows']} rows (x read "
                                       f"{x_read[t]:.2f} P), BN {p['BN']}, {p['smem']} B, "
                                       f"grid {p['grid'][:2]}" for t, p in plans.items())
                    ratio = f", mean err/control {worst_ratio:.3f}" if dtype == torch.bfloat16 else ""
                    log(f"ring {name} x[{B},{P},{C}] F={F} blocks[{S},{T}]: worst rel err {worst:.2e}"
                        f"{ratio} over tiles 1,2 x natural,padded (B=16 too); {plan_s}; [{smi}] "
                        f"ms: tiles 1 {tm['ms']:.4f}, tiles 2 {tm['r2_ms']:.4f}, plain "
                        f"{tm['plain_ms']:.4f}, G=1 {tm['g1_ms']:.4f}, v3 route {tm['v3_ms']:.4f}, "
                        f"bound {records[-1]['bound_ms']:.4f} ({records[-1]['bound_by']})")
    for name in ("float32", "bfloat16"):
        timed = [r for r in records if "ms" in r and r["dtype"] == name]
        sums = {k: sum(r[k] for r in timed) for k in ("ms", "r2_ms", "g1_ms", "plain_ms", "v3_ms")}
        bnd = summed_bound(timed)
        log(f"ring {name} B=32 padded, summed over {len(timed)} shapes [{smi}]: "
            f"tiles 1 {sums['ms']:.4f} ms, tiles 2 {sums['r2_ms']:.4f}, fused G=1 "
            f"{sums['g1_ms']:.4f}, plain {sums['plain_ms']:.4f}, v3 route {sums['v3_ms']:.4f}, "
            f"bound {bnd['bound_ms']:.4f} ({bnd['bound_by']}); bound / kernel: tiles 1 "
            f"{bnd['bound_ms'] / sums['ms']:.1%}, tiles 2 {bnd['bound_ms'] / sums['r2_ms']:.1%}")

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
    return records, counts


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


def start_server(engine, **kw):
    """Serve `engine` on 127.0.0.1:0 from a thread (serve()'s options in
    kw); returns (httpd, thread, model server, CapeClient)."""
    from cape_tpu_torch.apps.client import CapeClient
    from cape_tpu_torch.apps.server import serve

    httpd, ms = serve(engine, "127.0.0.1", 0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, ms, CapeClient(f"http://127.0.0.1:{httpd.server_address[1]}")


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
    """The request plan of the serve phase (npz wire, /encode on JSON);
    returns the responses."""
    from cape_tpu_torch.apps.client import CapeClient

    disp, z = client.sample(pose[:1], clo[:1], n=40, seed=0)
    out = {"sample": {"disp": disp, "z": z}}
    check_mesh("/sample", disp, 40)
    meshes = disp[:3]
    z_mean, z_logvar, y, y2 = CapeClient(client.base_url, wire="json").encode(
        meshes, pose[:3], clo[:3])
    out["encode"] = {"z_mean": z_mean, "z_logvar": z_logvar, "y": y, "y2": y2}
    if not np.isfinite(z_mean).all():
        raise AssertionError("/encode: non-finite z_mean")
    out["decode"] = {"disp": client.decode(z_mean, pose[:3], clo[:3])}
    check_mesh("/decode", out["decode"]["disp"], 3)
    out["reconstruct"] = {"disp": client.reconstruct(meshes, pose[:3], clo[:3])}
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
    [sum, sum of squares, max|.|] and, where present, whole arrays. `rel`
    is one bound for every leaf or one per leaf (in the order of `keys`).

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
    rels = np.broadcast_to(np.asarray(rel, np.float64), (len(keys),))
    for k, (r_sum, r_sq, r_max), rel in zip(keys, summary, rels):
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
    lo, hi = rels.min(), rels.max()
    bounds = f"{lo:.4g}" if lo == hi else f"{lo:.4g}-{hi:.4g}"
    log(f"{name}: {len(keys)} leaves ({len(whole)} whole), worst {rows[0][0]:.3e} at "
        f"{rows[0][1]} (bound {bounds}, relative to the leaf's max|update|); "
        f"{ties} tie elements in all")
    if bad:
        raise AssertionError(f"{name}: updates of {bad} exceed the bound")


def golden_view(golden, prefix: str) -> dict:
    """One preset's arrays of a golden file that holds several, by their
    own names (the families golden's keys are "<prefix>:<name>")."""
    head = prefix + ":"
    return {k[len(head):]: golden[k] for k in golden.files if k.startswith(head)}


def check_fingerprint(name, model, golden) -> None:
    """The model's parameters are the ones the golden was made from: the
    same sorted keys and per-leaf sums (tests/make_torch_golden.py)."""
    sd = model.state_dict()
    keys = sorted(sd)
    sums = np.array([sd[k].double().sum().item() for k in keys])
    if keys != list(golden["param_keys"]) or not np.allclose(sums, golden["param_sums"],
                                                             rtol=1e-6, atol=1e-6):
        raise AssertionError(f"{name}: parameters from seed 0 differ from the golden's")


def gan_steps(cfg, c, batches, eps, spe, golden, dtypes: dict | None = None):
    """GAN steps of a fresh seed-0 model on context c, one per batch and eps,
    its parameters checked against `golden`'s fingerprint. Returns (train
    state, the golden's metrics per step, the last step's updates as numpy,
    band_apply (forward, backward) launches per step); fills `dtypes`, if
    given, with each metric's dtype name."""
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import cheb_kernel
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), c)
    check_fingerprint(cfg.name, model, golden)
    state = TrainState(model.to("cuda"), Optimizer(cfg, spe))
    names = [str(k) for k in golden["metric_names"]]
    metrics, counts = [], []
    for batch, e in zip(batches, eps):
        f0, b0 = cheb_kernel.launches, cheb_kernel.bwd_launches
        m, updates = train_step(state, c, batch, e)
        torch.cuda.synchronize()
        counts.append((cheb_kernel.launches - f0, cheb_kernel.bwd_launches - b0))
        metrics.append({k: float(m[k]) for k in names})
        if dtypes is not None:
            dtypes.update({k: _name(m[k].dtype) for k in names})
    for i, m in enumerate(metrics):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{cfg.name} step {i + 1}: non-finite metrics {m}")
    return state, metrics, {k: v.cpu().numpy() for k, v in updates.items()}, counts


def golden_batches(golden, perm, batch_size: int = 32):
    """The train golden's batch recipe on the device: synthetic data from
    its seed in the context's vertex order, G and D index streams seeded
    seed and seed + 1."""
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.data.synthetic import synthetic_bodydata

    seed = int(golden["seed"])
    data = synthetic_bodydata(n_train=int(golden["n_train"]), n_test=int(golden["n_test"]),
                              num_verts=6890, seed=seed)
    n = len(data.disp_train)
    if n // batch_size != int(golden["steps_per_epoch"]):
        raise AssertionError(f"{n} train rows: not the golden's steps per epoch")
    sg, sd = BatchStream(n, batch_size, seed), BatchStream(n, batch_size, seed + 1)
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
    return batches, n // batch_size


def train_phase(cfg, ctx, ctx_plain, smi):
    """Two GAN steps of the flagship at batch 32 on each route, from the
    seed-0 parameters and the golden's batches and eps; launch counts per
    step; both routes held to each other and to the JAX golden; then the
    step time on both routes. Returns the step times."""
    from cape_tpu_torch.tools.perf_lab import time_routes
    from cape_tpu_torch.train.step import train_step

    golden = np.load(GOLDEN_TRAIN)
    names = [str(k) for k in golden["metric_names"]]
    keys = [str(k) for k in golden["param_keys"]]
    whole = {k[len("update/"):]: golden[k] for k in golden.files if k.startswith("update/")}
    eps = torch.from_numpy(golden["eps"]).cuda()
    batches, spe = golden_batches(golden, ctx.perm0)
    runs = {}
    for route, c in (("kernel", ctx), ("plain", ctx_plain)):
        state, metrics, updates, counts = gan_steps(cfg, c, batches, eps, spe, golden)
        log(f"train step, {route} route: band_apply launches (forward, backward) per step "
            f"{counts}; step 1 " + " ".join(f"{k}={v:.6g}" for k, v in metrics[0].items()))
        want = [(FWD_PER_STEP, BWD_PER_STEP)] * 2 if route == "kernel" else [(0, 0)] * 2
        if counts != want:
            raise AssertionError(f"{route} route: launches {counts}, expected {want}")
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


def run_phase(cfg, golden=None):
    """The train mode through apps.main.run on synthetic data (n_train=64:
    32 train rows after the val split, one step per epoch, two epochs),
    which ends, as the JAX package's, with the DemoSuite (test_model on
    the 32 test rows, then run(): 6 demo poses and 4 clothing types, 5
    samples each), with the kernel counts set to 0 just before and read
    just after; its checkpoint restored bit-equal through restore_params;
    one decode from the restored model of `golden`'s z, pose and clothing
    type (by default the flagship golden's). Returns the (forward,
    backward) launch counts."""
    from cape_tpu_torch.apps.main import restore_params, run
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.models.cape import CAPE

    run_cfg = cfg.replace(name=f"{cfg.name}_train", mode="train", num_epochs=2,
                          smpl_model_folder=NO_SMPL)
    data = synthetic_bodydata(n_train=64, n_test=32, num_verts=6890, seed=cfg.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        # ---- the train main path: every count at 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        result = run(run_cfg, workdir, device="cuda", data=data)
        torch.cuda.synchronize()
        after = read_counts()
        trainer, calls = result.trainer, dict(result.demos.engine.calls)
        counts = (after["launches"], after["bwd_launches"])
        steps = trainer.state.step
        evals = run_cfg.num_epochs   # one val batch per epoch
        # the DemoSuite: test_model's encode and decode call, run()'s ten decodes
        if calls != {"embed": 2, "encode": 1, "decode": 11, "sample": 1}:
            raise AssertionError(f"run(): DemoSuite device calls {calls}")
        demo = 7 * (calls["encode"] + calls["decode"])
        want = (FWD_PER_STEP * steps + FWD_PER_EVAL * evals + demo, BWD_PER_STEP * steps)
        log(f"train mode run(): {time.perf_counter() - t0:.2f} s, {steps} steps, "
            f"{evals} eval batches, DemoSuite device calls {calls}, band_apply launches "
            f"(forward, backward) {counts}; all counts {json.dumps(after)}; test_model "
            + json.dumps(result.test))
        if steps != 2 or counts != want or not only(after, "launches", "bwd_launches"):
            raise AssertionError(f"run(): {steps} steps, launches {counts}, expected {want}")
        if not all(math.isfinite(v) for v in result.test.values()):
            raise AssertionError(f"run(): test_model {result.test}")
        restored = restore_params(run_cfg, CAPE(run_cfg), trainer.ctx, workdir)
        trained = trainer.model.state_dict()
        for k, v in restored.state_dict().items():
            if not torch.equal(v, trained[k].cpu()):
                raise AssertionError(f"restored {k} differs from the trained parameter")
        log(f"restore_params: {len(trained)} leaves bit-equal to the trained parameters")
        golden = np.load(GOLDEN) if golden is None else golden
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


def quantiles(ms: list) -> dict:
    """Nearest-rank p50 and p95 (the server's own rule) of latencies in ms."""
    lat = sorted(ms)
    q = lambda p: lat[max(0, math.ceil(p * len(lat)) - 1)]
    return {"p50_ms": q(0.50), "p95_ms": q(0.95), "n": len(lat)}


def microbatch_load(client, pose, clo, meshes):
    """The microbatch phase's load from 16 threads: 64 single-mesh /sample
    requests (seeds 0..63, except every 8th, which repeats seed 1000 with
    the same conditions) and 16 deterministic /reconstruct requests, mixed.
    Returns [(kind, index, response, latency ms)] in submission order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(job):
        kind, i = job
        t0 = time.perf_counter()
        if kind == "sample":
            rep = i % 8 == 0
            row = 0 if rep else i % len(pose)
            out = client.sample(pose[row:row + 1], clo[row:row + 1], n=1,
                                seed=1000 if rep else i)[0]
        else:
            out = client.reconstruct(meshes[i:i + 1], pose[i:i + 1], clo[i:i + 1])
        return kind, i, out, 1000.0 * (time.perf_counter() - t0)

    jobs = [("sample", i) for i in range(64)]
    for j in range(16):   # one reconstruct after every four samples
        jobs.insert(5 * j + 4, ("reconstruct", j))
    with ThreadPoolExecutor(16) as pool:
        return list(pool.map(one, jobs))


def microbatch_phase(model, ctx, smi):
    """The server's default mode (dynamic micro-batching) on the flagship,
    f32, batch 32: the microbatch load with every count at 0 just before and
    read just after; every response held to the same request answered by a
    micro_batch=False server on the same engine (1e-5 * max|ref|), the
    repeated seed bit-equal, decode_calls < decode_requests, 7 band_apply
    launches per encode and decode device call and no other kernel;
    /metrics and /viewer; drain(). Then request latency p50/p95 under the
    load in both modes, in turns, 3 rounds. Returns (launches, timings)."""
    from cape_tpu_torch.apps.inference import InferenceEngine

    engine = InferenceEngine(model, ctx, 32)
    # the host seconds inside the engine's device calls, all of which hold
    # the server's device lock (each ends in a copy to the host, which
    # waits for the device): busy / wall is the lock's busy share
    busy = [0.0]

    def timed(fn):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                busy[0] += time.perf_counter() - t0

        return call

    for name in ("encode_only_condition", "encode", "decode"):
        setattr(engine, name, timed(getattr(engine, name)))
    golden = np.load(GOLDEN)
    pose, clo = golden["pose"], golden["clo"]
    meshes = np.asarray(golden["disp"][:1].repeat(16, 0)
                        + 0.01 * np.random.default_rng(5).standard_normal((16, 6890, 3)),
                        np.float32)
    httpd, thread, ms, client = start_server(engine)
    ref_httpd, ref_thread, ref_ms, ref_client = start_server(engine, micro_batch=False)
    try:
        ms.warmup()
        # ---- the micro-batched main path: every count at 0 just before, read just after
        zero_counts()
        engine.calls = dict.fromkeys(engine.calls, 0)
        busy[0] = 0.0
        t0 = time.perf_counter()
        got = microbatch_load(client, pose, clo, meshes)
        torch.cuda.synchronize()
        counts, calls, mb = read_counts(), dict(engine.calls), ms.batcher_counts()
        wall = time.perf_counter() - t0
        log(f"microbatch main path: {wall:.3f} s for {len(got)} requests, device lock busy "
            f"{busy[0]:.3f} s ({busy[0] / wall:.1%}), device calls {calls}, batchers "
            f"{json.dumps(mb)}; all counts {json.dumps(counts)}")
        if not mb["decode_calls"] < mb["decode_requests"] == 80:
            raise AssertionError(f"the decode batcher did not coalesce: {mb}")
        if (counts["launches"] != 7 * (calls["encode"] + calls["decode"])
                or not only(counts, "launches")):
            raise AssertionError(f"{counts} for {calls}: expected 7 band_apply launches per "
                                 "encode/decode device call and no other kernel")
        if calls["decode"] != mb["decode_calls"] or calls["encode"] != mb["encode_calls"]:
            raise AssertionError(f"engine calls {calls} are not the batchers' {mb}")
        with urllib.request.urlopen(client.base_url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
        with urllib.request.urlopen(client.base_url + "/viewer", timeout=60) as resp:
            page, ctype = resp.read(), resp.headers["Content-Type"]
        for line in ('cape_microbatch_requests_total{stage="decode"} 80',
                     f'cape_microbatch_device_calls_total{{stage="decode"}} {mb["decode_calls"]}'):
            if line not in metrics:
                raise AssertionError(f"/metrics lacks {line!r}:\n{metrics}")
        if not ctype.startswith("text/html") or b'"template"' not in page:
            raise AssertionError(f"/viewer: {ctype}, {len(page)} bytes, no template")
        log(f"/metrics {len(metrics.splitlines())} lines; /viewer {len(page)} bytes ({ctype})")
        if not ms.drain(timeout=10.0):
            raise AssertionError("drain() found requests in flight after the load")

        # ---- each response against the per-request server's
        ref = microbatch_load(ref_client, pose, clo, meshes)
        worst = 0.0
        for (kind, i, out, _), (_, _, want, _) in zip(got, ref):
            check_mesh(f"/{kind} {i}", out, 1)
            err = float(np.abs(out - want).max())
            worst = max(worst, err / float(np.abs(want).max()))
            if not err <= 1e-5 * float(np.abs(want).max()):
                raise AssertionError(f"/{kind} {i}: coalesced vs per-request {err:.3e}")
        rep = [out for kind, i, out, _ in got if kind == "sample" and i % 8 == 0]
        if not all(np.array_equal(r, rep[0]) for r in rep):
            raise AssertionError("the repeated seed gave different meshes")
        log(f"microbatch: {len(got)} responses within {worst:.3e} * max|ref| of the "
            f"per-request server's; seed 1000 bit-equal in {len(rep)} responses")

        # ---- request latency under the load, both modes in turns
        times = {"micro_batch": [], "per_request": []}
        for r in range(3):
            order = (("micro_batch", client), ("per_request", ref_client))
            for mode, c in order if r % 2 == 0 else order[::-1]:
                busy[0] = 0.0
                t0 = time.perf_counter()
                lat = [t for *_, t in microbatch_load(c, pose, clo, meshes)]
                wall = time.perf_counter() - t0
                times[mode].append({**quantiles(lat), "wall_s": wall, "busy_s": busy[0],
                                    "busy_share": busy[0] / wall})
        timing = {}
        for mode, rounds in times.items():
            timing[mode] = {k: float(np.median([rd[k] for rd in rounds]))
                            for k in ("p50_ms", "p95_ms", "wall_s", "busy_share")}
            log(f"request latency under the load, {mode} [{smi}]: p50 "
                f"{timing[mode]['p50_ms']:.3f} ms, p95 {timing[mode]['p95_ms']:.3f} ms, "
                f"{timing[mode]['wall_s']:.3f} s for 80 requests, device lock busy "
                f"{timing[mode]['busy_share']:.1%} (median of 3 rounds; "
                f"rounds {json.dumps(rounds)})")
        return counts["launches"], timing
    finally:
        stop_server(httpd, thread)
        stop_server(ref_httpd, ref_thread)


def demo_phase(smi):
    """The nz18 release preset at batch 32, f32, seed-0 parameters, held to
    tests/data/torch_golden_demo.npz: apps.main.run in --mode test (its
    errors within 1e-4 relative, its first two reconstructions within 1e-4
    * max|ref|) and --mode demo (OBJ files), each with the counts at 0 just
    before and read just after; a fresh DemoSuite's sample_gmm_prior (z
    within 1e-6, bodies within 1e-4 * max|ref|); and /sample prior="gmm"
    through the server (z bit-equal, meshes within 1e-4 * max|ref|).
    Returns (launches, seconds of each mode)."""
    from cape_tpu_torch.apps.demos import DemoSuite
    from cape_tpu_torch.apps.main import build_context, run
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.meshops.obj_io import load_obj
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.models.gmm import GMM
    from cape_tpu_torch.train.checkpoint import save_checkpoint
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState

    golden = np.load(GOLDEN_DEMO)
    cfg = load_config(PRESET_NZ18, batch_size=32, compute_dtype="float32",
                      name="chip_smoke_nz18", smpl_model_folder=NO_SMPL)
    t0 = time.perf_counter()
    ctx = build_context(cfg, device="cuda")
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    check_fingerprint("nz18 preset", model, golden)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    launches, seconds = 0, {}
    try:
        save_checkpoint(os.path.join(workdir, cfg.name, "checkpoints"),
                        TrainState(model, Optimizer(cfg, 1)), step=0)
        data = synthetic_bodydata(n_train=int(golden["n_train"]), n_test=int(golden["n_test"]),
                                  num_verts=6890, seed=int(golden["seed"]))
        log(f"demo phase set-up (nz18 context, checkpoint, data): "
            f"{time.perf_counter() - t0:.2f} s")
        results = {}
        for mode in ("test", "demo"):
            # ---- the mode's main path: every count at 0 just before, read just after
            zero_counts()
            t0 = time.perf_counter()
            result = run(cfg.replace(mode=mode), workdir, device="cuda",
                         data=data if mode == "test" else None)
            torch.cuda.synchronize()
            seconds[mode] = time.perf_counter() - t0
            counts, calls = read_counts(), dict(result.demos.engine.calls)
            per_call = counts["launches"] / max(1, calls["encode"] + calls["decode"])
            log(f"--mode {mode} [{smi}]: {seconds[mode]:.3f} s (host clock, restore included), "
                f"device calls {calls}, band_apply launches {counts['launches']} "
                f"({per_call:g} per encode/decode call); all counts {json.dumps(counts)}")
            if (counts["launches"] != 7 * (calls["encode"] + calls["decode"])
                    or not only(counts, "launches")):
                raise AssertionError(f"--mode {mode}: {counts} for {calls}")
            launches += counts["launches"]
            results[mode] = result
        got = results["test"].test
        held_metrics("test_model vs JAX golden",
                     {k: got[k] for k in golden["error_names"]},
                     dict(zip(golden["error_names"], golden["errors"])))
        run_dir = os.path.join(workdir, cfg.name)
        obj_dir = os.path.join(run_dir, f"test_reconstruction_objs_{cfg.dataset}")
        recon = np.stack([load_obj(os.path.join(obj_dir, f"recon_{i:04d}.obj"))[0]
                          for i in range(len(golden["recon"]))])
        held_to("test_model reconstructions vs JAX golden", recon, golden["recon"])
        n_objs = {d: len(os.listdir(os.path.join(run_dir, d)))
                  for d in ("sample_vary_pose", "sample_vary_clotype")}
        if n_objs != {"sample_vary_pose": 6 * cfg.demo_n_sample,
                      "sample_vary_clotype": 4 * cfg.demo_n_sample}:
            raise AssertionError(f"--mode demo wrote {n_objs}")
        for d in n_objs:
            v, _ = load_obj(os.path.join(run_dir, d, sorted(os.listdir(os.path.join(run_dir, d)))[0]))
            check_mesh(f"--mode demo {d}", v[None], 1)

        # ---- the GMM prior: a fresh suite's draw, and the server's
        engine = results["demo"].demos.engine
        gmm = GMM.load_pretrained()
        key = int(np.random.default_rng(cfg.seed).integers(1 << 30))
        z = gmm.sample(prng.PRNGKey(key), len(golden["gmm_z"]))
        if key != int(golden["gmm_key"]):
            raise AssertionError(f"the suite's first key {key} is not the golden's")
        held_to("GMM.sample latents vs JAX golden", z, golden["gmm_z"],
                rel=1e-6 / float(np.abs(golden["gmm_z"]).max()))
        suite = DemoSuite(engine, cfg.name, cfg.dataset, cfg.gender, cfg.demo_n_sample, False,
                          NO_SMPL, workdir, cfg.seed)
        held_to("sample_gmm_prior bodies vs JAX golden",
                suite.sample_gmm_prior(n=len(golden["gmm_z"])), golden["gmm_full"])
        httpd, thread, ms, client = start_server(engine, gmm=gmm)
        try:
            disp, z = client.sample(golden["srv_pose"], golden["srv_clo"], n=len(golden["srv_z"]),
                                    prior="gmm", seed=int(golden["srv_seed"]))
        finally:
            stop_server(httpd, thread)
        if not np.array_equal(z, golden["srv_z"]):
            raise AssertionError("/sample prior=gmm: z differs from the JAX server's draw")
        held_to("/sample prior=gmm meshes vs JAX golden", disp[: len(golden["srv_disp"])],
                golden["srv_disp"])
        return launches, seconds
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def served_launches(name, engine, counts, per_call: int) -> int:
    """The band_apply launches of a main path that ran `engine`'s device
    calls: exactly per_call per encode and decode call, no other kernel."""
    calls = dict(engine.calls)
    want = per_call * (calls["encode"] + calls["decode"])
    log(f"{name}: device calls {calls}, band_apply launches {counts['launches']} "
        f"(expected {want}); all counts {json.dumps(counts)}")
    if counts["launches"] != want or not only(counts, "launches"):
        raise AssertionError(f"{name}: {counts} for {calls}")
    return counts["launches"]


def cmr_serve(cfg, ctx, ctx_plain, golden, smi):
    """The CMR preset behind the HTTP server on both routes, then the
    golden decode and encode and the decode time. Returns (launches, the
    model on the GPU, decode times)."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.tools.perf_lab import time_routes

    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
    check_fingerprint("CMR preset", model, golden)
    model.to("cuda")
    pose, clo = golden["pose"], golden["clo"]
    engine = InferenceEngine(model, ctx, cfg.batch_size)
    httpd, thread, ms, client = start_server(engine)
    log(f"serving {cfg.name} ({sum(p.numel() for p in model.parameters())} parameters); "
        f"warmup {ms.warmup():.2f} s")
    try:
        # ---- the CMR serve path: every count at 0 just before, read just after
        zero_counts()
        engine.calls = dict.fromkeys(engine.calls, 0)
        served = requests(client, pose, clo)
        launches = served_launches("CMR preset served", engine, read_counts(), 7)
    finally:
        stop_server(httpd, thread)
    engine_plain = InferenceEngine(model, ctx_plain, cfg.batch_size)
    httpd, thread, _, client = start_server(engine_plain)
    try:
        zero_counts()
        plain = requests(client, pose, clo)
        if any(read_counts().values()):
            raise AssertionError(f"the CMR preset's plain route launched {read_counts()}")
    finally:
        stop_server(httpd, thread)
    for name in ("sample", "decode", "reconstruct"):
        held_to(f"CMR preset, kernel route vs plain route /{name}", served[name]["disp"],
                plain[name]["disp"])

    # ---- the JAX golden's decode and encode (main path: counts at 0, read after)
    zero_counts()
    engine.calls = dict.fromkeys(engine.calls, 0)
    y, y2 = engine.encode_only_condition(pose, clo)
    disp = engine.decode(np.concatenate([golden["z"], y, y2], -1), y, y2)
    check_mesh("CMR golden decode", disp, 32)
    x = golden_meshes(golden)
    z_mean, z_logvar, _, _ = engine.encode(x, pose, clo)
    launches += served_launches("CMR preset golden decode and encode", engine, read_counts(), 7)
    held_to("CMR preset, kernel route vs JAX golden (batch-32 decode)", disp[: len(golden["disp"])],
            golden["disp"])
    held_to("CMR preset, kernel route vs JAX golden (encode z_mean)", z_mean, golden["z_mean"])
    held_to("CMR preset, kernel route vs JAX golden (encode z_logvar)", z_logvar,
            golden["z_logvar"])

    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    zt, ty, ty2 = dev(np.concatenate([golden["z"], y, y2], -1)), dev(y), dev(y2)
    with torch.inference_mode():
        t = time_routes({name: functools.partial(model.decode, c, zt, ty, ty2)
                         for name, c in (("kernel", ctx), ("plain", ctx_plain))})
    for name, v in t.items():
        log(f"batch-32 CMR preset decode device call, {name} route [{smi}]: {v:.3f} ms")
    return launches, t


def golden_meshes(golden) -> np.ndarray:
    """The families golden's 32 meshes to encode, drawn again (the recipe of
    tests/make_torch_golden.py), checked against the golden's sums."""
    x = (0.02 * np.random.default_rng(2).standard_normal((32, 6890, 3))).astype(np.float32)
    sums = np.array([x.astype(np.float64).sum(), np.abs(x.astype(np.float64)).sum()])
    if not np.allclose(sums, golden["x_sums"], rtol=1e-12, atol=0):
        raise AssertionError(f"encode meshes {sums} are not the golden's {golden['x_sums']}")
    return x


def hold_steps(name, runs_metrics, updates, golden) -> None:
    """Two steps' metrics (1e-4 relative) and the step-2 updates
    (hold_updates) against a families golden. The updates' bound is the
    larger of 1e-3 and twice the golden's `update_spread`: how far JAX's
    own updates move when its parameters move by about one float32 ulp
    (tests/make_torch_golden.py). Where the step is that sensitive to
    rounding, no f32 implementation can come closer."""
    names = [str(k) for k in golden["metric_names"]]
    keys = [str(k) for k in golden["param_keys"]]
    whole = {k[len("update/"):]: golden[k] for k in golden if k.startswith("update/")}
    for i, m in enumerate(runs_metrics):
        held_metrics(f"{name} step {i + 1} vs JAX golden", m, dict(zip(names, golden["metrics"][i])))
    rel = max(1e-3, 2 * float(golden["update_spread"]))
    log(f"{name}: JAX's one-ulp update spread {float(golden['update_spread']):.3e}, "
        f"bound {rel:.3e}")
    hold_updates(f"{name} step-2 updates vs JAX golden", updates, keys, golden["update_summary"],
                 whole, rel=rel)


def families_phase(flagship_cfg, flagship_ctx, smi):
    """Phase 17: the model families past the flagship, each main path with
    the counts at 0 just before and read just after. Returns (forward
    launches, backward launches, times)."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.tools.perf_lab import time_routes
    from cape_tpu_torch.train.step import train_step

    fam = np.load(GOLDEN_FAMILIES)
    times = {}
    # ---- 1. the CMR release preset: served, golden, trained, remat
    golden = golden_view(fam, "cmr")
    cfg = load_config(PRESET_CMR, batch_size=32, compute_dtype="float32", name="chip_smoke_cmr")
    t0 = time.perf_counter()
    ctx = build_context(cfg, device="cuda")
    ctx_plain = build_context(cfg.replace(use_pallas=False), device="cuda")
    log(f"CMR preset contexts built in {time.perf_counter() - t0:.2f} s")
    fwd, t = cmr_serve(cfg, ctx, ctx_plain, golden, smi)
    times["cmr_decode_ms"] = t
    bwd = 0
    eps = torch.from_numpy(golden["eps"]).cuda()
    batches, spe = golden_batches(golden, ctx.perm0)
    runs = {}
    for route, c, rcfg in (("kernel", ctx, cfg), ("plain", ctx_plain, cfg),
                           ("remat", ctx, cfg.replace(remat=True))):
        zero_counts()
        state, metrics, updates, counts = gan_steps(rcfg, c, batches, eps, spe, golden)
        total = read_counts()
        log(f"CMR train steps, {route}: band_apply launches (forward, backward) per step "
            f"{counts}; all counts {json.dumps(total)}")
        want = {"kernel": [(FWD_PER_STEP, BWD_PER_STEP)] * 2, "plain": [(0, 0)] * 2}.get(route)
        if want is not None and counts != want:
            raise AssertionError(f"CMR {route} steps: launches {counts}, expected {want}")
        if not only(total, "launches", "bwd_launches"):
            raise AssertionError(f"CMR {route} steps launched {total}")
        if route == "remat":
            # the checkpointed blocks' forwards run again in the backward pass
            extra = [f - FWD_PER_STEP for f, _ in counts]
            log(f"CMR train steps with remat: {extra} band_apply forward launches per step "
                f"beyond the {FWD_PER_STEP} of the steps without it (recomputed blocks)")
            if any(b != BWD_PER_STEP for _, b in counts) or min(extra) <= 0:
                raise AssertionError(f"CMR remat steps: launches {counts}")
        fwd += total["launches"]
        bwd += total["bwd_launches"]
        runs[route] = (state, c, metrics, updates)
    for route in ("kernel", "plain"):
        hold_steps(f"CMR preset, {route} route", runs[route][2], runs[route][3], golden)
    for i in range(2):
        held_metrics(f"CMR step {i + 1}, remat vs without", runs["remat"][2][i],
                     runs["kernel"][2][i], rel=1e-5)
    worst = max(np.abs(runs["remat"][3][k] - u).max() / max(np.abs(u).max(), 1e-30)
                for k, u in runs["kernel"][3].items())
    log(f"CMR step-2 updates, remat vs without: worst {worst:.3e} of the leaf's max|update| "
        f"(limit 1e-5)")
    if not worst <= 1e-5:
        raise AssertionError("CMR remat updates differ from the updates without it")
    step = lambda state, c: train_step(state, c, batches[0], eps[0])
    t = time_routes({route: functools.partial(step, *runs[route][:2])
                     for route in ("kernel", "plain")}, rounds=3, calls=2)
    for route, v in t.items():
        log(f"batch-32 CMR preset train step, {route} route [{smi}]: {v:.3f} ms "
            f"(CUDA events, routes in turns, median of 3 rounds of 2 steps)")
    times["cmr_step_ms"] = t
    del runs, ctx_plain
    # the train entry point a user calls (apps.main.run, as phase 10)
    run_fwd, run_bwd = run_phase(cfg, golden)
    fwd += run_fwd
    bwd += run_bwd

    # ---- 2. default_config.yaml: residual encoder and CMR decoder
    golden = golden_view(fam, "default")
    dcfg = load_config(PRESET_DEFAULT, batch_size=32, compute_dtype="float32",
                       name="chip_smoke_default")
    model = CAPE(dcfg).init_params(torch.Generator().manual_seed(0), ctx)
    check_fingerprint("default_config.yaml", model, golden)
    engine = InferenceEngine(model.to("cuda"), ctx, 32)
    pose, clo = golden["pose"], golden["clo"]
    x = golden_meshes(golden)
    for stage, per_call in (("encode", 15), ("decode", 7)):
        zero_counts()
        engine.calls = dict.fromkeys(engine.calls, 0)
        if stage == "encode":
            z_mean, z_logvar, y, y2 = engine.encode(x, pose, clo)
        else:
            disp = engine.decode(np.concatenate([golden["z"], y, y2], -1), y, y2)
        counts = read_counts()
        calls = dict(engine.calls)
        log(f"default_config.yaml {stage}: device calls {calls}; all counts {json.dumps(counts)}")
        if counts["launches"] != per_call * calls[stage] or not only(counts, "launches"):
            raise AssertionError(f"default_config.yaml {stage}: {counts} for {calls}")
        fwd += counts["launches"]
    held_to("default_config.yaml vs JAX golden (encode z_mean)", z_mean, golden["z_mean"])
    held_to("default_config.yaml vs JAX golden (encode z_logvar)", z_logvar, golden["z_logvar"])
    check_mesh("default_config.yaml golden decode", disp, 32)
    held_to("default_config.yaml vs JAX golden (batch-32 decode)", disp[: len(golden["disp"])],
            golden["disp"])
    batches, spe = golden_batches(golden, ctx.perm0)
    zero_counts()
    _, metrics, updates, counts = gan_steps(dcfg, ctx, batches,
                                            torch.from_numpy(golden["eps"]).cuda(), spe, golden)
    total = read_counts()
    log(f"default_config.yaml train steps: band_apply launches (forward, backward) per step "
        f"{counts}; all counts {json.dumps(total)}")
    if counts != [(25, 25)] * 2 or not only(total, "launches", "bwd_launches"):
        raise AssertionError(f"default_config.yaml steps: launches {counts}, expected 25 + 25")
    fwd += total["launches"]
    bwd += total["bwd_launches"]
    hold_steps("default_config.yaml", metrics, updates, golden)
    del engine, model, ctx

    # ---- 3. the flagship's knobs, each held to the flagship golden; the
    # ELL and dense modes keep the natural vertex order, in which fc1's
    # output is laid out otherwise, so they have a golden of their own
    golden = np.load(GOLDEN)
    natural = golden_view(fam, "natural")
    knobs = [("fold_conditions=False", {"fold_conditions": False}, 9, golden),
             ("fuse_decoder=True", {"fuse_decoder": True}, 0, golden),
             ('op_mode="ell"', {"op_mode": "ell"}, 0, natural),
             ('op_mode="dense"', {"op_mode": "dense"}, 0, natural)]
    for name, change, per_call, ref in knobs:
        kcfg = flagship_cfg.replace(**change)
        t0 = time.perf_counter()
        kctx = flagship_ctx if name.startswith("fold") else build_context(kcfg, device="cuda")
        model = CAPE(kcfg).init_params(torch.Generator().manual_seed(0), kctx)
        check_fingerprint(f"flagship {name}", model, ref)
        engine = InferenceEngine(model.to("cuda"), kctx, 32)
        y, y2 = engine.encode_only_condition(golden["pose"], golden["clo"])
        zero_counts()
        engine.calls = dict.fromkeys(engine.calls, 0)
        disp = engine.decode(np.concatenate([golden["z"], y, y2], -1), y, y2)
        fwd += served_launches(f"flagship decode, {name}", engine, read_counts(), per_call)
        check_mesh(f"flagship decode, {name}", disp, 32)
        held_to(f"flagship decode, {name}, vs JAX golden", disp[: len(ref["disp"])], ref["disp"])
        log(f"  ({time.perf_counter() - t0:.2f} s with the context)")
        del engine, model, kctx
    return fwd, bwd, times


def source_leaves(t: torch.Tensor) -> list[torch.Tensor]:
    """The autograd leaves (parameters) that `t` is computed from: t itself
    when it is a leaf, else the variables of the AccumulateGrad nodes that
    its graph reaches (a folded conv passes a cast and sliced weight)."""
    if t.grad_fn is None:
        return [t]
    leaves, todo = [], [t.grad_fn]
    while todo:
        fn = todo.pop()
        if hasattr(fn, "variable"):
            leaves.append(fn.variable)
        elif fn is not None:
            todo.extend(f for f, _ in fn.next_functions)
    return leaves


@contextlib.contextmanager
def kernel_route_weights(seen: list):
    """Append to `seen` the weight of every conv that the routing gate
    (ops.cheb) sends to the kernel route while the block runs."""
    from cape_tpu_torch.ops.kernels import cheb_kernel

    v3 = cheb_kernel.cheb2_banded_v3

    def spy(x, band_op, weight):
        seen.append(weight)
        return v3(x, band_op, weight)

    cheb_kernel.cheb2_banded_v3 = spy
    try:
        yield seen
    finally:
        cheb_kernel.cheb2_banded_v3 = v3


def bf16_view(golden, prefix: str) -> dict:
    """One configuration of the bf16 golden (b32, b16, opt) by its own
    names, with the shared parameter fingerprint and leaf names."""
    view = golden_view(golden, prefix)
    view.update({k: golden[k] for k in ("param_keys", "param_sums", "metric_names")})
    return view


def hold_bf16(name, runs_metrics, dtypes, updates, golden) -> None:
    """A bf16 run held to JAX's bf16 golden by the golden's derived bounds
    (tests/make_torch_golden.py bf16_bounds: from bf16's effect in JAX,
    its bf16 step against its f32 step): every metric of both steps within
    its bound, relative, and of JAX's dtype; each leaf's step-2 update
    summary within its bound (hold_updates)."""
    names = [str(k) for k in golden["metric_names"]]
    want = dict(zip(names, (str(d) for d in golden["metric_dtypes"])))
    if dtypes != want:
        raise AssertionError(f"{name}: metric dtypes {dtypes}, JAX's {want}")
    for i, m in enumerate(runs_metrics):
        ref, bound = golden["metrics"][i], golden["metric_bound"][i]
        errs = np.array([abs(m[k] - r) / abs(r) for k, r in zip(names, ref)])
        log(f"{name} step {i + 1} vs JAX bf16 golden: " + " ".join(
            f"{k}={m[k]:.7g}/{r:.7g} ({e:.2e} of {b:.2e})"
            for k, r, e, b in zip(names, ref, errs, bound)))
        if not (errs <= bound).all():
            raise AssertionError(f"{name} step {i + 1}: metrics outside the derived bounds")
    hold_updates(f"{name} step-2 updates vs JAX bf16 golden", updates,
                 [str(k) for k in golden["param_keys"]], golden["update_summary"], {},
                 rel=golden["update_bound"])


def resume_phase(cfg, smi) -> tuple[dict, dict]:
    """Phase 18 (d): the train mode through apps.main.run in bf16 at batch 32
    on synthetic data (one step per epoch): 2 epochs with TensorBoard and
    profile_steps=2; 1 epoch, then 1 more with restart=False; the counts at
    0 just before each run and read just after. The resumed run's final
    checkpoint within 1e-6 * max|leaf| of the uninterrupted run's (bit-equal
    expected); the event file parsed by the port's read_events, with loss_g
    scalars and parameter histograms; the trace naming the band-gather
    kernel. Returns (launch counts by run, what was found)."""
    from cape_tpu_torch.apps.main import run
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.train.checkpoint import latest_checkpoint
    from cape_tpu_torch.train.tb_events import read_events

    data = synthetic_bodydata(n_train=64, n_test=32, num_verts=6890, seed=cfg.seed)
    base = cfg.replace(mode="train", smpl_model_folder=NO_SMPL, save_obj=False)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    plan = [("whole", dict(name=f"{cfg.name}_whole", num_epochs=2, profile_steps=2)),
            ("first", dict(name=f"{cfg.name}_split", num_epochs=1)),
            ("resumed", dict(name=f"{cfg.name}_split", num_epochs=1, restart=False))]
    counts, trainers = {}, {}
    try:
        for label, change in plan:
            # ---- a train main path: every count at 0 just before, read just after
            zero_counts()
            t0 = time.perf_counter()
            result = run(base.replace(**change), workdir, device="cuda", data=data)
            torch.cuda.synchronize()
            counts[label] = read_counts()
            trainers[label] = result.trainer
            calls = dict(result.demos.engine.calls)
            steps = result.trainer.num_steps
            c = counts[label]
            demo = 7 * (calls["encode"] + calls["decode"])
            want = (FWD_PER_STEP * steps + FWD_PER_EVAL * change["num_epochs"] + demo,
                    BWD_PER_STEP * steps)
            log(f"resume, {label} run(): {time.perf_counter() - t0:.2f} s, {steps} steps to step "
                f"{result.trainer.state.step}, DemoSuite calls {calls}; counts {json.dumps(c)}")
            if ((c["launches"], c["bwd_launches"]) != want
                    or c["bf16_launches"] != c["launches"] + c["bwd_launches"]
                    or not only(c, "launches", "bwd_launches", "bf16_launches")):
                raise AssertionError(f"resume {label}: counts {c}, expected {want}, all bf16")
        whole, split = trainers["whole"], trainers["resumed"]
        a, b = latest_checkpoint(whole.ckpt_dir), latest_checkpoint(split.ckpt_dir)
        if os.path.basename(a) != os.path.basename(b) or split.state.step != 2:
            raise AssertionError(f"resume: checkpoints {a} and {b}")
        worst, equal = 0.0, True
        with np.load(a) as za, np.load(b) as zb:
            if sorted(za.files) != sorted(zb.files):
                raise AssertionError("resume: the checkpoints hold other keys")
            for k in za.files:
                x, y = za[k].astype(np.float64), zb[k].astype(np.float64)
                equal = equal and np.array_equal(x, y)
                scale = max(float(np.abs(x).max()), 1e-30)
                worst = max(worst, float(np.abs(x - y).max()) / scale)
            n_keys = len(za.files)
        log(f"resume: final checkpoint of 1 + 1 epochs against 2 epochs, {n_keys} leaves: "
            f"bit-equal {equal}, worst {worst:.3e} of max|leaf| (limit 1e-6)")
        if not worst <= 1e-6:
            raise AssertionError("resume: the resumed run's checkpoint differs")
        events = [e for p in sorted(glob.glob(os.path.join(whole.run_dir,
                                                           "events.out.tfevents.*")))
                  for e in read_events(p)]
        loss_steps = [e["step"] for e in events if "train/loss_g" in e["scalars"]]
        hists = sorted({t for e in events for t in e["histograms"]})
        log(f"resume: TensorBoard events of the 2-epoch run: {len(events)} records, loss_g at "
            f"steps {loss_steps}, {len(hists)} parameter histograms")
        if loss_steps != [0, 1] or "params/generator/decoder/fc1/kernel" not in hists:
            raise AssertionError("resume: TensorBoard events lack loss_g or histograms")
        with open(os.path.join(whole.run_dir, "profile", "trace.json")) as f:
            names = {str(ev.get("name", "")) for ev in json.load(f)["traceEvents"]}
        gather = sorted(n for n in names if "band_gather_kernel" in n)
        log(f"resume: profiler trace of the 2-epoch run: {len(names)} event names, "
            f"band-gather kernels {gather}")
        if not gather:
            raise AssertionError("resume: the profiler trace names no band_gather_kernel")
        found = {"bit_equal": equal, "worst_rel": worst, "tb_records": len(events),
                 "histograms": len(hists), "trace_kernels": gather}
        return counts, found
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def train_prod_phase(cfg, ctx, smi):
    """Phase 18: the JAX package's production training setup on the
    flagship, held to tests/data/torch_golden_bf16.npz (written by the JAX
    package), each main path with the counts at 0 just before and read just
    after. (a) bf16 compute at batch 32, two GAN steps on the kernel route
    (17 + 17 band_apply launches a step, all bf16) and the plain route
    (none), each held to JAX's bf16 golden by the derived bounds and to the
    other by BF16_ROUTES_METRIC and BF16_ROUTES_UPDATE; (b) bf16 at batch
    16 (JAX's headline; no launch); (c) bf16 optimizer state at batch 32,
    with the peak memory of the steps beside the f32 state's; (d) resume_phase; (e) the step times, the
    routes in turns, 6 rounds of 2 steps. Returns (forward and backward
    launches, the records)."""
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.tools.perf_lab import time_routes
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    gold = np.load(GOLDEN_BF16)
    bcfg = cfg.replace(compute_dtype="bfloat16", name="chip_smoke_bf16")
    t_phase = t0 = time.perf_counter()
    ctx_bf = build_context(bcfg, device="cuda")
    ctx_bf_plain = build_context(bcfg.replace(use_pallas=False), device="cuda")
    log(f"bf16 graph contexts built in {time.perf_counter() - t0:.2f} s")
    fwd = bwd = 0
    runs, records = {}, {}
    plan = [("b32 kernel", "b32", bcfg, ctx_bf, (FWD_PER_STEP, BWD_PER_STEP)),
            ("b32 plain", "b32", bcfg, ctx_bf_plain, (0, 0)),
            ("b16", "b16", bcfg.replace(batch_size=16), ctx_bf, (0, 0)),
            ("opt-state bf16", "opt", bcfg.replace(opt_state_dtype="bfloat16"), ctx_bf,
             (FWD_PER_STEP, BWD_PER_STEP))]
    for label, prefix, rcfg, c, per_step in plan:
        golden = bf16_view(gold, prefix)
        if str(golden["opt_state_dtype"]) != rcfg.opt_state_dtype:
            raise AssertionError(f"{label}: the golden's opt_state_dtype is "
                                 f"{golden['opt_state_dtype']}")
        batch_size = int(golden["batch"])
        batches, spe = golden_batches(golden, c.perm0, batch_size)
        eps = torch.from_numpy(golden["eps"]).cuda()
        dtypes = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        # ---- the main path: every count at 0 just before, read just after
        zero_counts()
        with kernel_route_weights([]) as routed:
            state, metrics, updates, counts = gan_steps(rcfg, c, batches, eps, spe, golden,
                                                        dtypes)
        total = read_counts()
        peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20
        moments = [t for bufs in state.tx.buffers.values() for t in bufs.values()]
        state_mb = sum(t.numel() * t.element_size() for t in moments) / 2**20
        log(f"{label} (bf16 compute, batch {batch_size}, {rcfg.opt_state_dtype} optimizer "
            f"state): band_apply launches (forward, backward) per step {counts}; all counts "
            f"{json.dumps(total)}; steps' peak memory {peak_mb:.3f} MiB above the "
            f"{mem0 / 2**20:.3f} allocated before, optimizer state {state_mb:.3f} MiB "
            f"({sorted({_name(t.dtype) for t in moments})})")
        if counts != [per_step] * 2 or total["bf16_launches"] != 2 * sum(per_step):
            raise AssertionError(f"{label}: launches {counts} ({total}), expected {per_step} "
                                 "a step, all bf16")
        if not only(total, "launches", "bwd_launches", "bf16_launches"):
            raise AssertionError(f"{label} launched {total}")
        fwd += total["launches"]
        bwd += total["bwd_launches"]
        hold_bf16(f"{label}", metrics, dtypes, updates, golden)
        runs[label] = (state, c, batches[0], eps[0], metrics, updates, routed)
        records[label] = {"launches_per_step": counts, "peak_mb": peak_mb, "state_mb": state_mb}
    golden = bf16_view(gold, "b32")
    kernel, plain = runs["b32 kernel"], runs["b32 plain"]
    for i in range(2):
        held_metrics(f"b32 step {i + 1}, kernel route vs plain route", kernel[4][i],
                     plain[4][i], rel=BF16_ROUTES_METRIC)
    # the leaves of the convs on the kernel route (the G loss's view of the
    # discriminator is detached, so its pred conv is found through D's loss)
    sources = [v for w in kernel[6] for v in source_leaves(w)]
    routed = sorted(n for n, p in kernel[0].model.named_parameters()
                    if any(p is v for v in sources))
    log(f"b32: {len(kernel[6])} convs on the kernel route in two steps, {len(routed)} "
        f"leaves: {routed}")
    if len(kernel[6]) != 2 * FWD_PER_STEP or plain[6]:
        raise AssertionError("b32: the routed convs are not the launches")
    keys = [str(k) for k in golden["param_keys"]]
    plain_summary = np.stack([[u.sum(), np.square(u).sum(), np.abs(u).max()]
                              for u in (plain[5][k].astype(np.float64) for k in keys)])
    hold_updates("b32 step-2 updates, kernel route vs plain route", kernel[5], keys,
                 plain_summary, {k: plain[5][k] for k in routed}, rel=BF16_ROUTES_UPDATE)
    log(f"optimizer state, bf16 against f32 at batch 32 [{smi}]: "
        f"{records['opt-state bf16']['state_mb']:.3f} against "
        f"{records['b32 kernel']['state_mb']:.3f} MiB; the two steps' peak "
        f"{records['opt-state bf16']['peak_mb']:.3f} against "
        f"{records['b32 kernel']['peak_mb']:.3f} MiB (torch.cuda.max_memory_allocated)")

    resume_counts, resume_found = resume_phase(bcfg, smi)
    for c in resume_counts.values():
        fwd += c["launches"]
        bwd += c["bwd_launches"]

    # ---- (e) step times: f32 at batch 16 beside the bf16 routes
    golden16 = bf16_view(gold, "b16")
    f32_16 = cfg.replace(batch_size=16)
    batches16, spe16 = golden_batches(golden16, ctx.perm0, 16)
    model = CAPE(f32_16).init_params(torch.Generator().manual_seed(0), ctx).to("cuda")
    f32_state = TrainState(model, Optimizer(f32_16, spe16))
    eps16 = torch.from_numpy(golden16["eps"]).cuda()
    routes = {
        "bf16 b16": runs["b16"][:4],
        "bf16 b32 kernel": runs["b32 kernel"][:4],
        "bf16 b32 plain": runs["b32 plain"][:4],
        "f32 b16": (f32_state, ctx, batches16[0], eps16[0]),
    }
    times = time_routes({k: functools.partial(train_step, *v) for k, v in routes.items()},
                        rounds=6, calls=2)
    for route, t in times.items():
        log(f"flagship train step, {route} [{smi}]: {t:.3f} ms (CUDA events, routes in turns, "
            f"median of 6 rounds of 2 steps)")
    records.update({"step_ms": times, "resume": resume_found,
                    "resume_counts": resume_counts})
    log(f"train-prod phase: {time.perf_counter() - t_phase:.2f} s")
    return fwd, bwd, records


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
    for name, shapes in (("CMR preset", CMR_DECODE), ("fold_conditions=False", CONCAT_DECODE)):
        recs = [next(r for r in records if "ms" in r and r["dtype"] == "float32"
                     and (r["P"], r["C"]) == pc) for pc in shapes]
        total = lambda key: sum(r[key] for r in recs)
        log(f"{name} decode's {len(recs)} band applies, f32 [{smi}]: kernel "
            f"{total('ms'):.4f} ms, plain {total('plain_ms'):.4f}, library "
            f"{total('library_ms'):.4f}, bound {summed_bound(recs)['bound_ms']:.4f}")
    bwd_records = addend_phase(ctx, smi)
    bwd_f32 = [r for r in bwd_records if r["dtype"] == "float32"]
    bwd_step = [r for r in bwd_f32 if (r["P"], r["C"]) in TRAIN_APPLIES]
    fused_records = fused_phase(ctx, smi)
    bm_records = bm_phase(ctx, smi)
    ring_records, ring_counts = ring_phase(ctx, smi)

    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    engine = InferenceEngine(model, ctx, cfg.batch_size)
    httpd, thread, ms, client = start_server(engine)
    log(f"serving {cfg.name} ({n_params} parameters) on {client.base_url}; "
        f"warmup {ms.warmup():.2f} s")
    golden = np.load(GOLDEN)
    pose, clo = golden["pose"], golden["clo"]

    # ---- the main path: every count at 0 just before, read just after
    zero_counts()
    engine.calls = dict.fromkeys(engine.calls, 0)
    t0 = time.perf_counter()
    health = client.health()
    served = requests(client, pose, clo)
    stats = client.stats()
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
    check_fingerprint("flagship", model, golden)
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
    mb_launches, mb_times = microbatch_phase(model, ctx, smi)
    demo_launches, demo_seconds = demo_phase(smi)
    fam_fwd, fam_bwd, fam_times = families_phase(cfg, ctx, smi)
    prod_fwd, prod_bwd, prod_records = train_prod_phase(cfg, ctx, smi)
    log(f"main paths: serve {launches} band_apply launches; train mode {run_fwd} "
        f"band_apply and {run_bwd} band_apply_bwd launches; microbatch {mb_launches} and "
        f"demo {demo_launches} band_apply launches; families {fam_fwd} band_apply and "
        f"{fam_bwd} band_apply_bwd launches; train-prod {prod_fwd} band_apply and {prod_bwd} "
        "band_apply_bwd launches")
    log(f"train-prod step times [{smi}]: " + json.dumps(prod_records["step_ms"]))
    log(f"families times [{smi}]: " + json.dumps(fam_times))
    log(f"serving latency under load [{smi}]: " + json.dumps(mb_times))
    log(f"DemoSuite modes, nz18 at batch 32 [{smi}]: " + json.dumps(demo_seconds))
    log(f"train step times [{smi}]: " + json.dumps(train_times))
    lab_lines, lab_counts = lab_phase(smi)
    os.makedirs(os.path.dirname(RECORDS), exist_ok=True)
    with open(RECORDS, "w") as f:
        json.dump({"device": smi, "band_apply": records, "band_apply_bwd": bwd_records,
                   "cheb2_fused": fused_records, "band_apply_bm": bm_records,
                   "cheb2_window": {"records": ring_records, "main_path_launches": ring_counts},
                   "lab": lab_lines, "lab_launches": lab_counts,
                   "microbatch_latency": mb_times, "demo_mode_seconds": demo_seconds,
                   "families": {"launches": [fam_fwd, fam_bwd], "times": fam_times},
                   "train_prod": {"launches": [prod_fwd, prod_bwd], **prod_records}}, f)

    per_step = lambda recs, key: sum(TRAIN_APPLIES[(r["P"], r["C"])] * r[key] for r in recs)
    summary = [{
        "name": "band_apply",
        "route": "cuda",
        "source": GATHER_SOURCE,
        "replaces": REPLACES,
        # the forward launches of the serve, train-mode, microbatch, demo,
        # families and train-prod main paths
        "launches": launches + run_fwd + mb_launches + demo_launches + fam_fwd + prod_fwd,
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
        "source": GATHER_SOURCE,
        "replaces": REPLACES_BWD,
        "launches": run_bwd + fam_bwd + prod_bwd,
        # worst f32 error of the addend variant over the train steps'
        # shapes (the CMR output conv's included); times and bounds summed
        # over the 17 backward applies of one flagship step
        "max_abs_err": max(r["max_abs_err"] for r in bwd_f32),
        "ms": per_step(bwd_step, "ms"),
        "plain_ms": per_step(bwd_step, "plain_ms"),
        **summed_bound(bwd_step, lambda r: TRAIN_APPLIES[(r["P"], r["C"])]),
        "library_ms": per_step(bwd_step, "library_ms"),
    }]
    # rows 1, 4, 3, 5 and 6: launches from the lab (rows 1, 3, 4) and from
    # the ring phase's main path (rows 5, 6); the worst f32 error over their
    # phases; times and bounds summed over the batch-32 f32 cases (every
    # FUSED_CONVS shape, padded; every banded op). No single library call
    # computes the fused conv: rows 1, 4, 5 and 6 carry the summed v3 route
    # (band-apply kernel plus two matmuls) as their yardstick.
    fused_err = lambda g: max(r["max_abs_err"] for r in fused_records
                              if r["dtype"] == "float32" and "max_abs_err" in r and (r["G"] == 1) == g)
    fused_t = [r for r in fused_records if "ms" in r and r["dtype"] == "float32" and r["B"] == 32]
    fused_v3_ms = sum(r["v3_ms"] for r in fused_t)
    bm_f32 = [r for r in bm_records if r["dtype"] == "float32"]
    bm_t = [r for r in bm_f32 if r["B"] == 32]

    def ring_row(name, replaces, tiles, key):
        timed = [r for r in ring_records if key in r and r["dtype"] == "float32" and r["B"] == 32]
        return {
            "name": name, "route": "cuda", "source": FUSED_SOURCE, "replaces": replaces,
            "launches": ring_counts["cheb2_ring" if tiles == 1 else "cheb2_ring2"],
            "max_abs_err": max(r["max_abs_err"] for r in ring_records
                               if r.get("tiles") == tiles and r["dtype"] == "float32"),
            "ms": sum(r[key] for r in timed), "plain_ms": sum(r["plain_ms"] for r in timed),
            **summed_bound(timed), "library_ms": None, "v3_ms": sum(r["v3_ms"] for r in timed),
        }

    summary += [{
        "name": "cheb2_fused (group 1)", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": REPLACES_V1, "launches": lab_counts["cheb2_fused_g1"],
        "max_abs_err": fused_err(True),
        "ms": sum(r["g1_ms"] for r in fused_t), "plain_ms": sum(r["plain_ms"] for r in fused_t),
        **summed_bound(fused_t), "library_ms": None, "v3_ms": fused_v3_ms,
    }, {
        "name": "band_apply_bm", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": REPLACES_BM, "launches": lab_counts["band_apply_bm"],
        "max_abs_err": max(r["max_abs_err"] for r in bm_f32),
        "ms": sum(r["ms"] for r in bm_t), "plain_ms": sum(r["plain_ms"] for r in bm_t),
        **summed_bound(bm_t), "library_ms": sum(r["library_ms"] for r in bm_t),
    }, {
        "name": "cheb2_fused (v5 group)", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": REPLACES_V5, "launches": lab_counts["cheb2_fused"],
        "max_abs_err": fused_err(False),
        "ms": sum(r["ms"] for r in fused_t), "plain_ms": sum(r["plain_ms"] for r in fused_t),
        **summed_bound(fused_t), "library_ms": None, "v3_ms": fused_v3_ms,
    }, ring_row("cheb2_window (v6, tiles 1)", REPLACES_V6, 1, "ms"),
        ring_row("cheb2_window (v7, tiles 2)", REPLACES_V7, 2, "r2_ms")]
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.2f} s in all")
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
