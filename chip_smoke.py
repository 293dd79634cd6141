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
     torch.Generator seed 0, the test form of core.params that the golden
     files were written for) behind the port's HTTP server on 127.0.0.1:0;
     /health, /sample (n=40: two padded decode calls), /encode, /decode,
     /reconstruct, /stats. The conv route's kernel must have run exactly 7
     times per decode and per encode device call.
  5. plain route: the same requests with use_pallas=False, held to the
     kernel route; no kernel launch, the plain BandedOp applies' included.
  6. golden: the batch-32 decode of tests/data/torch_golden_flagship.npz
     (written by the JAX package) held to 1e-4 * max|ref|.
  7. times: per-shape kernel against plain, and the batch-32 decode call on
     both routes. Every time in this script is `perf_lab.time_routes`'s:
     CUDA events, the routes in turns, each event pair around back-to-back
     calls, the median over rounds of the mean per call.
  8. train step: two flagship GAN steps at batch 32 (f32, seed-0
     parameters, the synthetic batches and eps of
     tests/data/torch_golden_train.npz) on the kernel route, 17 forward
     and 17 backward launches per step and OP_APPLIES_PER_STEP plain
     BandedOp applies on the kernel; the same steps on the plain route
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
     call and no other band kernel; the same requests on the plain route,
     no band launch, held to the kernel route; the golden's decode (1e-4 *
     max|ref|) and encode (z_mean, z_logvar); two GAN steps on the kernel
     and the plain route (17 + 17 and 0 + 0 launches a step) held to the
     golden (metrics 1e-4 relative, updates by hold_updates); the same
     steps with remat=True held to those without it (metrics 1e-5
     relative, updates within 1e-5 of each leaf's max|update|), its extra
     forward launches logged; the decode call and the train step timed on
     both routes (3 rounds of 2 steps); the train mode through
     apps.main.run, as phase 10. The decoder's 24 group norms run the norm
     kernel on both routes (no CUDA tensor takes the plain norm), so the
     routes' comparisons hold the band kernels and the JAX golden holds
     the norm kernel: each serve and train run checks its launches
     (`norm_launches`), 24 per decode call and 72 a step (96 with remat, whose backward runs
     the decoder's blocks again). (2) default_config.yaml (residual
     encoder, CMR decoder): encode (15 launches, no norm) and decode (7;
     24 norm launches) held to the golden, two GAN steps (25 + 25 launches
     and 72 norm launches a step) held to it, and the
     same steps on the plain route, unnudged and with the parameters moved
     by one ulp (NUDGE_SEEDS): its one-ulp spread enters the bound of
     both routes' step-2 updates (hold_steps). (3) The
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
     17 band_apply launches a step, all bf16 (`band_apply.bfloat16`), and on the
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
 19. artifact (after phase 18): the deployment path. The flagship (f32,
     batch 32, the golden's seed-0 parameters) exported with
     tools.export_model twice, f32 and int8 weights with bf16 constants
     (export seconds and MB logged), both loaded on the card; every
     program's parameters, buffers and constants on cuda. With the counts
     at 0 just before and read just after: the f32 artifact's batch-32
     decode of the golden inputs within 1e-4 * max|ref| of
     tests/data/torch_golden_flagship.npz, its embed and encode within
     1e-4 * max|ref| of the live engine's plain route; the int8 artifact
     within relative L2 0.05 of the f32 one (JAX's bound) and under 0.7x
     its size; the int8 artifact served through serve(ExportedEngine), a
     /sample round trip; no kernel launched (the artifact runs the plain
     route, as JAX's export does). decode.pt2 loaded and run on the card
     in a process that imports torch alone. Then each artifact's decode
     by `perf_lab artifact`, and both artifacts' and the live engine's
     kernel and plain decode calls timed in turns; one decode call of each
     artifact and of the live plain route under torch.profiler: its device
     kernels, their device time and the aten operators it dispatched, and
     what the artifacts launch and dispatch that the live call does not.
 14. lab (after phase 19): the kernel lab's conv, conv --padded 1, layout,
     fuse and bmapply with the counts at 0 just before; its errors within
     their limits; the v2, v1, v5 and bm kernels launched.
 20. lab-rest (last): the lab's model subcommands and the endurance run
     (tools.perf_lab, tools.endurance), each through its `main` as
     `python -m` runs it, counts at 0 just before each and read just after.
     parts --batch 32: band_apply and its addend variant launched, no other
     kernel, each part's output (so its loss) within 1e-4 of max|ref| of
     the plain route's.
     step --k 4 at batch 32 and 16, f32 and bf16: 17 + 17 launches a step at
     32 (bf16: all on bf16 tensors), none at 16; finite metrics (the lab
     checks). serve (bf16, padded, batches 1, 16, 64): launches per engine
     decode call 9 at 64 (the gate routes C >= 32 there), none at 1 and 16.
     trace at batch 32 and 16, bf16 and f32: band_gather_kernel named in
     the profiler's trace with 17 + 17 a step at 32 (0 at 16) beside the
     plain BandedOp applies (band_apply.op), the counts agreeing, device
     ms a step within the host window. chain --batch 32, both dtypes: its
     arms within 5e-2 (the lab checks), band_apply launched both ways. http
     (npz at 50 reps, json at 5) and concurrency (16 threads, 3 s) against
     the flagship (f32, batch 32) served on 127.0.0.1:0, micro-batched and
     one request at a time: every request answered (no failed request under
     load), 7 launches per encode and decode device call, more than one
     decode request per device call when micro-batched; the HTTP layer's
     share of a /sample n=32 against one
     engine decode call. endurance --epochs 1 --n-train 512 --batch 32
     (bf16): finite final_val_recon, its checkpoint kept, 17 + 17 launches
     a step and 14 per validation batch. The native BVH (csrc/aabb.cpp,
     built with the host's C++ compiler) against the numpy backend on the
     toy pyramid (`bvh_check`).
 21. f16-dp (after phase 20): float16 compute and data parallelism, each
     main path with the counts at 0 just before and read just after.
     (a) The band-gather kernel's f16 instantiation (rows 2 and 2b)
     against its plain version at every case of phase 3 and every addend
     case, within one f16 ulp of max|ref|; the seven batch-32 decode
     applies and the train step's backward applies timed in f16 beside
     f32 and bf16, the plain version and the library call (f16 CSR).
     (b) The flagship in f16 held to tests/data/torch_golden_f16.npz
     (written by the JAX package: its f16 runs beside its f32 runs): the
     batch-32 decode (7 launches, all f16) within the golden's derived
     decode bound, two batch-32 steps (17 + 17 a step, all f16) within
     the derived metric and update bounds; the decode call and the step
     timed in f16, bf16 and f32, in turns. (c) Two Gloo ranks on the one
     card (`chip_smoke.py dp-rank ...`, each with a timeout, killed on
     it; a rank's failure fails the phase), the flagship in f32 at global
     batch 64 (32 rows a rank: the kernel route), two steps held to the
     single-process batch-64 step (metrics 1e-4 relative, updates by
     hold_updates), 17 + 17 launches a step in each rank; the 2-rank step
     time and its all-reduce share (two ranks on one card measure no
     scaling). (d) One rank in an NCCL group of 1 through the DP Trainer
     (one step, one eval batch). (e) The DP engine over [cuda:0, cuda:0]
     (32 rows a device) against the single-device engine's 64-row decode,
     within 1e-5 * max|ref|, 7 launches per device call.
 22. mesh2d (after phase 21): tensor parallelism (parallel/mesh2d.py),
     the flagship in f32 at global batch 64 on phase 21 (c)'s inputs, the
     ranks Gloo processes on the one card (`chip_smoke.py tp-rank ...`,
     each mesh's with a timeout, killed on it; a rank's failure fails the
     phase). (a) MeshParallel(1, 2), 64 rows a rank, and (b)
     MeshParallel(2, 2), 32 rows a data group: two steps held to the
     single-process batch-64 step (metrics 1e-4 relative, updates by
     hold_updates); every rank's v3 convs a step, as (B, C, F), and its
     launches, forward and backward, those the gate gives its shapes
     (`tp_routes`: the column-parallel products at F = fout / 2); every
     rank's parameters and optimizer buffers at their shard shapes; the
     step time and its collectives' share (ranks that share one card
     measure no scaling). (c) MeshParallel(1, 1) in an NCCL group of 1
     through the Trainer (one step, one eval batch, a checkpoint).
 23. random (after phase 22): JAX's randomness on the card, each main
     path with the counts at 0 just before and read just after. (a) The
     flagship from init_params(prng.PRNGKey(cfg.seed)), on the card, held
     to JAX's init_params(PRNGKey(cfg.seed)) fingerprint in
     tests/data/torch_golden_init.npz (`hold_init`: each entry within
     INIT_ULP, one float32 ulp of the truncated normal's 2). (b) Trainer.fit
     of that model at batch 32 on synthetic data, in f32 and in bf16: one
     epoch of 2 steps and one val batch on the kernel route (17 + 17
     launches a step, 14 for the eval; all bf16 in bf16), the noise each
     step received bit-equal to core.prng's normal(fold_in(PRNGKey(seed),
     step)) in the compute dtype. (c) The bf16 engine's sampled
     autoencode (32 rows): the noise of its sample_z bit-equal to
     normal_rows(seed, 32, nz, bfloat16), 7 bf16 launches per encode and
     decode call.
 24. op-applies (after phase 13): the plain BandedOp applies on the
     band-gather kernel (ops.banded.kernel_apply), one of each operator
     kind of the padded flagship context (OP_APPLIES: Laplacians at C = 3,
     32 and a 2-D [V, 1], pools, unpools, the discriminator's, the edge
     operator), forward and transpose, held to apply_blocks (f32, 1e-5 *
     max|ref|) and timed against it in turns, with the bound of each;
     their launches count in band_apply.op only.
 25. norm (after phase 24): the fused group norm + ReLU
     (csrc/group_norm_relu.cu, ops.norm.group_norm_relu; it replaces no
     TPU kernel) at every distinct norm shape of the GraphCMR decoder at
     batch 16 (NORM_SHAPES: 11 shapes, C/G = 1 to 17, the natural rows
     valid), in f32, bf16 and f16: y, dx, dgamma and dbeta against the
     plain version's f32 arithmetic on the same inputs (1e-5 of max|ref|
     for y and dx, 1e-4 for dgamma and dbeta in f32; one ulp of the dtype
     for y and dx in 16 bits), with the gap to the plain version run in
     the 16-bit dtype in ulps. The cotangent is zeroed within 1e-5 of
     max|z| of the ReLU's kink (NORM_KINK; the count is logged), where
     either side's rounding may cross it; with the cotangent left whole,
     dx's worst element, where it is past the limit, must lie within that
     window. Each shape's plan (`norm_plan`); at the finest level's three
     norms, [16, 6912, C] for C = 160, 32, 96, each direction's f32 call
     time against the plain version's, in turns, and both device times
     (`device_ms`: the profiler's kernel durations) beside the bytes
     bound; and the host's split of a call (`norm_host_split`).
     `python3 chip_smoke.py norm` runs phases 1, 2 and 25 alone.
Launch counts are `cape_tpu_torch.ops.kernels.counts` (`read_counts`):
`band_apply.conv` and `.conv_bwd` are the conv route's band_apply
launches; `band_apply.op` the plain BandedOp applies on the same kernel,
which take it wherever use_pallas puts the conv route (SERVED, STEPPED);
`band_apply.bfloat16` and `.float16` count both (`half_launches`). The
norm kernel's `group_norm_relu` is left out of read_counts
(`norm_launches` checks it): the GraphCMR decoder launches it on either
route, 24 times a decode forward and 72 a train step.
Every timed record carries `bound_ms`, the least time the card could take
for the same work (see `bound`). The per-case records go to
build/chip_smoke_kernels.json. The last two lines are a JSON summary of
the kernels and the device line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import glob
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from bench_port.roofline import _name, apply_bound, bound, conv_bound, summed_bound

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
GOLDEN_F16 = os.path.join(ROOT, "tests", "data", "torch_golden_f16.npz")
GOLDEN_INIT = os.path.join(ROOT, "tests", "data", "torch_golden_init.npz")
# phase 23's bound on an initial parameter against JAX's, per entry: one
# float32 ulp of 2, where the truncated normal of the conv weights ends
# (its erf_inv is within a few float32 ulps of XLA's; the glorot kernels
# and the constants are bit-equal)
INIT_ULP = 2.4e-7
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
# the plain BandedOp applies of a flagship train step at batch 32 that take
# the band-gather kernel (band_apply.op), forward and backward
OP_APPLIES_PER_STEP = 120
# phase 24's plain BandedOp applies, one of each operator kind of the
# padded flagship context: (label, context field, index or None, batch,
# channels); batch 0 is a 2-D [rows, C] input
OP_APPLIES = [
    ("Laplacian 6890 C=3", "lap", 0, 32, 3), ("Laplacian 6890 C=32", "lap", 0, 32, 32),
    ("Laplacian 6890 [V, 1]", "lap", 0, 0, 1), ("pool 6890->3445", "down", 1, 32, 64),
    ("pool 1723->862", "down", 5, 32, 256), ("unpool 3445->6890", "up", 1, 32, 64),
    ("unpool 862->1723", "up", 5, 32, 256), ("disc Laplacian 431", "lap_d", 4, 32, 128),
    ("disc pool 6890->3445", "down_d", 0, 32, 3), ("edge op 6890->20664", "edge_op", None, 32, 3),
]
FWD_PER_EVAL = 14   # encode + decode of one eval batch
# phase 17: the seeds of the one-ulp nudges of default_config.yaml's
# parameters on the plain route (nudge_params; the families golden's
# JAX nudge draws from default_rng(3))
NUDGE_SEEDS = (3, 4, 5, 6)
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
# the ring phase's autograd main path: [B, P, C] -> F, padded, f32
RING_MAIN = (32, 6912, 64, 64)
# the lab's subcommands, as `python -m cape_tpu_torch.tools.perf_lab` takes them
LAB_RUNS = [["conv"], ["conv", "--padded", "1"], ["layout"], ["fuse"], ["bmapply"]]
# the lab-rest phase: steps per host sync of `perf_lab step`, and the band
# applies of one engine decode call at each `perf_lab serve` batch (the gate
# of ops.cheb, as tests/test_torch_ops.py holds it to JAX's)
LAB_STEP_K = 4
SERVE_DECODE_LAUNCHES = {1: 0, 16: 0, 64: 9}
# phase 21's data-parallel run: ranks on the one card (Gloo), the global
# batch (32 rows a rank, the kernel route's batch), the seconds a rank may
# take before it is killed, and the steps each rank times after the two
# held ones
DP_RANKS, DP_BATCH, DP_TIMEOUT, DP_TIMED_STEPS = 2, 64, 300, 6
# phase 22's tensor-parallel runs: the (dp, tp) meshes on the one card (Gloo
# ranks), at phase 21's global batch and inputs, the seconds a mesh's ranks
# may take before they are killed, and the steps each rank times after the
# two held ones
TP_MESHES, TP_TIMEOUT, TP_TIMED_STEPS = [(1, 2), (2, 2)], 420, 4


def log(*a):
    print(*a, flush=True)


def zero_counts() -> None:
    from cape_tpu_torch.ops.kernels import counts

    counts.clear()


# the norm kernel's launches of the GraphCMR decoder: 24 norms, one launch
# each forward and two each backward
NORM_PER_DECODE, NORM_PER_STEP = 24, 72


def norm_launches(name: str, want: int) -> int:
    """The norm kernel's launches since zero_counts, which must be `want`."""
    from cape_tpu_torch.ops.kernels import counts

    got = counts["group_norm_relu"]
    log(f"{name}: group_norm_relu launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{name}: {got} norm kernel launches, expected {want}")
    return got


def read_counts() -> collections.Counter:
    """The band kernels' launches since zero_counts: `kernels.counts`
    without the conv gate's routes and the norm kernel (`norm_launches`)."""
    from cape_tpu_torch.ops.kernels import counts

    return collections.Counter({k: v for k, v in counts.items()
                                if k != "group_norm_relu" and not k.startswith("route.")})


# what a served call (SERVED) and a train step (STEPPED) may launch on the
# conv route: its band applies and the plain BandedOp applies
SERVED = ("band_apply.conv", "band_apply.op")
STEPPED = (*SERVED, "band_apply.conv_bwd")


def only(counts: dict, *names) -> bool:
    """No kernel but `names` launched (`band_apply.op`, the plain BandedOp
    applies, among them only where named)."""
    return not any(v for k, v in counts.items() if k not in names)


def half_launches(counts: dict, conv: int) -> int:
    """What band_apply.bfloat16 (.float16) must read when every launch was
    bf16 (f16): the conv route's `conv` and every plain apply's."""
    return conv + counts["band_apply.op"]


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
    names = ("band_gather", "cheb2_fused", "group_norm_relu")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    build.band_gather_lib()
    build.cheb2_fused_lib()
    build.group_norm_relu_lib()
    log(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        ptxas = (lib.parent / f"{lib.stem}.log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"ptxas {lib.stem}:", line.strip())


def bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def f16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 10)


def rate(rec: dict) -> str:
    """A timed band apply's achieved rate: its bound's bytes over its time,
    and its share of the bound."""
    return (f"{rec['bytes'] / rec['ms'] / 1e6:.0f} GB/s, "
            f"{rec['bound_ms'] / rec['ms']:.1%} of the bound")


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


# (B, P, C, padded) of the band applies phase 3 holds to the plain version
GATHER_CASES = ([(32, P, C, True) for P, C in ON_PATH + [PRED] + FAMILY_APPLIES]
                + [(64, P, C, True) for P, C in ON_PATH + [(6912, 32)]]
                + [(32, 6890, 64, False), (32, 6912, 35, True)])


def kernel_phase(ctx, smi):
    """Kernel against plain at every case; returns the per-case records."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply, band_apply_plain
    from cape_tpu_torch.tools.perf_lab import time_routes

    laps = _laps(ctx)
    cases = GATHER_CASES
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
    from cape_tpu_torch.ops import kernels
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
        forward = (kernels.counts["cheb2_window.t1"], kernels.counts["cheb2_window.t2"])
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
    counts.update(cheb2_ring=after["cheb2_window.t1"], cheb2_ring2=after["cheb2_window.t2"])
    log(f"ring main path: launches {json.dumps(counts)}; phase {time.perf_counter() - t_phase:.2f} s")
    if (counts["cheb2_banded_v6 forward"] != (1, 0) or counts["cheb2_banded_v7 forward"] != (1, 1)
            or counts["cheb2_ring"] != 1 or counts["cheb2_ring2"] != 1
            or not only(after, "cheb2_window.t1", "cheb2_window.t2")):
        raise AssertionError(f"ring main path: launches {counts}, expected one of each ring "
                             "kernel in the forwards and none in the backwards")
    return records, counts


def op_apply_phase(ctx, smi):
    """Phase 24: the plain BandedOp applies on the band-gather kernel
    (ops.banded.kernel_apply, BandedMatvec's CUDA route), one of each
    operator kind (OP_APPLIES), forward and transpose: held to apply_blocks
    (f32, 1e-5 * max|ref|), timed against it in turns (time_routes), with
    the bound of each (apply_bound); every launch counted in
    band_apply.op and in no conv-route key. Returns the records."""
    from cape_tpu_torch.ops.banded import apply_blocks, kernel_apply
    from cape_tpu_torch.tools.perf_lab import time_routes

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(24)
    records = []
    zero_counts()
    for label, field, idx, B, C in OP_APPLIES:
        op = getattr(ctx, field) if idx is None else getattr(ctx, field)[idx]
        rec = {"op": label, "B": B, "C": C, "rows_in": op.rows_in, "rows_out": op.rows_out,
               "cb": op.col_block, "W": op.pack.width, "t_W": op.t_pack.width}
        sides = {"": (op.blocks, op.pack, op.pad_left, op.pad_right, op.n_rows,
                      op.rows_in, op.rows_out),
                 "t_": (op.t_blocks, op.t_pack, op.t_pad_left, op.t_pad_right, op.n_cols,
                        op.rows_out, op.rows_in)}
        for side, (blocks, pack, pad_left, pad_right, n_out, rows_in, rows_out) in sides.items():
            x = torch.randn((rows_in, C) if B == 0 else (B, rows_in, C), generator=gen,
                            device="cuda")
            routes = {"kernel": functools.partial(kernel_apply, x, blocks, pack, pad_left,
                                                  rows_out),
                      "plain": functools.partial(apply_blocks, x, blocks, pad_left, pad_right,
                                                 n_out, op.padded)}
            ref = routes["plain"]()
            rec[f"{side}max_abs_err"] = held_to(
                f"op apply {label}{' transpose' if side else ''}, kernel vs apply_blocks",
                routes["kernel"]().cpu().numpy(), ref.cpu().numpy(), rel=1e-5)
            t = time_routes(routes)
            rec[f"{side}ms"], rec[f"{side}plain_ms"] = t["kernel"], t["plain"]
            b = apply_bound(blocks, max(B, 1), rows_in, rows_out, C, torch.float32)
            rec[f"{side}bound_ms"], rec[f"{side}bound_by"] = b["bound_ms"], b["bound_by"]
        log(f"op apply {label} [{smi}]: kernel {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
            f"bound {rec['bound_ms']:.4f}), transpose {rec['t_ms']:.4f} ms (plain "
            f"{rec['t_plain_ms']:.4f}, bound {rec['t_bound_ms']:.4f}); " + json.dumps(rec))
        records.append(rec)
    counts = read_counts()
    log(f"op applies: counts {json.dumps(counts)}; phase {time.perf_counter() - t_phase:.2f} s")
    if not counts["band_apply.op"] or not only(counts, "band_apply.op"):
        raise AssertionError(f"op applies: counts {counts}, expected band_apply.op only")
    return records


# phase 25: the distinct norm shapes of the GraphCMR decoder at batch 16,
# (V, n_valid, C) in the padded layout (tests/test_torch_norm_kernel.py's
# DECODER_NORMS: C/G = 17, 8, 9, 4, 5, 2, 3 and 1); the finest level's
# three, the last, are timed
NORM_B = 16
NORM_SHAPES = [(896, 862, 544), (896, 862, 256), (1792, 1723, 544), (1792, 1723, 128),
               (1792, 1723, 288), (3456, 3445, 288), (3456, 3445, 64), (3456, 3445, 160),
               (6912, 6890, 160), (6912, 6890, 32), (6912, 6890, 96)]
NORM_TIMED = NORM_SHAPES[-3:]
NORM_SOURCE = "cape_tpu_torch/csrc/group_norm_relu.cu"
# the cotangent is zeroed where the value before the ReLU lies within this
# share of max|z| of the kink: the two sides' statistics differ in their
# last bits (y, which is z where positive, by up to ~2e-7 of max|z|), so
# an element that close may fall on either side, and its dx with it
NORM_KINK = 1e-5


def norm_phase(smi):
    """Phase 25: the fused group norm + ReLU against its plain version at
    NORM_SHAPES, f32, bf16 and f16; each NORM_TIMED direction's time in f32
    (time_routes: the kernel's and the plain version's forward under
    no_grad, and their backward through a kept graph) beside the bytes
    bound: x read and y written forward, x and dy read and dx written
    backward; and the host's split of a call (norm_host_split). Returns the
    records."""
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.ops.norm import group_norm, group_norm_relu, norm_plan
    from cape_tpu_torch.tools.perf_lab import time_routes

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(25)

    def graph(fn, x, g, b, dy):
        x, g, b = (t.detach().clone().requires_grad_() for t in (x, g, b))
        y = fn(x, g, b)
        grads = lambda: torch.autograd.grad(y, (x, g, b), dy, retain_graph=True)
        return y, grads, (y, *grads())

    records = []
    before = kernels.counts["group_norm_relu"]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for V, n_valid, C in NORM_SHAPES:
            B = NORM_B
            plain = lambda x, g, b: torch.relu(group_norm(x, g, b, n_valid=n_valid))
            kernel = lambda x, g, b: group_norm_relu(x, g, b, n_valid=n_valid)
            x = (2 * torch.randn((B, V, C), generator=gen, device="cuda") + 0.5).to(dtype)
            dy_raw = torch.randn((B, V, C), generator=gen, device="cuda").to(dtype)
            dy_raw[:, n_valid:] = 0
            g = 1 + 0.3 * torch.randn(C, generator=gen, device="cuda")
            b = 0.2 * torch.randn(C, generator=gen, device="cuda")
            r = lambda t: t.to(dtype).float()
            z = group_norm(x.float(), r(g), r(b), n_valid=n_valid)
            z_max = z[:, :n_valid].abs().max().item()
            near = z.abs() < NORM_KINK * z_max
            dy = torch.where(near, 0, dy_raw)
            _, k_grads, got = graph(kernel, x, g, b, dy)
            _, p_grads, ref = graph(plain, x.float(), r(g), r(b), dy.float())
            torch.cuda.synchronize()
            rec = {"dtype": _name(dtype), "B": B, "V": V, "C": C, "n_valid": n_valid,
                   "plan": norm_plan(dtype, B, V, C, 32, False, True),
                   "bwd_plan": norm_plan(dtype, B, V, C, 32, True, True),
                   "kink_zeroed": int(near.sum()), "elements": B * V * C}
            for name, a, w in zip(("y", "dx", "dgamma", "dbeta"), got, ref):
                scale = w.abs().max().item()
                err = (a.float() - w).abs().max().item()
                if dtype == torch.float32 or name in ("dgamma", "dbeta"):
                    limit = (1e-4 if name in ("dgamma", "dbeta") else 1e-5) * scale
                else:
                    limit = (bf16_ulp if dtype == torch.bfloat16 else f16_ulp)(scale)
                rec[f"{name}_err"], rec[f"{name}_limit"] = err, limit
                if not err <= limit:
                    raise AssertionError(f"group_norm_relu disagrees with plain: {name} {rec}")
            # the cotangent left whole: where dx's worst element is past the
            # limit, it lies within NORM_KINK * max|z| of the kink (a flip
            # there moves its own dx by rstd gamma dy, and its group's by
            # 1/n of that)
            err = (graph(kernel, x, g, b, dy_raw)[2][1].float()
                   - graph(plain, x.float(), r(g), r(b), dy_raw.float())[2][1]).abs()
            worst = int(err.argmax())
            rec["whole_dy_dx_err"] = err.flatten()[worst].item()
            rec["whole_dy_dx_over"] = int((err > rec["dx_limit"]).sum())
            rec["whole_dy_worst_z"] = z.flatten()[worst].abs().item() / z_max
            if rec["whole_dy_dx_err"] > rec["dx_limit"] and not rec["whole_dy_worst_z"] < NORM_KINK:
                raise AssertionError(f"group_norm_relu's worst dx is off the kink: {rec}")
            if dtype != torch.float32:
                ulp = (bf16_ulp if dtype == torch.bfloat16 else f16_ulp)(ref[0].abs().max().item())
                y16 = plain(x, g, b).float()
                rec["plain16_ulp"] = (y16 - ref[0]).abs().max().item() / ulp
                rec["gap16_ulp"] = (got[0].float() - y16).abs().max().item() / ulp
            if dtype == torch.float32 and (V, n_valid, C) in NORM_TIMED:
                el = x.element_size() * B * V * C
                for d, what, kernel_fn, plain_fn, nbytes in (
                        ("fwd", "forward", functools.partial(kernel, x, g, b),
                         functools.partial(plain, x, g, b), 2 * el),
                        ("bwd", "backward", k_grads, p_grads, 3 * el)):
                    with torch.no_grad() if d == "fwd" else contextlib.nullcontext():
                        t = time_routes({"ms": kernel_fn, "plain_ms": plain_fn})
                        t["device_ms"], t["plain_device_ms"] = device_ms(kernel_fn), device_ms(plain_fn)
                    rec[d] = {**t, **bound(nbytes, 8 * B * V * C, dtype)}
                    log(f"group_norm_relu [{B},{V},{C}] f32 {what} [{smi}]: call {t['ms']:.4f} ms "
                        f"(plain {t['plain_ms']:.4f}); device {t['device_ms']:.4f} ms (plain "
                        f"{t['plain_device_ms']:.4f}); bound {rec[d]['bound_ms']:.4f} ms, "
                        f"{rec[d]['bound_ms'] / t['device_ms']:.1%} of it on the device")
            log("group_norm_relu vs plain " + json.dumps(rec))
            records.append(rec)
    log(f"norm: {kernels.counts['group_norm_relu'] - before} launches; phase {time.perf_counter() - t_phase:.2f} s")
    records.append({"host_split": norm_host_split(smi)})
    return records


def norm_host_split(smi, shape=(16, 6912, 6890, 32), calls: int = 200) -> dict:
    """Where a norm call's host time goes, f32 at `shape` (B, V, n_valid, C;
    the finest level's narrowest norm, whose device time is least): the
    host time a call (perf_counter over `calls` calls, then one
    synchronize: the device is the faster, so the host sets the pace) of
    the forward (group_norm_relu under no_grad) and its ctypes entry alone;
    of the backward through torch.autograd.grad, its body called directly
    (_GroupNormReLU.backward on the graph's node) and its ctypes entry
    alone; and of one small aten operator, the unit of the plain version's
    cost. Returns µs a call."""
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.ops.norm import _GroupNormReLU, _entries, group_norm_relu, norm_plan

    B, V, n_valid, C = shape
    G = 32
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = (2 * torch.randn((B, V, C), generator=gen, device="cuda") + 0.5).requires_grad_()
    g = (1 + 0.3 * torch.randn(C, generator=gen, device="cuda")).requires_grad_()
    b = (0.2 * torch.randn(C, generator=gen, device="cuda")).requires_grad_()
    dy = torch.randn((B, V, C), generator=gen, device="cuda")
    y = group_norm_relu(x, g, b, n_valid=n_valid)
    node = y.grad_fn
    _, fwd, bwd = _entries()
    out, dx = torch.empty_like(x), torch.empty_like(x)
    stats = torch.empty((2, B, G), device="cuda")
    buf = torch.empty((B + 1, 2, C), device="cuda")
    s, d, stream = stats.data_ptr(), buf.data_ptr() + 8 * B * C, kernels.stream(x)
    fplan = norm_plan(torch.float32, B, V, C, G, False, True)
    bplan = norm_plan(torch.float32, B, V, C, G, True, True)
    one = torch.zeros(1, device="cuda")
    before = kernels.counts["group_norm_relu"]

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    with torch.no_grad():
        split = {
            "forward_call": host_us(lambda: group_norm_relu(x, g, b, n_valid=n_valid)),
            "forward_ctypes": host_us(lambda: fwd(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), s, s + 4 * B * G, 0,
                B, V, C, G, n_valid, *fplan, 1e-5, stream)),
            "backward_body": host_us(lambda: _GroupNormReLU.backward(node, dy)),
            "backward_ctypes": host_us(lambda: bwd(
                x.data_ptr(), dy.data_ptr(), g.data_ptr(), b.data_ptr(), s, s + 4 * B * G,
                dx.data_ptr(), buf.data_ptr(), d, d + 4 * C, 0, B, V, C, G, n_valid, *bplan,
                stream)),
            "empty": host_us(lambda: torch.empty((B + 1, 2, C), device="cuda")),
            "aten_add_": host_us(lambda: one.add_(1)),
        }
    split["backward_grad"] = host_us(
        lambda: torch.autograd.grad(y, (x, g, b), dy, retain_graph=True))
    split["launches"] = kernels.counts["group_norm_relu"] - before
    log(f"group_norm_relu host split [{B},{V},{C}] f32, µs a call [{smi}]: "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items() if k != "launches"))
    return split


def device_ms(fn, calls: int = 20) -> float:
    """The device time of one call of fn: the summed durations of the
    kernels, copies and sets it ran in `calls` calls under torch.profiler,
    over `calls`. time_routes' call times include the host's time between
    launches where the host is slower than the device."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    us = sum(e.get("dur", 0) for e in events if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return us / 1e3 / calls


def norm_rows(records) -> list[dict]:
    """The kernels line's rows of the norm kernel, each direction: the
    worst f32 error over NORM_SHAPES, and the times (call and device) and
    bounds summed over NORM_TIMED in f32."""
    f32 = [r for r in records if r.get("dtype") == "float32"]
    rows = []
    for d, name, errs in (("fwd", "group_norm_relu", ("y",)),
                          ("bwd", "group_norm_relu_bwd", ("dx", "dgamma", "dbeta"))):
        timed = [r[d] for r in f32 if d in r]
        rows.append({
            "name": name, "route": "cuda", "source": NORM_SOURCE,
            "replaces": None,   # none: the JAX package leaves the norm to XLA's fusion
            "max_abs_err": max(r[f"{e}_err"] for r in f32 for e in errs),
            **{k: sum(t[k] for t in timed)
               for k in ("ms", "plain_ms", "device_ms", "plain_device_ms")},
            **summed_bound(timed), "library_ms": None,
        })
    return rows


def lab_phase(smi):
    """The kernel lab, the main path of kernels 1, 3 and 4: each LAB_RUNS
    entry through `perf_lab.main`, as `python -m cape_tpu_torch.tools.perf_lab`
    runs it, in this process, with every kernel count set to 0 just before
    and read just after. Each printed error must be within its limit (f32:
    1e-5, the same sums in another order; bf16: the JAX lab's own 5e-2),
    and v2 (band_apply), v1, v5 and bm must have launched. Returns the
    lines and the counts."""
    from contextlib import redirect_stdout

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
    counts = read_counts()
    log(f"lab: {time.perf_counter() - t0:.2f} s, kernel launches {json.dumps(counts)}")
    for line in lines:
        dtype = next(line[k] for k in ("conv", "layout", "fuse", "bmapply") if k in line)
        limit = 1e-5 if dtype == "float32" else 5e-2
        for k, v in line.items():
            if k.startswith("max_rel_err") and not 0.0 <= v <= limit:
                raise AssertionError(f"lab {k} = {v} exceeds {limit}: {line}")
    for k in ("band_apply.conv", "cheb2_fused.g1", "cheb2_fused", "band_apply_bm"):
        if counts[k] == 0:
            raise AssertionError(f"the lab launched no {k} kernel: {counts}")
    return lines, counts


def bvh_check() -> dict:
    """The native BVH (csrc/aabb.cpp, built here with the host's C++
    compiler) against the numpy nearest-triangle search on the toy
    pyramid (icosphere(3), both pyramid plans): the upsample matrices equal
    at every row where the two chose the same triangle, within 1e-12 (the
    weights are in [0, 1]; the two implementations of the closest point
    differ by one double ulp, 2.2e-16, on the toy pyramid); at every
    other row both chosen triangles lie equally far from the fine vertex
    (a tie) within 1e-12 of the mesh scale."""
    import sys

    import scipy.sparse as sp

    from cape_tpu_torch.meshops import native_aabb
    from cape_tpu_torch.meshops.pyramid import build_pyramid
    from cape_tpu_torch.meshops.toy import icosphere
    from cape_tpu_torch.meshops.transfer import _nearest_numpy, closest_point_on_triangles

    t0 = time.perf_counter()
    native_aabb._load()
    built = time.perf_counter() - t0
    verts, faces = icosphere(3)
    scale = float(np.ptp(verts, axis=0).max())
    rows = ties = differ = 0
    for factors in ([1, 2, 1, 2, 1, 2, 1, 1], [2, 2, 2, 2]):
        native = build_pyramid(verts, faces, factors)
        saved = sys.modules.get("cape_tpu_torch.meshops.native_aabb")
        sys.modules["cape_tpu_torch.meshops.native_aabb"] = None   # the numpy backend
        try:
            plain = build_pyramid(verts, faces, factors)
        finally:
            sys.modules["cape_tpu_torch.meshops.native_aabb"] = saved
        for i, (u_nat, u_np) in enumerate(zip(native.upsamples, plain.upsamples, strict=True)):
            coarse_v, coarse_f, fine_v = native.verts[i + 1], native.faces[i + 1], native.verts[i]
            rows += len(fine_v)
            chosen = (native_aabb.nearest_triangles(coarse_v, coarse_f, fine_v)[0],
                      _nearest_numpy(fine_v, coarse_v, coarse_f)[0])
            other = np.flatnonzero(chosen[0] != chosen[1])
            diff = abs(sp.csr_matrix(u_nat) - sp.csr_matrix(u_np)).max(1).toarray()[:, 0]
            same = np.setdiff1d(np.arange(len(fine_v)), other)
            if not diff[same].max(initial=0.0) <= 1e-12:
                raise AssertionError(f"native BVH {factors} upsamples[{i}]: rows "
                                     f"{same[diff[same] > 0]} differ with the same triangle")
            p = fine_v[other]
            dist = [np.sqrt(closest_point_on_triangles(p, coarse_v[coarse_f[f[other]]][:, None])[0][:, 0])
                    for f in chosen]
            if not np.allclose(dist[0], dist[1], rtol=0, atol=1e-12 * scale):
                raise AssertionError(f"native BVH {factors} upsamples[{i}]: rows {other} "
                                     "chose triangles at different distances")
            ties += len(other)
            differ += int((diff > 1e-12).sum())
    rec = {"build_s": built, "rows": rows, "other_triangle": ties, "rows_differ": differ}
    log(f"native BVH: built in {built:.2f} s; of the toy pyramid's {rows} upsample rows, "
        f"{ties} chose another triangle than numpy's at the same distance (ties), and "
        f"{differ} of those differ in their weights; every other row within 1e-12")
    return rec


def lab_rest_phase(model, ctx, smi):
    """The lab's model subcommands and the endurance run, each through
    `perf_lab.main` or `endurance.main` as `python -m` runs it, in this
    process, with every kernel count at 0 just before each run and read
    just after (`run`); their checks are in the docstring at the top.
    Returns (records, forward launches, backward launches)."""
    from contextlib import redirect_stdout

    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.tools import endurance, perf_lab

    rec = {"runs": []}
    fwd = bwd = 0

    def run(argv, main=perf_lab.main, tag="lab"):
        nonlocal fwd, bwd
        buf = io.StringIO()
        # ---- a main path: every count at 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        try:
            with redirect_stdout(buf):
                result = main(argv)
        finally:
            for text in buf.getvalue().splitlines():
                log(f"{tag} {' '.join(argv)} [{smi}]: {text}")
        counts = read_counts()
        seconds = time.perf_counter() - t0
        fwd += counts["band_apply.conv"]
        bwd += counts["band_apply.conv_bwd"]
        log(f"{tag} {' '.join(argv)}: {seconds:.2f} s, counts {json.dumps(counts)}")
        rec["runs"].append({"argv": argv, "seconds": seconds, "counts": counts,
                            "lines": [json.loads(t) for t in buf.getvalue().splitlines()
                                      if t.startswith("{")]})
        return result, counts

    t_phase = time.perf_counter()
    # parts: rows 2 and 2b; each part's output within 1e-4 of the plain route's
    parts, counts = run(["parts", "--batch", "32"])
    if (not (counts["band_apply.conv"] and counts["band_apply.conv_bwd"])
            or not only(counts, *STEPPED)):
        raise AssertionError(f"parts --batch 32: {counts}: expected rows 2 and 2b only")
    for name, r in parts.items():
        if not r["max_rel_err"] <= 1e-4:
            raise AssertionError(f"parts {name}: {r['max_rel_err']} from the plain route")
    # step: 17 + 17 launches a step at batch 32 (bf16: all bf16), none at 16
    steps = (1 + perf_lab.STEP_GROUPS) * LAB_STEP_K
    rec["step_ms"] = {}
    for batch in (32, 16):
        for dtype in ("float32", "bfloat16"):
            line, counts = run(["step", "--batch", str(batch), "--dtype", dtype,
                                "--k", str(LAB_STEP_K)])
            per = FWD_PER_STEP * steps if batch == 32 else 0
            want = {"band_apply.conv": per, "band_apply.conv_bwd": per, "band_apply.bfloat16":
                    half_launches(counts, 2 * per) if dtype == "bfloat16" else 0}
            if (any(counts[k] != v for k, v in want.items())
                    or not only(counts, *want, "band_apply.op")):
                raise AssertionError(f"step --batch {batch} {dtype}: {counts}, expected {want} "
                                     f"over {steps} steps")
            rec["step_ms"][f"{dtype} b{batch}"] = line["step_ms"]
    # serve: launches per engine decode call by the gate (ops.cheb): 9 at 64
    # (C >= 32 reach B*C >= 2048), none at 1 and 16
    lines, counts = run(["serve"])
    for line in lines:
        want = SERVE_DECODE_LAUNCHES[line["batch"]]
        if line["launches_per_decode_call"] != want:
            raise AssertionError(f"serve batch {line['batch']}: "
                                 f"{line['launches_per_decode_call']} launches, expected {want}")
    if not counts["band_apply.conv"] or not only(counts, *SERVED, "band_apply.bfloat16"):
        raise AssertionError(f"serve: {counts}")
    # trace: the band-gather kernel named, 17 + 17 a step at batch 32 and the
    # plain BandedOp applies
    trace_dir = os.path.join(ROOT, "build", "chip_smoke_traces")
    rec["trace"] = {}
    for batch, dtype in ((32, "bfloat16"), (32, "float32"), (16, "float32"), (16, "bfloat16")):
        out = os.path.join(trace_dir, f"b{batch}_{dtype}")
        att, counts = run(["trace", "--batch", str(batch), "--dtype", dtype, "--out", out])
        n_steps = perf_lab.TRACE_WARMUP + 2 * perf_lab.TRACE_STEPS   # untraced, then traced
        per = FWD_PER_STEP if batch == 32 else 0
        named = att["family_counts"].get("band_gather_kernel", 0)
        applies = counts["band_apply.op"] / n_steps   # the plain BandedOp applies
        if (named != 2 * per + applies or counts["band_apply.conv"] != per * n_steps
                or counts["band_apply.conv_bwd"] != per * n_steps):
            raise AssertionError(f"trace --batch {batch} {dtype}: band_gather_kernel {named} a "
                                 f"step, counts {counts}; expected {per} + {per} a step and "
                                 f"{applies} op applies")
        if not att["device_ms_per_step"] <= att["wall_ms_per_step"]:
            raise AssertionError(f"trace: device {att['device_ms_per_step']} ms a step over the "
                                 f"wall's {att['wall_ms_per_step']}")
        rec["trace"][f"{dtype} b{batch}"] = {k: att[k] for k in (
            "device_ms_per_step", "wall_ms_per_step", "untraced_wall_ms_per_step",
            "kernels_per_step", "by_category", "by_kernel")}
        log(f"trace --batch {batch} {dtype} [{smi}]: device busy "
            f"{att['device_ms_per_step'] / att['untraced_wall_ms_per_step']:.1%} of an untraced "
            f"step ({att['device_ms_per_step']:.3f} of {att['untraced_wall_ms_per_step']:.3f} ms)")
    shutil.rmtree(trace_dir, ignore_errors=True)
    # chain: both layouts' arms within 5e-2 of batch-major (the lab raises)
    _, counts = run(["chain", "--batch", "32", "--dtype", "both"])
    if not (counts["band_apply.conv"] and counts["band_apply.conv_bwd"]):
        raise AssertionError(f"chain --batch 32: no band apply launched: {counts}")
    # http and concurrency against a live port server of the flagship at batch 32
    engine = InferenceEngine(model, ctx, 32)
    rng = np.random.default_rng(0)
    host = [rng.standard_normal((32, n)).astype(np.float32)
            for n in (model.cfg.z_total_dim, model.cfg.nz_cond, model.cfg.nz_cond2)]
    engine.decode(*host)
    lats = []
    for _ in range(16):
        t0 = time.perf_counter()
        engine.decode(*host)
        lats.append(1000.0 * (time.perf_counter() - t0))
    rec["engine_decode_ms_b32"] = statistics.median(lats)
    for micro_batch in (True, False):
        engine.calls = dict.fromkeys(engine.calls, 0)
        httpd, thread, _, client = start_server(engine, micro_batch=micro_batch)
        mode = "micro-batched" if micro_batch else "one at a time"
        try:
            launched = 0
            if micro_batch:
                # npz at the JAX lab's 50 reps (the HTTP share); json at a few
                for wire, reps in (("npz", "50"), ("json", "5")):
                    rec[f"http {wire}"], c_http = run(["http", "--url", client.base_url,
                                                       "--batch", "32", "--wire", wire,
                                                       "--reps", reps])
                    launched += c_http["band_apply.conv"]
            conc, c_conc = run(["concurrency", "--url", client.base_url, "--threads", "16",
                                "--seconds", "3"])
        finally:
            stop_server(httpd, thread)
        # the lab counts a failed request and goes on: none may fail
        if not (conc["requests"] > 0 and conc["errors"] == 0):
            raise AssertionError(f"concurrency ({mode}): {conc['errors']} of "
                                 f"{conc['requests'] + conc['errors']} requests failed")
        calls = dict(engine.calls)
        launched += c_conc["band_apply.conv"]
        if launched != 7 * (calls["decode"] + calls["encode"]):
            raise AssertionError(f"http/concurrency ({mode}): {launched} launches for {calls}")
        rec[f"concurrency {mode}"] = conc
        if micro_batch and not conc.get("decode_requests_per_device_call", 0) > 1:
            raise AssertionError(f"concurrency: no coalescing under load: {conc}")
    p50 = rec["http npz"]["npz"]["sample"]["p50_ms"]
    share = 1.0 - rec["engine_decode_ms_b32"] / p50
    log(f"HTTP share [{smi}]: /sample n=32 npz p50 {p50:.3f} ms of 50 requests against one "
        f"engine decode call at 32 {rec['engine_decode_ms_b32']:.3f} ms (median of 16): "
        f"{share:.1%} of the request")
    # endurance: one epoch at batch 32 in bf16 (412 train frames: 12 steps),
    # 17 + 17 launches a step and 14 per val batch (4 batches of 100 rows)
    workdir = os.path.join(ROOT, "build", "chip_smoke_endurance")
    out, counts = run(["--epochs", "1", "--n-train", "512", "--batch", "32",
                       "--workdir", workdir], main=endurance.main, tag="endurance")
    n_steps = out["steps"]
    want = (FWD_PER_STEP * n_steps + FWD_PER_EVAL * math.ceil(100 / 32), BWD_PER_STEP * n_steps)
    if ((counts["band_apply.conv"], counts["band_apply.conv_bwd"]) != want
            or not out["checkpoints_kept"]):
        raise AssertionError(f"endurance: {out}, counts {counts}, expected launches {want}")
    rec["endurance"] = out
    shutil.rmtree(workdir, ignore_errors=True)
    rec["native_bvh"] = bvh_check()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"lab-rest: {rec['seconds']:.2f} s; band_apply {fwd}, band_apply_bwd {bwd} launches")
    return rec, fwd, bwd


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


def nudge_params(model, seed: int) -> None:
    """Move every parameter by about one float32 ulp, as
    tests/make_torch_golden.py moves JAX's for `update_spread`: p * (1 +
    2^-24 * default_rng(seed) normal draws), in the order of the sorted
    parameter names."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            a = p.detach().cpu().double().numpy()
            p.copy_(torch.from_numpy(a * (1 + 2.0**-24 * rng.standard_normal(a.shape))))


def update_spread(ref: dict, other: dict, whole) -> float:
    """How far the updates `other` are from `ref` by hold_updates'
    measures, relative to each leaf's max|ref|: the error of max|.|, of the
    sum of squares (over twice it), of the sum (over sqrt(n * sum of
    squares)) and, for a leaf named in `whole`, of its elements once the
    ties hold_updates lets through are set aside. The largest over the
    leaves (tests/make_torch_golden.py's update_spread)."""
    worst = 0.0
    for k, u in ref.items():
        u, v = u.astype(np.float64), other[k].astype(np.float64)
        r_max, r_sq = np.abs(u).max(), np.square(u).sum()
        if r_max == 0:
            continue
        errs = [abs(np.abs(v).max() - r_max) / r_max, abs(np.square(v).sum() - r_sq) / (2 * r_sq),
                abs(v.sum() - u.sum()) / np.sqrt(u.size * r_sq)]
        if k in whole:
            ties = max(4, u.size // 10_000)
            errs.append(np.sort((np.abs(v - u) / r_max).ravel())[-ties - 1])
        worst = max(worst, *errs)
    return float(worst)


def gan_steps(cfg, c, batches, eps, spe, golden, dtypes: dict | None = None,
              nudge: int | None = None):
    """GAN steps of a fresh seed-0 model on context c, one per batch and eps,
    its parameters checked against `golden`'s fingerprint and then, given
    `nudge`, moved by one ulp (nudge_params). Returns (train state, the
    golden's metrics per step, the last step's updates as numpy,
    band_apply (forward, backward) launches per step); fills `dtypes`, if
    given, with each metric's dtype name."""
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import counts as launched
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), c)
    check_fingerprint(cfg.name, model, golden)
    if nudge is not None:
        nudge_params(model, nudge)
    state = TrainState(model.to("cuda"), Optimizer(cfg, spe))
    names = [str(k) for k in golden["metric_names"]]
    metrics, counts = [], []
    for batch, e in zip(batches, eps):
        f0, b0 = launched["band_apply.conv"], launched["band_apply.conv_bwd"]
        m, updates = train_step(state, c, batch, e)
        torch.cuda.synchronize()
        counts.append((launched["band_apply.conv"] - f0, launched["band_apply.conv_bwd"] - b0))
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
        applies = read_counts()["band_apply.op"]
        state, metrics, updates, counts = gan_steps(cfg, c, batches, eps, spe, golden)
        applies = read_counts()["band_apply.op"] - applies
        log(f"train step, {route} route: band_apply launches (forward, backward) per step "
            f"{counts}, plain BandedOp applies on the kernel in the 2 steps {applies}; step 1 "
            + " ".join(f"{k}={v:.6g}" for k, v in metrics[0].items()))
        want = [(FWD_PER_STEP, BWD_PER_STEP)] * 2 if route == "kernel" else [(0, 0)] * 2
        want_applies = 2 * OP_APPLIES_PER_STEP if route == "kernel" else 0
        if counts != want or applies != want_applies:
            raise AssertionError(f"{route} route: launches {counts} and {applies} op applies, "
                                 f"expected {want} and {want_applies}")
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
        counts = (after["band_apply.conv"], after["band_apply.conv_bwd"])
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
        if (steps != 2 or counts != want
                or not only(after, *STEPPED)):
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
        if (counts["band_apply.conv"] != 7 * (calls["encode"] + calls["decode"])
                or not only(counts, *SERVED)):
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
        return counts["band_apply.conv"], timing
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
            per_call = counts["band_apply.conv"] / max(1, calls["encode"] + calls["decode"])
            log(f"--mode {mode} [{smi}]: {seconds[mode]:.3f} s (host clock, restore included), "
                f"device calls {calls}, band_apply launches {counts['band_apply.conv']} "
                f"({per_call:g} per encode/decode call); all counts {json.dumps(counts)}")
            if (counts["band_apply.conv"] != 7 * (calls["encode"] + calls["decode"])
                    or not only(counts, *SERVED)):
                raise AssertionError(f"--mode {mode}: {counts} for {calls}")
            launches += counts["band_apply.conv"]
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
    log(f"{name}: device calls {calls}, band_apply launches {counts['band_apply.conv']} "
        f"(expected {want}); all counts {json.dumps(counts)}")
    if counts["band_apply.conv"] != want or not only(counts, *SERVED):
        raise AssertionError(f"{name}: {counts} for {calls}")
    return counts["band_apply.conv"]


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
        norm_launches("CMR preset served", NORM_PER_DECODE * engine.calls["decode"])
    finally:
        stop_server(httpd, thread)
    engine_plain = InferenceEngine(model, ctx_plain, cfg.batch_size)
    httpd, thread, _, client = start_server(engine_plain)
    try:
        zero_counts()
        engine_plain.calls = dict.fromkeys(engine_plain.calls, 0)
        plain = requests(client, pose, clo)
        if any(read_counts().values()):
            raise AssertionError(f"the CMR preset's plain route launched {read_counts()}")
        norm_launches("CMR preset served, plain route",
                      NORM_PER_DECODE * engine_plain.calls["decode"])
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
    norm_launches("CMR preset golden decode and encode", NORM_PER_DECODE * engine.calls["decode"])
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


def hold_steps(name, runs_metrics, updates, golden, port_spread: float = 0.0) -> None:
    """Two steps' metrics (1e-4 relative) and the step-2 updates
    (hold_updates) against a families golden. The updates' bound is the
    larger of 1e-3 and twice the larger one-ulp spread: the golden's
    `update_spread`, how far JAX's own updates move when its parameters
    move by about one float32 ulp (tests/make_torch_golden.py, one draw),
    and `port_spread`, the largest of the port's own over several draws
    where the caller measured it. Where the step is that sensitive to
    rounding, no f32 implementation can come closer."""
    names = [str(k) for k in golden["metric_names"]]
    keys = [str(k) for k in golden["param_keys"]]
    whole = {k[len("update/"):]: golden[k] for k in golden if k.startswith("update/")}
    for i, m in enumerate(runs_metrics):
        held_metrics(f"{name} step {i + 1} vs JAX golden", m, dict(zip(names, golden["metrics"][i])))
    rel = max(1e-3, 2 * max(float(golden["update_spread"]), port_spread))
    log(f"{name}: JAX's one-ulp update spread {float(golden['update_spread']):.3e}, the "
        f"port's {port_spread:.3e}, bound {rel:.3e}")
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
        # remat: the backward runs each decoder block's forward again
        per_step = NORM_PER_STEP + (NORM_PER_DECODE if route == "remat" else 0)
        norm_launches(f"CMR train steps, {route}", per_step * len(counts))
        want = {"kernel": [(FWD_PER_STEP, BWD_PER_STEP)] * 2, "plain": [(0, 0)] * 2}.get(route)
        if want is not None and counts != want:
            raise AssertionError(f"CMR {route} steps: launches {counts}, expected {want}")
        allowed = () if route == "plain" else STEPPED
        if not only(total, *allowed):
            raise AssertionError(f"CMR {route} steps launched {total}")
        if route == "remat":
            # the checkpointed blocks' forwards run again in the backward pass
            extra = [f - FWD_PER_STEP for f, _ in counts]
            log(f"CMR train steps with remat: {extra} band_apply forward launches per step "
                f"beyond the {FWD_PER_STEP} of the steps without it (recomputed blocks)")
            if any(b != BWD_PER_STEP for _, b in counts) or min(extra) <= 0:
                raise AssertionError(f"CMR remat steps: launches {counts}")
        fwd += total["band_apply.conv"]
        bwd += total["band_apply.conv_bwd"]
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
    del runs
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
        norm_launches(f"default_config.yaml {stage}", NORM_PER_DECODE * calls["decode"])
        log(f"default_config.yaml {stage}: device calls {calls}; all counts {json.dumps(counts)}")
        if (counts["band_apply.conv"] != per_call * calls[stage]
                or not only(counts, *SERVED)):
            raise AssertionError(f"default_config.yaml {stage}: {counts} for {calls}")
        fwd += counts["band_apply.conv"]
    held_to("default_config.yaml vs JAX golden (encode z_mean)", z_mean, golden["z_mean"])
    held_to("default_config.yaml vs JAX golden (encode z_logvar)", z_logvar, golden["z_logvar"])
    check_mesh("default_config.yaml golden decode", disp, 32)
    held_to("default_config.yaml vs JAX golden (batch-32 decode)", disp[: len(golden["disp"])],
            golden["disp"])
    batches, spe = golden_batches(golden, ctx.perm0)
    eps = torch.from_numpy(golden["eps"]).cuda()
    zero_counts()
    _, metrics, updates, counts = gan_steps(dcfg, ctx, batches, eps, spe, golden)
    total = read_counts()
    norm_launches("default_config.yaml train steps", NORM_PER_STEP * len(counts))
    log(f"default_config.yaml train steps: band_apply launches (forward, backward) per step "
        f"{counts}; all counts {json.dumps(total)}")
    if counts != [(25, 25)] * 2 or not only(total, *STEPPED):
        raise AssertionError(f"default_config.yaml steps: launches {counts}, expected 25 + 25")
    fwd += total["band_apply.conv"]
    bwd += total["band_apply.conv_bwd"]
    # the plain route, and its one-ulp spread: step 2's generator gradient
    # is what is left of a step-1 gradient 5e4 times larger (losses 2.6e10,
    # KL 3.2e13 from seed-0 parameters), so its norm, and through the clip
    # every generator update, moves by up to ~2% with the rounding
    zero_counts()
    _, plain_metrics, plain, _ = gan_steps(dcfg, ctx_plain, batches, eps, spe, golden)
    nudged = [gan_steps(dcfg, ctx_plain, batches, eps, spe, golden, nudge=s)[2]
              for s in NUDGE_SEEDS]
    if any(read_counts().values()):
        raise AssertionError(f"default_config.yaml plain route launched {read_counts()}")
    whole = {k[len("update/"):] for k in golden if k.startswith("update/")}
    spreads = [update_spread(plain, u, whole) for u in nudged]
    log(f"default_config.yaml, plain route: one-ulp update spreads "
        f"{dict(zip(NUDGE_SEEDS, (f'{v:.3e}' for v in spreads)))} (nudge seeds); kernel route "
        f"vs plain route {update_spread(plain, updates, whole):.3e}")
    for route, m, u in (("kernel", metrics, updates), ("plain", plain_metrics, plain)):
        hold_steps(f"default_config.yaml, {route} route", m, u, golden, port_spread=max(spreads))
    del engine, model, ctx, ctx_plain

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


def hold_bf16(name, runs_metrics, dtypes, updates, golden, what="JAX bf16 golden") -> None:
    """A bf16 (or f16) run held to JAX's golden in that dtype (`what` names
    it) by the golden's derived bounds (tests/make_torch_golden.py
    bf16_bounds: from the dtype's effect in JAX, its step in that dtype
    against its f32 step): every metric of both steps within its bound,
    relative, and of JAX's dtype; each leaf's step-2 update summary within
    its bound (hold_updates)."""
    names = [str(k) for k in golden["metric_names"]]
    want = dict(zip(names, (str(d) for d in golden["metric_dtypes"])))
    if dtypes != want:
        raise AssertionError(f"{name}: metric dtypes {dtypes}, JAX's {want}")
    for i, m in enumerate(runs_metrics):
        ref, bound = golden["metrics"][i], golden["metric_bound"][i]
        errs = np.array([abs(m[k] - r) / abs(r) for k, r in zip(names, ref)])
        log(f"{name} step {i + 1} vs {what}: " + " ".join(
            f"{k}={m[k]:.7g}/{r:.7g} ({e:.2e} of {b:.2e})"
            for k, r, e, b in zip(names, ref, errs, bound)))
        if not (errs <= bound).all():
            raise AssertionError(f"{name} step {i + 1}: metrics outside the derived bounds")
    hold_updates(f"{name} step-2 updates vs {what}", updates,
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
            if ((c["band_apply.conv"], c["band_apply.conv_bwd"]) != want
                    or c["band_apply.bfloat16"]
                    != half_launches(c, c["band_apply.conv"] + c["band_apply.conv_bwd"])
                    or not only(c, *STEPPED, "band_apply.bfloat16")):
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
        if counts != [per_step] * 2 or total["band_apply.bfloat16"] != half_launches(total,
                                                                               2 * sum(per_step)):
            raise AssertionError(f"{label}: launches {counts} ({total}), expected {per_step} "
                                 "a step, all bf16")
        if not only(total, *STEPPED, "band_apply.bfloat16"):
            raise AssertionError(f"{label} launched {total}")
        fwd += total["band_apply.conv"]
        bwd += total["band_apply.conv_bwd"]
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
        fwd += c["band_apply.conv"]
        bwd += c["band_apply.conv_bwd"]

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


def program_devices(em) -> dict:
    """{program: sorted device types} of every parameter, buffer and
    constant of an ExportedModel's programs, and of every device argument
    in their graphs."""
    out = {}
    for name, ep in em.programs.items():
        seen = {t.device.type for t in list(ep.state_dict.values()) + list(ep.constants.values())
                if isinstance(t, torch.Tensor)}
        seen |= {torch.device(n.kwargs["device"]).type for n in ep.graph.nodes
                 if isinstance(n.kwargs.get("device"), (str, torch.device))}
        out[name] = sorted(seen)
    return out


def kernel_census(fn) -> dict:
    """One call of `fn`, after one warm-up call, under torch.profiler: the
    device kernels it launched (count and summed device ms), the aten
    operators the host dispatched (those under no other aten operator),
    and {name: count} of both."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.name.startswith("aten::")
           and not (e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"))]
    return {"kernels": len(kernels),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1000.0,
            "ops": len(ops),
            "kernel_names": dict(Counter(e.name for e in kernels)),
            "op_names": dict(Counter(e.name for e in ops))}


def census_diff(a: dict, b: dict) -> dict:
    """{name: count in a - count in b} where they differ."""
    return {k: a.get(k, 0) - b.get(k, 0) for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


# loads an artifact's decode program with torch alone, runs it on the card
# at the artifact's batch, and lists the modules of this repo it imported
TORCH_ONLY_LOAD = """
import io, json, sys, zipfile
import torch
from torch.export.passes import move_to_device_pass
with zipfile.ZipFile(sys.argv[1]) as zf:
    meta = json.loads(zf.read("meta.json"))
    ep = torch.export.load(io.BytesIO(zf.read("decode.pt2")))
fn = move_to_device_pass(ep, "cuda").module()
B = meta["batch_size"]
with torch.inference_mode():
    out = fn(torch.zeros(B, meta["nz"] + meta["nz_cond"] + meta["nz_cond2"], device="cuda"),
             torch.zeros(B, meta["nz_cond"], device="cuda"),
             torch.zeros(B, meta["nz_cond2"], device="cuda"))
print(json.dumps({"shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
                  "repo_modules": sorted(m for m in sys.modules if m.startswith("cape_tpu"))}))
"""


def artifact_phase(cfg, model, ctx, ctx_plain, smi):
    """Phase 19: the deployment path. The flagship (f32, batch 32, the
    golden's seed-0 parameters) exported twice with tools.export_model (f32;
    int8 weights with bf16 constants) and both loaded on the card; every
    program tensor on cuda; with the counts at 0 just before and read just
    after, the f32 artifact's batch-32 decode of the golden inputs held to
    tests/data/torch_golden_flagship.npz and its embed and encode to the
    live engine's plain route (1e-4 * max|ref|), the int8 artifact to the
    f32 one (relative L2 < 0.05, JAX's bound), the int8 artifact served
    through serve(ExportedEngine) with a /sample round trip, and no kernel
    launched; decode.pt2 loaded in a process that imports torch alone. Then
    each artifact's decode by the lab's artifact timer, and the artifacts'
    and the live engine's decode calls timed in turns. Returns the record."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.tools import perf_lab
    from cape_tpu_torch.tools.export_model import ExportedEngine, ExportedModel, export_model
    from cape_tpu_torch.tools.perf_lab import time_routes

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    golden = np.load(GOLDEN)
    check_fingerprint("artifact phase", model, golden)
    params = to_jax_params(model)
    rec = {"device": smi}
    paths = {"f32": os.path.join(out_dir, "flagship_f32.capex"),
             "int8": os.path.join(out_dir, "flagship_int8_bf16.capex")}
    kinds = {"f32": {}, "int8": {"quantize": "int8", "constants_dtype": "bfloat16"}}
    em = {}
    for kind, path in paths.items():
        t0 = time.perf_counter()
        export_model(model, ctx_plain, params, cfg.batch_size, path, **kinds[kind])
        t1 = time.perf_counter()
        em[kind] = ExportedModel.load(path, device="cuda")
        t2 = time.perf_counter()
        rec[kind] = {"export_s": t1 - t0, "load_s": t2 - t1, "mb": os.path.getsize(path) / 1e6,
                     "devices": program_devices(em[kind])}
        log(f"artifact {kind} [{smi}]: exported in {t1 - t0:.2f} s, {rec[kind]['mb']:.3f} MB, "
            f"loaded on cuda in {t2 - t1:.2f} s; program tensors on {rec[kind]['devices']}")
        if any(d != ["cuda"] for d in rec[kind]["devices"].values()):
            raise AssertionError(f"artifact {kind}: a program tensor is not on cuda: "
                                 f"{rec[kind]['devices']}")
    if not rec["int8"]["mb"] < 0.7 * rec["f32"]["mb"]:
        raise AssertionError(f"the int8/bf16 artifact is not under 0.7x the f32 one: {rec}")
    ee = {kind: ExportedEngine(m) for kind, m in em.items()}
    live = InferenceEngine(model, ctx_plain, cfg.batch_size)
    pose, clo = golden["pose"], golden["clo"]

    # ---- the artifacts' main path: every count at 0 just before, read just after
    zero_counts()
    y, y2 = ee["f32"].encode_only_condition(pose, clo)
    zt = np.concatenate([golden["z"], y, y2], -1)
    disp = ee["f32"].decode(zt, y, y2)
    check_mesh("artifact f32 golden decode", disp, 32)
    rec["golden_err"] = held_to("artifact f32 vs JAX golden (batch-32 decode)",
                                disp[: len(golden["disp"])], golden["disp"])
    got_enc = ee["f32"].encode(disp, pose, clo)
    y8, y28 = ee["int8"].encode_only_condition(pose, clo)
    disp8 = ee["int8"].decode(np.concatenate([golden["z"], y8, y28], -1), y8, y28)
    httpd, thread, ms, client = start_server(ee["int8"])
    try:
        ms.warmup()
        served, z = client.sample(pose[:1], clo[:1], n=40, seed=0)
        health = client.health()
    finally:
        stop_server(httpd, thread)
    counts = read_counts()
    log(f"artifact main path: all counts {json.dumps(counts)} (0 by design: the artifact "
        "runs the plain route, as JAX's export does with use_pallas=False)")
    if any(counts.values()):
        raise AssertionError(f"the artifact calls launched a kernel: {counts}")
    rec["launches"] = counts

    # ---- against the live engine's plain route, and int8 against f32
    want_y = live.encode_only_condition(pose, clo)
    for name, g, w in zip(("y", "y2"), (y, y2), want_y):
        held_to(f"artifact f32 embed {name} vs live plain route", g, w)
    want_enc = live.encode(disp, pose, clo)
    for name, g, w in zip(("z_mean", "z_logvar", "y", "y2"), got_enc, want_enc):
        held_to(f"artifact f32 encode {name} vs live plain route", g, w)
    rel = float(np.linalg.norm(disp8 - disp) / np.linalg.norm(disp))
    log(f"artifact int8/bf16 vs f32 decode: relative L2 {rel:.3e} (limit 0.05)")
    if not rel < 0.05:
        raise AssertionError(f"the int8/bf16 artifact drifts {rel} from the f32 one")
    rec["int8_rel_l2"] = rel
    check_mesh("artifact int8 /sample", served, 40)
    yy, yy2 = ee["int8"].encode_only_condition(pose[:1], clo[:1])
    yy, yy2 = np.repeat(yy, 40, 0), np.repeat(yy2, 40, 0)
    held_to("artifact int8 /sample vs its direct decode", served,
            ee["int8"].decode(np.concatenate([z, yy, yy2], -1), yy, yy2), rel=1e-5)
    if health["num_verts"] != 6890 or health["batch_size"] != 32:
        raise AssertionError(f"artifact /health: {health}")

    # ---- decode.pt2 with torch alone
    proc = subprocess.run(["python3", "-c", TORCH_ONLY_LOAD, paths["int8"]], capture_output=True,
                          text=True, timeout=300, cwd=tempfile.gettempdir())
    if proc.returncode != 0:
        raise AssertionError(f"torch-only load failed: {proc.stderr[-2000:]}")
    alone = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"decode.pt2 in a process that imports torch alone: {json.dumps(alone)}")
    if alone["repo_modules"] or alone["shape"] != [32, 6890, 3] or not alone["finite"]:
        raise AssertionError(f"torch-only load: {alone}")

    # ---- times: the lab's artifact timer, then every decode in turns
    for kind, path in paths.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            perf_lab.main(["artifact", path, "--device", "cuda"])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        rec[kind]["lab"] = line
        log(f"perf_lab artifact {kind} [{smi}]: {json.dumps(line)}")
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    tz, ty, ty2 = dev(zt), dev(y), dev(y2)
    with torch.inference_mode():
        t = time_routes({
            "live_kernel": functools.partial(model.decode, ctx, tz, ty, ty2),
            "live_plain": functools.partial(model.decode, ctx_plain, tz, ty, ty2),
            **{f"artifact_{k}": functools.partial(m._calls["decode"], tz, ty, ty2)
               for k, m in em.items()},
        })
    rec["decode_ms"] = t
    for name, ms_ in t.items():
        log(f"batch-32 decode call, {name} [{smi}]: {ms_:.3f} ms")

    # ---- what one decode call launches and dispatches, per route
    with torch.inference_mode():
        census = {"live_plain": kernel_census(functools.partial(
                      model.decode, ctx_plain, tz, ty, ty2)),
                  **{f"artifact_{k}": kernel_census(functools.partial(m._calls["decode"], tz, ty, ty2))
                     for k, m in em.items()}}
    rec["census"] = census
    for name, c in census.items():
        log(f"batch-32 decode call, {name}, torch.profiler [{smi}]: {c['kernels']} device "
            f"kernels, {c['kernel_ms']:.3f} ms of device time, {c['ops']} aten operators "
            "dispatched")
    for kind in em:
        a, p = census[f"artifact_{kind}"], census["live_plain"]
        log(f"artifact {kind} minus live plain, per decode call: kernels "
            f"{json.dumps(census_diff(a['kernel_names'], p['kernel_names']))}; aten operators "
            f"{json.dumps(census_diff(a['op_names'], p['op_names']))}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"artifact phase: {rec['phase_s']:.2f} s")
    return rec


# ------------------------------------------------------------ phase 21: f16 and DP


def f16_gather_phase(ctx, smi):
    """Phase 21 (a): the band-gather kernel's f16 instantiation (rows 2 and
    2b) against its plain version at every case of phase 3 and every addend
    case of the addend phase, within one f16 ulp of max|ref|; the batch-32
    shapes of serving (ON_PATH) and of the train step's backward
    (TRAIN_APPLIES, with the addend) timed in f16 beside f32 and bf16, the
    plain version and one library call (torch.sparse.mm / addmm of the
    operator as an f16 CSR matrix), in turns. Returns (records, addend
    records)."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply, band_apply_plain
    from cape_tpu_torch.tools.perf_lab import time_routes

    laps = _laps(ctx)
    gen = torch.Generator(device="cuda").manual_seed(21)
    records, bwd_records = [], []
    cases = [(B, P, C, padded, False) for B, P, C, padded in GATHER_CASES]
    cases += [(32, P, C, True, True) for P, C in [*TRAIN_APPLIES, FAMILY_APPLIES[0]]]
    for B, P, C, padded, addend in cases:
        op = laps[P if padded else 6912]
        rows = P if padded else op.n_rows
        blocks = {d: op.blocks.to(d).contiguous()
                  for d in (torch.float32, torch.bfloat16, torch.float16)}
        x32 = torch.randn((B, P, C), generator=gen, device="cuda")
        r32 = torch.randn((B, rows, C), generator=gen, device="cuda") if addend else None
        xs = {d: x32.to(d) for d in blocks}
        rs = {d: None if r32 is None else r32.to(d) for d in blocks}
        x, r, b16 = xs[torch.float16], rs[torch.float16], blocks[torch.float16]
        y = band_apply(x, b16, op.pad_left, rows, addend=r, pack=op.pack)
        ref = band_apply_plain(x, b16, op.pad_left, rows, r)
        err, scale = _err(y, ref)
        limit = f16_ulp(scale)
        rec = dict(dtype="float16", B=B, P=P, C=C, addend=addend, W=op.pack.width,
                   layout="padded" if padded else "natural", max_abs_err=err,
                   max_rel_err=err / scale, limit=limit)
        log(f"f16 {'addend ' if addend else ''}kernel vs plain x[{B},{P},{C}] W={rec['W']} "
            f"{rec['layout']}: max_abs_err {err:.3e} rel {err / scale:.3e} (limit {limit:.3e})")
        if y.dtype != torch.float16 or not err <= limit:
            raise AssertionError(f"f16 band_apply disagrees with its plain version: {rec}")
        timed = B == 32 and padded and (P, C) in (TRAIN_APPLIES if addend else ON_PATH)
        if timed:
            A, xv = csr_operator(b16, op.pad_left, P, rows), vertex_major(x)
            routes = {f"{_name(d)}_ms": functools.partial(band_apply, xs[d], blocks[d], op.pad_left,
                                                          rows, addend=rs[d], pack=op.pack)
                      for d in blocks}
            routes["plain_ms"] = lambda: band_apply_plain(x, b16, op.pad_left, rows, r)
            if addend:
                rv = vertex_major(r)
                routes["library_ms"] = lambda: torch.sparse.addmm(rv, A, xv)
            else:
                routes["library_ms"] = lambda: torch.sparse.mm(A, xv)
            rec.update(time_routes(routes, rounds=6, calls=5))
            rec["ms"] = rec.pop("float16_ms")
            rec.update(apply_bound(b16, B, P, rows, C, torch.float16, addend=addend))
            log(f"  time [{smi}]: f16 kernel {rec['ms']:.4f} ms (f32 {rec['float32_ms']:.4f}, "
                f"bf16 {rec['bfloat16_ms']:.4f}), plain {rec['plain_ms']:.4f}, library "
                f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
                f"{rate(rec)}")
        (bwd_records if addend else records).append(rec)
    return records, bwd_records


def f16_flagship_phase(cfg, ctx, model, smi):
    """Phase 21 (b): the flagship in compute_dtype=float16 on the kernel route,
    held to tests/data/torch_golden_f16.npz (JAX's f16 runs beside its f32
    runs), each main path with the counts at 0 just before and read just
    after: the batch-32 decode of the serve golden's inputs (7 launches, all
    f16) within the golden's decode bound of max|ref|, and two batch-32 GAN
    steps (17 + 17 launches a step, all f16) held by the derived bounds
    (hold_bf16). Then the decode call and the step timed in f16, bf16 and
    f32, in turns. Returns (forward, backward launches, the times)."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.tools.perf_lab import time_routes
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    gold = np.load(GOLDEN_F16)
    t0 = time.perf_counter()
    cfgs = {"float16": cfg.replace(compute_dtype="float16", name="chip_smoke_f16"),
            "bfloat16": cfg.replace(compute_dtype="bfloat16", name="chip_smoke_bf16")}
    ctxs = {d: build_context(c, device="cuda") for d, c in cfgs.items()}
    ctxs["float32"], cfgs["float32"] = ctx, cfg
    models = {d: CAPE(cfgs[d]).init_params(torch.Generator().manual_seed(0), ctxs[d]).to("cuda")
              for d in ("float16", "bfloat16")}
    models["float32"] = model
    check_fingerprint("f16 flagship", models["float16"], gold)
    log(f"f16 and bf16 graph contexts and models built in {time.perf_counter() - t0:.2f} s")

    # ---- the decode main path: every count at 0 just before, read just after
    engine = InferenceEngine(models["float16"], ctxs["float16"], cfg.batch_size)
    zero_counts()
    y, y2 = engine.encode_only_condition(gold["decode:pose"], gold["decode:clo"])
    z_total = np.concatenate([gold["decode:z"], y, y2], -1)
    disp = engine.decode(z_total, y, y2)
    decode_counts = read_counts()
    log(f"f16 decode: device calls {engine.calls}; counts {json.dumps(decode_counts)}")
    if (decode_counts["band_apply.conv"] != 7
            or decode_counts["band_apply.float16"] != half_launches(decode_counts, 7)
            or not only(decode_counts, *SERVED, "band_apply.float16")):
        raise AssertionError(f"f16 decode: counts {decode_counts}, expected 7 f16 launches")
    check_mesh("f16 decode", disp, 32)
    ref = gold["decode:disp"]
    held_to("f16 kernel route vs JAX f16 golden (batch-32 decode)", disp[: len(ref)], ref,
            rel=float(gold["decode:bound"]))
    f32_ref = gold["decode:f32_disp"]
    log(f"f16 decode against JAX's f32 decode (f16's effect): "
        f"{np.abs(disp[: len(ref)] - f32_ref).max() / np.abs(f32_ref).max():.3e} of max|ref|")

    # ---- the train main path
    golden = bf16_view(gold, "b32")
    batches, spe = golden_batches(golden, ctxs["float16"].perm0, int(golden["batch"]))
    eps = torch.from_numpy(golden["eps"]).cuda()
    dtypes = {}
    zero_counts()
    state, metrics, updates, counts = gan_steps(cfgs["float16"], ctxs["float16"], batches, eps,
                                                spe, golden, dtypes)
    total = read_counts()
    log(f"f16 steps: band_apply launches (forward, backward) per step {counts}; all counts "
        f"{json.dumps(total)}")
    if (counts != [(FWD_PER_STEP, BWD_PER_STEP)] * 2
            or total["band_apply.float16"]
            != half_launches(total, 2 * (FWD_PER_STEP + BWD_PER_STEP))
            or not only(total, *STEPPED, "band_apply.float16")):
        raise AssertionError(f"f16 steps: launches {counts} ({total}), expected 17 + 17 a "
                             "step, all f16")
    hold_bf16("f16 b32 kernel", metrics, dtypes, updates, golden, what="JAX f16 golden")

    # ---- times: the decode call and the train step in each dtype, in turns
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    zt, ty, ty2 = dev(z_total), dev(y), dev(y2)
    states = {"float16": state}
    for d in ("bfloat16", "float32"):
        m = CAPE(cfgs[d]).init_params(torch.Generator().manual_seed(0), ctxs[d]).to("cuda")
        states[d] = TrainState(m, Optimizer(cfgs[d], spe))
    with torch.inference_mode():
        decode_ms = time_routes({d: functools.partial(models[d].decode, ctxs[d], zt, ty, ty2)
                                 for d in ("float16", "bfloat16", "float32")})
    step_ms = time_routes({d: functools.partial(train_step, states[d], ctxs[d], batches[0],
                                                eps[0])
                           for d in ("float16", "bfloat16", "float32")}, rounds=6, calls=2)
    for d in decode_ms:
        log(f"flagship batch 32, kernel route, {d} [{smi}]: decode call {decode_ms[d]:.3f} ms, "
            f"train step {step_ms[d]:.3f} ms (CUDA events, dtypes in turns)")
    fwd = decode_counts["band_apply.conv"] + total["band_apply.conv"]
    return fwd, total["band_apply.conv_bwd"], {"decode_ms": decode_ms, "step_ms": step_ms}


def dp_inputs(cfg, perm):
    """Phase 21 (c)'s two global batches of DP_BATCH rows (the train golden's
    data recipe: synthetic n_train=512 from cfg.seed, G and D streams seeded
    seed and seed + 1) and their eps [2, DP_BATCH, nz] (numpy default_rng(5)),
    as numpy."""
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.data.synthetic import synthetic_bodydata

    data = synthetic_bodydata(n_train=512, n_test=64, num_verts=6890, seed=cfg.seed)
    n = len(data.disp_train)
    sg, sd = BatchStream(n, DP_BATCH, cfg.seed), BatchStream(n, DP_BATCH, cfg.seed + 1)
    disp = data.disp_train[:, perm]
    batches = []
    for _ in range(2):
        ig, idd = sg.next_indices(), sd.next_indices()
        batches.append({"disp_g": disp[ig], "pose_g": data.pose_train[ig],
                        "clo_g": data.clo_train[ig], "disp_d": disp[idd],
                        "pose_d": data.pose_train[idd], "clo_d": data.clo_train[idd]})
    eps = np.random.default_rng(5).standard_normal((2, DP_BATCH, cfg.nz)).astype(np.float32)
    return batches, eps, n // DP_BATCH


def dp_rank(rank: int, n: int, port: int, workdir: str) -> None:
    """One rank of phase 21 (c), started as `chip_smoke.py dp-rank RANK N PORT
    DIR`: the flagship (f32, seed-0 parameters broadcast from rank 0) on the
    one card in a Gloo group, its rows of the two global steps of
    DIR/inputs.npz with the gradients averaged, the counts at 0 just before
    and read just after; then DP_TIMED_STEPS more steps, each timed by the
    host clock around a synchronised step, with the all-reduce's share (the
    reducer synchronises before and after it). Writes DIR/rank<RANK>.npz."""
    import torch.distributed as dist

    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.parallel import multihost
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    multihost.initialize(f"localhost:{port}", n, rank, backend="gloo")
    try:
        mh = multihost.MultiHostDataParallel(torch.device("cuda", 0))
        cfg = load_config(PRESET, batch_size=DP_BATCH, compute_dtype="float32",
                          name="chip_smoke_dp", data_parallel=n)
        ctx = build_context(cfg, device="cuda")
        model = mh.replicate(CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
                             .to("cuda"))
        lo, hi = mh.local_rows(DP_BATCH)
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            eps = torch.from_numpy(f["eps"][:, lo:hi]).cuda()
            batches = [{k.split("/")[1]: torch.from_numpy(np.ascontiguousarray(f[k][lo:hi])).cuda()
                        for k in f.files if k.startswith(f"{i}/")} for i in range(2)]
            spe = int(f["steps_per_epoch"])
        reduce_s = [0.0]

        def reduce(grads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mh.all_reduce_mean(grads)
            torch.cuda.synchronize()
            reduce_s[0] += time.perf_counter() - t0
            return out

        state = TrainState(model, Optimizer(cfg, spe))
        zero_counts()
        metrics = []
        for batch, e in zip(batches, eps):
            m, updates = train_step(state, ctx, batch, e, reduce=reduce)
            metrics.append([float(v) for v in mh.all_reduce_mean(m).values()])
        torch.cuda.synchronize()
        counts = read_counts()
        names = list(m)
        step_s = []
        for i in range(DP_TIMED_STEPS):
            reduce_s[0] = 0.0
            mh.barrier()
            t0 = time.perf_counter()
            train_step(state, ctx, batches[i % 2], eps[i % 2], reduce=reduce)
            torch.cuda.synchronize()
            step_s.append((time.perf_counter() - t0, reduce_s[0]))
        arrays = {f"update/{k}": v.cpu().numpy() for k, v in updates.items()} if mh.lead else {}
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), metrics=np.array(metrics),
                 metric_names=np.array(names), counts=json.dumps(counts),
                 step_s=np.array(step_s), **arrays)
    finally:
        dist.destroy_process_group()


def reference_steps(cfg, ctx, batches, eps, spe) -> tuple[list, dict]:
    """The single-process steps on the global batches of `dp_inputs` from
    the seed-0 parameters: (metrics per step, the last step's updates as
    numpy)."""
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    ref_cfg = cfg.replace(batch_size=DP_BATCH)
    model = CAPE(ref_cfg).init_params(torch.Generator().manual_seed(0), ctx).to("cuda")
    state = TrainState(model, Optimizer(ref_cfg, spe))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    metrics = []
    for batch, e in zip(batches, eps):
        m, updates = train_step(state, ctx, {k: dev(v) for k, v in batch.items()}, dev(e))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.cpu().numpy() for k, v in updates.items()}


def run_ranks(subcommand: str, n: int, workdir: str, timeout: float, *args, meanwhile=None):
    """Start n ranks of a Gloo group on a free port (`chip_smoke.py
    SUBCOMMAND RANK N PORT WORKDIR *ARGS`, one process each), run
    `meanwhile()` if given, and wait for every rank until `timeout` seconds
    after the start; a rank still running then is killed, and a rank that
    did not exit 0 fails the phase. Returns what `meanwhile` returned."""
    import socket
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), subcommand, str(r),
                               str(n), str(port), workdir, *map(str, args)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        result = meanwhile() if meanwhile is not None else None
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0] for p in procs]
    finally:
        for p in procs:   # no rank outlives the phase
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{subcommand} {r} of {n} exited {p.returncode}:\n{out[-4000:]}")
    return result


def dp_train_phase(cfg, ctx, smi):
    """Phase 21 (c): DP_RANKS Gloo ranks on the one card (`dp_rank`), the
    flagship in f32 at global batch DP_BATCH (32 rows a rank: the kernel
    route), two steps, held to the single-process batch-64 step from the
    same parameters, batches and eps (metrics within 1e-4 relative, every
    leaf's step-2 update by hold_updates); each rank's launches 17 + 17 a
    step. Every rank must exit 0 within DP_TIMEOUT seconds, or is killed and
    fails the phase. Logs the 2-rank step time and its all-reduce share (two
    ranks share one card: no scaling is measured). Returns (forward,
    backward launches of the ranks, the records)."""
    t_phase = time.perf_counter()
    batches, eps, spe = dp_inputs(cfg, ctx.perm0)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=os.path.join(ROOT, "build"))
    try:
        np.savez(os.path.join(workdir, "inputs.npz"), eps=eps, steps_per_epoch=spe,
                 **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
        # the single-process reference at the same global batch, meanwhile
        ref_metrics, ref_updates = run_ranks(
            "dp-rank", DP_RANKS, workdir, DP_TIMEOUT,
            meanwhile=lambda: reference_steps(cfg, ctx, batches, eps, spe))
        ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(DP_RANKS)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    names = [str(k) for k in ranks[0]["metric_names"]]
    fwd = bwd = 0
    for r, rec in enumerate(ranks):
        c = collections.Counter(json.loads(str(rec["counts"])))
        log(f"DP rank {r} of {DP_RANKS} (Gloo, one card), 2 steps at {DP_BATCH // DP_RANKS} rows: "
            f"counts {json.dumps(c)}")
        if ((c["band_apply.conv"], c["band_apply.conv_bwd"]) != (2 * FWD_PER_STEP, 2 * BWD_PER_STEP)
                or not only(c, *STEPPED)):
            raise AssertionError(f"DP rank {r}: counts {c}, expected 17 + 17 a step")
        fwd += c["band_apply.conv"]
        bwd += c["band_apply.conv_bwd"]
        if not np.array_equal(rec["metrics"], ranks[0]["metrics"]):
            raise AssertionError("DP ranks report different reduced metrics")
    for i in range(2):
        held_metrics(f"DP {DP_RANKS} ranks step {i + 1} vs the single-process batch-"
                     f"{DP_BATCH} step", dict(zip(names, ranks[0]["metrics"][i])),
                     ref_metrics[i])
    got = {k[len("update/"):]: v for k, v in ranks[0].items() if k.startswith("update/")}
    keys = sorted(ref_updates)
    summary = np.stack([[u.sum(), np.square(u).sum(), np.abs(u).max()]
                        for u in (ref_updates[k].astype(np.float64) for k in keys)])
    hold_updates(f"DP {DP_RANKS} ranks step-2 updates vs the single-process step", got, keys,
                 summary, ref_updates)
    steps = np.concatenate([rec["step_s"] for rec in ranks])
    step_ms = 1e3 * float(np.median(steps[:, 0]))
    share = float(np.median(steps[:, 1] / steps[:, 0]))
    log(f"DP {DP_RANKS}-rank step at global batch {DP_BATCH} [{smi}]: {step_ms:.3f} ms (host "
        f"clock around a synchronised step, median of {len(steps)} rank-steps), gradient "
        f"all-reduce share {share:.1%} (Gloo through the host); two ranks share one card, so "
        "this measures no scaling")
    rec = {"step_ms": step_ms, "allreduce_share": share, "launches": [fwd, bwd],
           "seconds": time.perf_counter() - t_phase}
    log(f"DP train phase: {rec['seconds']:.2f} s")
    return fwd, bwd, rec


def nccl_phase(cfg, ctx, mesh: bool = False):
    """Phase 21 (d), and with `mesh` phase 22 (c): one rank in an NCCL group
    of 1 through the Trainer (synthetic n_train=64: one step of batch 32 and
    one eval batch, a checkpoint), counts at 0 just before and read just
    after: NCCL initialises, the parameter broadcast, the gradient
    all-reduce and the eval's row gather run. With `mesh` the Trainer's dp
    is MeshParallel(1, 1): its groups made with new_group on NCCL, every
    leaf "sharded" over a model group of one (copy and gather run), the
    checkpoint assembled whole. Returns (forward, backward launches)."""
    import socket

    import torch.distributed as dist

    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.parallel import multihost
    from cape_tpu_torch.parallel.mesh2d import MeshParallel
    from cape_tpu_torch.train.loop import Trainer

    name = "TP 1x1 over NCCL" if mesh else "NCCL at world size 1"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    data = synthetic_bodydata(n_train=64, n_test=32, num_verts=6890, seed=cfg.seed)
    tcfg = cfg.replace(name="chip_smoke_nccl", num_epochs=1, tensorboard=False)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_nccl_", dir=os.path.join(ROOT, "build"))
    multihost.initialize(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        dp = MeshParallel(1, 1, device=torch.device("cuda", 0)) if mesh else None
        model = CAPE(tcfg).init_params(torch.Generator().manual_seed(0), ctx).to("cuda")
        zero_counts()
        trainer = Trainer(tcfg, model, ctx, data, workdir=workdir, dp=dp)
        val, _ = trainer.fit()
        torch.cuda.synchronize()
        counts = read_counts()
        groups = [trainer.dp.group] + ([dp.model_group, dp.data.group] if mesh else [])
        backends = [dist.get_backend(g) for g in groups]
        n_sharded = len(trainer.state.tx.sharded)
        saved = os.listdir(trainer.ckpt_dir)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"{name}: backends {backends}, {n_sharded} leaves sharded, {trainer.num_steps} step to "
        f"step {trainer.state.step}, val recon {val}, checkpoints {saved}; counts "
        f"{json.dumps(counts)}")
    if (set(backends) != {"nccl"} or trainer.dp.world_size != 1 or trainer.state.step != 1
            or bool(n_sharded) != mesh or len(saved) != 1
            or not all(math.isfinite(v) for v in val)):
        raise AssertionError(f"{name}: the Trainer did not run")
    if ((counts["band_apply.conv"], counts["band_apply.conv_bwd"]) != (FWD_PER_STEP + FWD_PER_EVAL,
                                                         BWD_PER_STEP)
            or not only(counts, *STEPPED)):
        raise AssertionError(f"{name}: counts {counts}")
    return counts["band_apply.conv"], counts["band_apply.conv_bwd"]


def dp_engine_phase(model, ctx):
    """Phase 21 (e): the DP engine over devices [cuda:0, cuda:0] (32 rows a
    device, padded calls of 64 split in device order) against the single
    device engine at batch 64, on 64 rows of decode inputs (numpy
    default_rng(6)), within 1e-5 * max|ref| (phase 15's limit); counts at 0
    just before and read just after: 2 decode device calls of 7 launches.
    Returns the launches."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.parallel.mesh import DataParallel

    cfg = model.cfg
    rng = np.random.default_rng(6)
    z = rng.standard_normal((64, cfg.nz)).astype(np.float32)
    pose = (0.5 * rng.standard_normal((64, cfg.cond_dim))).astype(np.float32)
    clo = np.eye(cfg.cond2_dim, dtype=np.float32)[rng.integers(0, cfg.cond2_dim, 64)]
    single = InferenceEngine(model, ctx, 64)
    y, y2 = single.encode_only_condition(pose, clo)
    zt = np.concatenate([z, y, y2], -1)
    ref = single.decode(zt, y, y2)
    engine = InferenceEngine(model, ctx, 32, dp=DataParallel(devices=["cuda:0", "cuda:0"]))
    zero_counts()
    disp = engine.decode(zt, y, y2)
    counts = read_counts()
    log(f"DP engine over [cuda:0, cuda:0]: device calls {engine.calls}; counts "
        f"{json.dumps(counts)}")
    if (engine.calls["decode"] != 2 or counts["band_apply.conv"] != 14
            or not only(counts, *SERVED)):
        raise AssertionError(f"DP engine: calls {engine.calls}, counts {counts}")
    check_mesh("DP engine decode", disp, 64)
    held_to("DP engine (2 x 32 rows) vs the single-device engine (64 rows)", disp, ref, rel=1e-5)
    return counts["band_apply.conv"]


def f16_dp_phase(cfg, ctx, model, smi):
    """Phase 21: float16 compute and data parallelism (f16_gather_phase,
    f16_flagship_phase, dp_train_phase, nccl_phase, dp_engine_phase).
    Returns its records and its launches: f16 forward and backward, f32
    forward and backward."""
    t_phase = time.perf_counter()
    f16_records, f16_bwd_records = f16_gather_phase(ctx, smi)
    f16_fwd, f16_bwd, f16_times = f16_flagship_phase(cfg, ctx, model, smi)
    dp_fwd, dp_bwd, dp_rec = dp_train_phase(cfg, ctx, smi)
    nccl_fwd, nccl_bwd = nccl_phase(cfg, ctx)
    engine_fwd = dp_engine_phase(model, ctx)
    rec = {"f16_band_apply": f16_records, "f16_band_apply_bwd": f16_bwd_records,
           "f16_flagship": f16_times, "dp_train": dp_rec,
           "nccl_launches": [nccl_fwd, nccl_bwd], "dp_engine_launches": engine_fwd,
           "seconds": time.perf_counter() - t_phase}
    log(f"f16-dp phase: {rec['seconds']:.2f} s")
    return rec, (f16_fwd, f16_bwd), (dp_fwd + nccl_fwd + engine_fwd, dp_bwd + nccl_bwd)

# ---------------------------------------------------- phase 22: mesh2d (TP)
def tp_routes(params: dict, cfg, B: int, tp: int, index: int) -> list[tuple[int, int, int]]:
    """The (B, C, F) of every conv of one flagship train step's forward
    that the gate (ops.cheb) sends to the v3 kernel on model index `index`
    of a tp-way model group feeding B rows, derived from the K=2 conv
    weights' full shapes `params` ({path: shape}), JAX's leaf rule and the
    gate: a column-parallel conv keeps its input channels C (the whole x)
    and computes F = fout / tp; a row-parallel one takes the rank's rows of
    [x | y | y2] and convolves only its share of x's channels (none: no
    conv); a replicated one is whole. The gate routes B >= VM_MIN_BATCH with
    B * C >= VM_MIN_COLS. Each routed conv launches one forward and one
    backward apply (its input is an activation that needs its gradient);
    the encoder and decoder run once a step, the discriminator's pred three
    times."""
    from cape_tpu_torch.ops import cheb
    from cape_tpu_torch.parallel.mesh2d import MODEL_AXIS, leaf_spec

    if cfg.cond_encoder or cfg.K != 2 or not cfg.fold_conditions:
        raise ValueError("tp_routes derives the flagship's plan only")
    ncond = cfg.nz_cond + cfg.nz_cond2
    convs = []   # (full weight shape, x's channels among its input rows, calls a step)
    for i in range(cfg.num_conv_layers):
        w = params[f"generator.encoder.layer{i}.w"]
        convs.append((w, w[1], 1))
    for i in range(cfg.num_conv_layers):
        w = params[f"generator.decoder.layer{i}.conv.w"]
        convs.append((w, w[1] - ncond, 1))
    w = params["generator.decoder.out.w"]
    convs.append((w, w[1] - ncond, 1))
    w = params["discriminator.pred.w"]
    convs.append((w, w[1], 3))
    routes = []
    for shape, cx, calls in convs:
        spec = leaf_spec(shape, tp)
        axis = spec.index(MODEL_AXIS) if spec else None
        C, F = cx, shape[2]
        if axis == 2:
            F = shape[2] // tp
        elif axis == 1:
            n = shape[1] // tp
            C = max(0, min((index + 1) * n, cx) - index * n)
        if C and B >= cheb.VM_MIN_BATCH and B * C >= cheb.VM_MIN_COLS:
            routes += [(B, C, F)] * calls
    return sorted(routes)


def tp_rank(rank: int, n: int, port: int, workdir: str, dp: int, tp: int) -> None:
    """One rank of phase 22 (a) or (b), started as `chip_smoke.py tp-rank
    RANK N PORT DIR DP TP`: the flagship (f32, seed-0 parameters broadcast
    from rank 0, then sharded) on the one card, a rank of a Gloo
    MeshParallel(DP, TP), its data group's rows of the two global steps of
    DIR/inputs.npz; per step the counts (at 0 just before, read just after)
    and the (B, C, F) of every v3 conv it launched; its parameters' and
    optimizer buffers' shapes checked against its shards; then
    TP_TIMED_STEPS more steps, each timed by the host clock around a
    synchronised step, with the share of its collectives (each one
    synchronised before and after). Writes DIR/rank<RANK>.npz; the lead
    adds the step-2 updates gathered whole."""
    import torch.distributed as dist

    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import cheb_kernel
    from cape_tpu_torch.parallel import multihost
    from cape_tpu_torch.parallel.mesh2d import MeshParallel, shard_of
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    multihost.initialize(f"localhost:{port}", n, rank, backend="gloo")
    try:
        mp = MeshParallel(dp, tp, device=torch.device("cuda", 0))
        cfg = load_config(PRESET, batch_size=DP_BATCH, compute_dtype="float32",
                          name="chip_smoke_tp")
        ctx = build_context(cfg, device="cuda")
        model = mp.replicate(CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx)
                             .to("cuda"))
        whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
        lo, hi = mp.local_rows(DP_BATCH)
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            eps = torch.from_numpy(f["eps"][:, lo:hi]).cuda()
            batches = [{k.split("/")[1]: torch.from_numpy(np.ascontiguousarray(f[k][lo:hi])).cuda()
                        for k in f.files if k.startswith(f"{i}/")} for i in range(2)]
            spe = int(f["steps_per_epoch"])
        state = mp.shard_state(TrainState(model, Optimizer(cfg, spe)))

        routed = []
        v3 = cheb_kernel.cheb2_banded_v3

        def logged_v3(x, band_op, weight):
            routed.append((x.shape[0], x.shape[2], weight.shape[2]))
            return v3(x, band_op, weight)

        cheb_kernel.cheb2_banded_v3 = logged_v3
        metrics, counts, routes = [], [], []
        for batch, e in zip(batches, eps):
            routed.clear()
            zero_counts()
            m, updates = train_step(state, ctx, batch, e, reduce=mp.all_reduce_mean)
            torch.cuda.synchronize()
            counts.append(read_counts())
            routes.append(sorted(routed))
            metrics.append([float(v) for v in mp.all_reduce_mean(m).values()])
        cheb_kernel.cheb2_banded_v3 = v3
        names = list(m)
        bad = []
        for k, p in model.named_parameters():
            s = shard_of(p)
            want = list(whole[k])
            if s is not None:
                want[s.axis] //= tp
            got = [list(p.shape)] + [list(b.shape) for b in state.tx.buffers[k].values()]
            if got != [want] * len(got):
                bad.append((k, got, want))
        if bad:
            raise AssertionError(f"rank {rank}: parameters or buffers not at their shard shapes: "
                                 f"{bad}")
        n_sharded = len(state.tx.sharded)
        full_updates = {}
        named = dict(model.named_parameters())
        with torch.no_grad():
            for k, u in updates.items():
                s = shard_of(named[k])
                full_updates[k] = (u if s is None else s.gather(u, s.axis)).cpu().numpy()

        comm = [0.0, 0]   # seconds and bytes in collectives
        calls = {}
        for op in ("all_reduce", "broadcast"):
            calls[op] = getattr(dist, op)

            def timed(tensor, *a, _op=calls[op], **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _op(tensor, *a, **kw)
                torch.cuda.synchronize()
                comm[0] += time.perf_counter() - t0
                comm[1] += tensor.numel() * tensor.element_size()
                return out

            setattr(dist, op, timed)
        step_s = []
        for i in range(TP_TIMED_STEPS):
            mp.barrier()
            comm[:] = [0.0, 0]
            t0 = time.perf_counter()
            train_step(state, ctx, batches[i % 2], eps[i % 2], reduce=mp.all_reduce_mean)
            torch.cuda.synchronize()
            step_s.append((time.perf_counter() - t0, comm[0], comm[1]))
        for op, fn in calls.items():
            setattr(dist, op, fn)
        arrays = {f"update/{k}": v for k, v in full_updates.items()} if mp.lead else {}
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), metrics=np.array(metrics),
                 metric_names=np.array(names), counts=json.dumps(counts),
                 routes=json.dumps(routes), step_s=np.array(step_s),
                 coords=np.array([mp.data_index, mp.model_index]),
                 n_sharded=n_sharded, n_leaves=len(whole), **arrays)
    finally:
        dist.destroy_process_group()


def tp_mesh_run(dp: int, tp: int, inputs: str, params: dict, cfg, ref, smi) -> dict:
    """Phase 22 (a) or (b): dp*tp Gloo ranks (`tp_rank`) on the one card,
    every one of which must exit 0 within TP_TIMEOUT seconds, or is killed
    and fails the phase. Held to the single-process batch-64 step `ref`
    (metrics, the step-2 updates): metrics within 1e-4 relative, updates by
    hold_updates; every rank's launches and v3 convs a step those of
    `tp_routes`. Returns the record."""
    ref_metrics, ref_updates = ref
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_tp{dp}x{tp}_", dir=os.path.join(ROOT, "build"))
    n = dp * tp
    try:
        shutil.copy(inputs, os.path.join(workdir, "inputs.npz"))
        run_ranks("tp-rank", n, workdir, TP_TIMEOUT, dp, tp)
        ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(n)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    name = f"TP {dp}x{tp}"
    B = DP_BATCH // dp
    fwd = bwd = 0
    per_rank = []
    for r, rec in enumerate(ranks):
        counts = [collections.Counter(c) for c in json.loads(str(rec["counts"]))]
        routes = json.loads(str(rec["routes"]))
        want = tp_routes(params, cfg, B, tp, r % tp)
        log(f"{name} rank {r} at {[int(v) for v in rec['coords']]} (Gloo, one card), {B} rows, "
            f"{int(rec['n_sharded'])} of {int(rec['n_leaves'])} leaves sharded: launches a "
            f"step {[(c['band_apply.conv'], c['band_apply.conv_bwd']) for c in counts]}, v3 convs "
            f"(B, C, F) {routes[0]}")
        for step, (c, got) in enumerate(zip(counts, routes)):
            if [tuple(v) for v in got] != want:
                raise AssertionError(f"{name} rank {r} step {step + 1}: v3 convs {got}, the gate "
                                     f"gives {want}")
            if ((c["band_apply.conv"], c["band_apply.conv_bwd"]) != (len(want), len(want))
                    or not only(c, *STEPPED)):
                raise AssertionError(f"{name} rank {r} step {step + 1}: counts {c}, expected "
                                     f"{len(want)} + {len(want)}")
            fwd += c["band_apply.conv"]
            bwd += c["band_apply.conv_bwd"]
        per_rank.append(len(want))
        if not np.array_equal(rec["metrics"], ranks[0]["metrics"]):
            raise AssertionError(f"{name}: ranks report different reduced metrics")
    names = [str(k) for k in ranks[0]["metric_names"]]
    for i in range(2):
        held_metrics(f"{name} step {i + 1} vs the single-process batch-{DP_BATCH} step",
                     dict(zip(names, ranks[0]["metrics"][i])), ref_metrics[i])
    got = {k[len("update/"):]: v for k, v in ranks[0].items() if k.startswith("update/")}
    keys = sorted(ref_updates)
    summary = np.stack([[u.sum(), np.square(u).sum(), np.abs(u).max()]
                        for u in (ref_updates[k].astype(np.float64) for k in keys)])
    hold_updates(f"{name} step-2 updates vs the single-process step", got, keys, summary,
                 ref_updates)
    steps = np.concatenate([rec["step_s"] for rec in ranks])
    step_ms = 1e3 * float(np.median(steps[:, 0]))
    share = float(np.median(steps[:, 1] / steps[:, 0]))
    mb = float(np.median(steps[:, 2])) / 1e6
    rate = float(np.median(steps[:, 2] / steps[:, 1])) / 1e9
    log(f"{name} step at global batch {DP_BATCH} [{smi}]: {step_ms:.3f} ms (host clock around a "
        f"synchronised step, median of {len(steps)} rank-steps), collectives' share "
        f"{share:.1%}, {mb:.1f} MB a rank and step through them at {rate:.3f} GB/s (Gloo "
        f"through the host, each collective synchronised); {n} ranks share one card, so this "
        "measures no scaling")
    return {"step_ms": step_ms, "collective_share": share, "collective_mb": mb,
            "collective_gb_per_s": rate, "launches": [fwd, bwd],
            "launches_per_rank_step": per_rank}


def mesh2d_phase(cfg, ctx, smi):
    """Phase 22: tensor parallelism (parallel/mesh2d.py). (a) MeshParallel(1,
    2) and (b) MeshParallel(2, 2) on the one card (`tp_mesh_run`), both held
    to one single-process batch-64 step, computed here; (c) `nccl_phase`
    with `mesh`. Returns the record and the launches (forward, backward)."""
    from cape_tpu_torch.models.cape import CAPE

    t_phase = time.perf_counter()
    batches, eps, spe = dp_inputs(cfg, ctx.perm0)
    params = {k: tuple(p.shape) for k, p in CAPE(cfg).init_params(
        torch.Generator().manual_seed(0), ctx).named_parameters()}
    ref = reference_steps(cfg, ctx, batches, eps, spe)
    torch.cuda.empty_cache()
    inputs = os.path.join(ROOT, "build", "chip_smoke_tp_inputs.npz")
    np.savez(inputs, eps=eps, steps_per_epoch=spe,
             **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    try:
        runs = {f"{dp}x{tp}": tp_mesh_run(dp, tp, inputs, params, cfg, ref, smi)
                for dp, tp in TP_MESHES}
    finally:
        os.remove(inputs)
    nccl_fwd, nccl_bwd = nccl_phase(cfg, ctx, mesh=True)
    fwd = sum(r["launches"][0] for r in runs.values()) + nccl_fwd
    bwd = sum(r["launches"][1] for r in runs.values()) + nccl_bwd
    rec = {**runs, "nccl_launches": [nccl_fwd, nccl_bwd], "seconds": time.perf_counter() - t_phase}
    log(f"mesh2d phase: {rec['seconds']:.2f} s")
    return rec, (fwd, bwd)


def hold_init(state_dict: dict, golden) -> float:
    """A model's initial parameters (a state dict, on any device) against
    JAX's init golden (tests/make_torch_golden.py `init_record`): per
    leaf, with n entries and every entry within INIT_ULP, the sum within
    n * INIT_ULP, the sum of squares within n * INIT_ULP * (2 max|ref| +
    INIT_ULP), max|.| within INIT_ULP, and each stored whole leaf within
    INIT_ULP per entry. Raises past a bound; returns the worst error over
    its bound."""
    keys = [str(k) for k in golden["keys"]]
    if sorted(state_dict) != keys:
        raise AssertionError(f"init: leaves {sorted(set(state_dict) ^ set(keys))} differ")
    worst = 0.0
    for k, (r_sum, r_sq, r_max) in zip(keys, golden["summary"]):
        t = state_dict[k].detach()
        n = t.numel()
        got = [float(t.double().sum()), float(t.double().square().sum()), float(t.abs().max())]
        bounds = [n * INIT_ULP, n * INIT_ULP * (2 * r_max + INIT_ULP), INIT_ULP]
        errs = [abs(g - r) for g, r in zip(got, (r_sum, r_sq, r_max))]
        if f"whole/{k}" in golden.files:
            errs.append(float(np.abs(t.float().cpu().numpy() - golden[f"whole/{k}"]).max()))
            bounds.append(INIT_ULP)
        for e, b in zip(errs, bounds):
            if not e <= b:
                raise AssertionError(f"init {k}: {errs} outside {bounds}")
            worst = max(worst, e / b)
    return worst


def random_phase(cfg, ctx, smi) -> tuple[int, int, dict]:
    """Phase 23: JAX's randomness on the card (see the module docstring).
    Returns (forward, backward launches of its main paths, the record)."""
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.train import loop

    t_phase = t0 = time.perf_counter()
    key = prng.PRNGKey(cfg.seed)
    model = CAPE(cfg).init_params(key, ctx).to("cuda")
    init_s = time.perf_counter() - t0
    golden = np.load(GOLDEN_INIT)
    if int(golden["seed"]) != cfg.seed:
        raise AssertionError(f"init golden seed {golden['seed']}, config seed {cfg.seed}")
    worst = hold_init(model.state_dict(), golden)
    log(f"random (a) init_params(PRNGKey({cfg.seed})) on the host in {init_s:.2f} s "
        f"[{smi}], {len(golden['keys'])} leaves held to JAX's: worst error "
        f"{worst:.3f} of its bound (INIT_ULP {INIT_ULP} per entry)")
    rec = {"init_s": init_s, "init_worst_of_bound": worst}

    # 64 train rows (2 steps at batch 32) and 32 val rows (one eval batch)
    data = synthetic_bodydata(n_train=96, n_test=32, num_verts=6890, seed=cfg.seed)
    ctx_bf = build_context(cfg.replace(compute_dtype="bfloat16"), device="cuda")
    seen, train_step = [], loop.train_step

    def recorded(state, c, batch, eps, **kw):
        seen.append(eps)   # read after the fit: no sync on the path
        return train_step(state, c, batch, eps, **kw)

    fwd = bwd = 0
    workdir = tempfile.mkdtemp(prefix="chip_smoke_random_", dir=os.path.join(ROOT, "build"))
    loop.train_step = recorded
    try:
        for dtype, c in (("float32", ctx), ("bfloat16", ctx_bf)):
            fcfg = cfg.replace(name=f"chip_smoke_random_{dtype}", compute_dtype=dtype,
                               num_epochs=1, tensorboard=False)
            m = model if dtype == "float32" else CAPE(fcfg).init_params(key, c).to("cuda")
            seen.clear()
            # ---- a train main path: every count at 0 just before, read just after
            zero_counts()
            t0 = time.perf_counter()
            trainer = loop.Trainer(fcfg, m, c, data, workdir=workdir)
            val, _ = trainer.fit()
            torch.cuda.synchronize()
            counts = read_counts()
            fit_s = time.perf_counter() - t0
            steps = trainer.state.step
            tdt = getattr(torch, dtype)
            want = torch.from_numpy(prng.normal_folded(key, range(steps), (32, cfg.nz),
                                                       dtype)).to(tdt)
            got = torch.stack([e.cpu() for e in seen]) if seen else None
            exp = (FWD_PER_STEP * steps + FWD_PER_EVAL, BWD_PER_STEP * steps)
            ok_half = dtype == "float32" or counts["band_apply.bfloat16"] == half_launches(counts,
                                                                                     sum(exp))
            log(f"random (b) Trainer.fit {dtype}: {steps} steps and one val batch in "
                f"{fit_s:.2f} s [{smi}], val recon {val}; eps of {len(seen)} steps "
                f"{'bit-equal' if got is not None and torch.equal(got, want) else 'NOT equal'}"
                f" to core.prng's {dtype} draw; counts {json.dumps(counts)}")
            if steps != 2 or got is None or got.dtype != tdt or not torch.equal(got, want):
                raise AssertionError(f"random fit {dtype}: the steps' eps are not JAX's")
            if ((counts["band_apply.conv"], counts["band_apply.conv_bwd"]) != exp or not ok_half
                    or not only(counts, *STEPPED, "band_apply.bfloat16")):
                raise AssertionError(f"random fit {dtype}: counts {counts}, expected {exp}")
            if not all(math.isfinite(v) for v in val):
                raise AssertionError(f"random fit {dtype}: val recon {val}")
            fwd, bwd = fwd + counts["band_apply.conv"], bwd + counts["band_apply.conv_bwd"]
            rec[f"fit_{dtype}"] = {"s": fit_s, "val_recon": val, "counts": counts}
    finally:
        loop.train_step = train_step
        shutil.rmtree(workdir, ignore_errors=True)

    # (c) the bf16 engine's sampled autoencode, on the bf16 fit's model
    engine = InferenceEngine(m, ctx_bf, 32)
    drawn, sample_z = [], m.sample_z
    m.sample_z = lambda zm, zl, e: (drawn.append(e), sample_z(zm, zl, e))[1]
    test = data.split("test")
    try:
        zero_counts()
        t0 = time.perf_counter()
        out = engine.autoencode(*test, rng=7, sample=True)
        counts = read_counts()
        ae_s = time.perf_counter() - t0
    finally:
        del m.sample_z
    want = torch.from_numpy(prng.normal_rows(7, 32, cfg.nz, "bfloat16")).to(torch.bfloat16)
    calls = dict(engine.calls)
    equal = len(drawn) == 1 and drawn[0].dtype == torch.bfloat16 and torch.equal(
        drawn[0].cpu(), want)
    log(f"random (c) bf16 sampled autoencode of 32 rows in {ae_s:.2f} s [{smi}]: eps "
        f"{'bit-equal' if equal else 'NOT equal'} to normal_rows(7, 32, {cfg.nz}, bfloat16); "
        f"device calls {calls}, counts {json.dumps(counts)}")
    n_launch = 7 * (calls["encode"] + calls["decode"])
    if not equal or calls["sample"] != 1:
        raise AssertionError("random: the engine's sampled eps are not JAX's bf16 draw")
    if (counts["band_apply.conv"] != n_launch
            or counts["band_apply.bfloat16"] != half_launches(counts, n_launch)
            or not only(counts, *SERVED, "band_apply.bfloat16")):
        raise AssertionError(f"random autoencode: counts {counts}, expected {n_launch}")
    check_mesh("bf16 sampled autoencode", out, 32)
    fwd += counts["band_apply.conv"]
    rec["autoencode_s"] = ae_s
    log(f"random phase: {time.perf_counter() - t_phase:.2f} s [{smi}]")
    return fwd, bwd, rec


def main():
    t_start = time.perf_counter()
    smi = device_phase()
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
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
    op_records = op_apply_phase(ctx, smi)
    norm_records = norm_phase(smi)

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
    launches = serve_counts["band_apply.conv"]
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
    if (launches != 7 * (calls["decode"] + calls["encode"])
            or not only(serve_counts, *SERVED)):
        raise AssertionError(f"{serve_counts} launches for {calls}: expected 7 band_apply per "
                             "decode/encode call and no other kernel")

    # ---- the plain route on the same requests
    engine_plain = InferenceEngine(model, ctx_plain, cfg.batch_size)
    httpd, thread, _, client = start_server(engine_plain)
    before = read_counts()
    plain = requests(client, pose, clo)
    stop_server(httpd, thread)
    if read_counts() != before:
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
    artifact_rec = artifact_phase(cfg, model, ctx, ctx_plain, smi)
    log(f"main paths: serve {launches} band_apply launches; train mode {run_fwd} "
        f"band_apply and {run_bwd} band_apply_bwd launches; microbatch {mb_launches} and "
        f"demo {demo_launches} band_apply launches; families {fam_fwd} band_apply and "
        f"{fam_bwd} band_apply_bwd launches; train-prod {prod_fwd} band_apply and {prod_bwd} "
        "band_apply_bwd launches; artifact 0 launches (the plain route by design)")
    log(f"train-prod step times [{smi}]: " + json.dumps(prod_records["step_ms"]))
    log(f"families times [{smi}]: " + json.dumps(fam_times))
    log(f"serving latency under load [{smi}]: " + json.dumps(mb_times))
    log(f"DemoSuite modes, nz18 at batch 32 [{smi}]: " + json.dumps(demo_seconds))
    log(f"train step times [{smi}]: " + json.dumps(train_times))
    lab_lines, lab_counts = lab_phase(smi)
    rest_rec, rest_fwd, rest_bwd = lab_rest_phase(model, ctx, smi)
    f16_dp_rec, (f16_fwd, f16_bwd), (dp_fwd, dp_bwd) = f16_dp_phase(cfg, ctx, model, smi)
    tp_rec, (tp_fwd, tp_bwd) = mesh2d_phase(cfg, ctx, smi)
    rand_fwd, rand_bwd, rand_rec = random_phase(cfg, ctx, smi)
    os.makedirs(os.path.dirname(RECORDS), exist_ok=True)
    with open(RECORDS, "w") as f:
        json.dump({"device": smi, "band_apply": records, "band_apply_bwd": bwd_records,
                   "cheb2_fused": fused_records, "band_apply_bm": bm_records,
                   "cheb2_window": {"records": ring_records, "main_path_launches": ring_counts},
                   "lab": lab_lines, "lab_launches": lab_counts,
                   "microbatch_latency": mb_times, "demo_mode_seconds": demo_seconds,
                   "families": {"launches": [fam_fwd, fam_bwd], "times": fam_times},
                   "train_prod": {"launches": [prod_fwd, prod_bwd], **prod_records},
                   "artifact": artifact_rec, "lab_rest": rest_rec, "f16_dp": f16_dp_rec,
                   "mesh2d": tp_rec, "random": rand_rec, "op_applies": op_records,
                   "group_norm_relu": norm_records}, f)

    per_step = lambda recs, key: sum(TRAIN_APPLIES[(r["P"], r["C"])] * r[key] for r in recs)
    summary = [{
        "name": "band_apply",
        "route": "cuda",
        "source": GATHER_SOURCE,
        "replaces": REPLACES,
        # the forward launches of the serve, train-mode, microbatch, demo,
        # families, train-prod, lab-rest, (f32) DP, TP and random main paths
        "launches": (launches + run_fwd + mb_launches + demo_launches + fam_fwd + prod_fwd
                     + rest_fwd + dp_fwd + tp_fwd + rand_fwd),
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
        "launches": run_bwd + fam_bwd + prod_bwd + rest_bwd + dp_bwd + tp_bwd + rand_bwd,
        # worst f32 error of the addend variant over the train steps'
        # shapes (the CMR output conv's included); times and bounds summed
        # over the 17 backward applies of one flagship step
        "max_abs_err": max(r["max_abs_err"] for r in bwd_f32),
        "ms": per_step(bwd_step, "ms"),
        "plain_ms": per_step(bwd_step, "plain_ms"),
        **summed_bound(bwd_step, lambda r: TRAIN_APPLIES[(r["P"], r["C"])]),
        "library_ms": per_step(bwd_step, "library_ms"),
    }]
    # rows 2 and 2b in f16 (phase 21): launches from its f16 main paths;
    # the worst error over every f16 case; times and bounds as the f32 rows'
    f16_fwd_t = [r for r in f16_dp_rec["f16_band_apply"] if "ms" in r]
    f16_bwd_all = f16_dp_rec["f16_band_apply_bwd"]
    f16_bwd_t = [r for r in f16_bwd_all if "ms" in r]
    summary += [{
        "name": "band_apply (f16)", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": REPLACES, "launches": f16_fwd,
        "max_abs_err": max(r["max_abs_err"] for r in f16_dp_rec["f16_band_apply"]),
        "ms": sum(r["ms"] for r in f16_fwd_t), "plain_ms": sum(r["plain_ms"] for r in f16_fwd_t),
        **summed_bound(f16_fwd_t), "library_ms": sum(r["library_ms"] for r in f16_fwd_t),
    }, {
        "name": "band_apply_bwd (f16)", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": REPLACES_BWD, "launches": f16_bwd,
        "max_abs_err": max(r["max_abs_err"] for r in f16_bwd_all),
        "ms": per_step(f16_bwd_t, "ms"), "plain_ms": per_step(f16_bwd_t, "plain_ms"),
        **summed_bound(f16_bwd_t, lambda r: TRAIN_APPLIES[(r["P"], r["C"])]),
        "library_ms": per_step(f16_bwd_t, "library_ms"),
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
        "replaces": REPLACES_V1, "launches": lab_counts["cheb2_fused.g1"],
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
    summary += norm_rows(norm_records)
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.2f} s in all")
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["dp-rank"]:   # one rank of phase 21's data-parallel run
        dp_rank(*map(int, sys.argv[2:5]), sys.argv[5])
    elif sys.argv[1:2] == ["tp-rank"]:   # one rank of phase 22's tensor-parallel runs
        tp_rank(*map(int, sys.argv[2:5]), sys.argv[5], *map(int, sys.argv[6:8]))
    elif sys.argv[1:2] == ["norm"]:   # phases 1, 2 and 25 alone
        smi = device_phase()
        build_phase()
        log(json.dumps({"kernels": norm_rows(norm_phase(smi))}))
    else:
        main()
