"""Drive the PyTorch port of CAPE (serving and training) once on a CUDA GPU.

    python3 chip_smoke.py       # one GPU; needs the checkout around it

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device: a CUDA GPU must be present (there is no CPU path); TF32 off.
  2. build: compile csrc/band_apply.cu with nvcc.
  3. kernel: the band-apply kernel against its plain PyTorch version at
     every batch-32 and batch-64 shape of the flagship serving path, one
     natural-layout and one ragged-column case, in f32 and bf16; then its
     addend variant (the backward pass of the conv) at every batch-32
     shape of the train step, the discriminator's [32, 512, 128] included,
     in f32 and bf16, with times against plain.
  4. serve: the flagship preset (f32, batch 32, parameters from
     torch.Generator seed 0) behind the port's HTTP server on 127.0.0.1:0;
     /health, /sample (n=40: two padded decode calls), /encode, /decode,
     /reconstruct, /stats. The kernel must have run exactly 7 times per
     decode and per encode device call.
  5. plain route: the same requests with use_pallas=False, held to the
     kernel route; no kernel launch.
  6. golden: the batch-32 decode of tests/data/torch_golden_flagship.npz
     (written by the JAX package) held to 1e-4 * max|ref|.
  7. times: CUDA events, 3 warm-up calls, median of 20: per-shape kernel
     against plain, and the batch-32 decode call on both routes.
  8. train step: two flagship GAN steps at batch 32 (f32, seed-0
     parameters, the synthetic batches and eps of
     tests/data/torch_golden_train.npz) on the kernel route, 17 forward
     and 17 backward launches per step; the same steps on the plain route
     with none; both held to each other and to the JAX golden (metrics
     1e-4 relative, step-2 updates per leaf, see hold_updates).
  9. train time: CUDA events, 3 warm-up steps, median of 10, both routes.
 10. train mode: apps.main.run (synthetic n_train=64, 2 epochs of one
     step); restore_params reads its checkpoint bit-equal, and decodes.
The last two lines are a JSON summary of the kernels and the device line.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
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
REPLACES = "cape_tpu/ops/pallas/cheb_kernel.py:168"  # _pallas_band_apply_v2
REPLACES_BWD = "cape_tpu/ops/pallas/cheb_kernel.py:268"  # the apply in _v3_bwd

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


def log(*a):
    print(*a, flush=True)


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
    from cape_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    lib = build.build("band_apply")
    build.band_apply_lib()
    log(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")
    ptxas = (lib.parent / f"{lib.stem}.log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas:", line.strip())


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of `iters` single-call CUDA-event times after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _laps(ctx) -> dict:
    """A Laplacian of the context for each padded row count P."""
    laps = {}
    for op in ctx.lap + ctx.lap_d:
        laps.setdefault(op.blocks.shape[1] * 128, op)
    return laps


def kernel_phase(ctx, smi):
    """Kernel against plain at every case; returns the per-case records."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply, band_apply_plain

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
                rec["ms"] = time_ms(lambda: band_apply(x, blocks, op.pad_left, rows_out))
                rec["plain_ms"] = time_ms(lambda: band_apply_plain(x, blocks, op.pad_left, rows_out))
                rec["dense_gflop"] = 2 * S * 128 * P * B * C / 1e9
                log(f"  time [{smi}]: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
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
                rec["ms"] = time_ms(lambda: band_apply(x, blocks, op.pad_left, P, addend=r))
                rec["plain_ms"] = time_ms(lambda: band_apply_plain(x, blocks, op.pad_left, P, r))
                log(f"  time [{smi}]: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms")
            records.append(rec)
    return records


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

    times = {}
    for route in ("kernel", "plain", "kernel", "plain"):
        state, c = runs[route][:2]
        t = time_ms(lambda: train_step(state, c, batches[0], eps[0]), warmup=3, iters=10)
        times.setdefault(route, []).append(t)
        log(f"batch-32 flagship train step, {route} route [{smi}]: {t:.3f} ms "
            f"(CUDA events, 3 warm-up, median of 10)")
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
    from cape_tpu_torch.ops.kernels import cheb_kernel

    run_cfg = cfg.replace(name="chip_smoke_train", mode="train", num_epochs=2)
    data = synthetic_bodydata(n_train=64, n_test=32, num_verts=6890, seed=cfg.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        # ---- the train main path: every count at 0 just before, read just after
        cheb_kernel.launches = cheb_kernel.bwd_launches = 0
        t0 = time.perf_counter()
        trainer = run(run_cfg, workdir, device="cuda", data=data)
        torch.cuda.synchronize()
        counts = (cheb_kernel.launches, cheb_kernel.bwd_launches)
        steps = trainer.state.step
        evals = run_cfg.num_epochs + 1   # one val batch per epoch, one test batch
        want = (FWD_PER_STEP * steps + FWD_PER_EVAL * evals, BWD_PER_STEP * steps)
        log(f"train mode run(): {time.perf_counter() - t0:.2f} s, {steps} steps, "
            f"{evals} eval batches, band_apply launches (forward, backward) {counts}")
        if steps != 2 or counts != want:
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
    smi = device_phase()
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.ops.kernels import cheb_kernel

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

    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), ctx).to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    engine = InferenceEngine(model, ctx, cfg.batch_size)
    httpd, thread, ms, client = start_server(engine)
    log(f"serving {cfg.name} ({n_params} parameters) on {client.base}; "
        f"warmup {ms.warmup():.2f} s")
    golden = np.load(GOLDEN)
    pose, clo = golden["pose"], golden["clo"]

    # ---- the main path: every count at 0 just before, read just after
    cheb_kernel.launches = 0
    engine.calls = dict.fromkeys(engine.calls, 0)
    t0 = time.perf_counter()
    health = client.get("/health")
    served = requests(client, pose, clo)
    stats = client.get("/stats")
    launches = cheb_kernel.launches
    calls = dict(engine.calls)
    log(f"main path: {time.perf_counter() - t0:.2f} s, device calls {calls}, "
        f"band_apply launches {launches}")
    log(f"/health {json.dumps(health)}")
    log(f"/stats {json.dumps(stats)}")
    stop_server(httpd, thread)
    if health["batch_size"] != 32 or health["num_verts"] != 6890:
        raise AssertionError(f"/health: {health}")
    if calls["decode"] != 4 or calls["encode"] != 2:
        raise AssertionError(f"expected 4 decode and 2 encode device calls, got {calls}")
    if launches != 7 * (calls["decode"] + calls["encode"]):
        raise AssertionError(f"{launches} launches for {calls}: expected 7 per decode/encode call")

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
        for name, c in (("kernel", ctx), ("plain", ctx_plain), ("kernel", ctx), ("plain", ctx_plain)):
            t = time_ms(lambda: model.decode(c, zt, ty, ty2))
            log(f"batch-32 decode device call, {name} route [{smi}]: {t:.3f} ms")

    # ---- training: the step on both routes, then the train mode
    train_times = train_phase(cfg, ctx, ctx_plain, smi)
    run_fwd, run_bwd = run_phase(cfg)
    log(f"main paths: serve {launches} band_apply launches; train mode {run_fwd} "
        f"band_apply and {run_bwd} band_apply_bwd launches")
    log(f"train step times [{smi}]: " + json.dumps(train_times))

    per_step = lambda recs, key: sum(TRAIN_APPLIES[(r["P"], r["C"])] * r[key] for r in recs)
    summary = [{
        "name": "band_apply",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        # the serve and train-mode main paths' forward launches
        "launches": launches + run_fwd,
        # worst f32 error over the batch-32 shapes of serving and training;
        # times summed over the seven band applies of one batch-32 decode
        "max_abs_err": max(r["max_abs_err"] for r in records
                           if "ms" in r and r["dtype"] == "float32"),
        "ms": sum(r["ms"] for r in on_path),
        "plain_ms": sum(r["plain_ms"] for r in on_path),
    }, {
        "name": "band_apply_bwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES_BWD,
        "launches": run_bwd,
        # worst f32 error of the addend variant over the train step's
        # shapes; times summed over the 17 backward applies of one step
        "max_abs_err": max(r["max_abs_err"] for r in bwd_f32),
        "ms": per_step(bwd_f32, "ms"),
        "plain_ms": per_step(bwd_f32, "plain_ms"),
    }]
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
