"""Drive the PyTorch port of the CAPE serving path once on a CUDA GPU.

    python3 chip_smoke.py       # one GPU; needs the checkout around it

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device: a CUDA GPU must be present (there is no CPU path); TF32 off.
  2. build: compile csrc/band_apply.cu with nvcc.
  3. kernel: the band-apply kernel against its plain PyTorch version at
     every batch-32 and batch-64 shape of the flagship serving path, one
     natural-layout and one ragged-column case, in f32 and bf16.
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
The last two lines are a JSON summary of the kernel and the device line.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESET = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_flagship.npz")
KERNEL_SOURCE = "cape_tpu_torch/csrc/band_apply.cu"
REPLACES = "cape_tpu/ops/pallas/cheb_kernel.py:168"  # _pallas_band_apply_v2

# (padded rows P, channels C) of the seven band applies of one batch-32
# flagship decode (and encode) call; batch 64 adds C=32 at P=6912
ON_PATH = [(896, 512), (896, 256), (1792, 256), (1792, 128), (3456, 128), (3456, 64), (6912, 64)]


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


def kernel_phase(ctx, smi):
    """Kernel against plain at every case; returns the per-case records."""
    from cape_tpu_torch.ops.kernels.cheb_kernel import band_apply, band_apply_plain

    laps = {}
    for op in ctx.lap:
        laps.setdefault(op.blocks.shape[1] * 128, op)
    cases = [(32, P, C, True) for P, C in ON_PATH]
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
            if B == 32 and padded and (P, C) in ON_PATH:
                rec["ms"] = time_ms(lambda: band_apply(x, blocks, op.pad_left, rows_out))
                rec["plain_ms"] = time_ms(lambda: band_apply_plain(x, blocks, op.pad_left, rows_out))
                rec["dense_gflop"] = 2 * S * 128 * P * B * C / 1e9
                log(f"  time [{smi}]: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                    f"dense {rec['dense_gflop']:.2f} GFLOP -> "
                    f"{rec['dense_gflop'] / rec['ms']:.1f} TFLOP/s dense-equivalent, "
                    f"non-zero 128x32 slabs {rec['nonzero_slabs']:.3f}")
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
    on_path = [r for r in records if "ms" in r and r["dtype"] == "float32"]

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

    summary = {
        "name": "band_apply",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        # worst f32 error over the on-path shapes; times summed over the
        # seven band applies of one batch-32 decode call
        "max_abs_err": max(r["max_abs_err"] for r in on_path),
        "ms": sum(r["ms"] for r in on_path),
        "plain_ms": sum(r["plain_ms"] for r in on_path),
    }
    log(json.dumps({"kernels": [summary]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
