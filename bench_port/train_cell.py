"""The runner of `train` cells: the program's Trainer, stepped through
`Trainer.run_steps` in dispatch chunks, each closed by the loss screen as
`Trainer.fit` closes it (no evaluation, no checkpoint).

Set-up (`setup_s`, from the process's start to the window's): the graph
context, the weights made on the device from the seed and loaded into
the program's model, the train split made on the device and held by the
Trainer, the first three steps (one `run_steps` call each, read for the
check), and one whole chunk to warm every shape of the window. The window
then runs whole chunks until `--seconds` have passed; its rate is the rows
of all its steps over the time from its start to the end of its last
chunk, synchronised.

With --trace 1 the window is followed by a profiled stretch of the mix's
`profile_steps` steps, which the per-layer readers and `breakdown` read;
the window's own step time gives step_mfu.train. A cell whose end-to-end
metrics name the device's time a step (`DEVICE_STEP`) profiles that
stretch with --trace 0 too, and reads the metric from it: the union of
the device's kernel and copy intervals over the stretch's steps. The
shapes of the band applies, whose bounds `kernel_roofline.train` pairs
with the stretch's kernel time, are recorded over the set-up's steps
(`program.LaunchRecorder`): every step applies the same operators at the
same shapes, and a step that a later program replays from a CUDA graph
calls no Python entry to record.

The check (`gaps`, limits in the mix's `limits`): the program's loss of each of the first three
steps, its first gradient as the optimizer took it (the momentum trace
after step 0) and its parameters' change over the three steps, against
the reference (`reference.model.train_steps`) run from the same weights,
rows and noise once the window has closed and the program's state is
freed.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import statistics
import time

import numpy as np
import torch

from bench_port import common, flops, program, roofline, tracing, weights
from bench_port.reference import model as ref
from bench_port.reference import prng as ref_prng
from bench_port.reference.mesh import RefMesh, load_raw

ASSETS = os.path.join(common.ROOT, "assets")
CHECK_STEPS = 3
# a leaf counts in delta_gap unless the reference's first gradient of it
# is under this share of the median leaf's
ROUNDOFF_SHARE = 1e-3
# the end-to-end metric read from a profiled stretch after the window:
# the device's busy time a step (the union of its kernels and copies)
DEVICE_STEP = "train_device_ms_per_step"


def batch_rows(n: int, batch: int, seed: int, k: int) -> np.ndarray:
    """The first k batches' row indices [k, batch] of an epoch-permuted
    stream: numpy default_rng((seed, epoch)).permutation(n), consumed in
    order (k * batch <= n)."""
    perm = np.random.default_rng((seed, 0)).permutation(n)
    return perm[: k * batch].reshape(k, batch)


def program_config(cfgfile: dict, mix: dict, seed: int, name: str):
    return program.config(cfgfile["settings"], name=name, seed=seed,
                          batch_size=mix["batch_size"], compute_dtype=mix["compute_dtype"],
                          steps_per_dispatch=mix["steps_per_dispatch"], **cfgfile["overrides"])


def meshes(cfgfile: dict, cfg) -> tuple[dict | None, object]:
    """(the program's mesh, a function giving the reference's raw
    matrices): the published pyramids, or the icosphere a test's
    configuration names (`toy_mesh`)."""
    if cfgfile.get("toy_mesh"):
        mesh = program.toy_mesh(cfgfile["toy_mesh"], cfg)
        return mesh, lambda: mesh["raw"]
    return None, lambda: load_raw(ASSETS)


def setup_program(cfgfile: dict, mix: dict, seed: int, name: str, device, mesh=None):
    """(cfg, trainer, streams) of a cell, its weights and split made from
    `seed`."""
    s = cfgfile["settings"]
    cfg = program_config(cfgfile, mix, seed, name)
    ctx = program.context(cfg, device, mesh)
    perm0, perm_last = program.level_perms(cfg, mesh)
    spec = ref.param_spec(s, list(ctx.level_sizes), list(ctx.level_sizes_d))
    w = weights.port_layout(weights.make(spec, seed, device),
                            torch.as_tensor(perm0, device=device),
                            torch.as_tensor(perm_last, device=device))
    m = program.model(cfg, w)
    del w
    gen = common.generator(mix["kind"])
    data = gen.resident(mix, seed, ctx.level_sizes[0], device, perm0=perm0)
    t = program.trainer(cfg, m, ctx, data, os.path.join(common.WORK_DIR, "runs"))
    return cfg, t, program.streams(cfg, len(data["disp"]))


def first_steps(t, sg, sd) -> dict:
    """The first CHECK_STEPS steps: step 0 in a call of its own, so that
    the optimizer's state after it can be read, and the rest in one
    multi-step `run_steps` call as the window makes them (each step's
    noise from the call's one draw, its rows gathered in turn). Each step's
    losses, the first gradient's norm per leaf as the optimizer holds it
    (the momentum trace after step 0: the clipped gradient) and the norm
    per leaf of the parameters' change over the steps."""
    named = dict(t.model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named.items()}
    metrics = program.run_chunk(t, 1, sg, sd)
    # a leaf the optimizer holds no trace of took no gradient
    bufs = t.state.tx.buffers
    grad = {n: float(bufs[n]["trace"].norm()) if "trace" in bufs.get(n, {}) else 0.0
            for n in named}
    metrics += program.run_chunk(t, CHECK_STEPS - 1, sg, sd)
    losses = [{k: float(m[k]) for k in ("loss_g", "loss_d")} for m in metrics]
    delta = {n: float((p.detach() - p0[n]).norm()) for n, p in named.items()}
    return {"losses": losses, "grad": grad, "delta": delta}


def reference_steps(cfgfile: dict, mix: dict, seed: int, device, raw: dict,
                    dtype=torch.float32, rows_used=None) -> dict:
    """The reference's first CHECK_STEPS steps from the seed's weights,
    rows and noise, in `dtype` (`rows_used`: keep that many rows of each
    batch, for a planted fault)."""
    s = cfgfile["settings"]
    mesh = RefMesh(raw, device)
    spec = ref.param_spec(s, mesh.level_sizes, mesh.level_sizes_d)
    P = weights.make(spec, seed, device)
    p0 = {k: v.clone() for k, v in P.items()}
    B, n = mix["batch_size"], mix["n_train"]
    idx_g, idx_d = batch_rows(n, B, seed, CHECK_STEPS), batch_rows(n, B, seed + 1, CHECK_STEPS)
    gen = common.generator(mix["kind"])
    data = gen.rows(mix, seed, mesh.level_sizes[0], device,
                    np.concatenate([idx_g.ravel(), idx_d.ravel()]))
    eps = torch.as_tensor(ref_prng.step_noise(seed, range(CHECK_STEPS), B, s["nz"]), device=device)
    keep = slice(None) if rows_used is None else slice(0, rows_used)
    batches = []
    for i in range(CHECK_STEPS):
        g = slice(i * B, (i + 1) * B)
        d = slice(CHECK_STEPS * B + i * B, CHECK_STEPS * B + (i + 1) * B)
        batches.append({f"{k}_{who}": data[k][rows][keep] for k in ("disp", "pose", "clo")
                        for who, rows in (("g", g), ("d", d))})
    losses, first = ref.train_steps(s, P, mesh, batches, [e[keep] for e in eps], n // B, dtype)
    return {"losses": losses,
            "grad": {k: float(v.norm()) for k, v in first.items()},
            "delta": {k: float((P[k] - p0[k]).norm()) for k in P}}


def gaps(prog: dict, refr: dict) -> dict:
    """The numbers compared: the largest relative gap of a step's loss;
    by the worst leaf, the gap between the program's norm of the first
    gradient and the reference's over the larger of the reference's norm
    of that leaf and of the median leaf; and the gap between the norms of
    the parameters' whole change over the three steps, over the
    reference's (leaves whose reference gradient is round-off left out).
    The change is taken whole and not by the worst leaf: in the warm-up's
    first steps (lr about 5e-7) most leaves move by a few ulps or none,
    so one leaf's norm reads its rounding (PERF.md)."""
    loss = max(abs(p[k] - r[k]) / abs(r[k])
               for p, r in zip(prog["losses"], refr["losses"]) for k in r)
    gmed = statistics.median(refr["grad"].values())
    grad = max(abs(prog["grad"][k] - v) / max(v, gmed) for k, v in refr["grad"].items())
    counted = [k for k, v in refr["grad"].items() if v >= ROUNDOFF_SHARE * gmed]
    whole = lambda d: math.sqrt(sum(d[k] ** 2 for k in counted))
    delta = abs(whole(prog["delta"]) - whole(refr["delta"])) / whole(refr["delta"])
    return {"loss_gap": loss, "grad_gap": grad, "delta_gap": delta}


def checks_of(g: dict, limits: dict) -> dict:
    """Each number compared beside its limit (the mix's `limits`, set from
    the readings in PERF.md)."""
    return {k: {"value": v, "limit": limits[k]} for k, v in g.items()}


def run(args, t0, bench, wl, cfgfile, mix, device=None):
    """One run of the cell: (result, checks). `device` other than the
    card is for the benchmark's CPU tests."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, chunk = mix["batch_size"], mix["steps_per_dispatch"]
    mesh, raw_of = meshes(cfgfile, program_config(cfgfile, mix, args.seed, wl["name"]))
    # --trace 1: the band applies' shapes over the set-up's steps alone; the
    # window and the profiled stretch run without the wrapper
    recorder = program.LaunchRecorder() if args.trace else contextlib.nullcontext()
    with recorder:
        cfg, t, (sg, sd) = setup_program(cfgfile, mix, args.seed, wl["name"], device, mesh)
        prog = first_steps(t, sg, sd)
        program.run_chunk(t, chunk, sg, sd)    # warms every shape of the window
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0

    steps, w0 = 0, time.perf_counter()
    while time.perf_counter() - w0 < args.seconds:
        program.run_chunk(t, chunk, sg, sd)
        steps += chunk
    sync()
    window_s = time.perf_counter() - w0

    e2e, per = common.cell_metrics(bench, wl["name"])
    result = {"correct": False, "attempted": steps, "failed": 0}
    metrics = {"setup_s": setup_s, "train_samples_per_s": steps * B / window_s}
    breakdown = events = None
    if args.trace or DEVICE_STEP in {s["name"] for s in e2e}:
        events = tracing.profile(lambda: program.run_chunk(t, mix["profile_steps"], sg, sd),
                                 os.path.join(common.WORK_DIR, f"{wl['name']}.json"), sync)
        metrics[DEVICE_STEP] = tracing.busy_us(events) / 1e3 / mix["profile_steps"]
    if args.trace:
        m = {"kind": "train", "step_s": window_s / steps,
             "window_samples_per_s": metrics["train_samples_per_s"]}
        m.update(trace_events=events, profiled_steps=mix["profile_steps"],
                 launch_bounds=tracing.launch_bounds(recorder.records))
        breakdown = tracing.breakdown(events)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del t, sg, sd
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    raw = raw_of()
    refr = reference_steps(cfgfile, mix, args.seed, device, raw)
    g = gaps(prog, refr)
    result["correct"] = all(v <= mix["limits"][k] for k, v in g.items())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type, "count": 1,
           "memory_peak_bytes": memory_peak}
    if cuda:
        dev["power"] = common.power_limit()
    if args.trace:
        counter = flops.Counter(cfgfile["settings"], raw)
        m.update(step_ops=counter.train_step(B),
                 peak_flops=roofline.PEAK_FLOP_PER_S[cfg.compute_dtype])
        result["metrics"] = common.read_per_layer(per, m)
        dev.update(tracing.device_fields(m["trace_events"]))
        result["breakdown"] = breakdown
    else:
        result["metrics"] = {s["name"]: {"value": metrics[s["name"]], "unit": s["unit"]}
                             for s in e2e}
    result["device"] = dev
    return result, checks_of(g, mix["limits"])
