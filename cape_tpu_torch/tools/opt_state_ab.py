"""f32 against bf16 optimizer state on the flagship train step, in one process.

Counterpart of `cape_tpu.tools.opt_state_ab`, on the port's train step:
cfg.opt_state_dtype = "bfloat16" stores the momentum (SGD's trace) in bf16,
halving that buffer's bytes (train/optim.py); this prices it. Both arms run
the JAX tool's flagship configuration (dtype_ablation.ABLATION) in bf16
compute from the same parameters on the same batches, each with its own
train state. Their steps are timed in ABBA blocks (f32, bf16, bf16, f32),
so that drift between blocks cancels to first order: a block is
`dispatches` runs of STEPS_PER_DISPATCH steps, each run timed on the host
clock up to a device synchronise, and the block's median over them; an
arm's time is the median of its blocks. Beside each arm's time: its
optimizer state's bytes and the device memory its warm-up steps added at
their peak (torch.cuda.max_memory_allocated after reset_peak_memory_stats,
less what was allocated before), "not measured" (None) on the CPU.

  python -m cape_tpu_torch.tools.opt_state_ab [--dispatches 6] [--save out.json] [--device cuda]

It runs on the GPU unless --device cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# steps between two host synchronisations: the JAX tool's scanned dispatch
STEPS_PER_DISPATCH = 32
STEPS_PER_EPOCH = 1940  # the male set's epoch at batch 16, as the JAX tool's schedule


def main(argv=None) -> dict:
    import torch

    from cape_tpu_torch.apps.main import build_context, require_device
    from cape_tpu_torch.core.config import CAPEConfig
    from cape_tpu_torch.data.loader import BatchStream
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.tools.dtype_ablation import ABLATION
    from cape_tpu_torch.train.loop import noise
    from cape_tpu_torch.train.optim import Optimizer
    from cape_tpu_torch.train.step import TrainState, train_step

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dispatches", type=int, default=6)
    p.add_argument("--save", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    require_device(args.device)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    cfg = CAPEConfig(name="flagship", compute_dtype="bfloat16", **ABLATION)
    ctx = build_context(cfg, device=device)
    data = synthetic_bodydata(n_train=max(256, cfg.batch_size * 4), n_test=8, num_verts=6890,
                              seed=0)
    disp = data.disp_train if ctx.perm0 is None else data.disp_train[:, ctx.perm0]
    train = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for k, a in (("disp", disp), ("pose", data.pose_train), ("clo", data.clo_train))}
    n = len(disp)
    streams = BatchStream(n, cfg.batch_size, 0), BatchStream(n, cfg.batch_size, 1)

    def step(arm):
        ig, idd = (torch.from_numpy(s.next_indices()).to(device) for s in streams)
        batch = {f"{k}_{s}": v.index_select(0, i) for k, v in train.items()
                 for s, i in (("g", ig), ("d", idd))}
        arm["step"] += 1
        train_step(arm["state"], ctx, batch,
                   noise((cfg.batch_size, cfg.nz), device, 0, arm["step"]))

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    arms = {}
    for name, dt in (("f32_state", "float32"), ("bf16_state", "bfloat16")):
        c = cfg.replace(opt_state_dtype=dt)
        model = CAPE(c).init_params(torch.Generator().manual_seed(0), ctx)
        arm = {"state": TrainState(model.to(device), Optimizer(c, STEPS_PER_EPOCH)), "step": 0,
               "blocks_ms": []}
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        for _ in range(2):  # warm-up: the first step makes the moment buffers
            step(arm)
        sync()
        arm["warmup_s"] = time.perf_counter() - t0
        arm["step_peak_mb"] = (
            (torch.cuda.max_memory_allocated(device) - base) / 2**20 if cuda else None)
        buffers = [t for bufs in arm["state"].tx.buffers.values() for t in bufs.values()]
        # Adam's nu stays f32 by design: the moment slot carries the dtype
        moments = {t.dtype for bufs in arm["state"].tx.buffers.values()
                   for slot, t in bufs.items() if slot != "nu"}
        if moments != {getattr(torch, dt)}:
            raise AssertionError(f"{name}: optimizer moment dtypes {moments}, expected {dt}")
        arm["state_mb"] = sum(t.numel() * t.element_size() for t in buffers) / 2**20
        arms[name] = arm

    for name in ("f32_state", "bf16_state", "bf16_state", "f32_state"):
        arm = arms[name]
        per_dispatch = []
        for _ in range(args.dispatches):
            sync()
            t0 = time.perf_counter()
            for _ in range(STEPS_PER_DISPATCH):
                step(arm)
            sync()
            per_dispatch.append(1e3 * (time.perf_counter() - t0))
        med = float(np.median(per_dispatch))
        arm["blocks_ms"].append(med)
        print(f"{name}: block median {med:.3f} ms/dispatch "
              f"({med / STEPS_PER_DISPATCH:.3f} ms/step)", flush=True)

    results = {"device": torch.cuda.get_device_name(device) if cuda else "cpu",
               "batch_size": cfg.batch_size, "compute_dtype": cfg.compute_dtype}
    for name, arm in arms.items():
        results[name] = {"ms_per_step": float(np.median(arm["blocks_ms"])) / STEPS_PER_DISPATCH,
                         "block_medians_ms": arm["blocks_ms"], "state_mb": arm["state_mb"],
                         "step_peak_mb": arm["step_peak_mb"], "warmup_s": arm["warmup_s"]}
    results["bf16_vs_f32"] = (results["bf16_state"]["ms_per_step"]
                              / results["f32_state"]["ms_per_step"])
    print(json.dumps(results), flush=True)
    if args.save:
        with open(args.save, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
