"""Full-schedule endurance run: the reference's complete training recipe at
the reference dataset's scale, end to end, on the GPU.

Counterpart of `cape_tpu.tools.endurance`. The real CAPE dataset is
license-gated, so this drives the production Trainer with a synthetic
dataset of the real size and shapes (male split: 31,036 train frames)
through the whole schedule (60 epochs by default: 116k train steps at
batch 16, per-epoch validation, checkpoint rotation, lr decay) on the
flagship (`tools.flagship`) in `--dtype` (bf16 by default, the JAX
package's production setting), and reports sustained wall-clock throughput
with every overhead included. The real packed dataset slots into the same
path (`apps.main --mode train`) with no code change.

  python -m cape_tpu_torch.tools.endurance              # the full schedule
  python -m cape_tpu_torch.tools.endurance --epochs 2   # a quick smoke
  python -m cape_tpu_torch.tools.endurance --device cpu --epochs 1 --n-train 64 --batch 8

The run goes to <--workdir>/endurance_torch (checkpoints, metrics.jsonl,
TensorBoard events), wiped at the start. It runs on the GPU; without one
it raises unless `--device cpu` asks for the CPU. Prints one JSON line at
the end with the sustained numbers (the JAX tool's keys, and `device`);
`--expect-final` turns the run into a gate on `final_val_recon` (6
decimals). The parameters (PRNGKey(cfg.seed)), the batches and each step's
noise are the JAX endurance run's, so JAX's own final_val_recon is the
value to hold a run to; two implementations' float sums part it by some
ulps, so take the gate's value from a port run of the same build.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m cape_tpu_torch.tools.endurance")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--n-train", type=int, default=31036, help="male-split size")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--workdir", default="results")
    p.add_argument("--device", default="cuda")
    p.add_argument(
        "--expect-final", type=float, default=None,
        help="final_val_recon to assert (6 decimals), a no-regression gate for "
        "reruns of one schedule on one build",
    )
    args = p.parse_args(argv)

    from cape_tpu_torch.apps.main import require_device

    require_device(args.device)

    import torch

    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.tools.flagship import flagship_setup
    from cape_tpu_torch.train.loop import Trainer

    # init_seed None: PRNGKey(cfg.seed), as the JAX package's Trainer.fit draws it
    cfg, model, ctx = flagship_setup(
        args.dtype, args.device, init_seed=None, name="endurance_torch", num_epochs=args.epochs,
        batch_size=args.batch, restart=True,
        log_every_steps=0,          # per-epoch logging only
    )
    print(f"# generating synthetic dataset at reference scale "
          f"({args.n_train} train frames)...", flush=True)
    data = synthetic_bodydata(
        n_train=args.n_train, n_test=64, num_verts=ctx.level_sizes[0], seed=0, n_val=100
    )
    trainer = Trainer(cfg, model, ctx, data, workdir=args.workdir)
    n_steps = trainer.num_steps
    print(f"# {args.epochs} epochs x {trainer.steps_per_epoch} steps/epoch "
          f"= {n_steps} steps, batch {args.batch}, {args.dtype}, {args.device}", flush=True)
    t0 = time.time()
    val_losses, t_step = trainer.fit()
    wall = time.time() - t0

    ckpts = sorted(os.listdir(trainer.ckpt_dir)) if os.path.isdir(trainer.ckpt_dir) else []
    device = torch.device(args.device)
    out = {
        "steps": n_steps,
        "epochs": args.epochs,
        "wall_s": wall,
        "sustained_steps_per_sec": n_steps / wall,
        "sec_per_step_incl_overheads": t_step,
        "final_val_recon": round(float(val_losses[-1]), 6),
        "val_recon_first": round(float(val_losses[0]), 6),
        "checkpoints_kept": len(ckpts),
        "batch": args.batch,
        "dtype": args.dtype,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }
    if not np.isfinite(out["final_val_recon"]):
        raise AssertionError(f"non-finite final_val_recon: {out}")
    if args.expect_final is not None:
        got, want = out["final_val_recon"], round(args.expect_final, 6)
        if got != want:
            raise AssertionError(
                f"final_val_recon {got} != expected {want}: the training math "
                "changed; investigate before trusting this build"
            )
        out["matches_pinned_final"] = want
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
