"""f32-against-bf16 quality and speed ablation on the synthetic stand-in set.

Counterpart of `cape_tpu.tools.dtype_ablation`, on the port's Trainer and
DemoSuite: identical short trainings of the flagship architecture (the JAX
tool's settings, `ABLATION`) under compute_dtype float32 and bfloat16
(same seed, same data, f32 parameters either way), comparing the end
validation losses and the demo suite's per-vertex Euclidean error
(reference demos.py:47-124, the acceptance metric's form). The real CAPE
dataset is licence-gated, so this bounds the bf16 risk on the synthetic
set.

  python -m cape_tpu_torch.tools.dtype_ablation --epochs 8 [--seed 2] [--device cuda]

Prints one JSON line per dtype (the JAX tool's keys) plus a verdict line.
It runs on the GPU unless --device cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# the JAX tool's configuration: the flagship architecture at batch 16 on
# N_TRAIN synthetic train and N_TEST test rows
ABLATION = dict(nz=64, nz_cond=32, nz_cond2=32, nf=64, use_res_block=False,
                use_res_block_dec=True, affine=True, reduce_dim=64, lambda_edge=1.0,
                batch_size=16, log_every_steps=0)
N_TRAIN, N_TEST = 512, 64


def run_one(dtype: str, epochs: int, seed: int, workdir: str, device) -> dict:
    """Train ABLATION in `dtype` on synthetic data from `seed`, then
    evaluate: the val split's losses and DemoSuite.test_model's per-vertex
    error."""
    from cape_tpu_torch.apps.demos import DemoSuite
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context, require_device
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.config import CAPEConfig
    from cape_tpu_torch.data.synthetic import synthetic_bodydata
    from cape_tpu_torch.models.cape import CAPE
    from cape_tpu_torch.train.loop import Trainer

    cfg = CAPEConfig(name=f"dtype_ablation_{dtype}", num_epochs=epochs, compute_dtype=dtype,
                     seed=seed, **ABLATION)
    require_device(device)
    ctx = build_context(cfg, device=device)
    data = synthetic_bodydata(n_train=N_TRAIN, n_test=N_TEST, num_verts=6890, seed=seed)
    # PRNGKey(cfg.seed): the parameters JAX's Trainer.fit starts from
    model = CAPE(cfg).init_params(prng.PRNGKey(cfg.seed), ctx).to(device)
    trainer = Trainer(cfg, model, ctx, data, workdir=workdir)
    t0 = time.time()
    val_losses, _ = trainer.fit()
    engine = InferenceEngine(model, ctx, cfg.batch_size, device=device)
    suite = DemoSuite(engine, cfg.name, n_sample=0, save_objs=False,
                      smpl_model_folder=os.path.join(workdir, "no_smpl_model"),
                      results_root=workdir, seed=cfg.seed)
    metric = suite.test_model(data)
    val = trainer.evaluate("val", rng=prng.PRNGKey(99))
    return {
        "dtype": dtype,
        "val_recon": round(float(val["recon"]), 5),
        "val_edge": round(float(val["edge"]), 5),
        "euclidean_mean": round(metric["euclidean_mean_m"], 6),
        "euclidean_median": round(metric["euclidean_median_m"], 6),
        "first_val_recon": round(float(val_losses[0]), 5),
        "last_val_recon": round(float(val_losses[-1]), 5),
        "wall_s": round(time.time() - t0, 1),
    }


def verdict(f32: dict, bf16: dict) -> dict:
    """The relative gaps of bf16's euclidean error and val recon from f32's,
    and whether both are under 2%."""
    rel_metric = abs(bf16["euclidean_mean"] - f32["euclidean_mean"]) / max(
        f32["euclidean_mean"], 1e-9)
    rel_recon = abs(bf16["val_recon"] - f32["val_recon"]) / max(f32["val_recon"], 1e-9)
    return {
        "rel_euclidean_gap": round(rel_metric, 4),
        "rel_val_recon_gap": round(rel_recon, 4),
        "bf16_within_2pct": bool(rel_metric < 0.02 and rel_recon < 0.02),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--workdir", default="results/dtype_ablation")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    results = {}
    for dtype in ("float32", "bfloat16"):
        results[dtype] = run_one(dtype, args.epochs, args.seed, args.workdir, args.device)
        print(json.dumps(results[dtype]), flush=True)
    out = verdict(results["float32"], results["bfloat16"])
    print(json.dumps(out), flush=True)
    return {**results, "verdict": out}


if __name__ == "__main__":
    main()
