"""Acceptance runner: per-vertex autoencoding error against the thresholds.

Counterpart of `cape_tpu.tools.acceptance`, on the port's engine: the
reference's headline metric (README tables; SURVEY §6), the mean per-vertex
Euclidean error over the 3627 clothing vertices of the test split, in
meters. Targets: <= 6.1 mm male, <= 3.7 mm female.

  python -m cape_tpu_torch.tools.acceptance --config configs/<preset>.yaml \\
      --name <run> [--threshold_mm 6.1] [--workdir results] [--device cuda]

Restores the newest checkpoint of <workdir>/<name> (either package's),
exits 0 when the threshold is met and prints a JSON result line either
way. It needs the packed real dataset (data/datasets/<dataset>, written by
`python -m cape_tpu_torch.data.packer`) and refuses, before building
anything, to judge against synthetic stand-ins (exit 2). It runs on the
GPU unless --device cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_THRESHOLD_MM = {"male": 6.1, "female": 3.7}


def main(argv=None):
    from cape_tpu_torch.apps.demos import DemoSuite
    from cape_tpu_torch.apps.inference import InferenceEngine
    from cape_tpu_torch.apps.main import build_context, require_device, restore_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.data.loader import BodyData
    from cape_tpu_torch.models.cape import CAPE

    p = argparse.ArgumentParser(description="CAPE acceptance metric")
    p.add_argument("--config", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--datadir_root", default="data/datasets")
    p.add_argument("--threshold_mm", type=float, default=None)
    p.add_argument("--workdir", default="results", help="run root holding <name>/checkpoints")
    p.add_argument("--gender", default=None,
                   help="override the config's gender (selects the per-gender default threshold)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_config(args.config, name=args.name, gender=args.gender)
    data_dir = os.path.join(args.datadir_root, cfg.dataset)
    if not os.path.isdir(data_dir):
        print(
            f"error: packed dataset {data_dir!r} not found — the acceptance metric is only "
            "meaningful on the real CAPE data (pack it with `python -m "
            "cape_tpu_torch.data.packer`)",
            file=sys.stderr,
        )
        sys.exit(2)
    threshold_mm = (args.threshold_mm if args.threshold_mm is not None
                    else DEFAULT_THRESHOLD_MM.get(cfg.gender, 6.1))
    require_device(args.device)
    ctx = build_context(cfg, device=args.device)
    model = restore_params(cfg, CAPE(cfg), ctx, workdir=args.workdir)
    engine = InferenceEngine(model, ctx, cfg.batch_size, device=args.device)
    data = BodyData.from_packed(data_dir, pose_type=cfg.pose_type)
    demo = DemoSuite(engine, cfg.name, cfg.dataset, cfg.gender, n_sample=cfg.demo_n_sample,
                     save_objs=False, smpl_model_folder=cfg.smpl_model_folder,
                     results_root=args.workdir)
    res = demo.test_model(data)
    err_mm = res["euclidean_mean_m"] * 1000.0
    passed = err_mm <= threshold_mm
    print(json.dumps({
        "metric": "per_vertex_autoencoding_error_mm",
        "value": round(err_mm, 4),
        "median_mm": round(res["euclidean_median_m"] * 1000.0, 4),
        "std_mm": round(res["euclidean_std_m"] * 1000.0, 4),
        "n_test": res["n_test"],
        "threshold_mm": threshold_mm,
        "passed": passed,
    }))
    sys.exit(0 if passed else 1)


if __name__ == "__main__":
    main()
