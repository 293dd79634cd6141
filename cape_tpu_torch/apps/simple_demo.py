"""Standalone generation demo: 4 clothing types x 3 z-samples as .obj meshes.

    python -m cape_tpu_torch.apps.simple_demo --config configs/<preset>.yaml \
        [--name <run>] [--params params.npz] [--random] [--device cpu]

Counterpart of `cape_tpu.apps.simple_demo`. The parameters come from the
newest checkpoint of --name, from a bare parameter npz (--params, keys as
the JAX package's flatten_tree writes them), or from PRNGKey(cfg.seed)
(--random, a smoke test): the JAX demo's draws, from JAX's keys (its
--params template is PRNGKey(0)). It runs on the GPU; without one it
raises unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys

from cape_tpu_torch.apps.demos import SimpleDemo
from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.apps.main import build_context, require_device, restore_params
from cape_tpu_torch.core import prng
from cape_tpu_torch.core.bridge import load_jax_checkpoint
from cape_tpu_torch.core.config import load_config
from cape_tpu_torch.models.cape import CAPE


def main(argv=None):
    p = argparse.ArgumentParser(description="simple CAPE generation demo")
    p.add_argument("--config", default="configs/CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
    p.add_argument("--name", default=None, help="run name with checkpoints")
    p.add_argument("--params", default=None, help="params .npz (e.g. converted TF ckpt)")
    p.add_argument("--results_dir", default="results/demo_results")
    p.add_argument("--random", action="store_true",
                   help="use randomly initialized params (smoke test only)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    require_device(args.device)
    cfg = load_config(args.config, name=args.name)
    model = CAPE(cfg)
    ctx = build_context(cfg)
    if args.params:
        model.init_params(prng.PRNGKey(0), ctx)
        shapes = {k: v.shape for k, v in model.state_dict().items()}
        # a converted checkpoint may hold e.g. (1, 1, F) biases for (F,)
        sd = {k: v.reshape(shapes[k]) if k in shapes and v.numel() == shapes[k].numel() else v
              for k, v in load_jax_checkpoint(args.params).items()}
        model.load_state_dict(sd, strict=True)
        print(f"loaded params from {args.params}", flush=True)
    elif args.random:
        model.init_params(prng.PRNGKey(cfg.seed), ctx)
        print("using randomly initialized params (smoke test)", flush=True)
    else:
        if not cfg.name:
            print("error: provide --name, --params, or --random", file=sys.stderr)
            sys.exit(2)
        restore_params(cfg, model, ctx)

    engine = InferenceEngine(model, ctx, cfg.batch_size, device=args.device)
    out = SimpleDemo(engine, results_dir=args.results_dir, seed=cfg.seed).run()
    print(f"generated {out.shape[0] * out.shape[1]} meshes -> {args.results_dir}", flush=True)


if __name__ == "__main__":
    main()
