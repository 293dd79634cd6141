"""Fit a Gaussian-mixture prior over a trained model's train-set latents.

    python -m cape_tpu_torch.tools.fit_latent_gmm --config configs/<preset>.yaml \
        --name <run> [--out latent_gmm.npz] [--device cpu]

Counterpart of `cape_tpu.tools.fit_latent_gmm`: encode the train split,
fit the first-party EM (`models.gmm.fit_gmm`, 10 full-covariance
components by default, as the shipped prior) and write an npz that
`GMM.from_npz` reads, in either package. It runs on the GPU; without one
it raises unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.apps.main import build_context, load_bodydata, require_device, restore_params
from cape_tpu_torch.core.config import load_config
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.models.gmm import fit_gmm


def main(argv=None):
    p = argparse.ArgumentParser(description="fit latent GMM prior")
    p.add_argument("--config", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--n_components", type=int, default=10)
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--out", default="latent_gmm.npz")
    p.add_argument("--workdir", default="results")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    require_device(args.device)
    cfg = load_config(args.config, name=args.name)
    model = CAPE(cfg)
    ctx = build_context(cfg)
    restore_params(cfg, model, ctx, args.workdir)
    data = load_bodydata(cfg)  # natural order; the engine permutes internally
    engine = InferenceEngine(model, ctx, cfg.batch_size, device=args.device)
    z_mean, _, _, _ = engine.encode(data.disp_train, data.pose_train, data.clo_train)
    gmm = fit_gmm(z_mean, n_components=args.n_components, n_iter=args.n_iter, seed=cfg.seed)
    np.savez(args.out, weights=gmm.weights, means=gmm.means, covariances=gmm.covariances)
    print(f"wrote {args.out}: {args.n_components} components over {z_mean.shape[1]}-d latents")


if __name__ == "__main__":
    main()
