"""CLI entry point and the model set-up shared by the entry points.

    python -m cape_tpu_torch.apps.main --config configs/<preset>.yaml \\
        --mode train --name <run> [--batch_size 32] [--num_epochs N] [--device cuda]

Counterpart of `cape_tpu.apps.main`. `--mode train` builds the graph
context, the model (parameters from torch.Generator seed 0), the data and
the Trainer, fits, and evaluates the test split. The data is the packed
dataset under data/datasets/<dataset> if it exists, else a synthetic
stand-in, with a loud notice. Not ported: `--mode test|demo` and the
DemoSuite the JAX package runs after training (demo meshes, OBJ files).
"""

from __future__ import annotations

import os
import sys

import torch

from cape_tpu.meshops import assets
from cape_tpu.meshops.pyramid import load_or_build as load_or_build_pyramid
from cape_tpu_torch.core.bridge import load_jax_checkpoint
from cape_tpu_torch.core.config import CAPEConfig, parse_cli
from cape_tpu_torch.data.loader import BodyData
from cape_tpu_torch.data.synthetic import synthetic_bodydata
from cape_tpu_torch.models.cape import CAPE, DTYPES
from cape_tpu_torch.ops.sparse import build_graph_context
from cape_tpu_torch.train.checkpoint import latest_checkpoint
from cape_tpu_torch.train.loop import Trainer


def build_context(cfg: CAPEConfig, device="cpu"):
    """GraphContext of the configured pyramid plan, on `device`."""
    verts, _ = assets.template_mesh()
    loss_mask = assets.loss_mask_binary() if cfg.loss_mask == "binary" else 1.0
    return build_graph_context(
        load_or_build_pyramid(cfg.ds_factors), assets.load_pyramid("ds2"),
        assets.smpl_edges(), verts, loss_mask=loss_mask,
        mode=cfg.op_mode, dtype=DTYPES[cfg.compute_dtype],
        padded=cfg.padded_layout and cfg.op_mode == "banded",
        use_pallas=cfg.use_pallas, device=device,
    )


def load_bodydata(cfg: CAPEConfig, datadir_root: str = "data/datasets") -> BodyData:
    data_dir = os.path.join(datadir_root, cfg.dataset)
    if os.path.isdir(data_dir):
        print(f"loading packed dataset from {data_dir}", flush=True)
        return BodyData.from_packed(data_dir, pose_type=cfg.pose_type)
    print(
        f"WARNING: packed dataset {data_dir!r} not found — using a synthetic "
        "stand-in dataset (pack the CAPE release with cape_tpu.data.packer "
        "for real training)",
        flush=True,
    )
    return synthetic_bodydata(
        n_train=512, n_test=64, num_verts=6890, seed=cfg.seed, pose_type=cfg.pose_type,
    )


def restore_params(cfg: CAPEConfig, model: CAPE, ctx, workdir: str = "results") -> CAPE:
    """Load the newest checkpoint of run `cfg.name` (written by either
    package) into `model` (its parameters are laid out first, then
    overwritten)."""
    ckpt_dir = os.path.join(workdir, cfg.name, "checkpoints")
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    model.init_params(torch.Generator().manual_seed(0), ctx)
    model.load_state_dict(load_jax_checkpoint(path), strict=True)
    print(f"restored {path}", flush=True)
    return model


def resolve_config(cfg: CAPEConfig) -> CAPEConfig:
    """pose_type='pose' conditions on 14 joints x 3 axis-angle dims = 42."""
    if cfg.pose_type == "pose" and cfg.cond_dim == 126:
        cfg = cfg.replace(cond_dim=42)
    return cfg


def run(cfg: CAPEConfig, workdir: str = "results", device="cpu",
        data: BodyData | None = None) -> Trainer:
    """Train, then evaluate the test split; returns the Trainer. `data`
    replaces the dataset that load_bodydata would pick."""
    cfg = resolve_config(cfg)
    if cfg.mode != "train":
        raise NotImplementedError(
            f"--mode {cfg.mode} is not ported to cape_tpu_torch yet: it runs the "
            "JAX package's DemoSuite (test-set meshes, demo samples, OBJ export)"
        )
    model = CAPE(cfg)
    ctx = build_context(cfg, device=device)
    model.init_params(torch.Generator().manual_seed(0), ctx).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params} parameters on {device}", flush=True)
    trainer = Trainer(cfg, model, ctx, load_bodydata(cfg) if data is None else data,
                      workdir=workdir)
    _, t_step = trainer.fit()
    print(f"training done: {t_step * 1000:.1f} ms/step (host clock, eval included)", flush=True)
    test = trainer.evaluate("test")
    print("test " + " ".join(f"{k}={v:.6g}" for k, v in test.items()), flush=True)
    print("not ported: the post-training DemoSuite of the JAX package "
          "(demo samples, OBJ export); skipped", flush=True)
    return trainer


def main(argv=None):
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("--workdir", default="results")
    own, rest = ap.parse_known_args(argv)
    cfg = parse_cli(rest)
    if not cfg.name:
        print("error: --name is required", file=sys.stderr)
        sys.exit(2)
    run(cfg, own.workdir, own.device)


if __name__ == "__main__":
    main()
