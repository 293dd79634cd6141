"""CLI entry point and the model set-up shared by the entry points.

    python -m cape_tpu_torch.apps.main --config configs/<preset>.yaml \\
        --mode train|test|demo --name <run> [--batch_size 32] [--num_epochs N] \\
        [--workdir results] [--device cpu]

Counterpart of `cape_tpu.apps.main`. Every mode prints the architecture
table (`models.summary.describe`) first.
  * train: the graph context, the model (parameters from torch.Generator
    seed 0), the data and the Trainer; fit, then, as the JAX package, the
    DemoSuite: test_model on the test split and run() (demo samples, OBJ
    files under <workdir>/<name>/). The JAX package's production setting
    is `--compute_dtype bfloat16 --batch_size 16` (f32 parameters);
    `--opt_state_dtype bfloat16` keeps the momentum in bf16; `--restart 0`
    resumes from the newest checkpoint of the run (either package's) and
    trains --num_epochs more; `--profile_steps N` writes a trace of N steps
    to <workdir>/<name>/profile/trace.json.
  * test: restore the newest checkpoint of <workdir>/<name> (written by
    either package) and run DemoSuite.test_model.
  * demo: restore it and run DemoSuite.run() (sample_vary_pose and
    sample_vary_clotype). The nz18 release preset, for example:
      python -m cape_tpu_torch.apps.main \\
          --config configs/CAPE-affineconv_nz18_pose24_clotype8_male.yaml \\
          --name <run> --mode demo --batch_size 32
    (at its default batch 16 no conv reaches the CUDA kernel; see ops.cheb).
The data is the packed dataset under data/datasets/<dataset> if it
exists, else a synthetic stand-in, with a loud notice. It runs on the
GPU; without one it raises unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from cape_tpu_torch.apps.demos import DemoSuite
from cape_tpu_torch.apps.inference import InferenceEngine

from cape_tpu_torch.meshops import assets
from cape_tpu_torch.meshops.pyramid import load_or_build as load_or_build_pyramid
from cape_tpu_torch.core.bridge import load_jax_checkpoint
from cape_tpu_torch.core.config import CAPEConfig, parse_cli
from cape_tpu_torch.data.loader import BodyData
from cape_tpu_torch.data.synthetic import synthetic_bodydata
from cape_tpu_torch.models import summary
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
        use_pallas=cfg.use_pallas, build_fused=cfg.fuse_decoder, device=device,
    )


def load_bodydata(cfg: CAPEConfig, datadir_root: str = "data/datasets") -> BodyData:
    data_dir = os.path.join(datadir_root, cfg.dataset)
    if os.path.isdir(data_dir):
        print(f"loading packed dataset from {data_dir}", flush=True)
        return BodyData.from_packed(data_dir, pose_type=cfg.pose_type)
    print(
        f"WARNING: packed dataset {data_dir!r} not found — using a synthetic "
        "stand-in dataset (pack the CAPE release with "
        "`python -m cape_tpu_torch.data.packer` for real training)",
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


def require_device(device) -> None:
    """The entry points run on the GPU unless the caller asks for the CPU:
    a CUDA device with no GPU present raises, before anything is built."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA GPU is available; pass --device cpu "
            "(device='cpu' to run()) to run on the CPU"
        )


@dataclasses.dataclass
class RunResult:
    """What run() did: the Trainer (train mode), the DemoSuite (its engine
    counts the device calls) and test_model's metrics (train and test)."""

    demos: DemoSuite
    trainer: Trainer | None = None
    test: dict | None = None


def run(cfg: CAPEConfig, workdir: str = "results", device="cuda",
        data: BodyData | None = None) -> RunResult:
    """One mode of the CLI (cfg.mode: train, test or demo). `data`
    replaces the dataset that load_bodydata would pick."""
    cfg = resolve_config(cfg)
    if cfg.mode not in ("train", "test", "demo"):
        raise ValueError(f"unknown mode {cfg.mode!r} (use train, test or demo)")
    if cfg.mode != "train":
        ckpt_dir = os.path.join(workdir, cfg.name, "checkpoints")
        if latest_checkpoint(ckpt_dir) is None:  # before anything is built
            raise FileNotFoundError(
                f"--mode {cfg.mode} restores a trained run: no checkpoint under {ckpt_dir}"
            )
    require_device(device)
    model = CAPE(cfg)
    ctx = build_context(cfg, device=device)
    print(summary.describe(model, ctx), flush=True)
    trainer = None
    if cfg.mode == "train":
        model.init_params(torch.Generator().manual_seed(0), ctx).to(device)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{cfg.name}: {n_params} parameters on {device}", flush=True)
        data = load_bodydata(cfg) if data is None else data
        trainer = Trainer(cfg, model, ctx, data, workdir=workdir)
        _, t_step = trainer.fit()
        print(f"training done: {t_step * 1000:.1f} ms/step (host clock, eval included)",
              flush=True)
    else:
        restore_params(cfg, model, ctx, workdir)
    engine = InferenceEngine(model, ctx, cfg.batch_size, device=device)
    demos = DemoSuite(
        engine, cfg.name, cfg.dataset, cfg.gender, cfg.demo_n_sample,
        cfg.save_obj, cfg.smpl_model_folder, workdir, cfg.seed, vis=cfg.vis_demo,
    )
    result = RunResult(demos, trainer)
    if cfg.mode in ("train", "test"):
        result.test = demos.test_model(load_bodydata(cfg) if data is None else data)
    if cfg.mode in ("train", "demo"):
        demos.run()
    return result


def main(argv=None):
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default="results")
    own, rest = ap.parse_known_args(argv)
    cfg = parse_cli(rest)
    if not cfg.name:
        print("error: --name is required", file=sys.stderr)
        sys.exit(2)
    run(cfg, own.workdir, own.device)


if __name__ == "__main__":
    main()
