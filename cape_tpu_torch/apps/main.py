"""Model set-up shared by the entry points: graph context, parameters and
config fixes. Counterpart of the serving half of `cape_tpu.apps.main`
(its train / test / demo modes are not ported yet)."""

from __future__ import annotations

import os
import re

import torch

from cape_tpu.meshops import assets
from cape_tpu.meshops.pyramid import load_or_build as load_or_build_pyramid
from cape_tpu_torch.core.bridge import load_jax_checkpoint
from cape_tpu_torch.core.config import CAPEConfig
from cape_tpu_torch.models.cape import CAPE, DTYPES
from cape_tpu_torch.ops.sparse import build_graph_context


def build_context(cfg: CAPEConfig, device="cpu"):
    """GraphContext of the configured pyramid plan, on `device`."""
    return build_graph_context(
        load_or_build_pyramid(cfg.ds_factors), assets.load_pyramid("ds2"),
        mode=cfg.op_mode, dtype=DTYPES[cfg.compute_dtype],
        padded=cfg.padded_layout and cfg.op_mode == "banded",
        use_pallas=cfg.use_pallas, device=device,
    )


def restore_params(cfg: CAPEConfig, model: CAPE, ctx, workdir: str = "results") -> CAPE:
    """Load the newest JAX-written checkpoint of run `cfg.name` into
    `model` (its parameters are laid out first, then overwritten)."""
    ckpt_dir = os.path.join(workdir, cfg.name, "checkpoints")
    names = sorted(
        f for f in (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else [])
        if re.fullmatch(r"ckpt_\d+\.npz", f)
    )
    if not names:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, names[-1])
    model.init_params(torch.Generator().manual_seed(0), ctx)
    model.load_state_dict(load_jax_checkpoint(path), strict=True)
    print(f"restored {path}", flush=True)
    return model


def resolve_config(cfg: CAPEConfig) -> CAPEConfig:
    """pose_type='pose' conditions on 14 joints x 3 axis-angle dims = 42."""
    if cfg.pose_type == "pose" and cfg.cond_dim == 126:
        cfg = cfg.replace(cond_dim=42)
    return cfg
