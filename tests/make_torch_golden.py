"""Write tests/data/torch_golden_flagship.npz: the JAX package's flagship
decode at full width, for parameters made by the PyTorch port.

    JAX_PLATFORMS=cpu python tests/make_torch_golden.py

The port draws the flagship preset's parameters from torch.Generator seed
0 on the CPU; they go to JAX through the bridge. JAX then decodes 32 latent
rows (z, pose, clothing type drawn from numpy default_rng(0)) at batch 32,
f32, on its plain banded route (use_pallas=False, which tests/test_ops.py
holds equal to the Pallas v3 route). The file keeps the inputs, the first
8 output meshes in natural vertex order, and a fingerprint of the
parameters (per-leaf sums), so that a reader can tell a parameter mismatch
from a compute mismatch. `chip_smoke.py` holds the port on the GPU to it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = os.path.join(ROOT, "configs", "CAPE-affineconv_nz64_pose32_clotype32_male.yaml")
OUT = os.path.join(ROOT, "tests", "data", "torch_golden_flagship.npz")
B, KEEP = 32, 8


def fingerprint(state_dict) -> tuple[list[str], np.ndarray]:
    """(sorted keys, float64 sum of each leaf) of a port state dict."""
    keys = sorted(state_dict)
    return keys, np.array([state_dict[k].double().sum().item() for k in keys])


def golden_inputs(cfg):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, cfg.nz)).astype(np.float32)
    pose = (0.5 * rng.standard_normal((B, cfg.cond_dim))).astype(np.float32)
    clo = np.eye(cfg.cond2_dim, dtype=np.float32)[rng.integers(0, cfg.cond2_dim, B)]
    return z, pose, clo


def main():
    sys.path.insert(0, ROOT)
    import jax
    import torch

    from cape_tpu.apps.inference import InferenceEngine as JaxEngine
    from cape_tpu.apps.main import build_context as jax_build_context
    from cape_tpu.core.config import load_config as jax_load_config
    from cape_tpu.models.cape import CAPE as JaxCAPE
    from cape_tpu_torch.apps.main import build_context
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import load_config
    from cape_tpu_torch.models.cape import CAPE

    cfg = load_config(PRESET)
    model = CAPE(cfg).init_params(torch.Generator().manual_seed(0), build_context(cfg))
    keys, sums = fingerprint(model.state_dict())
    params = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_params(model))

    jcfg = jax_load_config(PRESET, use_pallas=False)
    engine = JaxEngine(JaxCAPE(jcfg), jax_build_context(jcfg), params, batch_size=B)
    z, pose, clo = golden_inputs(cfg)
    y, y2 = engine.encode_only_condition(pose, clo)
    disp = engine.decode(np.concatenate([z, y, y2], -1), y, y2)
    assert disp.shape == (B, 6890, 3) and np.isfinite(disp).all()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, z=z, pose=pose, clo=clo, disp=disp[:KEEP].astype(np.float32),
        param_keys=np.array(keys), param_sums=sums,
    )
    print(f"wrote {OUT}: disp[:{KEEP}] max|ref| {np.abs(disp[:KEEP]).max():.6g}")


if __name__ == "__main__":
    main()
