"""Synthetic CAPE-shaped data for tests, smoke runs and the train mode when
the packed dataset is not on disk.

Counterpart of `cape_tpu.data.synthetic` (the same draws from the same
numpy generator, so the same arrays): per-vertex displacement fields that
are a smooth low-rank function of pose and clothing type, plus noise.
"""

from __future__ import annotations

import numpy as np

from cape_tpu_torch.data.loader import BodyData
from cape_tpu_torch.smpl.rodrigues import pose_to_rotmats


def synthetic_bodydata(
    n_train: int = 256,
    n_test: int = 64,
    num_verts: int = 6890,
    pose_type: str = "rot",
    rank: int = 12,
    noise: float = 0.001,
    seed: int = 0,
    n_val: int = 32,
) -> BodyData:
    rng = np.random.default_rng(seed)
    n = n_train + n_test

    pose_aa = 0.3 * rng.standard_normal((n, 72))
    clo = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=n)]

    # displacements = smooth function of (pose, clotype) + small noise
    basis = rng.standard_normal((rank, num_verts, 3)) * 0.01
    pose_proj = rng.standard_normal((72, rank))
    clo_proj = rng.standard_normal((4, rank))
    coeff = np.tanh(pose_aa @ pose_proj + clo @ clo_proj)           # [n, rank]
    disp = np.einsum("nr,rvc->nvc", coeff, basis)
    disp += noise * rng.standard_normal(disp.shape)

    cond = pose_to_rotmats(pose_aa) if pose_type == "rot" else pose_aa
    return BodyData(
        train_disp=disp[:n_train],
        train_pose=cond[:n_train],
        train_clo=clo[:n_train],
        test_disp=disp[n_train:],
        test_pose=cond[n_train:],
        test_clo=clo[n_train:],
        n_val=n_val,
    )
