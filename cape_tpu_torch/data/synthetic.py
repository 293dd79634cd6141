"""Synthetic CAPE-shaped data for tests, smoke runs and the train mode when
the packed dataset is not on disk.

Counterpart of `cape_tpu.data.synthetic` (the same draws from the same
numpy generator, so the same arrays): per-vertex displacement fields that
are a smooth low-rank function of pose and clothing type, plus noise. The
Rodrigues map is numpy here (`cape_tpu.smpl.rodrigues` imports jax).
"""

from __future__ import annotations

import numpy as np

from cape_tpu_torch.data.loader import BodyData


def _rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    """axis-angle [..., 3] -> rotation matrices [..., 3, 3] (exp map), with
    the numpy arithmetic of cape_tpu.smpl.rodrigues."""
    theta = np.sqrt(np.sum(axis_angle**2, axis=-1, keepdims=True) + 1e-16)
    k = axis_angle / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = np.zeros_like(kx)
    K = np.stack(
        [
            np.stack([zeros, -kz, ky], axis=-1),
            np.stack([kz, zeros, -kx], axis=-1),
            np.stack([-ky, kx, zeros], axis=-1),
        ],
        axis=-2,
    )
    theta = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=axis_angle.dtype), K.shape)
    return eye + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def pose_to_rotmats(pose: np.ndarray) -> np.ndarray:
    """[N, J*3] axis-angle pose -> [N, J*9] flat rotation matrices."""
    pose = pose.reshape(pose.shape[0], -1, 3)
    return _rodrigues(pose).reshape(pose.shape[0], -1)


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
