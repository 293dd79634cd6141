"""Closed-form Rodrigues conversions, batched, in numpy and torch.

Counterpart of `cape_tpu.smpl.rodrigues`: the exponential map (axis-angle
to rotation matrix) and the log map back, with the JAX package's
arithmetic. The numpy functions serve the data and the demo suite's OBJ
export; `rodrigues` on a tensor serves `smpl.lbs`.
"""

from __future__ import annotations

import numpy as np
import torch


def _skew(k, stack, zeros_like):
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = zeros_like(kx)
    return stack([stack([zeros, -kz, ky], -1), stack([kz, zeros, -kx], -1),
                  stack([-ky, kx, zeros], -1)], -2)


def _rodrigues_np(axis_angle: np.ndarray) -> np.ndarray:
    """axis-angle [..., 3] -> rotation matrices [..., 3, 3] (exp map)."""
    theta = np.sqrt(np.sum(axis_angle**2, axis=-1, keepdims=True) + 1e-16)
    K = _skew(axis_angle / theta, np.stack, np.zeros_like)
    theta = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=axis_angle.dtype), K.shape)
    return eye + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _rodrigues_torch(axis_angle: torch.Tensor) -> torch.Tensor:
    theta = torch.sqrt((axis_angle**2).sum(-1, keepdim=True) + 1e-16)
    K = _skew(axis_angle / theta, torch.stack, torch.zeros_like)
    theta = theta[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device).expand(K.shape)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def _inverse_rodrigues_np(R: np.ndarray) -> np.ndarray:
    """rotation matrices [..., 3, 3] -> axis-angle [..., 3] (log map)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0))
    # the skew part gives axis * 2 sin(theta)
    v = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    sin_theta = np.sin(theta)
    small = np.abs(sin_theta) < 1e-6
    scale = np.where(small, 0.5, theta / np.where(small, 1.0, 2.0 * sin_theta))
    aa_generic = v * scale[..., None]
    # theta ~ pi: the axis from the diagonal of (R + I) / 2
    near_pi = theta > np.pi - 1e-3
    diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis = np.sqrt(np.clip((diag + 1.0) / 2.0, 0.0, 1.0))
    # signs from the off-diagonals (largest component positive)
    sx = np.where(v[..., 0] < 0, -1.0, 1.0)
    sy = np.where(R[..., 0, 1] + R[..., 1, 0] < 0, -sx, sx)
    sz = np.where(R[..., 0, 2] + R[..., 2, 0] < 0, -sx, sx)
    axis = axis * np.stack([np.ones_like(sx), sy * sx, sz * sx], axis=-1) * sx[..., None]
    return np.where(near_pi[..., None], axis * theta[..., None], aa_generic)


def pose_to_rotmats(pose: np.ndarray) -> np.ndarray:
    """[N, J*3] axis-angle pose -> [N, J*9] flat rotation matrices."""
    pose = np.asarray(pose)
    n = pose.shape[0]
    return _rodrigues_np(pose.reshape(n, -1, 3)).reshape(n, -1)


def rotmats_to_pose(rot: np.ndarray) -> np.ndarray:
    """[N, J*9] flat rotation matrices -> [N, J*3] axis-angle."""
    rot = np.asarray(rot)
    n = rot.shape[0]
    return _inverse_rodrigues_np(rot.reshape(n, -1, 3, 3)).reshape(n, -1)


def rodrigues(axis_angle):
    """[..., 3] axis-angle -> [..., 3, 3] rotation matrices: a tensor for a
    tensor (on its device), numpy for numpy."""
    if isinstance(axis_angle, torch.Tensor):
        return _rodrigues_torch(axis_angle)
    return _rodrigues_np(np.asarray(axis_angle))
