"""SMPL joint metadata and clothing-relevant pose filtering.

A copy of `cape_tpu.smpl.joints` (numpy only). The 14 clothing-related
joints select 42 of 72 axis-angle dims (or 126 of 216 rot-matrix dims) as
the pose condition.
"""

from __future__ import annotations

import numpy as np

SMPL_JOINT_NAMES = {
    0: "Pelvis",
    1: "L_Hip", 4: "L_Knee", 7: "L_Ankle", 10: "L_Foot",
    2: "R_Hip", 5: "R_Knee", 8: "R_Ankle", 11: "R_Foot",
    3: "Spine1", 6: "Spine2", 9: "Spine3", 12: "Neck", 15: "Head",
    13: "L_Collar", 16: "L_Shoulder", 18: "L_Elbow", 20: "L_Wrist", 22: "L_Hand",
    14: "R_Collar", 17: "R_Shoulder", 19: "R_Elbow", 21: "R_Wrist", 23: "R_Hand",
}

NUM_SMPL_JOINTS = 24

# joints whose rotation affects clothing
CLOTH_JOINT_IDX = [1, 2, 3, 4, 5, 6, 9, 12, 13, 14, 16, 17, 18, 19]


def filter_cloth_pose(pose_vec: np.ndarray) -> np.ndarray:
    """[N, 72] axis-angle or [N, 216] rot-matrix pose -> the 14
    clothing-joint slice ([N, 42] / [N, 126])."""
    pose_vec = np.asarray(pose_vec)
    n, dim = pose_vec.shape[0], pose_vec.shape[-1]
    if dim == 72:
        per_joint = 3
    elif dim == 216:
        per_joint = 9
    else:
        raise ValueError(f"expected 72- or 216-dim pose, got {dim}")
    return pose_vec.reshape(n, -1, per_joint)[:, CLOTH_JOINT_IDX, :].reshape(n, -1)
