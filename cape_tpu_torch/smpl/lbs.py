"""SMPL linear blend skinning in torch.

Counterpart of `cape_tpu.smpl.lbs`: shape blendshapes, pose blendshapes,
joint regression, the kinematic chain and skinning, in float32 on the
model's device. The official SMPL .pkl files load without chumpy through
a tolerant unpickler; they are license-gated and not shipped, so
`SMPLModel.synthetic` builds a rig over any mesh (the JAX package's, draw
for draw) for tests and demos.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from cape_tpu_torch.smpl.rodrigues import rodrigues

NUM_JOINTS = 24


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickle SMPL .pkl files without chumpy or scipy-version landmines."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChStub
        if module == "scipy.sparse.csc" and name == "csc_matrix":
            import scipy.sparse

            return scipy.sparse.csc_matrix
        return super().find_class(module, name)


class _ChStub:
    """Minimal stand-in for chumpy.Ch: keeps the wrapped ndarray."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.__dict__.get("x"))
        return arr.astype(dtype) if dtype is not None else arr


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


@dataclasses.dataclass
class SMPLModel:
    """SMPL constants as float32 tensors."""

    v_template: torch.Tensor      # [V, 3]
    shapedirs: torch.Tensor       # [V, 3, n_betas]
    posedirs: torch.Tensor        # [(J-1)*9, V*3] pose-blendshape basis
    J_regressor: torch.Tensor     # [J, V]
    weights: torch.Tensor         # [V, J] skinning weights
    parents: tuple
    faces: np.ndarray | None = None

    def to(self, device) -> "SMPLModel":
        move = lambda t: t.to(device)
        return dataclasses.replace(
            self, v_template=move(self.v_template), shapedirs=move(self.shapedirs),
            posedirs=move(self.posedirs), J_regressor=move(self.J_regressor),
            weights=move(self.weights),
        )

    @classmethod
    def load(cls, model_path: str, gender: str = "male") -> "SMPLModel":
        """Load an official SMPL .pkl (the usual smplx layout
        <model_path>/smpl/SMPL_<GENDER>.pkl, or a direct file path)."""
        candidates = [
            model_path,
            os.path.join(model_path, "smpl", f"SMPL_{gender.upper()}.pkl"),
            os.path.join(model_path, f"SMPL_{gender.upper()}.pkl"),
            os.path.join(model_path, "smpl", f"basicmodel_{gender[0]}_lbs_10_207_0_v1.0.0.pkl"),
        ]
        path = next((c for c in candidates if os.path.isfile(c)), None)
        if path is None:
            raise FileNotFoundError(
                f"No SMPL model found under {model_path!r} for gender={gender!r}"
            )
        with open(path, "rb") as f:
            data = _TolerantUnpickler(f, encoding="latin1").load()
        shapedirs = _to_np(data["shapedirs"])
        posedirs = _to_np(data["posedirs"])
        V = shapedirs.shape[0]
        return cls(
            v_template=_f32(_to_np(data["v_template"])),
            shapedirs=_f32(shapedirs),
            posedirs=_f32(posedirs.reshape(V * 3, -1).T),
            J_regressor=_f32(_to_np(data["J_regressor"])),
            weights=_f32(_to_np(data["weights"])),
            parents=tuple(int(p) for p in _to_np(data["kintree_table"])[0]),
            faces=_to_np(data["f"]).astype(np.int32),
        )

    @classmethod
    def synthetic(cls, verts: np.ndarray, faces: np.ndarray, seed: int = 0) -> "SMPLModel":
        """A plausible rig over an arbitrary mesh: joints from vertex
        clusters, smooth distance-based skinning weights (the JAX
        package's rig for the same seed)."""
        rng = np.random.default_rng(seed)
        verts = np.asarray(verts, dtype=np.float64)
        V = len(verts)
        centers = verts[rng.choice(V, NUM_JOINTS, replace=False)]
        # joint regressor: soft assignment of vertices to nearest centers
        d = np.linalg.norm(verts[None] - centers[:, None], axis=-1)  # [J, V]
        Jreg = np.exp(-(d**2) / (2 * 0.05**2)) + 1e-8
        Jreg /= Jreg.sum(axis=1, keepdims=True)
        # skinning weights: softmax over inverse distances
        w = np.exp(-(d.T**2) / (2 * 0.1**2)) + 1e-8                  # [V, J]
        w /= w.sum(axis=1, keepdims=True)
        parents = tuple([0] + [max(0, (i - 1) // 2) for i in range(1, NUM_JOINTS)])
        return cls(
            v_template=_f32(verts),
            shapedirs=_f32(0.01 * rng.standard_normal((V, 3, 10))),
            posedirs=_f32(0.001 * rng.standard_normal(((NUM_JOINTS - 1) * 9, V * 3))),
            J_regressor=_f32(Jreg),
            weights=_f32(w),
            parents=parents,
            faces=np.asarray(faces, np.int32),
        )


def lbs(model: SMPLModel, pose, betas=None, v_template=None) -> torch.Tensor:
    """SMPL forward: pose [B, 72] axis-angle (joint 0 = global orient),
    optional betas [B, n_betas], optional per-sample template override
    [B, V, 3]. Arrays may be numpy or tensors; the result is a float32
    tensor [B, V, 3] on the model's device."""
    dev = model.v_template.device
    as_t = lambda a: torch.as_tensor(a).to(device=dev, dtype=torch.float32)
    pose = as_t(pose)
    B = pose.shape[0]
    vt = model.v_template[None] if v_template is None else as_t(v_template)
    vt = vt.expand((B,) + tuple(model.v_template.shape))

    if betas is not None:
        vt = vt + torch.einsum("vck,bk->bvc", model.shapedirs, as_t(betas))

    joints = torch.einsum("jv,bvc->bjc", model.J_regressor, vt)       # [B, J, 3]
    R = rodrigues(pose.reshape(B, NUM_JOINTS, 3))                     # [B, J, 3, 3]

    # pose blendshapes from the non-root joint rotations
    eye = torch.eye(3, dtype=R.dtype, device=dev)
    pose_feat = (R[:, 1:] - eye).reshape(B, -1)                       # [B, (J-1)*9]
    v_posed = vt + (pose_feat @ model.posedirs).reshape(B, -1, 3)

    # kinematic chain: world transforms per joint
    parents = model.parents
    rel = joints.clone()
    rel[:, 1:] -= joints[:, [parents[j] for j in range(1, NUM_JOINTS)]]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=dev).expand(B, 1, 4)

    def make_tf(rot, trans):
        return torch.cat([torch.cat([rot, trans[..., None]], -1), bottom], -2)  # [B, 4, 4]

    transforms = [make_tf(R[:, 0], rel[:, 0])]
    for j in range(1, NUM_JOINTS):
        transforms.append(transforms[parents[j]] @ make_tf(R[:, j], rel[:, j]))
    A = torch.stack(transforms, 1)                                    # [B, J, 4, 4]

    # remove the rest-pose joint locations from the transforms
    joints_h = torch.cat([joints, joints.new_zeros(B, NUM_JOINTS, 1)], -1)
    correction = torch.einsum("bjik,bjk->bji", A, joints_h)
    A = A.clone()
    A[:, :, :3, 3] -= correction[:, :, :3]

    # skinning
    T = torch.einsum("vj,bjik->bvik", model.weights, A)               # [B, V, 4, 4]
    v_h = torch.cat([v_posed, v_posed.new_ones(B, v_posed.shape[1], 1)], -1)
    return torch.einsum("bvik,bvk->bvi", T, v_h)[..., :3]
