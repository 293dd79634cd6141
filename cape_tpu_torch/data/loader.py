"""In-memory dataset wrapper and batch streams.

Counterpart of `cape_tpu.data.loader` (copied, numpy only: the JAX
package's data modules import jax through their package). BodyData loads
the packed per-frame arrays, carves a validation split off the train tail,
z-score-normalizes vertices by per-vertex train mean/std, filters the pose
condition down to the 14 clothing joints (keeping the full pose), and casts
float32. BatchStream gives the epoch-permuted index sequence of the JAX
package, as a pure function of (seed, position).
"""

from __future__ import annotations

import os

import numpy as np

from cape_tpu_torch.smpl.joints import filter_cloth_pose


class BodyData:
    def __init__(
        self,
        train_disp: np.ndarray,
        train_pose: np.ndarray,
        train_clo: np.ndarray,
        test_disp: np.ndarray,
        test_pose: np.ndarray,
        test_clo: np.ndarray,
        n_val: int = 100,
    ):
        n_val = min(n_val, max(len(train_disp) - 1, 1))
        self.disp_train = np.asarray(train_disp[:-n_val])
        self.disp_val = np.asarray(train_disp[-n_val:])
        self.disp_test = np.asarray(test_disp)

        pose_train = np.asarray(train_pose).reshape(len(train_pose), -1)
        pose_test = np.asarray(test_pose).reshape(len(test_pose), -1)
        self.pose_train_full = pose_train[:-n_val]
        self.pose_val_full = pose_train[-n_val:]
        self.pose_test_full = pose_test

        # filter to the clothing joints unless already filtered
        if pose_test.shape[-1] % 14 != 0:
            self.pose_train = filter_cloth_pose(self.pose_train_full)
            self.pose_val = filter_cloth_pose(self.pose_val_full)
            self.pose_test = filter_cloth_pose(self.pose_test_full)
        else:
            self.pose_train = self.pose_train_full
            self.pose_val = self.pose_val_full
            self.pose_test = self.pose_test_full

        self.clo_train = np.asarray(train_clo[:-n_val])
        self.clo_val = np.asarray(train_clo[-n_val:])
        self.clo_test = np.asarray(test_clo)

        # normalization stats from the train split (val excluded)
        self.mean = np.mean(self.disp_train, axis=0)
        self.std = np.std(self.disp_train, axis=0)
        self.std = np.where(self.std < 1e-12, 1.0, self.std)

        for name in ("disp_train", "disp_val", "disp_test"):
            arr = (getattr(self, name) - self.mean) / self.std
            setattr(self, name, arr.astype(np.float32))
        for name in (
            "pose_train", "pose_val", "pose_test",
            "clo_train", "clo_val", "clo_test",
        ):
            setattr(self, name, getattr(self, name).astype(np.float32))

    @classmethod
    def from_packed(cls, data_dir: str, pose_type: str = "rot", n_val: int = 100):
        """Load a packed dataset directory (`cape_tpu.data.packer`'s output:
        <data_dir>/{train,test}/{phase}_{disp,<pose_type>,clo_label}.npy)."""

        def load(phase, kind):
            return np.load(os.path.join(data_dir, phase, f"{phase}_{kind}.npy"))

        return cls(
            train_disp=load("train", "disp"),
            train_pose=load("train", pose_type),
            train_clo=load("train", "clo_label"),
            test_disp=load("test", "disp"),
            test_pose=load("test", pose_type),
            test_clo=load("test", "clo_label"),
            n_val=n_val,
        )

    def split(self, name: str):
        """('disp', 'pose', 'clo') arrays for 'train' | 'val' | 'test'."""
        return (
            getattr(self, f"disp_{name}"),
            getattr(self, f"pose_{name}"),
            getattr(self, f"clo_{name}"),
        )


class BatchStream:
    """Epoch-permuted minibatch index stream. Each epoch's permutation is
    numpy default_rng((seed, epoch)).permutation(n), so the sequence is a
    pure function of (seed, position), the JAX package's exactly."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self._pos = 0                    # items consumed so far
        self._cached: tuple[int, np.ndarray | None] = (-1, None)

    def _perm(self, epoch: int) -> np.ndarray:
        if self._cached[0] != epoch:
            perm = np.random.default_rng((self.seed, epoch)).permutation(self.n)
            self._cached = (epoch, perm)
        return self._cached[1]

    def next_indices(self) -> np.ndarray:
        out = np.empty(self.batch_size, dtype=np.int64)
        got = 0
        while got < self.batch_size:
            epoch, off = divmod(self._pos, self.n)
            take = min(self.batch_size - got, self.n - off)
            out[got : got + take] = self._perm(epoch)[off : off + take]
            got += take
            self._pos += take
        return out

    def skip(self, n_batches: int) -> None:
        """Advance past n_batches batches without materializing them (resume
        from a checkpointed step)."""
        self._pos += int(n_batches) * self.batch_size
