"""Loaders for the shipped binary data fixtures in assets/.

Centralizes every `np.load`-by-path in the reference (SURVEY L0):
template mesh, SMPL edge table, clothing-vertex mask, loss mask, demo
poses, train-set stats, and the precomputed transform-matrix pyramids.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np

from cape_tpu_torch.meshops.obj_io import load_obj
from cape_tpu_torch.meshops.pyramid import MeshPyramid, pyramid_from_matrices

ASSET_DIR = os.environ.get(
    "CAPE_TPU_ASSETS",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets"),
)


def asset_path(*parts: str) -> str:
    return os.path.join(ASSET_DIR, *parts)


@functools.lru_cache(maxsize=None)
def template_mesh() -> tuple[np.ndarray, np.ndarray]:
    """SMPL template: (verts [6890,3], faces [13776,3])."""
    return load_obj(asset_path("template_mesh.obj"))


@functools.lru_cache(maxsize=None)
def smpl_edges() -> np.ndarray:
    """[20664, 2] int32 vertex-pairs-per-edge table (reference: data/edges_smpl.npy)."""
    return np.load(asset_path("edges_smpl.npy"))


@functools.lru_cache(maxsize=None)
def clothing_verts_idx() -> np.ndarray:
    """Indices of the 3627 clothing-related vertices."""
    return np.load(asset_path("clothing_verts_idx.npy"))


@functools.lru_cache(maxsize=None)
def loss_mask_binary() -> np.ndarray:
    """[6890] per-vertex loss weighting mask (reference: lib/models.py:47-52)."""
    return np.load(asset_path("loss_mask_binary.npy"))


def demo_pose_params() -> dict[str, np.ndarray]:
    """6 demo poses: {'pose': [6,72] axis-angle, 'rot': [6,216] rot matrices}."""
    d = np.load(asset_path("demo_data", "demo_pose_params.npz"))
    return {k: d[k] for k in d}


def trainset_stats() -> tuple[np.ndarray, np.ndarray]:
    """(mean [6890,3], std [6890,3]) of the male train displacements."""
    d = np.load(asset_path("demo_data", "trainset_stats.npz"))
    return d["mean"], d["std"]


def _load_sparse_list(path: str) -> list:
    return list(np.load(path, allow_pickle=True, encoding="latin1"))


def load_pyramid(which: str = "for_demo") -> MeshPyramid:
    """Load a shipped transform-matrix pyramid ('for_demo' 9-level VAE pyramid
    or 'ds2' 5-level discriminator pyramid), as in lib/load_data.py:7-32."""
    base = asset_path("transform_matrices", which)
    A = _load_sparse_list(os.path.join(base, "A.npy"))
    D = _load_sparse_list(os.path.join(base, "D.npy"))
    U = _load_sparse_list(os.path.join(base, "U.npy"))
    pyr = pyramid_from_matrices(A, D, U)
    edges_file = os.path.join(base, "E.npy")
    if os.path.exists(edges_file):
        pyr.edges = _load_sparse_list(edges_file)
    return pyr


class _PickleStub:
    """Attribute bag standing in for classes we don't need to import."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __getattr__(self, name):
        raise AttributeError(name)


class _TolerantUnpickler(pickle.Unpickler):
    """Load the shipped sklearn pickle without requiring the (renamed,
    version-pinned) sklearn module layout it was written with."""

    def find_class(self, module, name):
        if module.startswith("sklearn"):
            return _PickleStub
        return super().find_class(module, name)


def load_gmm():
    """The pretrained latent GMM (10 components, full covariance, 18-dim).

    Returns a plain dict {weights, means, covariances} decoded from the
    sklearn pickle without importing sklearn.
    """
    with open(asset_path("pretrained_gmm.pkl"), "rb") as f:
        gmm = _TolerantUnpickler(f, encoding="latin1").load()
    d = gmm.__dict__
    return {
        "weights": np.asarray(d["weights_"]),
        "means": np.asarray(d["means_"]),
        "covariances": np.asarray(d["covariances_"]),
    }
