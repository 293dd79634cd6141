"""The port's copy of the host-side mesh precompute (`cape_tpu_torch.meshops`)
against its original (`cape_tpu.meshops`): the shipped assets, the shipped
pyramids, their orderings and a QSlim pyramid built from scratch, all
bit-equal."""

import numpy as np
import pytest
import scipy.sparse as sp

from cape_tpu.meshops import assets as jax_assets
from cape_tpu_torch.meshops import assets


def _same_csr(a, b, name):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape, name
    for part in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a, part), getattr(b, part), err_msg=f"{name} {part}")


def _same_pyramid(got, want):
    for field in ("adjacencies", "downsamples", "upsamples"):
        assert len(getattr(got, field)) == len(getattr(want, field)), field
        for i, (a, b) in enumerate(zip(getattr(got, field), getattr(want, field))):
            _same_csr(a, b, f"{field}[{i}]")
    for field in ("verts", "faces", "edges"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        for i, (a, b) in enumerate(zip(g or [], w or [])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{field}[{i}]")


def test_assets_match():
    assert assets.ASSET_DIR == jax_assets.ASSET_DIR
    for got, want in zip(assets.template_mesh(), jax_assets.template_mesh()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(assets.smpl_edges(), jax_assets.smpl_edges())
    np.testing.assert_array_equal(assets.loss_mask_binary(), jax_assets.loss_mask_binary())


@pytest.mark.parametrize("which", ["for_demo", "ds2"])
def test_shipped_pyramids_and_orderings_match(which):
    """The CSR data, indices and indptr of every matrix of a shipped
    pyramid, and the RCM/induced orderings the graph context applies."""
    from cape_tpu.meshops.ordering import pyramid_orderings as jax_orderings
    from cape_tpu_torch.meshops.ordering import pyramid_orderings

    got, want = assets.load_pyramid(which), jax_assets.load_pyramid(which)
    _same_pyramid(got, want)
    for a, b in zip(pyramid_orderings(got), jax_orderings(want), strict=True):
        np.testing.assert_array_equal(a, b)


def test_load_or_build_takes_the_shipped_pyramid_for_the_canonical_plan():
    from cape_tpu_torch.meshops.pyramid import CANONICAL_DS_FACTORS, load_or_build

    _same_pyramid(load_or_build(CANONICAL_DS_FACTORS), jax_assets.load_pyramid("for_demo"))


def test_build_pyramid_matches(small_mesh, monkeypatch):
    """QSlim decimation and upsample matrices on the toy icosphere. The port
    keeps the numpy nearest-triangle backend only, so the JAX package's
    native C++ BVH is taken out of its path for the comparison (the two may
    pick another triangle for a point equidistant from two)."""
    import sys

    from cape_tpu.meshops.pyramid import build_pyramid as jax_build
    from cape_tpu_torch.meshops.pyramid import build_pyramid

    monkeypatch.setitem(sys.modules, "cape_tpu.meshops.native_aabb", None)
    verts, faces = small_mesh
    for factors in ([1, 2, 1, 2, 1, 2, 1, 1], [2, 2, 2, 2]):
        _same_pyramid(build_pyramid(verts, faces, factors), jax_build(verts, faces, factors))
