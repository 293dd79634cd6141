"""The port's copy of the host-side mesh precompute (`cape_tpu_torch.meshops`)
against its original (`cape_tpu.meshops`): the shipped assets, the shipped
pyramids, their orderings, the toy icosphere, the native BVH's nearest
triangles and a QSlim pyramid built from scratch on either backend, all
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


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_icosphere_matches(n):
    from cape_tpu.meshops.toy import icosphere as jax_icosphere
    from cape_tpu_torch.meshops.toy import icosphere

    for got, want in zip(icosphere(n), jax_icosphere(n), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_native_nearest_triangles_match(small_mesh):
    """The port's BVH (its copy of the C++ source, built at first use into
    build/cape_tpu_torch/) against the JAX package's: the same faces and
    bit-equal barycentric coordinates for seeded query points around
    icosphere(3), on and off the surface."""
    from cape_tpu.meshops import native_aabb as jax_native
    from cape_tpu_torch.meshops import native_aabb

    verts, faces = small_mesh
    rng = np.random.default_rng(0)
    queries = np.concatenate([
        rng.standard_normal((300, 3)) * 1.5,
        verts[rng.integers(0, len(verts), 100)] * rng.uniform(0.9, 1.1, (100, 1)),
    ])
    got, want = native_aabb.nearest_triangles(verts, faces, queries), \
        jax_native.nearest_triangles(verts, faces, queries)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_build_pyramid_matches(small_mesh, monkeypatch, caplog, backend):
    """QSlim decimation and upsample matrices on the toy icosphere, built by
    both packages on the same nearest-triangle backend: numpy (each
    package's native module taken out of its path) or the native C++ BVH
    (each package's own build). Each upsample logs its backend."""
    import logging
    import sys

    from cape_tpu.meshops.pyramid import build_pyramid as jax_build
    from cape_tpu_torch.meshops.pyramid import build_pyramid

    if backend == "numpy":
        monkeypatch.setitem(sys.modules, "cape_tpu.meshops.native_aabb", None)
        monkeypatch.setitem(sys.modules, "cape_tpu_torch.meshops.native_aabb", None)
    else:
        from cape_tpu.meshops import native_aabb

        native_aabb._load()   # the JAX package's BVH (built if missing)
    verts, faces = small_mesh
    caplog.set_level(logging.INFO, logger="cape_tpu_torch.meshops.transfer")
    for factors in ([1, 2, 1, 2, 1, 2, 1, 1], [2, 2, 2, 2]):
        _same_pyramid(build_pyramid(verts, faces, factors), jax_build(verts, faces, factors))
    built = [r.getMessage() for r in caplog.records if "built by" in r.getMessage()]
    assert len(built) == 3 + 4
    assert all(m.endswith(f"built by the {backend} backend") for m in built), built


@pytest.mark.parametrize("factors", [[1, 2, 1, 2, 1, 2, 1, 1], [2, 2, 2, 2]])
def test_upsamples_differ_from_the_native_bvh_only_at_ties(small_mesh, factors, monkeypatch):
    """The toy pyramid's upsample matrices from the port's numpy nearest
    triangle (its native BVH taken out of its path) against
    `cape_tpu.meshops` with its native C++ BVH in the path. Every row where the two differ is a tie: the two chosen triangles
    lie equally far from the fine vertex, within 1e-12 of the mesh scale.
    Where both chose the same triangle, U @ coarse_verts agrees within 1e-9
    of the scale. Where they chose different triangles, each closest point
    lies at that same distance from the vertex, but the two points need not
    coincide: on the toy pyramid three vertices get points 6.8e-3 apart."""
    import sys

    from cape_tpu.meshops import native_aabb
    from cape_tpu.meshops.pyramid import build_pyramid as jax_build
    from cape_tpu_torch.meshops.pyramid import build_pyramid
    from cape_tpu_torch.meshops.transfer import _nearest_numpy, closest_point_on_triangles

    native_aabb._load()   # the BVH is in the JAX package's path (built if missing)
    monkeypatch.setitem(sys.modules, "cape_tpu_torch.meshops.native_aabb", None)
    verts, faces = small_mesh
    scale = float(np.ptp(verts, axis=0).max())
    got, want = build_pyramid(verts, faces, factors), jax_build(verts, faces, factors)
    ties = 0
    for i, (u_port, u_jax) in enumerate(zip(got.upsamples, want.upsamples, strict=True)):
        coarse_v, coarse_f, fine_v = want.verts[i + 1], want.faces[i + 1], want.verts[i]
        np.testing.assert_array_equal(got.verts[i + 1], coarse_v)
        np.testing.assert_array_equal(got.faces[i + 1], coarse_f)
        points = (u_port @ coarse_v, u_jax @ coarse_v)
        differ = np.flatnonzero(abs(sp.csr_matrix(u_port) - sp.csr_matrix(u_jax)).sum(1).A1)
        p = fine_v[differ]
        chosen = (_nearest_numpy(p, coarse_v, coarse_f)[0],
                  native_aabb.nearest_triangles(coarse_v, coarse_f, p)[0])
        dist = [np.sqrt(closest_point_on_triangles(p, coarse_v[coarse_f[f]][:, None])[0][:, 0])
                for f in chosen]
        np.testing.assert_allclose(dist[0], dist[1], rtol=0, atol=1e-12 * scale,
                                   err_msg=f"upsamples[{i}]: rows {differ} are not ties")
        other = differ[chosen[0] != chosen[1]]
        ties += len(other)
        for q in points:
            np.testing.assert_allclose(np.linalg.norm(q[other] - fine_v[other], axis=1),
                                       dist[0][chosen[0] != chosen[1]], rtol=0, atol=1e-12 * scale)
        same = np.setdiff1d(np.arange(len(fine_v)), other)
        np.testing.assert_allclose(points[0][same], points[1][same], rtol=0, atol=1e-9 * scale,
                                   err_msg=f"upsamples[{i}] @ coarse verts")
    assert ties >= 1   # the ties the two backends break apart
