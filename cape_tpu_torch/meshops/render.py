"""Offscreen software mesh rendering — no GL, no display.

A copy of `cape_tpu.meshops.render`. It needs PIL, and only the demo
suite's vis_demo option calls it; without PIL the contact sheet is
skipped with a notice.

Replaces the reference's interactive MeshViewers window grid
(reference demos.py:225-246, lib/load_data.py:134-141: psbody
MeshViewers driven by the vis_demo flag) with a headless renderer that
writes PNG contact sheets next to the exported .obj files. Accelerator
hosts are headless; a software rasterizer is the right surface for "eyeball
the generated clothing" at SMPL scale (6.9k verts / 13.8k faces),
and the PNGs travel through CI artifacts where an
OpenGL window cannot.

Method: orthographic painter's algorithm. Faces are depth-sorted far to
near and filled as flat-shaded polygons (Lambert against a fixed light)
into a PIL image. No z-buffer: SMPL bodies are near-convex enough that
back-to-front fill is artifact-free at contact-sheet resolution.
"""

from __future__ import annotations

import os

import numpy as np

try:  # PIL ships in this image; degrade to a stub if absent
    from PIL import Image, ImageDraw

    HAVE_PIL = True
except ImportError:  # pragma: no cover
    HAVE_PIL = False

# SMPL bodies stand along +y with +z out of the chest: the front view is
# the xy plane. A slight yaw makes shape silhouettes easier to read.
_LIGHT = np.array([0.25, 0.35, 0.9])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)


def _yaw(verts: np.ndarray, degrees: float) -> np.ndarray:
    t = np.deg2rad(degrees)
    c, s = np.cos(t), np.sin(t)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return verts @ rot.T


def render_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    size: int = 400,
    yaw_degrees: float = 20.0,
    base_gray: int = 235,
    background: int = 255,
) -> np.ndarray:
    """Render one mesh to an [size, size, 3] uint8 image (front view)."""
    if not HAVE_PIL:  # pragma: no cover
        raise RuntimeError("mesh rendering requires PIL (not installed)")
    v = _yaw(np.asarray(verts, np.float64), yaw_degrees)
    f = np.asarray(faces, np.int64)

    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2.0
    half_extent = max(float((hi - lo)[:2].max()) / 2.0, 1e-9)
    scale = 0.45 * size / half_extent
    u = size / 2.0 + (v[:, 0] - center[0]) * scale
    w = size / 2.0 - (v[:, 1] - center[1]) * scale  # image y grows down

    tri = v[f]                                         # [F, 3, 3]
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(normal, axis=1, keepdims=True)
    normal = normal / np.maximum(norm, 1e-12)
    # two-sided shading: winding conventions differ between pyramids
    shade = np.abs(normal @ _LIGHT)
    gray = (base_gray * (0.25 + 0.75 * shade)).astype(np.uint8)

    order = np.argsort(tri[:, :, 2].mean(axis=1))      # far (small z) first
    img = Image.new("RGB", (size, size), (background,) * 3)
    draw = ImageDraw.Draw(img)
    uu, ww = u[f], w[f]                                # [F, 3]
    for i in order:
        g = int(gray[i])
        draw.polygon(
            [(uu[i, 0], ww[i, 0]), (uu[i, 1], ww[i, 1]), (uu[i, 2], ww[i, 2])],
            fill=(g, g, g),
        )
    return np.asarray(img)


def contact_sheet(
    meshes: np.ndarray,
    faces: np.ndarray,
    path: str,
    cols: int = 0,
    size: int = 400,
    yaw_degrees: float = 20.0,
) -> str:
    """Render a batch [N, V, 3] into a grid PNG at `path`. Returns path."""
    if not HAVE_PIL:  # pragma: no cover
        print("note: PIL unavailable — skipping visualization", flush=True)
        return path
    meshes = np.asarray(meshes)
    n = len(meshes)
    if n == 0:
        return path
    cols = cols if cols > 0 else min(n, 5)
    rows = (n + cols - 1) // cols
    sheet = Image.new("RGB", (cols * size, rows * size), (255, 255, 255))
    for i, m in enumerate(meshes):
        tile = Image.fromarray(render_mesh(m, faces, size=size, yaw_degrees=yaw_degrees))
        sheet.paste(tile, ((i % cols) * size, (i // cols) * size))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sheet.save(path)
    return path
