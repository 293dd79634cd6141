"""Everything the benchmark takes from the program under test,
`cape_tpu_torch`: its configuration, its graph context, its model with the
benchmark's weights loaded through its state-dict path, its Trainer and
its engine, and the kernel wrapper whose launches the traced run records.
No other module of the harness imports the program; the reference
imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

from cape_tpu_torch.apps.inference import InferenceEngine
from cape_tpu_torch.apps.main import build_context
from cape_tpu_torch.core.config import CAPEConfig, load_config
from cape_tpu_torch.data.loader import BatchStream
from cape_tpu_torch.meshops.ordering import pyramid_orderings
from cape_tpu_torch.meshops.pyramid import load_or_build
from cape_tpu_torch.models.cape import CAPE, ParamTree
from cape_tpu_torch.ops.kernels import cheb_kernel
from cape_tpu_torch.train.loop import Trainer

def config(settings: dict, **overrides) -> CAPEConfig:
    """The program's config of a benchmark configuration's settings."""
    return load_config(None, **{**settings, **overrides})


def toy_mesh(subdivisions: int, cfg: CAPEConfig) -> dict:
    """An icosphere's pyramids, built by the program's mesh tools, for the
    benchmark's CPU tests: {"pyramid", "pyramid_d", "edges", "verts"}, and
    the same matrices as the reference reads them ("raw")."""
    from cape_tpu_torch.meshops.pyramid import build_pyramid
    from cape_tpu_torch.meshops.topology import vertices_per_edge
    from cape_tpu_torch.meshops.toy import icosphere

    verts, faces = icosphere(subdivisions)
    pyr = build_pyramid(verts, faces, cfg.ds_factors)
    pyr_d = build_pyramid(verts, faces, [2, 2, 2, 2])
    edges = np.asarray(vertices_per_edge(faces, len(verts)))
    raw = {"A": pyr.adjacencies, "D": pyr.downsamples, "U": pyr.upsamples,
           "A_d": pyr_d.adjacencies, "D_d": pyr_d.downsamples, "edges": edges.astype(np.int64)}
    return {"pyramid": pyr, "pyramid_d": pyr_d, "edges": edges, "verts": verts, "raw": raw}


def context(cfg: CAPEConfig, device, mesh: dict | None = None):
    """The program's graph context: of the published pyramids, or of
    `mesh` (`toy_mesh`)."""
    if mesh is None:
        return build_context(cfg, device=device)
    from cape_tpu_torch.models.cape import DTYPES
    from cape_tpu_torch.ops.sparse import build_graph_context

    return build_graph_context(mesh["pyramid"], mesh["pyramid_d"], mesh["edges"], mesh["verts"],
                               mode=cfg.op_mode, dtype=DTYPES[cfg.compute_dtype],
                               padded=cfg.padded_layout, use_pallas=cfg.use_pallas,
                               device=device)


def level_perms(cfg: CAPEConfig, mesh: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The program's vertex orderings of levels 0 and the coarsest: row r
    of a level is natural vertex perm[r]."""
    pyr = load_or_build(cfg.ds_factors) if mesh is None else mesh["pyramid"]
    perms = pyramid_orderings(pyr)
    return np.ascontiguousarray(perms[0]), np.ascontiguousarray(perms[-1])


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *heads, leaf = name.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t
    return tree


def model(cfg: CAPEConfig, weights: dict) -> CAPE:
    """A CAPE whose parameters are laid out as `weights` names them and
    then loaded from them with load_state_dict(strict=True)."""
    m = CAPE(cfg)
    for top, sub in _nest({k: torch.empty_like(v) for k, v in weights.items()}).items():
        m.add_module(top, ParamTree(sub))
    m.load_state_dict(weights, strict=True)
    return m


class _DeviceSplit:
    """Stands in for `BodyData`: the Trainer reads the train split's size
    from it; the split itself is put on the device by `trainer`."""

    def __init__(self, n: int, num_verts: int, cond_dim: int, cond2_dim: int):
        self.disp_train = range(n)
        self._empty = (np.zeros((0, num_verts, 3), np.float32),
                       np.zeros((0, cond_dim), np.float32), np.zeros((0, cond2_dim), np.float32))

    def split(self, name: str):
        return self._empty


def trainer(cfg: CAPEConfig, m: CAPE, ctx, data: dict, workdir: str) -> Trainer:
    """The program's Trainer over a train split already on the device in
    the context's vertex order ({disp, pose, clo}), as `Trainer` keeps its
    split resident."""
    n = len(data["disp"])
    t = Trainer(cfg, m, ctx, _DeviceSplit(n, ctx.level_sizes[0], cfg.cond_dim, cfg.cond2_dim),
                workdir=workdir)
    t.train_data = data
    return t


def streams(cfg: CAPEConfig, n: int) -> tuple[BatchStream, BatchStream]:
    """The G and D index streams as `Trainer.fit` makes them."""
    return BatchStream(n, cfg.batch_size, cfg.seed), BatchStream(n, cfg.batch_size, cfg.seed + 1)


def run_chunk(t: Trainer, k: int, sg: BatchStream, sd: BatchStream) -> list[dict]:
    """k steps through `Trainer.run_steps`, closed by its loss screen as
    `Trainer.fit` closes a chunk (the loop's one host sync)."""
    step = t.state.step
    metrics = t.run_steps(k, sg, sd)
    t._screen([(step + i, torch.stack([m["loss_g"], m["loss_d"]])) for i, m in enumerate(metrics)])
    return metrics


def engine(cfg: CAPEConfig, m: CAPE, ctx, device) -> InferenceEngine:
    return InferenceEngine(m, ctx, cfg.batch_size, device=device)


class LaunchRecorder:
    """Records the shapes of each band-apply kernel launch while on:
    wraps `cheb_kernel.band_apply`, the entry that the conv route and the
    plain applies call, from outside. A record: (blocks, pad_left,
    rows_out, B, rows_in, C, dtype, addend).

    It sees the calls made while it is on, and a launch replayed from a
    CUDA graph calls no Python: a train cell keeps it on over its set-up's
    steps, whose launches (eager, or at a graph's capture) are whole
    multiples of one step's, and off in the window and the profiled
    stretch; the serve cell's child keeps it on over its profiled stretch."""

    def __init__(self):
        self.records: list[tuple] = []
        self._orig = None

    def __enter__(self):
        self._orig = orig = cheb_kernel.band_apply

        def band_apply(x, blocks, pad_left, rows_out, addend=None, pack=None):
            if x.is_cuda:
                B, rows_in, C = x.shape
                self.records.append((blocks, pad_left, rows_out, B, rows_in, C, x.dtype,
                                     addend is not None))
            return orig(x, blocks, pad_left, rows_out, addend=addend, pack=pack)

        cheb_kernel.band_apply = band_apply
        return self

    def __exit__(self, *exc):
        cheb_kernel.band_apply = self._orig
