"""Batched inference engine: encode / decode / condition-embedding helpers.

Counterpart of `cape_tpu.apps.inference`. Every device call is padded to
`batch_size` rows, so a server sees one set of shapes (and, at batch >= 32,
the band-apply kernel route of `ops.cheb`). The public contract is host
numpy in natural (template) vertex order; inputs are permuted into the
banded device order and outputs un-permuted at this boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from cape_tpu_torch.core import prng
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.ops.sparse import GraphContext


def broadcast_conditions(y, y2, n: int):
    """1-row y/y2 embeddings broadcast over n rows (decode semantics of
    the reference: one condition, many z)."""
    y = np.asarray(y, np.float32)
    y2 = np.asarray(y2, np.float32)
    if y.shape[0] == 1:
        y = np.repeat(y, n, axis=0)
    if y2.shape[0] == 1:
        y2 = np.repeat(y2, n, axis=0)
    return y, y2


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr[:n]
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])


class BatchedCalls:
    """Host-side fixed-batch loop: each chunk is padded to `batch_size`
    rows, sent to `device`, and its outputs come back as float32 numpy."""

    batch_size: int
    device: torch.device

    def _batched(self, fn, n: int, *arrays):
        if n <= 0:
            raise ValueError("empty batch: callers must guard n == 0 (nothing to infer)")
        outs = None
        bs = self.batch_size
        for begin in range(0, n, bs):
            end = min(begin + bs, n)
            padded = [
                torch.from_numpy(_pad_to(a[begin:end], bs)).to(self.device)
                for a in arrays
            ]
            with torch.inference_mode():
                res = fn(*padded)
            # one tensor, or a tuple or list of them (an exported program's
            # outputs), on `device`
            res = res if isinstance(res, (tuple, list)) else (res,)
            res = [r.float().cpu().numpy()[: end - begin] for r in res]
            if outs is None:
                outs = [[] for _ in res]
            for o, r in zip(outs, res):
                o.append(r)
        return tuple(np.concatenate(o, axis=0) for o in outs)


class InferenceEngine(BatchedCalls):
    """Public contract is in natural (template) vertex order.

    `calls` counts the padded device calls per stage ("embed", "encode",
    "decode", "sample"), so a caller can relate kernel launches to them."""

    def __init__(self, model: CAPE, ctx: GraphContext, batch_size: int = 16, device=None):
        self.device = torch.device(device) if device is not None else next(model.parameters()).device
        self.model = model.to(self.device)
        self.ctx = ctx.to(self.device)
        self.batch_size = batch_size
        self.vertex_perm = ctx.perm0
        self._inv_perm = None
        if self.vertex_perm is not None:
            self._inv_perm = np.empty_like(self.vertex_perm)
            self._inv_perm[self.vertex_perm] = np.arange(len(self.vertex_perm))
        self.calls = {"embed": 0, "encode": 0, "decode": 0, "sample": 0}

    def _count(self, stage: str, fn):
        def call(*args):
            self.calls[stage] += 1
            return fn(*args)

        return call

    # ------------------------------------------------------------------
    def encode_only_condition(self, pose: np.ndarray, clo: np.ndarray):
        """(pose [N,126], clo [N,4]) -> (y [N,nz_cond], y2 [N,nz_cond2])."""
        pose = np.asarray(pose, np.float32)
        clo = np.asarray(clo, np.float32)
        return self._batched(
            self._count("embed", self.model.embed_conditions), len(pose), pose, clo
        )

    def _to_device_order(self, disp: np.ndarray) -> np.ndarray:
        if self.vertex_perm is None:
            return disp
        return np.ascontiguousarray(disp[:, self.vertex_perm])

    def _to_natural_order(self, disp: np.ndarray) -> np.ndarray:
        if self._inv_perm is None:
            return disp
        return np.ascontiguousarray(disp[:, self._inv_perm])

    def encode(self, disp: np.ndarray, pose: np.ndarray, clo: np.ndarray):
        """Returns (z_mean, z_logvar, y, y2)."""
        disp = self._to_device_order(np.asarray(disp, np.float32))
        pose = np.asarray(pose, np.float32)
        clo = np.asarray(clo, np.float32)

        def fn(d, p, c):
            y, y2 = self.model.embed_conditions(p, c)
            zm, zl = self.model.encode(self.ctx, d, y, y2)
            return zm, zl, y, y2

        return self._batched(self._count("encode", fn), len(disp), disp, pose, clo)

    def decode(self, z_total: np.ndarray, y: np.ndarray, y2: np.ndarray):
        """z_total [N, nz+nz_cond+nz_cond2] -> disp [N, V, 3]. y / y2 may
        have one row (broadcast over all z)."""
        z_total = np.asarray(z_total, np.float32)
        n = len(z_total)
        y, y2 = broadcast_conditions(y, y2, n)
        (out,) = self._batched(
            self._count("decode", lambda z, a, b: self.model.decode(self.ctx, z, a, b)),
            n, z_total, y, y2,
        )
        return self._to_natural_order(out)

    def autoencode(self, disp, pose, clo, rng: int | None = None, sample: bool = False):
        """Full reconstruction. sample=False uses the posterior mean;
        sample=True draws z = mu + sigma * eps with the JAX engine's
        row-keyed eps: row i from normal(fold_in(PRNGKey(seed), i))
        (`core.prng.normal_rows`), so one integer seed `rng` gives the JAX
        engine's draw, whatever the batch size. Like the JAX engine, the
        seed is taken modulo 2**32."""
        z_mean, z_logvar, y, y2 = self.encode(disp, pose, clo)
        if sample:
            seed = 0 if rng is None else int(rng) % (1 << 32)
            eps = prng.normal_rows(seed, len(z_mean), z_mean.shape[1])
            (z,) = self._batched(
                self._count("sample", self.model.sample_z), len(z_mean), z_mean, z_logvar, eps
            )
        else:
            z = z_mean
        z_total = np.concatenate([z, y, y2], axis=-1)
        return self.decode(z_total, y, y2)
