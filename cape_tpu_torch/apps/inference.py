"""Batched inference engine: encode / decode / condition-embedding helpers.

Counterpart of `cape_tpu.apps.inference`. Every device call is padded to
`batch_size` rows, so a server sees one set of shapes (and, at batch >= 32,
the band-apply kernel route of `ops.cheb`). The public contract is host
numpy in natural (template) vertex order; inputs are permuted into the
banded device order and outputs un-permuted at this boundary.

With `dp` (a `parallel.mesh.DataParallel` of N devices; the server's
`--data_parallel N`), the engine holds a replica of the model and the
context on each device and pads to batch_size x N rows, split in device
order: every device's chunk is launched before any output is read, and the
outputs come back in natural order. Per-row math does not depend on the
batch, so the outputs are the single-device engine's.
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
    rows, sent to `device`, and its outputs come back as float32 numpy.
    With `devices` (N of them), each padded chunk is split into N equal
    parts in device order, every part's call is launched before any output
    is read, and the outputs are joined in that order."""

    batch_size: int
    device: torch.device
    devices: list[torch.device] | None = None

    def _batched(self, fn, n: int, *arrays):
        if n <= 0:
            raise ValueError("empty batch: callers must guard n == 0 (nothing to infer)")
        outs = None
        bs = self.batch_size
        devices = self.devices or [self.device]
        per = bs // len(devices)
        for begin in range(0, n, bs):
            end = min(begin + bs, n)
            padded = [_pad_to(a[begin:end], bs) for a in arrays]
            launched = []
            with torch.inference_mode():
                for i, d in enumerate(devices):
                    res = fn(*(torch.from_numpy(p[i * per: (i + 1) * per]).to(d) for p in padded))
                    # one tensor, or a tuple or list of them (an exported
                    # program's outputs), on `d`
                    launched.append(res if isinstance(res, (tuple, list)) else (res,))
            res = [np.concatenate([r[j].float().cpu().numpy() for r in launched])[: end - begin]
                   for j in range(len(launched[0]))]
            if outs is None:
                outs = [[] for _ in res]
            for o, r in zip(outs, res):
                o.append(r)
        return tuple(np.concatenate(o, axis=0) for o in outs)


def _indexed(device) -> torch.device:
    """`device` as its tensors report it (cuda -> cuda:<current>)."""
    return torch.empty(0, device=device).device


class InferenceEngine(BatchedCalls):
    """Public contract is in natural (template) vertex order.

    `calls` counts the device calls per stage ("embed", "encode", "decode",
    "sample"; with `dp`, one per device and padded call), so a caller can
    relate kernel launches to them. `dp` (parallel.mesh.DataParallel
    without a group) replicates the model and the context on its devices,
    `batch_size` rows on each (see the module docstring); `device` is then
    ignored."""

    def __init__(self, model: CAPE, ctx: GraphContext, batch_size: int = 16, device=None,
                 dp=None):
        if dp is not None:
            if dp.group is not None:
                raise ValueError("InferenceEngine drives the devices of one process (a "
                                 "DataParallel without a process group)")
            self.devices = [_indexed(d) for d in dp.devices]
            replicas = zip(self.devices, dp.replicate(model), dp.replicate(ctx))
            self._replicas = {d: (m, c) for d, m, c in replicas}
            batch_size *= len(self.devices)
            self.device = self.devices[0]
        else:
            self.device = _indexed(device if device is not None
                                   else next(model.parameters()).device)
            self._replicas = {self.device: (model.to(self.device), ctx.to(self.device))}
        self.model, self.ctx = self._replicas[self.device]
        self.batch_size = batch_size
        self.vertex_perm = ctx.perm0
        self._inv_perm = None
        if self.vertex_perm is not None:
            self._inv_perm = np.empty_like(self.vertex_perm)
            self._inv_perm[self.vertex_perm] = np.arange(len(self.vertex_perm))
        self.calls = {"embed": 0, "encode": 0, "decode": 0, "sample": 0}

    def _count(self, stage: str, fn):
        """fn(model, ctx, *tensors) as a call of the tensors alone, on the
        replica of their device, counted in `calls[stage]`."""
        def call(*args):
            self.calls[stage] += 1
            return fn(*self._replicas[args[0].device], *args)

        return call

    # ------------------------------------------------------------------
    def encode_only_condition(self, pose: np.ndarray, clo: np.ndarray):
        """(pose [N,126], clo [N,4]) -> (y [N,nz_cond], y2 [N,nz_cond2])."""
        pose = np.asarray(pose, np.float32)
        clo = np.asarray(clo, np.float32)
        return self._batched(
            self._count("embed", lambda m, c, p, cl: m.embed_conditions(p, cl)), len(pose),
            pose, clo,
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

        def fn(model, ctx, d, p, c):
            y, y2 = model.embed_conditions(p, c)
            zm, zl = model.encode(ctx, d, y, y2)
            return zm, zl, y, y2

        return self._batched(self._count("encode", fn), len(disp), disp, pose, clo)

    def decode(self, z_total: np.ndarray, y: np.ndarray, y2: np.ndarray):
        """z_total [N, nz+nz_cond+nz_cond2] -> disp [N, V, 3]. y / y2 may
        have one row (broadcast over all z)."""
        z_total = np.asarray(z_total, np.float32)
        n = len(z_total)
        y, y2 = broadcast_conditions(y, y2, n)
        (out,) = self._batched(
            self._count("decode", lambda m, c, z, a, b: m.decode(c, z, a, b)),
            n, z_total, y, y2,
        )
        return self._to_natural_order(out)

    def autoencode(self, disp, pose, clo, rng: int | None = None, sample: bool = False):
        """Full reconstruction. sample=False uses the posterior mean;
        sample=True draws z = mu + sigma * eps with the JAX engine's
        row-keyed eps: row i from normal(fold_in(PRNGKey(seed), i)) in
        z_mean's dtype, the compute dtype (`core.prng.normal_rows`), and
        computes z in that dtype, as the JAX engine does; so one integer seed
        `rng` gives the JAX engine's draw, whatever the batch size. Like the
        JAX engine, the seed is taken modulo 2**32."""
        z_mean, z_logvar, y, y2 = self.encode(disp, pose, clo)
        if sample:
            seed = 0 if rng is None else int(rng) % (1 << 32)
            # encode's outputs come back as f32 holding the compute dtype's values
            eps = prng.normal_rows(seed, len(z_mean), z_mean.shape[1], self.model.dtype)

            def sample_z(m, c, zm, zl, e):
                return m.sample_z(zm.to(m.dtype), zl.to(m.dtype), e.to(m.dtype))

            (z,) = self._batched(self._count("sample", sample_z), len(z_mean), z_mean, z_logvar,
                                 eps)
        else:
            z = z_mean
        z_total = np.concatenate([z, y, y2], axis=-1)
        return self.decode(z_total, y, y2)
