"""The benchmark's weights: made on the device from the run's seed.

Every parameter of the reference's `param_spec` is drawn at its shape and
with CAPE's init scale, in three large calls on one `torch.Generator` of
the device: the graph-conv weights N(0, 0.1) cut at two sigma (inverse
CDF), the dense kernels glorot-uniform, the biases and norms constant.
The draws are in the natural vertex order, which the reference takes as
they are. The program keeps the vertex-indexed parameters in its banded
vertex order: `port_layout` permutes those rows by the level orderings the
program reports (`program.level_perms`).
"""

from __future__ import annotations

import math

import torch

TRUNC_STD = 0.1


def make(spec: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for `spec` ({name: (shape,
    init)}), a function of `seed` alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    numel = lambda shape: math.prod(shape)
    trunc = [n for n, (_, init) in spec.items() if init == "trunc"]
    glorot = [n for n, (_, init) in spec.items() if init == "glorot"]
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(sum(numel(spec[n][0]) for n in trunc), generator=gen, device=device,
                   dtype=torch.float64)
    z = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
    z = (TRUNC_STD * z.clamp(-2.0, 2.0)).float()
    v = torch.rand(sum(numel(spec[n][0]) for n in glorot), generator=gen, device=device) * 2 - 1
    out, off_z, off_v = {}, 0, 0
    for name, (shape, init) in spec.items():
        k = numel(shape)
        if init == "trunc":
            out[name] = z[off_z: off_z + k].reshape(shape).clone()
            off_z += k
        elif init == "glorot":
            limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            out[name] = (v[off_v: off_v + k] * limit).reshape(shape).clone()
            off_v += k
        else:
            out[name] = torch.full(shape, float(init), device=device)
    return out


def port_layout(weights: dict, perm0: torch.Tensor, perm_last: torch.Tensor) -> dict:
    """The weights with their vertex-indexed rows in the program's order:
    row r of a level holds natural vertex perm[r]. The decoder's output
    bias is per vertex of level 0; the encoder's fc_mean/fc_var rows and
    the decoder's fc1 columns are (vertex, channel) pairs of the coarsest
    level, vertex-major."""
    out = dict(weights)
    nv = len(perm_last)
    b = "generator.decoder.out.b"
    out[b] = weights[b][perm0]
    for name in ("generator.encoder.fc_mean.kernel", "generator.encoder.fc_var.kernel"):
        w = weights[name]
        out[name] = w.reshape(nv, -1, w.shape[-1])[perm_last].reshape(w.shape)
    w = weights["generator.decoder.fc1.kernel"]
    out["generator.decoder.fc1.kernel"] = w.reshape(w.shape[0], nv, -1)[:, perm_last].reshape(w.shape)
    bias = weights["generator.decoder.fc1.bias"]
    out["generator.decoder.fc1.bias"] = bias.reshape(nv, -1)[perm_last].reshape(bias.shape)
    return {k: v.contiguous() for k, v in out.items()}
