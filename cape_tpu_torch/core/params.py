"""Parameter initializers and small functional-layer helpers.

Counterpart of `cape_tpu.core.params`. Same distributions, drawn from an
explicit `torch.Generator` (the bits differ from `jax.random`'s):
  * graph-conv weights: truncated normal, stddev 0.1, cut at +-2 sigma;
    graph-conv biases: constant 0.1;
  * dense layers: glorot-uniform kernel, zero bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cape_tpu_torch.parallel.mesh2d import full, shard_apply

LEAKY_SLOPE = 0.2


def trunc_normal(generator: torch.Generator, shape, stddev: float = 0.1) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2], by inverse-CDF sampling."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2
    u = torch.empty(shape, dtype=torch.float64).uniform_(lo, hi, generator=generator)
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (stddev * z.clamp_(-2.0, 2.0)).to(torch.float32)


def glorot_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=generator)


def conv_weight(generator: torch.Generator, K: int, fin: int, fout: int) -> torch.Tensor:
    """Chebyshev filterbank [K, Fin, Fout]."""
    return trunc_normal(generator, (K, fin, fout))


def conv_bias(fout: int) -> torch.Tensor:
    return torch.full((fout,), 0.1, dtype=torch.float32)


def dense_init(generator: torch.Generator, fin: int, fout: int) -> dict:
    return {
        "kernel": glorot_uniform(generator, (fin, fout)),
        "bias": torch.zeros((fout,), dtype=torch.float32),
    }


def dense_apply(p: dict, x: torch.Tensor, activation=None) -> torch.Tensor:
    """x @ kernel + bias. Under tensor parallelism the kernel may be this
    rank's shard, column- or row-parallel (`parallel.mesh2d.shard_apply`),
    and the bias is added whole (`mesh2d.full`)."""
    matmul = lambda x, _, w: torch.matmul(x, w.to(x.dtype))
    y = shard_apply(matmul, x, [], p["kernel"]) + full(p["bias"]).to(x.dtype)
    if activation is not None:
        y = activation(y)
    return y


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


ACTIVATIONS = {
    "b1leakyrelu": leaky_relu,
    "b1relu": torch.relu,
    "b1tanh": torch.tanh,
}
