"""Parameter initializers and small functional-layer helpers.

Counterpart of `cape_tpu.core.params`, with its distributions:
  * graph-conv weights: truncated normal, stddev 0.1, cut at +-2 sigma;
    graph-conv biases: constant 0.1;
  * dense layers: glorot-uniform kernel, zero bias.

A draw's source is a `core.prng` key (uint32 [2]): the initializers then
draw JAX's values (`prng.truncated_normal`, `prng.uniform`), and `split`
is jax.random.split, so a model initialised from PRNGKey(seed) holds the
JAX package's parameters from PRNGKey(seed). The source may instead be a
`torch.Generator`, the test form: its draws are not JAX's, `split` hands
the same generator on, and each draw takes the next values of its stream.
The golden files under tests/data keep fingerprints of parameters drawn
that way from seed 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from cape_tpu_torch.core import prng
from cape_tpu_torch.parallel.mesh2d import full, shard_apply

LEAKY_SLOPE = 0.2


def split(source, num: int) -> list:
    """`num` sources from `source`: jax.random.split of a key; a
    torch.Generator hands itself on."""
    if isinstance(source, torch.Generator):
        return [source] * num
    return list(prng.split(source, num))


def trunc_normal(source, shape, stddev: float = 0.1) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2]: JAX's draw from a key;
    inverse-CDF sampling from a generator."""
    if not isinstance(source, torch.Generator):
        z = prng.truncated_normal(source, -2.0, 2.0, shape)
        return torch.from_numpy(np.float32(stddev) * z)
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2
    u = torch.empty(shape, dtype=torch.float64).uniform_(lo, hi, generator=source)
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (stddev * z.clamp_(-2.0, 2.0)).to(torch.float32)


def glorot_uniform(source, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    if not isinstance(source, torch.Generator):
        # JAX takes the limit's square root in float32
        limit = np.sqrt(np.float32(6.0 / (fan_in + fan_out)))
        return torch.from_numpy(prng.uniform(source, shape, -limit, limit))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=source)


def conv_weight(source, K: int, fin: int, fout: int) -> torch.Tensor:
    """Chebyshev filterbank [K, Fin, Fout]."""
    return trunc_normal(source, (K, fin, fout))


def conv_bias(fout: int) -> torch.Tensor:
    return torch.full((fout,), 0.1, dtype=torch.float32)


def dense_init(source, fin: int, fout: int) -> dict:
    return {
        "kernel": glorot_uniform(source, (fin, fout)),
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
