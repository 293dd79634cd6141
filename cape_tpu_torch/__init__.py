"""cape_tpu_torch — CAPE serving and training in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `cape_tpu` (JAX/XLA/Pallas on a TPU), module for module: each
module here has the same name and layout as its counterpart there, and
the tests hold both packages to the same outputs on the same inputs. This
package imports `torch` and nothing of `cape_tpu`, `jax`, `flax` or `yaml`;
it keeps its own copy of the host-side mesh precompute (`meshops/`,
numpy/scipy only).

Layout:
  core/      config dataclass and preset reader, initializers, JAX bridge
  meshops/   mesh precompute: pyramids, orderings, the shipped assets
  ops/       banded operators, graph context, Chebyshev conv and its kernels
  csrc/      CUDA C++ sources, built at first use by ops/kernels/build.py
  models/    the CAPE model (condition nets, encoder, decoder, discriminator)
  losses.py  the training losses
  train/     schedules, the G/D optimizer, the GAN step, checkpoints, Trainer
  data/      the packed-dataset wrapper, batch streams, synthetic data
  apps/      inference engine, checkpoint restore, HTTP model server, CLI
"""

__version__ = "0.1.0"
