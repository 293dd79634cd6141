"""Host-side mesh precompute of the port (numpy/scipy only): OBJ reading,
topology, Laplacians, QSlim decimation, upsample matrices, the mesh
pyramid, its bandwidth-minimizing orderings and the shipped assets.

A copy of the modules of `cape_tpu.meshops` that the port uses, so that
the port imports nothing of the JAX package. `tests/test_torch_meshops.py`
holds each to its original.
"""
