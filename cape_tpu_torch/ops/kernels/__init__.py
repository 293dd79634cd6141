"""Hand-written kernels for Hopper and their plain PyTorch versions.

A wrapper here takes its plain version only for tensors on the CPU or the
`meta` device; for a CUDA tensor it launches its kernel or raises.
"""
