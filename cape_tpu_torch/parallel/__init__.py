"""Data parallelism: the device mesh, multi-process groups and the collectives."""
