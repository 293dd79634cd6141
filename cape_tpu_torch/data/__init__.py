"""Datasets: the packer and its split configurations, the packed-array
wrapper, batch streams and synthetic data."""
