"""Datasets: the packed-array wrapper, batch streams and synthetic data."""
