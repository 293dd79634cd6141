"""The CAPE model and its building blocks."""
