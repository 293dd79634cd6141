"""Mesh operators, the graph context, the Chebyshev conv and its kernel."""
