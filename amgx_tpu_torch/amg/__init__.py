"""Algebraic multigrid of the port; importing this package registers the
AMG solver, the aggregation and classical levels and their selectors,
strength measures and interpolators."""
from . import aggregation, classical, solver  # noqa: F401
