"""Algebraic multigrid of the port; importing this package registers the
AMG solver, the aggregation, classical and energymin levels and their
selectors, strength measures and interpolators."""
from . import aggregation, classical, energymin, solver  # noqa: F401
