"""Algebraic multigrid of the port; importing this package registers the
AMG solver, the aggregation level and its selectors."""
from . import aggregation, solver  # noqa: F401
