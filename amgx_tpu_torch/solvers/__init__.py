"""Solvers of the port; importing this package registers them."""
from . import base, direct, gmres, polynomial, refinement  # noqa: F401
