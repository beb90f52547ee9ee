"""Solvers of the port; importing this package registers them."""
from . import (base, direct, gmres, krylov, polynomial,  # noqa: F401
               refinement, relaxation)
