"""Solvers of the port; importing this package registers them."""
from . import (base, direct, gmres, idr, kaczmarz, krylov,  # noqa: F401
               multicolor, polynomial, refinement, relaxation)
