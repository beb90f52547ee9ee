"""Solvers of the port; importing this package registers them."""
from . import (base, direct, gmres, idr, krylov, multicolor,  # noqa: F401
               polynomial, refinement, relaxation)
