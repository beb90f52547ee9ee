"""Eigensolver subsystem (the port of amgx_tpu/eigen/).

The analog of the reference's secondary eigensolver product
(src/eigensolvers/; C API include/amgx_eig_c.h:18-26). The registry
names match src/eigensolvers/eigensolvers.cu:38-48:

    SINGLE_ITERATION / POWER_ITERATION / PAGERANK / INVERSE_ITERATION
    SUBSPACE_ITERATION, LANCZOS, ARNOLDI, LOBPCG, JACOBI_DAVIDSON

Usage (AMG_EigenSolver analog, src/amg_eigensolver.cu; the card unless
device="cpu")::

    cfg = Config.from_string("eig_solver=LANCZOS, eig_which=smallest, "
                             "eig_eigenvector=1")
    es = create_eigensolver(cfg)
    es.setup(A)
    res = es.solve()          # -> EigenResult
"""
from .base import (EigenResult, EigenSolver, create_eigensolver,
                   make_eigensolver)
from .operators import (DeflatedOperator, MatrixOperator, Operator,
                        PageRankOperator, ShiftedOperator, SolveOperator)
from . import power, krylov, block, jacobi_davidson  # noqa: F401 (register)

__all__ = [
    "EigenResult", "EigenSolver", "create_eigensolver", "make_eigensolver",
    "Operator", "MatrixOperator", "ShiftedOperator", "DeflatedOperator",
    "SolveOperator", "PageRankOperator",
]
