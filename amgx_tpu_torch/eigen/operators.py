"""Operator adapters for eigensolvers (the port of
amgx_tpu/eigen/operators.py).

An Operator is a linear action `y = Op(x)` the Krylov / power
iterations consume, written as `apply(data, x)` over a dict of device
tensors (the reference's virtual `apply(v, res, view)`), as the
solvers' `solve_data` / `apply` pairs are.

Adapters (reference files):
- MatrixOperator      -- plain SpMV (`ops/spmv.py`: B1 on a float32 DIA
                         operator, B8 on a float32 CSR one).
- ShiftedOperator     -- (A - sigma I) x   (src/operators/shifted_operator.cu)
- DeflatedOperator    -- A x - V diag(l) V^T x
                         (src/operators/deflated_multiply_operator.cu)
- SolveOperator       -- approximate A^{-1} x via a nested Solver
                         (src/operators/solve_operator.cu:29-42)
- PageRankOperator    -- alpha * H^T x + (a . x) b, the Google-matrix
                         action (src/operators/pagerank_operator.cu:21-36)
"""
from __future__ import annotations

import numpy as np
import torch

from ..matrix import CsrMatrix
from ..ops.spmv import spmv
from ..ops.transpose import transpose


class Operator:
    """Linear action over a dict of device tensors."""

    def data(self):
        raise NotImplementedError

    def apply(self, data, x):
        raise NotImplementedError

    def apply_rows(self, data, X):
        """The action on each row of X (k, n): the JAX package's vmap
        over columns, one application a row."""
        return torch.stack([self.apply(data, X[j]) for j in range(X.shape[0])])


class MatrixOperator(Operator):
    def __init__(self, A: CsrMatrix):
        self.A = A if A.initialized else A.init()
        self.num_rows = A.num_rows

    def data(self):
        return {"A": self.A}

    def apply(self, data, x):
        return spmv(data["A"], x)


class ShiftedOperator(Operator):
    """(inner - sigma I) x -- spectral shift (shifted_operator.cu)."""

    def __init__(self, inner: Operator, sigma: float):
        self.inner = inner
        self.sigma = sigma
        self.num_rows = inner.num_rows

    def data(self):
        return {"inner": self.inner.data(), "sigma": float(self.sigma)}

    def apply(self, data, x):
        y = self.inner.apply(data["inner"], x)
        return y - data["sigma"] * x


class DeflatedOperator(Operator):
    """inner(x) - V diag(lambdas) V^T x: deflates converged eigenpairs out
    of the spectrum (deflated_multiply_operator.cu)."""

    def __init__(self, inner: Operator, lambdas, V):
        self.inner = inner
        self.lambdas = torch.as_tensor(lambdas)
        self.V = torch.as_tensor(V)           # (n, k) orthonormal columns
        self.num_rows = inner.num_rows

    def data(self):
        return {"inner": self.inner.data(), "lambdas": self.lambdas,
                "V": self.V}

    def apply(self, data, x):
        y = self.inner.apply(data["inner"], x)
        c = data["V"].T @ x
        return y - data["V"] @ (data["lambdas"] * c)


class SolveOperator(Operator):
    """Approximate inverse action via a nested Solver's fixed-sweep
    preconditioner application (solve_operator.cu:29-42). Used by
    INVERSE_ITERATION for the smallest eigenpair."""

    def __init__(self, solver):
        self.solver = solver               # a set-up solvers.base.Solver
        self.num_rows = solver.A.num_rows

    def data(self):
        return {"sdata": self.solver.solve_data()}

    def apply(self, data, x):
        return self.solver.apply(data["sdata"], x)


class PageRankOperator(Operator):
    """Google-matrix action on the stationary-distribution iterate:

        y = alpha * H^T x + (a . x) * b

    with H the row-stochastic link matrix built from A's adjacency,
    a = alpha * dangling + (1 - alpha) * ones (teleport + dangling-node
    correction) and b = ones/n -- exactly the reference apply
    (pagerank_operator.cu:30-36: SpMV, scal, dot, axpy). The dominant
    eigenvector (eigenvalue 1) is the PageRank vector. The out-degree
    normalisation runs once on the host in float64, as in the JAX
    package; H and its transpose (`ops/transpose.py`) live on A's
    device, so the SpMV is B8's on a float32 graph.
    """

    def __init__(self, A: CsrMatrix, damping: float = 0.85):
        n = A.num_rows
        dev, dt = A.device, A.dtype
        # out-degree row normalization of the adjacency (host, once)
        ro = A.row_offsets.cpu().numpy()
        vals = np.abs(A.values.cpu().numpy().astype(np.float64))
        row_ids = np.repeat(np.arange(n), np.diff(ro))
        deg = np.zeros(n)
        np.add.at(deg, row_ids, vals)
        dangling = (deg == 0.0).astype(np.float64)
        inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-300), 0.0)
        Hvals = torch.from_numpy(vals * inv_deg[row_ids]).to(
            device=dev, dtype=dt)
        H = CsrMatrix(row_offsets=A.row_offsets, col_indices=A.col_indices,
                      values=Hvals, num_rows=n, num_cols=n)
        self.Ht = transpose(H).init()
        self.alpha = damping
        self.a = torch.from_numpy(damping * dangling + (1.0 - damping)).to(
            device=dev, dtype=dt)
        self.b = torch.full((n,), 1.0 / n, dtype=dt, device=dev)
        self.num_rows = n

    def data(self):
        return {"Ht": self.Ht, "a": self.a, "b": self.b}

    def apply(self, data, x):
        y = self.alpha * spmv(data["Ht"], x)
        gamma = torch.dot(data["a"], x)
        return y + gamma * data["b"]
