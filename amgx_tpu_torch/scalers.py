"""Equation scalers applied around a solve (the port of
amgx_tpu/scalers.py; src/scalers/, registered at src/core.cu:687-689).
A scaler turns A x = b into (L A R) x' = L b with x = R x', L and R
diagonal:

- DIAGONAL_SYMMETRIC: L = R = |diag(A)|^-1/2 (a unit diagonal);
- BINORMALIZATION: symmetric binormalization (Livne & Golub, "Scaling
  by Binormalization", Numer. Algorithms 35, 2004): a fixed point on
  B = A .* A equalizing the scaled row 2-norms;
- NBINORMALIZATION: alternate row and column 2-norm equilibration,
  independent L and R.

Only the root of a solver tree scales (solvers/base.py): the tree is set
up on L A R, b and x0 are scaled in and x out, and the monitored
residuals are those of the scaled system, as in the reference
(solver.cu:449). Row and column sums are ordered (ops/segment.py), so
the scale vectors have the same bits on the CPU and on the card.
"""
from __future__ import annotations

import torch

from . import registry
from .matrix import CsrMatrix
from .ops.segment import ordered_sum, ordered_sum_plan


class Scaler:
    """Base: setup(A) computes the diagonal left / right scale vectors."""

    def __init__(self, cfg, scope: str = "default"):
        self.cfg = cfg
        self.scope = scope
        self.left = None        # (n,)
        self.right = None       # (m,)

    def setup(self, A: CsrMatrix):
        raise NotImplementedError

    def scale_matrix(self, A: CsrMatrix) -> CsrMatrix:
        """L A R: the same structure, new values (and DIA view)."""
        rows, cols, vals = A.coo()
        return A.with_values(vals * self.left[rows]
                             * self.right[cols.long()])

    def scale_rhs(self, b):
        return b * self.left

    def to_scaled_x(self, x):
        return x / self.right

    def from_scaled_x(self, x):
        return x * self.right


def _row_sum_fn(A: CsrMatrix):
    """v -> the ordered row sums of a per-entry vector v of A."""
    plan = ordered_sum_plan(A.row_offsets)
    return lambda v: ordered_sum(v, plan, A.num_rows)


def _col_sum_fn(A: CsrMatrix):
    """v -> the ordered column sums of a per-entry vector v of A: each
    column's entries in their stored order (the order of the JAX
    package's scatter-add on the CPU)."""
    cols = A.col_indices.long()
    order = torch.argsort(cols, stable=True)
    starts = torch.zeros(A.num_cols + 1, dtype=torch.int64,
                         device=cols.device)
    torch.cumsum(torch.bincount(cols, minlength=A.num_cols), 0,
                 out=starts[1:])
    plan = ordered_sum_plan(starts)
    return lambda v: ordered_sum(v[order], plan, A.num_cols)


@registry.scalers.register("DIAGONAL_SYMMETRIC")
class DiagonalSymmetricScaler(Scaler):
    """L = R = |diag(A)|^-1/2 (diagonal_symmetric.cu)."""

    def setup(self, A: CsrMatrix):
        d = A.diagonal().abs()
        pos = d > 0
        s = torch.where(pos, 1.0 / torch.sqrt(torch.where(
            pos, d, torch.ones_like(d))), torch.ones_like(d))
        self.left = self.right = s
        return self


@registry.scalers.register("BINORMALIZATION")
class BinormalizationScaler(Scaler):
    """Symmetric binormalization on B = A .* A: x_i <- sqrt(x_i avg /
    (B x)_i) drives x_i (B x)_i to a constant; the scale vectors are
    sqrt(x)."""

    ITERS = 30

    def setup(self, A: CsrMatrix):
        _, cols, vals = A.coo()
        cols = cols.long()
        row_sum = _row_sum_fn(A)
        B = vals * vals
        x = torch.ones(A.num_rows, dtype=vals.dtype, device=vals.device)
        one = torch.ones_like(x)
        for _ in range(self.ITERS):
            beta = row_sum(B * x[cols])                        # B x
            avg = torch.mean(beta * x)
            pos = beta > 0
            x = torch.where(pos, torch.sqrt(x * avg / torch.where(
                pos, beta, one)), x)
        s = torch.sqrt(torch.where(x > 0, x, one))
        self.left = self.right = torch.where(x > 0, s, one)
        return self


@registry.scalers.register("NBINORMALIZATION")
class NBinormalizationScaler(Scaler):
    """Nonsymmetric binormalization: alternate row / column 2-norm
    equilibration (nbinormalization.cu's beta / gamma iteration)."""

    ITERS = 50

    def setup(self, A: CsrMatrix):
        rows, cols, vals = A.coo()
        cols = cols.long()
        n, m = A.num_rows, A.num_cols
        row_sum, col_sum = _row_sum_fn(A), _col_sum_fn(A)
        B = vals * vals
        x = torch.ones(n, dtype=vals.dtype, device=vals.device)  # left^2
        y = torch.ones(m, dtype=vals.dtype, device=vals.device)  # right^2
        for _ in range(self.ITERS):
            beta = row_sum(B * y[cols])                # scaled row norms^2
            x = torch.where(beta > 0, 1.0 / beta, torch.ones_like(beta))
            gamma = col_sum(B * x[rows])
            y = torch.where(gamma > 0, 1.0 / gamma, torch.ones_like(gamma))
        # balance, so that neither side carries all the magnitude
        scale = row_sum(B * y[cols]) * x
        mean = torch.mean(torch.where(scale > 0, scale,
                                      torch.ones_like(scale)))
        q = torch.sqrt(torch.sqrt(mean))
        self.left = torch.sqrt(x) / q
        self.right = torch.sqrt(y) / q
        return self


def make_scaler(name: str, cfg, scope: str = "default") -> Scaler:
    """ScalerFactory::allocate analog (src/core.cu:687-689)."""
    return registry.scalers.create(name, cfg, scope)
