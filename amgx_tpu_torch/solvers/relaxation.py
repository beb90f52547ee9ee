"""Pointwise relaxation solvers (the port of amgx_tpu/solvers/relaxation.py,
scalar matrices): damped JACOBI / BLOCK_JACOBI, JACOBI_L1 and the
identity NOSOLVER / DUMMY.

A damped-Jacobi sweep x += omega * dinv * (b - A x) is the smoother
kernels' step with every tau equal to omega and the dinv operand, so the
fused hooks run through B2-B4 (ops/smooth.py) and the coarse tail (B5)
like CHEBYSHEV_POLY's, with `fused_smoother=0` or a level the kernels do
not take composing the sweeps here. The port's matrices are scalar: the
block variants of the JAX package have nothing to act on yet.
"""
from __future__ import annotations

import torch

from .. import registry
from ..ops import smooth as fused
from ..ops.segment import segment_sum
from ..ops.spmv import spmv
from .base import Solver


def safe_recip(d):
    """Elementwise 1/d with 0 -> 0 (zero diagonals stay inert)."""
    return torch.where(d == 0, torch.zeros_like(d),
                       1.0 / torch.where(d == 0, torch.ones_like(d), d))


def l1_strengthened_diag(A):
    """The diagonal strengthened by the off-diagonal row L1 norm in the
    diagonal's sign (jacobi_l1_solver.cu); zero diagonals stay zero. The
    row sums are ordered (ops/segment.py), so dinv has the same bits on
    the CPU and on the card, run after run."""
    rows, cols, vals = A.coo()
    off = torch.where(rows != cols.long(), vals.abs(),
                      torch.zeros_like(vals))
    l1 = segment_sum(off, rows, A.num_rows)
    d = A.diagonal()
    return d + torch.sign(d) * l1


class _FusedJacobiMixin:
    """Fused smooth / smooth_residual / transfer hooks for the scalar
    damped-Jacobi solvers, through the smoother kernels with dinv."""

    is_smoother = True

    def __init__(self, cfg, scope="default", name="?", device="cpu"):
        super().__init__(cfg, scope, name, device)
        self.relaxation_factor = float(cfg.get("relaxation_factor", scope))
        self.fused_smoother = bool(int(cfg.get("fused_smoother", scope)))
        self._tau_cache = {}

    def computes_residual(self):
        return False

    def solve_data(self):
        d = super().solve_data()
        d["dinv"] = self._dinv
        return d

    def solve_iteration(self, data, b, st):
        r = b - spmv(data["A"], st["x"])
        out = dict(st)
        out["x"] = st["x"] + self.relaxation_factor * (data["dinv"] * r)
        return out

    def _fused_taus(self, sweeps: int, like):
        """`sweeps` copies of omega, made once per (sweeps, dtype)."""
        key = (sweeps, like.dtype)
        if key not in self._tau_cache:
            self._tau_cache[key] = torch.full(
                (max(sweeps, 0),), self.relaxation_factor, dtype=like.dtype,
                device=like.device)
        return self._tau_cache[key]

    def _fused_ok(self, data, sweeps):
        return sweeps > 0 and self.fused_smoother and "dinv" in data

    def smooth(self, data, b, x, sweeps: int):
        if self._fused_ok(data, sweeps):
            out = fused.fused_smooth(data, b, x, self._fused_taus(sweeps, x),
                                     dinv=data["dinv"], with_residual=False)
            if out is not None:
                return out
        return super().smooth(data, b, x, sweeps)

    def smooth_residual(self, data, b, x, sweeps: int):
        if self._fused_ok(data, sweeps):
            out = fused.fused_smooth(data, b, x, self._fused_taus(sweeps, x),
                                     dinv=data["dinv"], with_residual=True)
            if out is not None:
                return out
        return super().smooth_residual(data, b, x, sweeps)

    # -- cycle fusion (AMGLevel.restrict_fused / prolongate_smooth) ----
    def smooth_restrict(self, data, b, x, sweeps: int, xfer):
        if not self._fused_ok(data, sweeps):
            return None
        return fused.fused_smooth_restrict(
            data, b, x, self._fused_taus(sweeps, x), xfer, dinv=data["dinv"])

    def smooth_corr(self, data, b, x, xc, sweeps: int, xfer,
                    want_dot: bool = False):
        if not self._fused_ok(data, sweeps):
            return None
        return fused.fused_corr_smooth(
            data, b, x, xc, self._fused_taus(sweeps, x), xfer,
            dinv=data["dinv"], want_dot=want_dot)

    def fused_tail_spec(self, data, sweeps: int, dtype):
        """(taus, dinv) for the coarse-tail kernel, or None when this
        smoother does not ride it."""
        if not self.fused_smoother or "dinv" not in data:
            return None
        return (self._fused_taus(max(sweeps, 0), data["dinv"]).to(dtype),
                data["dinv"])


@registry.solvers.register("BLOCK_JACOBI")
@registry.solvers.register("JACOBI")
class JacobiSolver(_FusedJacobiMixin, Solver):
    """Damped Jacobi: x += omega * D^-1 (b - A x)."""

    def solver_setup(self):
        self._dinv = safe_recip(self.A.diagonal())


@registry.solvers.register("JACOBI_L1")
class JacobiL1Solver(_FusedJacobiMixin, Solver):
    """L1-Jacobi: the diagonal strengthened by the off-diagonal row L1
    norm, so the sweep converges for every SPD matrix
    (jacobi_l1_solver.cu)."""

    def solver_setup(self):
        self._dinv = safe_recip(l1_strengthened_diag(self.A))


@registry.solvers.register("NOSOLVER")
@registry.solvers.register("DUMMY")
class NoSolver(Solver):
    """Identity 'solver' (dummy_solver.cu): x = b; as a coarse solver, no
    coarse correction (amg/cycles.py)."""

    is_smoother = True

    def computes_residual(self):
        return False

    def solve_iteration(self, data, b, st):
        out = dict(st)
        out["x"] = b
        return out

    def apply(self, data, rhs):
        return rhs

    def smooth(self, data, b, x, sweeps):
        return x
