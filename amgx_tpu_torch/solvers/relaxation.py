"""Pointwise relaxation solvers (the port of amgx_tpu/solvers/relaxation.py,
scalar matrices): damped JACOBI / BLOCK_JACOBI, JACOBI_L1 and the
identity NOSOLVER / DUMMY.

A damped-Jacobi sweep x += omega * dinv * (b - A x) is the smoother
kernels' step with every tau equal to omega and the dinv operand, so the
fused hooks run through B2-B4 (ops/smooth.py) and the coarse tail (B5)
like CHEBYSHEV_POLY's, with `fused_smoother=0` or a level the kernels do
not take composing the sweeps here. The port's matrices are scalar: the
block variants of the JAX package have nothing to act on yet.

Matrix-free levels: when the hierarchy's detector installed a
StencilOperator on the smoother (`_mf_stencil`, amg/hierarchy.py
`matrix_free`), solve_data carries the stencil instead of dinv and the
operator without its value slab; the kernels synthesize dinv from the
diagonal coefficient ("jacobi": JACOBI, BLOCK_JACOBI) or the
L1-strengthened diagonal ("l1": JACOBI_L1).

A batch (x, b (B, n); solve data shared or per system) smooths through
the batched kernels K2 / K4 (ops/smooth.py `fused_smooth`); float64 and
`fused_smoother=0` compose `solve_iteration`, which broadcasts dinv (n,)
or (B, n) over the rows.
"""
from __future__ import annotations

import torch

from .. import registry
from ..ops import smooth as fused
from ..ops.segment import segment_sum
from ..ops.spmv import spmv
from ..ops.stencil import mf_slim
from ..precision import compute_dtype
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
    batched_iteration = True
    # consulted by AMG._maybe_install_stencil: the sweeps need only the
    # stencil coefficients, dinv synthesized per `matrix_free_dinv`
    supports_matrix_free = True
    matrix_free_dinv = "jacobi"
    _mf_stencil = None

    def __init__(self, cfg, scope="default", name="?", device=None):
        super().__init__(cfg, scope, name, device)
        self.relaxation_factor = float(cfg.get("relaxation_factor", scope))
        self.fused_smoother = bool(int(cfg.get("fused_smoother", scope)))
        self._tau_cache = {}

    def computes_residual(self):
        return False

    def solve_data(self):
        d = super().solve_data()
        if self._mf_stencil is not None:
            d["A"] = mf_slim(d["A"])
            d["stencil"] = self._mf_stencil
            return d
        d["dinv"] = self._dinv
        return d

    def solve_iteration(self, data, b, st):
        r = b - spmv(data["A"], st["x"])
        out = dict(st)
        out["x"] = st["x"] + self.relaxation_factor * (data["dinv"] * r)
        return out

    def _fused_taus(self, sweeps: int, like, dtype=None):
        """`sweeps` copies of omega rounded to `dtype` (default: like's),
        held in its compute dtype on like's device, made once per
        (sweeps, dtype). The per-level kernels get omega in the vector's
        dtype (under a bf16 cycle omega rounded to bf16, as the JAX
        package's `_fused_taus(sweeps, x.dtype)`, then widened to
        float32 here, once); the coarse tail asks for float32."""
        dtype = like.dtype if dtype is None else dtype
        key = (sweeps, dtype)
        if key not in self._tau_cache:
            self._tau_cache[key] = torch.full(
                (max(sweeps, 0),), self.relaxation_factor, dtype=dtype,
                device=like.device).to(compute_dtype(dtype))
        return self._tau_cache[key]

    def _fused_ok(self, data, sweeps):
        return sweeps > 0 and self.fused_smoother and (
            "dinv" in data or "stencil" in data)

    def smooth(self, data, b, x, sweeps: int):
        if self._fused_ok(data, sweeps):
            out = fused.fused_smooth(data, b, x, self._fused_taus(sweeps, x),
                                     dinv=data.get("dinv"),
                                     with_residual=False)
            if out is not None:
                return out
        return super().smooth(data, b, x, sweeps)

    def smooth_residual(self, data, b, x, sweeps: int):
        if self._fused_ok(data, sweeps):
            out = fused.fused_smooth(data, b, x, self._fused_taus(sweeps, x),
                                     dinv=data.get("dinv"),
                                     with_residual=True)
            if out is not None:
                return out
        return super().smooth_residual(data, b, x, sweeps)

    # -- cycle fusion (AMGLevel.restrict_fused / prolongate_smooth) ----
    # Under a batch (x (B, n)) both decline: the cycle composes smoothing,
    # residual and transfer, as the JAX package's vmap rules do.
    def smooth_restrict(self, data, b, x, sweeps: int, xfer):
        if not self._fused_ok(data, sweeps) or x.dim() == 2:
            return None
        return fused.fused_smooth_restrict(
            data, b, x, self._fused_taus(sweeps, x), xfer,
            dinv=data.get("dinv"))

    def smooth_corr(self, data, b, x, xc, sweeps: int, xfer,
                    want_dot: bool = False):
        if not self._fused_ok(data, sweeps) or x.dim() == 2:
            return None
        return fused.fused_corr_smooth(
            data, b, x, xc, self._fused_taus(sweeps, x), xfer,
            dinv=data.get("dinv"), want_dot=want_dot)

    def fused_tail_spec(self, data, sweeps: int, dtype):
        """(taus, dinv) for the coarse-tail kernel, or None when this
        smoother does not ride it. A matrix-free level returns dinv None:
        the kernel synthesizes it from the stencil."""
        if not self.fused_smoother:
            return None
        if "stencil" in data:
            return (self._fused_taus(max(sweeps, 0), data["stencil"].coeffs,
                                     dtype), None)
        if "dinv" not in data:
            return None
        return (self._fused_taus(max(sweeps, 0), data["dinv"], dtype),
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

    matrix_free_dinv = "l1"

    def solver_setup(self):
        self._dinv = safe_recip(l1_strengthened_diag(self.A))


@registry.solvers.register("NOSOLVER")
@registry.solvers.register("DUMMY")
class NoSolver(Solver):
    """Identity 'solver' (dummy_solver.cu): x = b; as a coarse solver, no
    coarse correction (amg/cycles.py)."""

    is_smoother = True
    batched_iteration = True

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
