"""Multicolor smoothers (the port of amgx_tpu/solvers/multicolor.py):
MULTICOLOR_GS (with `symmetric_GS`), FIXCOLOR_GS and MULTICOLOR_DILU.

Each color step is a masked update of the whole vector driven by one
SpMV, as in the JAX package (the reference launches one kernel per color
over that color's rows). The SpMVs go through ops/spmv.py `spmv`: B1 on
a float32 DIA level, B8 on a float32 CSR level, the plain form in
float64. The masks of the colors are made once per coloring.

- colored GS:   for c: x <- where(color == c, x + w dinv (b - A x), x);
- DILU forward: for c ascending: delta <- where(color == c,
                    Einv (r - A delta), delta), r = b - A x;
- DILU backward: for c descending: Delta <- where(color == c,
                    delta - Einv (A Delta), Delta); x += w Delta;
- DILU setup:   Einv_i = 1 / (a_ii - sum_{color_j < color_i}
                    (a_ij a_ji) Einv_j), color by color, 1/0 -> 0.

The setup's row sums are ordered (ops/segment.py), so Einv has the same
bits on the CPU and on the card, setup after setup. These smoothers have
no fused hooks: the cycle composes their sweeps and the transfers, and
the matrix-free detector leaves their levels a value slab.

The port's matrices are scalar; a block matrix, and the module's other
solvers (GS, MULTICOLOR_ILU, CF_JACOBI), raise and name ROADMAP.md
Queue A item 8.
"""
from __future__ import annotations

import torch

from .. import registry
from ..ops.coloring import color_matrix
from ..ops.segment import ordered_sum, ordered_sum_plan
from ..ops.spmv import spmv
from .base import Solver
from .relaxation import safe_recip


def _match_transpose(A):
    """For every CSR entry (i, j) the value of (j, i), or 0 where the
    pattern has none (the reference's search over row j,
    multicolor_dilu_solver.cu:740-781): int64 keys and searchsorted."""
    rows, cols, vals = A.coo()
    cols = cols.long()
    keys = rows * A.num_cols + cols
    skeys, order = torch.sort(keys, stable=True)
    want = cols * A.num_cols + rows
    pos = torch.searchsorted(skeys, want).clamp_(0, max(keys.numel() - 1,
                                                        0))
    found = skeys[pos] == want
    return torch.where(found, vals[order[pos]], torch.zeros_like(vals))


def _scalar_only(A, name):
    if A.values.dim() != 1:
        raise NotImplementedError(
            f"{name}: block matrices are not ported to amgx_tpu_torch yet "
            f"(ROADMAP.md Queue A item 8)")


class _ColoredSolver(Solver):
    """Shared coloring plumbing (Solver::setup colors the matrix when
    isColoringNeeded(), include/solvers/solver.h:140)."""

    is_smoother = True

    def __init__(self, cfg, scope="default", name="?", device="cpu"):
        super().__init__(cfg, scope, name, device)
        self.relaxation_factor = float(cfg.get("relaxation_factor", scope))
        self.row_colors = None
        self.num_colors = 0
        self._masks_memo = None

    def _color(self):
        coloring = color_matrix(self.A, self.cfg, self.scope)
        self.row_colors = coloring.row_colors
        self.num_colors = int(coloring.num_colors)

    def color_masks(self):
        """One bool mask a color, made once per coloring (a coloring
        carried in by interop.py is picked up too)."""
        memo = self._masks_memo
        if memo is None or memo[0] is not self.row_colors:
            colors = self.row_colors
            memo = self._masks_memo = (colors, tuple(
                colors == c for c in range(self.num_colors)))
        return memo[1]

    def solve_data(self):
        d = super().solve_data()
        d["colors"] = self.row_colors
        d["masks"] = self.color_masks()
        return d

    def computes_residual(self):
        return False


@registry.solvers.register("MULTICOLOR_GS")
class MulticolorGSSolver(_ColoredSolver):
    """Color-parallel Gauss-Seidel (multicolor_gauss_seidel_solver.cu);
    `symmetric_GS=1` appends the reverse color sweep."""

    def __init__(self, cfg, scope="default", name="MULTICOLOR_GS",
                 device="cpu"):
        super().__init__(cfg, scope, name, device)
        self.symmetric = bool(int(cfg.get("symmetric_GS", scope)))

    def solver_setup(self):
        _scalar_only(self.A, self.name)
        self._color()
        self._dinv = safe_recip(self.A.diagonal())

    def solve_data(self):
        d = super().solve_data()
        d["dinv"] = self._dinv
        return d

    def _color_update(self, data, b, x, c):
        r = b - spmv(data["A"], x)
        upd = x + self.relaxation_factor * (data["dinv"] * r)
        return torch.where(data["masks"][c], upd, x)

    def solve_iteration(self, data, b, st):
        x = st["x"]
        nc = self.num_colors
        for c in range(nc):
            x = self._color_update(data, b, x, c)
        if self.symmetric:
            for c in range(nc - 1, -1, -1):
                x = self._color_update(data, b, x, c)
        out = dict(st)
        out["x"] = x
        return out


@registry.solvers.register("FIXCOLOR_GS")
class FixcolorGSSolver(MulticolorGSSolver):
    """Fixed 4-color striped GS (fixcolor_gauss_seidel_solver.cu): the
    row index modulo 4 instead of a graph coloring -- valid for banded
    stencils, cheap to set up."""

    FIXED_COLORS = 4

    def _color(self):
        n = self.A.num_rows
        self.row_colors = torch.arange(
            n, dtype=torch.int32, device=self.A.device) % self.FIXED_COLORS
        self.num_colors = min(self.FIXED_COLORS, max(n, 1))


@registry.solvers.register("MULTICOLOR_DILU")
class MulticolorDILUSolver(_ColoredSolver):
    """Diagonal ILU (multicolor_dilu_solver.cu): M = (E + L) E^-1 (E + U)
    with L / U split by color order and E chosen so diag(M) = diag(A)."""

    def solver_setup(self):
        _scalar_only(self.A, self.name)
        self._color()
        A = self.A
        n = A.num_rows
        _, cols, vals = A.coo()
        cols = cols.long()
        # the reference's product order: (a_ij a_ji) Einv_j
        prod = vals * _match_transpose(A)
        d = A.diagonal()
        plan = ordered_sum_plan(A.row_offsets)
        Einv = torch.zeros_like(d)
        for mask in self.color_masks():
            # Einv_j is zero for colors >= c (the diagonal too), so only
            # the earlier colors contribute
            e = ordered_sum(prod * Einv[cols], plan, n)
            Einv = torch.where(mask, safe_recip(d - e), Einv)
        self._Einv = Einv

    def solve_data(self):
        d = super().solve_data()
        d["Einv"] = self._Einv
        return d

    def solve_iteration(self, data, b, st):
        A, Einv, masks = data["A"], data["Einv"], data["masks"]
        x = st["x"]
        r = b - spmv(A, x)
        # forward: (E + L) delta = r, colors ascending
        delta = torch.zeros_like(x)
        for mask in masks:
            delta = torch.where(mask, Einv * (r - spmv(A, delta)), delta)
        # backward: (E + U) Delta = E delta, colors descending
        Delta = torch.zeros_like(x)
        for mask in reversed(masks):
            Delta = torch.where(mask, delta - Einv * spmv(A, Delta), Delta)
        out = dict(st)
        out["x"] = x + self.relaxation_factor * Delta
        return out


class _NotPorted(Solver):
    def __init__(self, cfg, scope="default", name="?", device="cpu"):
        raise NotImplementedError(
            f"{name} is not ported to amgx_tpu_torch yet (ROADMAP.md Queue A "
            f"item 8)")


for _name in ("GS", "MULTICOLOR_ILU", "CF_JACOBI"):
    registry.solvers.register(_name)(_NotPorted)
