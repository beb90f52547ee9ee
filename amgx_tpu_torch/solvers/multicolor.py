"""Multicolor smoothers (the port of amgx_tpu/solvers/multicolor.py):
MULTICOLOR_GS (with `symmetric_GS`), FIXCOLOR_GS, MULTICOLOR_DILU,
MULTICOLOR_ILU, the serial GS and CF_JACOBI.

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

MULTICOLOR_ILU factors the color-permuted matrix P A P^T by Chow-Patel
fixed-point sweeps (min(colors, 24) + 1 of them, each a pattern-
restricted L U product, ops/spgemm.py `csr_multiply`), on the pattern
of A or, with `ilu_sparsity_level` k > 0, A joined with k rounds of
level fill (`csr_add`); fill must join rows of different colors, so
k > 0 needs `coloring_level=2` and anything else raises. The factors
are kept in the original order, CSR without a DIA view, and the sweeps
are masked SpMVs with them (B8 in float32), colors ascending for L y =
r and descending for U z = y.

GS is the serial natural-order sweep (`GS_L1_variant`: the L1-
strengthened diagonal): one K6 launch a sweep on the card (ops/gs.py).
CF_JACOBI sweeps the F points and then the C points of the level's CF
split (`cf_smoothing_mode` 0: C first; 1: F first); the AMG hierarchy
hands it the split (`needs_cf_map` / `set_cf_map`), and without one its
setup raises.

The port's matrices are scalar; a block matrix raises and names
ROADMAP.md Queue A item 8.4.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import registry
from ..errors import BadParametersError
from ..matrix import CsrMatrix
from ..ops.coloring import color_matrix
from ..ops.gs import gs_sweep
from ..ops.segment import ordered_sum, ordered_sum_plan
from ..ops.spgemm import csr_add, csr_multiply
from ..ops.spmv import spmv
from .base import Solver
from .relaxation import l1_strengthened_diag, safe_recip


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
            f"(ROADMAP.md Queue A item 8.4)")


class _ColoredSolver(Solver):
    """Shared coloring plumbing (Solver::setup colors the matrix when
    isColoringNeeded(), include/solvers/solver.h:140)."""

    is_smoother = True

    def __init__(self, cfg, scope="default", name="?", device=None):
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
                 device=None):
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


def csr_only(M: CsrMatrix) -> CsrMatrix:
    """M initialized without a DIA view: its SpMVs take the CSR route (B8
    in float32), as the JAX package's `init(ell="never")` factors do."""
    return dataclasses.replace(M.init(), dia_offsets=None, dia_vals=None)


@registry.solvers.register("MULTICOLOR_ILU")
class MulticolorILUSolver(_ColoredSolver):
    """ILU(k) on the color-permuted matrix (multicolor_ilu_solver.cu)."""

    def __init__(self, cfg, scope="default", name="MULTICOLOR_ILU",
                 device=None):
        super().__init__(cfg, scope, name, device)
        self.sparsity_level = int(cfg.get("ilu_sparsity_level", scope))

    def solver_setup(self):
        _scalar_only(self.A, self.name)
        self._color()
        A, n = self.A, self.A.num_rows
        dev = A.device
        colors = self.row_colors.long()
        # color-sorted order: position p holds original row perm[p]
        perm = torch.argsort(colors, stable=True)
        iperm = torch.empty_like(perm)
        iperm[perm] = torch.arange(n, device=dev)
        rows, cols, vals = A.coo()
        Ap = CsrMatrix.from_coo(iperm[rows], iperm[cols.long()], vals, n, n)
        if self.sparsity_level > 0:
            Ap = self._extend_pattern(Ap)
        rows, cols, vals = Ap.coo()
        cols = cols.long()
        colors_p = colors[perm]
        if bool(((rows != cols) & (colors_p[rows] == colors_p[cols])).any()):
            raise BadParametersError(
                "MULTICOLOR_ILU: fill pattern joins same-colored rows; "
                "use coloring_level=2 (distance-2 coloring) with "
                f"ilu_sparsity_level={self.sparsity_level}")
        lower = rows > cols
        upper = ~lower
        keys = rows * n + cols
        zero = torch.zeros_like(vals)
        didx = Ap.diag_index()          # nnz where a row has no diagonal
        # the standard Chow-Patel start: l = a_ij / a_jj, u = a_ij
        l = torch.where(lower, vals * safe_recip(Ap.diagonal())[cols], zero)
        u = torch.where(upper, vals, zero)

        def u_diag_of(u):
            return torch.cat([u, u.new_zeros(1)])[didx]

        for _ in range(min(self.num_colors, 24) + 1):
            P = csr_multiply(
                CsrMatrix.from_coo(rows[lower], cols[lower], l[lower], n, n),
                CsrMatrix.from_coo(rows[upper], cols[upper], u[upper], n, n))
            pr, pc, pv = P.coo()
            if pv.numel():
                pkeys = pr * n + pc.long()
                pos = torch.searchsorted(pkeys, keys).clamp_(
                    0, pkeys.numel() - 1)
                prod = torch.where(pkeys[pos] == keys, pv[pos], zero)
            else:
                prod = zero
            # (L_strict U)_ij holds the k = j term l_ij u_jj for i > j
            u_jj = u_diag_of(u)[cols]
            l = torch.where(lower, safe_recip(u_jj) * (vals - (prod - l * u_jj)),
                            zero)
            u = torch.where(upper, vals - prod, zero)
        # the factors in the original order: a proper coloring has no
        # same-color couplings, so the color-masked sweeps do not depend
        # on the ordering
        self._Lp = csr_only(CsrMatrix.from_coo(
            perm[rows[lower]], perm[cols[lower]], l[lower], n, n))
        self._Up = csr_only(CsrMatrix.from_coo(
            perm[rows[upper]], perm[cols[upper]], u[upper], n, n))
        u_diag = torch.empty(n, dtype=vals.dtype, device=dev)
        u_diag[perm] = u_diag_of(u)
        self._u_diag = u_diag

    def _extend_pattern(self, Ap: CsrMatrix) -> CsrMatrix:
        """A joined with the pattern of L U (zero values on the fill),
        `sparsity_level` times."""
        n = Ap.num_rows
        for _ in range(self.sparsity_level):
            rows, cols, vals = Ap.coo()
            cols = cols.long()
            lo, up = rows > cols, rows < cols
            ones = torch.ones_like(vals)
            F = csr_multiply(
                CsrMatrix.from_coo(rows[lo], cols[lo], ones[lo], n, n),
                CsrMatrix.from_coo(rows[up], cols[up], ones[up], n, n))
            fr, fc, _ = F.coo()
            Ap = csr_add(Ap, CsrMatrix.from_coo(
                fr, fc.long(), torch.zeros(fr.numel(), dtype=vals.dtype,
                                           device=vals.device), n, n))
        return Ap

    def solve_data(self):
        d = super().solve_data()
        d.update(ilu_L=self._Lp, ilu_U=self._Up, u_diag=self._u_diag)
        return d

    def solve_iteration(self, data, b, st):
        A, Lp, Up, masks = data["A"], data["ilu_L"], data["ilu_U"], \
            data["masks"]
        u_dinv = safe_recip(data["u_diag"])
        x = st["x"]
        r = b - spmv(A, x)
        # L y = r (unit diagonal), colors ascending
        y = torch.zeros_like(r)
        for mask in masks:
            y = torch.where(mask, r - spmv(Lp, y), y)
        # U z = y, colors descending
        z = torch.zeros_like(r)
        for mask in reversed(masks):
            z = torch.where(mask, u_dinv * (y - spmv(Up, z)), z)
        out = dict(st)
        out["x"] = x + self.relaxation_factor * z
        return out


@registry.solvers.register("GS")
class GSSolver(Solver):
    """Serial natural-order Gauss-Seidel (gauss_seidel_solver.cu): one K6
    launch a sweep on the card. n sequential rows: MULTICOLOR_GS is the
    parallel smoother for large operators."""

    is_smoother = True

    def __init__(self, cfg, scope="default", name="GS", device=None):
        super().__init__(cfg, scope, name, device)
        self.relaxation_factor = float(cfg.get("relaxation_factor", scope))
        self._l1 = bool(int(cfg.get("GS_L1_variant", scope)))

    def solver_setup(self):
        _scalar_only(self.A, self.name)
        self._gs_diag = l1_strengthened_diag(self.A) if self._l1 \
            else self.A.diagonal()
        self._dinv = safe_recip(self._gs_diag)

    def solve_data(self):
        d = super().solve_data()
        d.update(gs_diag=self._gs_diag, dinv=self._dinv)
        return d

    def computes_residual(self):
        return False

    def solve_iteration(self, data, b, st):
        A = data["A"]
        out = dict(st)
        out["x"] = gs_sweep(A.row_offsets, A.col_indices, A.values, b,
                            data["gs_diag"], data["dinv"], st["x"],
                            self.relaxation_factor)
        return out


@registry.solvers.register("CF_JACOBI")
class CFJacobiSolver(Solver):
    """CF-ordered Jacobi for classical AMG (cf_jacobi_solver.cu): a sweep
    updates one point class, then the other, each from a fresh residual
    (`cf_smoothing_mode` 0: C then F; 1: F then C)."""

    is_smoother = True
    needs_cf_map = True

    def __init__(self, cfg, scope="default", name="CF_JACOBI", device=None):
        super().__init__(cfg, scope, name, device)
        self.relaxation_factor = float(cfg.get("relaxation_factor", scope))
        self.mode = int(cfg.get("cf_smoothing_mode", scope))
        self.cf_map = None

    def set_cf_map(self, cf_map):
        self.cf_map = None if cf_map is None else torch.as_tensor(cf_map)

    def solver_setup(self):
        _scalar_only(self.A, self.name)
        if self.cf_map is None:
            raise BadParametersError(
                "CF_JACOBI needs the CF map of a classical AMG level "
                "(use it as a smoother under algorithm=CLASSICAL)")
        self._dinv = safe_recip(self.A.diagonal())

    def solve_data(self):
        d = super().solve_data()
        d["dinv"] = self._dinv
        d["is_coarse"] = self.cf_map.to(self.A.device) == 1
        return d

    def computes_residual(self):
        return False

    def solve_iteration(self, data, b, st):
        A, dinv, coarse = data["A"], data["dinv"], data["is_coarse"]
        w = self.relaxation_factor
        x = st["x"]
        for mask in ((coarse, ~coarse) if self.mode == 0
                     else (~coarse, coarse)):
            r = b - spmv(A, x)
            x = torch.where(mask, x + w * dinv * r, x)
        out = dict(st)
        out["x"] = x
        return out
