"""KACZMARZ smoother (the port of amgx_tpu/solvers/kaczmarz.py).

A sweep projects x onto row hyperplanes, x += w (b_i - a_i x) /
||a_i||^2 a_i^T, in the JAX package's deterministic form:

- colored (`kaczmarz_coloring_needed=1`, colors from ops/coloring.py):
  a color's rows project at once, and where rows of one color share a
  column their updates are averaged (a block-Cimmino step a color);
- naive (`kaczmarz_coloring_needed=0`): all rows at once (Cimmino).

Each projection is r = b - A x (ops/spmv.py: B1 / B8 in float32), then
the column scatter of the rows' updates. The scatter is ordered: the
entries are sorted by column once (a stable sort, so each column keeps
its rows' order) into a (columns, longest column) table padded with a
zero, and every projection gathers the table once and adds its columns
left to right, starting from 0: the sums of ops/segment.py's ordered
segment sum bit for bit (a padding zero changes no sum), the same bits on
the CPU and on the card, in one gather and one add a table column. Each
color's count of rows a column is integer and made once. The row norms
||a_i||^2 are ordered sums too.
"""
from __future__ import annotations

import torch

from .. import registry
from ..ops.coloring import color_matrix
from ..ops.segment import segment_sum, starts_from_ids
from ..ops.spmv import spmv
from .base import Solver
from .multicolor import _scalar_only
from .relaxation import safe_recip


@registry.solvers.register("KACZMARZ")
class KaczmarzSolver(Solver):

    is_smoother = True

    def __init__(self, cfg, scope="default", name="KACZMARZ", device=None):
        super().__init__(cfg, scope, name, device)
        self.relaxation_factor = float(cfg.get("relaxation_factor", scope))
        self.use_coloring = bool(int(cfg.get("kaczmarz_coloring_needed",
                                             scope)))
        self.row_colors = None
        self.num_colors = 1
        self._memo = None

    def solver_setup(self):
        A = self.A
        _scalar_only(A, self.name)
        rows, _, vals = A.coo()
        self._inv_rn2 = safe_recip(segment_sum(vals * vals, rows,
                                               A.num_rows))
        if self.use_coloring:
            coloring = color_matrix(A, self.cfg, self.scope)
            self.row_colors = coloring.row_colors
            self.num_colors = int(coloring.num_colors)
        else:
            self.row_colors = torch.zeros(A.num_rows, dtype=torch.int32,
                                          device=A.device)
            self.num_colors = 1

    def _scatter(self):
        """(each entry's row, the (columns, longest column) table of entry
        positions in column order, nnz -- a zero -- past a column's end,
        [(row mask, rows a column of that mask)] a color), made once per
        operator structure and coloring."""
        A = self.A
        memo = self._memo
        if memo is None or memo[0] is not A.col_indices \
                or memo[1] is not self.row_colors:
            rows, cols, _ = A.coo()
            cols = cols.long()
            order = torch.argsort(cols, stable=True)
            starts = starts_from_ids(cols[order], A.num_cols)
            lengths = starts[1:] - starts[:-1]
            pos = torch.arange(max(int(lengths.max()), 1),
                               device=cols.device)
            inside = pos < lengths[:, None]
            table = torch.where(inside, torch.cat([order, order.new_full(
                (1,), A.nnz)])[(starts[:-1, None] + pos).clamp(max=A.nnz)],
                A.nnz)
            masks = []
            for c in range(self.num_colors):
                mask = self.row_colors == c
                cnt = torch.bincount(cols[mask[rows]],
                                     minlength=A.num_cols)
                masks.append((mask, cnt.clamp(min=1).to(A.dtype)))
            memo = self._memo = (A.col_indices, self.row_colors,
                                 (rows, table, masks))
        return memo[2]

    def solve_data(self):
        d = super().solve_data()
        d["inv_rn2"] = self._inv_rn2
        return d

    def computes_residual(self):
        return False

    def _project(self, data, b, x, mask, cnt, scatter):
        rows, table, _ = scatter
        A = data["A"]
        r = b - spmv(A, x)
        coef = torch.where(mask, r * data["inv_rn2"], torch.zeros_like(r))
        prod = A.values * coef[rows]
        cols = torch.cat([prod, prod.new_zeros(1)])[table]
        upd = cols[:, 0] + 0.0          # 0 + the first, as the ordered sum
        for j in range(1, cols.shape[1]):
            upd = upd + cols[:, j]
        return x + self.relaxation_factor * (upd / cnt.to(upd.dtype))[
            :x.shape[0]]

    def solve_iteration(self, data, b, st):
        scatter = self._scatter()
        x = st["x"]
        for mask, cnt in scatter[2]:
            x = self._project(data, b, x, mask, cnt, scatter)
        out = dict(st)
        out["x"] = x
        return out
