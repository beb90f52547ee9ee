"""Unsmoothed-aggregation AMG level (the port of
amgx_tpu/amg/aggregation/__init__.py).

The selector builds an aggregates map. GEO (structured pairing) levels
restrict by per-axis pair sums and prolongate by per-axis repeats -- the
cycle_fusion=0 route -- and get the structured Galerkin product. Every
other level (the matching selectors SIZE_2/4/8, MULTI_PAIRWISE, DUMMY)
gets the relabel Galerkin product through a plan memoized on the level
(ops/spgemm.py `AggPlan`; its value phase is B10's relabel form in
float32), restricts through its children table (each coarse row's fine
rows added in ascending order: deterministic on the card) and
prolongates by a gather. `reuse_structure` carries the aggregates, the
grid fields and the plan memo into a structure-reuse resetup's new
level, which then reruns only the relabel value phase. With
cycle_fusion=1 the level's transfers ride the smoother kernels instead:
the restriction in B3's epilogue through the children table `ctab`, the
prolongation in B4's prologue through the aggregate ids `agg` (with
B4's x'.b epilogue when the Krylov shell asks for the cycle's dot), and
the coarse tail's levels through both tables inside B5. The level data
carries the stencil the hierarchy installs on a matrix-free level
(`matrix_free`), and its hooks then run the coefficient-mode kernels.
"""
from __future__ import annotations

import dataclasses

from ... import registry
from ...ops import spgemm
from ...ops.smooth import (build_transfer_tables, children_index,
                           children_table, restrict_children)
from ..hierarchy import AMGLevel
from . import selectors  # noqa: F401  (registers the selectors)
from .galerkin import (geo_assemble_dia, geo_coarse_values, geo_shapes,
                       pair_sum_axis)


def _geo_restrict(r, fine_shape, axis):
    """Pair-sum along one grid axis (x fastest in the linear index)."""
    nx, ny, nz = fine_shape
    return pair_sum_axis(r.reshape(nz, ny, nx), fine_shape[axis],
                         axis).reshape(-1)


def _geo_prolongate(xc, fine_shape, coarse_shape, axis):
    """Repeat each coarse value on both fine points of its pair."""
    nx, ny, nz = coarse_shape
    dims = 2 - axis
    out = xc.reshape(nz, ny, nx).repeat_interleave(2, dim=dims)
    return out.narrow(dims, 0, fine_shape[axis]).reshape(-1)


@registry.amg_levels.register("AGGREGATION")
class AggregationAMGLevel(AMGLevel):
    algorithm = "AGGREGATION"
    matrix_free = True

    geo_axes = None          # set when the selector pairs geometrically
    geo_fine_shape = None
    geo_coarse_shape = None
    aggregates = None

    def create_coarse_vertices(self):
        sel = registry.aggregation_selectors.create(
            str(self.cfg.get("selector", self.scope)), self.cfg, self.scope)
        self.aggregates, self.coarse_size = sel.set_aggregates(self.A)
        if getattr(sel, "pair_axes", None) is not None:
            self.geo_axes = sel.pair_axes
            self.geo_fine_shape = sel.fine_shape
            self.geo_coarse_shape = sel.coarse_shape

    def create_coarse_matrix(self):
        if self.geo_axes is not None:
            pre = geo_coarse_values(self.A, self.geo_fine_shape,
                                    self.geo_axes, self.geo_coarse_shape)
            if pre is not None:
                return geo_assemble_dia(pre[0], pre[1],
                                        self.geo_coarse_shape)
        Ac = self._relabel_planned()
        if self.geo_coarse_shape is not None:
            Ac = dataclasses.replace(Ac, grid_shape=self.geo_coarse_shape)
        return Ac

    def _relabel_planned(self):
        """The relabel Galerkin through the level's plan, built once per
        (aggregates, A's pattern): the memo holds the tensors it was
        built from and is reused only for those same objects, so a
        structure-reuse resetup (same aggregates, same pattern tensors,
        new values) reruns only the value phase."""
        memo = getattr(self, "_rap_plan_memo", None)
        if memo is None or memo[0] is not self.aggregates \
                or memo[1] is not self.A.row_offsets \
                or memo[2] is not self.A.col_indices:
            plan = spgemm.build_agg_plan(self.A, self.aggregates,
                                         int(self.coarse_size))
            memo = self._rap_plan_memo = (self.aggregates,
                                          self.A.row_offsets,
                                          self.A.col_indices, plan)
        return spgemm.plan_coarse_matrix(memo[3], self.A)

    def reuse_structure(self, old):
        """structure_reuse_levels: keep the old level's aggregates, grid
        fields and relabel plan; no selector runs."""
        self.aggregates = old.aggregates
        self.coarse_size = old.coarse_size
        self.geo_axes = old.geo_axes
        self.geo_fine_shape = old.geo_fine_shape
        self.geo_coarse_shape = old.geo_coarse_shape
        memo = getattr(old, "_rap_plan_memo", None)
        if memo is not None:
            self._rap_plan_memo = memo

    def _geo_shapes(self):
        return geo_shapes(self.geo_fine_shape, self.geo_axes)

    def level_data(self):
        d = super().level_data()
        if self.geo_axes is None:
            d["children"], d["aggregates"] = self._children()
        xfer = self._transfer_tables()
        if xfer is not None:
            d["xfer"] = xfer
        return d

    def _children(self):
        """(children index table, int64 aggregates): what the unfused
        restriction and prolongation read, built once per level."""
        memo = getattr(self, "_children_memo", None)
        if memo is None or memo[0] is not self.aggregates:
            agg = self.aggregates.long()
            memo = self._children_memo = (self.aggregates, children_index(
                children_table(agg, int(self.coarse_size)), agg.shape[0]),
                agg)
        return memo[1:]

    def _transfer_tables(self):
        """ctab/agg for the fused transfers (ops/smooth.py), built once
        per level; None with cycle_fusion=0, on a level without a DIA
        view or with an aggregate of more than TRANSFER_MAX_CHILD rows."""
        memo = getattr(self, "_xfer_memo", None)
        if memo is None:
            tables = None
            if bool(int(self.cfg.get("cycle_fusion", self.scope))) \
                    and self.aggregates is not None and self.coarse_size:
                tables = build_transfer_tables(self.A, self.aggregates,
                                               int(self.coarse_size))
            memo = self._xfer_memo = (tables,)
        return memo[0]

    def supports_fusion(self, data):
        """The fused transfers; a matrix-free level (its stencil installed
        by the hierarchy's detector) also advertises "matrix_free": its
        hooks run the coefficient-mode kernels."""
        if self.smoother is None:
            return ()
        if "stencil" in data:
            return self.FUSION_CAPS | {"matrix_free"}
        return self.FUSION_CAPS

    def restrict_fused(self, data, b, x, sweeps: int):
        fn = getattr(self.smoother, "smooth_restrict", None)
        if fn is None:
            return None
        return fn(data["smoother"], b, x, sweeps, data.get("xfer"))

    def prolongate_smooth(self, data, b, x, xc, sweeps: int,
                          want_dot: bool = False):
        fn = getattr(self.smoother, "smooth_corr", None)
        if fn is None:
            return None
        return fn(data["smoother"], b, x, xc, sweeps, data.get("xfer"),
                  want_dot=want_dot)

    def restrict(self, data, r):
        if self.geo_axes is not None:
            shapes = self._geo_shapes()
            for k, a in enumerate(self.geo_axes):
                r = _geo_restrict(r, shapes[k], a)
            return r
        return restrict_children(data["children"], r)

    def prolongate(self, data, xc):
        if self.geo_axes is not None:
            shapes = self._geo_shapes()
            for k in range(len(self.geo_axes) - 1, -1, -1):
                xc = _geo_prolongate(xc, shapes[k], shapes[k + 1],
                                     self.geo_axes[k])
            return xc
        return xc[data["aggregates"]]
