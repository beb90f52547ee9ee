"""Unsmoothed-aggregation AMG level (the port of
amgx_tpu/amg/aggregation/__init__.py, GEO levels).

The selector builds an aggregates map. GEO (structured pairing) levels
restrict by per-axis pair sums and prolongate by per-axis repeats -- the
cycle_fusion=0 route -- and get the structured Galerkin product. With
cycle_fusion=1 the level's transfers ride the smoother kernels instead:
the restriction in B3's epilogue through the children table `ctab`, the
prolongation in B4's prologue through the aggregate ids `agg` (with
B4's x'.b epilogue when the Krylov shell asks for the cycle's dot), and
the coarse tail's levels through both tables inside B5. The level data
carries the stencil the hierarchy installs on a matrix-free level
(`matrix_free`), and its hooks then run the coefficient-mode kernels.
"""
from __future__ import annotations

import torch

from ... import registry
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
        pre = None
        if self.geo_axes is not None:
            pre = geo_coarse_values(self.A, self.geo_fine_shape,
                                    self.geo_axes, self.geo_coarse_shape)
        if pre is None:
            raise NotImplementedError(
                "only the structured (GEO) Galerkin product is ported: "
                "this level has no stencil DIA view on its grid")
        return geo_assemble_dia(pre[0], pre[1], self.geo_coarse_shape)

    def _geo_shapes(self):
        return geo_shapes(self.geo_fine_shape, self.geo_axes)

    def level_data(self):
        d = super().level_data()
        if self.geo_axes is None:
            d["aggregates"] = self.aggregates
        xfer = self._transfer_tables()
        if xfer is not None:
            d["xfer"] = xfer
        return d

    def _transfer_tables(self):
        """ctab/agg for the fused transfers (ops/smooth.py), built once
        per level; None with cycle_fusion=0."""
        memo = getattr(self, "_xfer_memo", None)
        if memo is None:
            tables = None
            if bool(int(self.cfg.get("cycle_fusion", self.scope))) \
                    and self.aggregates is not None and self.coarse_size:
                from ...ops.smooth import build_transfer_tables
                tables = build_transfer_tables(self.aggregates,
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
        agg = data["aggregates"].long()
        return torch.zeros(self.coarse_size, dtype=r.dtype,
                           device=r.device).index_add_(0, agg, r)

    def prolongate(self, data, xc):
        if self.geo_axes is not None:
            shapes = self._geo_shapes()
            for k in range(len(self.geo_axes) - 1, -1, -1):
                xc = _geo_prolongate(xc, shapes[k], shapes[k + 1],
                                     self.geo_axes[k])
            return xc
        return xc[data["aggregates"].long()]
