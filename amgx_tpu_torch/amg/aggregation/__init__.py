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
prolongates by a gather. A GEO level's product goes through its
`GeoRapPlan` (galerkin.py), memoized on the level (`_geo_plan_memo`).
The relabel plan is memoized on the level for the tensors it was built
from and otherwise looked up in the cross-setup cache
(ops/spgemm.py `get_agg_plan`). `reuse_structure` carries the
aggregates, the grid fields and both plan memos into a structure-reuse
resetup's new level, which then reruns only the value phase;
`structure_snapshot` / `structure_restore` persist what it reads. With
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

import numpy as np
import torch

from ... import registry
from ...ops import spgemm
from ...ops.cuda_spmv import restrict_plain
from ...ops.smooth import (build_transfer_tables, children_index,
                           children_table, restrict_children)
from ..hierarchy import AMGLevel
from . import selectors  # noqa: F401  (registers the selectors)
from .galerkin import get_geo_plan, geo_shapes, pair_sum_axis


def _geo_restrict(r, fine_shape, axis):
    """Pair-sum along one grid axis (x fastest in the linear index); r
    may carry a leading batch axis."""
    nx, ny, nz = fine_shape
    lead = r.shape[:-1]
    g = r.reshape(lead + (nz, ny, nx))
    if lead:
        # pair_sum_axis reads the grid's three axes last to first
        return torch.stack([pair_sum_axis(v, fine_shape[axis], axis)
                            for v in g]).reshape(lead + (-1,))
    return pair_sum_axis(g, fine_shape[axis], axis).reshape(-1)


def _geo_prolongate(xc, fine_shape, coarse_shape, axis):
    """Repeat each coarse value on both fine points of its pair; xc may
    carry a leading batch axis."""
    nx, ny, nz = coarse_shape
    lead = xc.shape[:-1]
    dims = len(lead) + 2 - axis
    out = xc.reshape(lead + (nz, ny, nx)).repeat_interleave(2, dim=dims)
    return out.narrow(dims, 0, fine_shape[axis]).reshape(lead + (-1,))


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
            # the memo names the plan that built this level's coarse
            # operator, and no other (the value resetup splices into it)
            self._geo_plan_memo = None
            plan = get_geo_plan(self.A, self.geo_fine_shape, self.geo_axes,
                                self.geo_coarse_shape)
            Ac = None if plan is None else plan.coarse_matrix(self.A)
            if Ac is not None:
                self._geo_plan_memo = (plan,)
                return Ac
        Ac = self._relabel_planned()
        if self.geo_coarse_shape is not None:
            Ac = dataclasses.replace(Ac, grid_shape=self.geo_coarse_shape)
        return Ac

    def _relabel_planned(self):
        """The relabel Galerkin through the level's plan: the memo holds
        the tensors it was built from and is reused only for those same
        objects, so a structure-reuse resetup (same aggregates, same
        pattern tensors, new values) reruns only the value phase; other
        tensors look the plan up by content (`spgemm.get_agg_plan`)."""
        memo = getattr(self, "_rap_plan_memo", None)
        if memo is None or memo[0] is not self.aggregates \
                or memo[1] is not self.A.row_offsets \
                or memo[2] is not self.A.col_indices:
            plan = spgemm.get_agg_plan(self.A, self.aggregates,
                                       int(self.coarse_size))
            memo = self._rap_plan_memo = (self.aggregates,
                                          self.A.row_offsets,
                                          self.A.col_indices, plan)
        return spgemm.plan_coarse_matrix(memo[3], self.A)

    def reuse_structure(self, old):
        """structure_reuse_levels: keep the old level's aggregates, grid
        fields and plan memos; no selector runs. A restored level's
        aggregates (numpy) move to this level's device."""
        agg = old.aggregates
        if agg is not None and not torch.is_tensor(agg):
            agg = torch.from_numpy(np.asarray(agg)).to(self.A.device)
        self.aggregates = agg
        self.coarse_size = old.coarse_size
        self.geo_axes = old.geo_axes
        self.geo_fine_shape = old.geo_fine_shape
        self.geo_coarse_shape = old.geo_coarse_shape
        # the transfer tables too (each memo names the aggregates it was
        # built from): every system of a multi-matrix batch then shares
        # them by identity (batch/core.py `stack_solve_datas`)
        for attr in ("_rap_plan_memo", "_geo_plan_memo", "_children_memo",
                     "_xfer_memo"):
            memo = getattr(old, attr, None)
            if memo is not None:
                setattr(self, attr, memo)

    def structure_snapshot(self):
        if self.coarse_size is None:
            return None

        def listed(v):
            return None if v is None else [int(e) for e in v]

        meta = {"num_rows": int(self.A.num_rows),
                "coarse_size": int(self.coarse_size),
                "geo_axes": listed(self.geo_axes),
                "geo_fine_shape": listed(self.geo_fine_shape),
                "geo_coarse_shape": listed(self.geo_coarse_shape)}
        arrays = {}
        if self.aggregates is not None:
            arrays["aggregates"] = self.aggregates.cpu().numpy()
        return meta, arrays

    @classmethod
    def structure_restore(cls, meta, arrays):
        g = cls._ghost(meta["num_rows"])
        g.coarse_size = int(meta["coarse_size"])
        g.aggregates = arrays.get("aggregates")
        for k in ("geo_axes", "geo_fine_shape", "geo_coarse_shape"):
            setattr(g, k, None if meta[k] is None else tuple(meta[k]))
        return g

    def batch_refusal(self):
        return None

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
        has_dia = self.A.dia_offsets is not None
        if memo is None or memo[0] is not self.aggregates \
                or memo[1] != has_dia:
            tables = None
            if bool(int(self.cfg.get("cycle_fusion", self.scope))) \
                    and self.aggregates is not None and self.coarse_size:
                tables = build_transfer_tables(self.A, self.aggregates,
                                               int(self.coarse_size))
            memo = self._xfer_memo = (self.aggregates, has_dia, tables)
        return memo[2]

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
        xfer = data.get("xfer")
        if self.geo_axes is not None and r.dim() == 2 and xfer is not None:
            # a batch restricts through the children table, each coarse
            # row's children added in ascending fine index (the JAX
            # package's `restrict_multi`)
            return restrict_plain(xfer["ctab"], r)
        if self.geo_axes is not None:
            shapes = self._geo_shapes()
            for k, a in enumerate(self.geo_axes):
                r = _geo_restrict(r, shapes[k], a)
            return r
        return restrict_children(data["children"], r)

    def prolongate(self, data, xc):
        xfer = data.get("xfer")
        if self.geo_axes is not None and xc.dim() == 2 and xfer is not None:
            # `prolong_corr_multi`'s aggregate gather
            return xc[..., xfer["agg"].long()]
        if self.geo_axes is not None:
            shapes = self._geo_shapes()
            for k in range(len(self.geo_axes) - 1, -1, -1):
                xc = _geo_prolongate(xc, shapes[k], shapes[k + 1],
                                     self.geo_axes[k])
            return xc
        return xc[..., data["aggregates"]]
