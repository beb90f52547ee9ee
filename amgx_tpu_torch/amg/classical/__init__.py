"""Classical (Ruge-Stuben) AMG level (the port of
amgx_tpu/amg/classical/__init__.py): strength of connection -> CF split
(selector) -> interpolation P -> R = P^T -> Galerkin R A P, all on the
operator's device.

The Galerkin product takes the plan split (ops/spgemm.py) unless
`spgemm_plan=0`: the plan memoized on the level for the very tensors it
was built from (P, R and A's pattern, proved by identity), else looked
up by content in the cross-setup cache (`spgemm.get_rap_plan`), then
the value phase -- B10 for a float32 operator, the plain ordered sums
otherwise. With `cycle_fusion` the level builds the weighted
transfer tables of its fine operator (ops/smooth.py
`build_csr_transfer_tables`) on the CPU and the card alike (the JAX
package builds them only where its kernels run), so the cycle's
restriction rides B3's weighted epilogue and the prolongation B4's
weighted prologue; levels the caps decline, and every level whose
operator has no DIA view, compose the R / P products (B8 in float32).

Structure reuse (`structure_reuse_levels` on resetup): `reuse_structure`
keeps the strength, the CF split, P, R, the aggressive flag, the RAP
plan memo and (when A's DIA offsets match) the transfer tables, and the
level's `create_coarse_matrix` then runs only the Galerkin value phase.
`structure_snapshot` / `structure_restore` persist the CF split and P
(R = P^T is rebuilt on restore).

Aggressive coarsening: the first `aggressive_levels` levels take
`aggressive_selector` (DEFAULT: AGGRESSIVE_ plus the selector's name,
unless it already starts with AGGRESSIVE; an unknown name falls back to
PMIS) and `aggressive_interpolator` (an unknown name falls back to D1).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import registry
from ...matrix import CsrMatrix
from ...ops import spgemm
from ...ops.spmv import spmv
from ...ops.transpose import transpose
from ..hierarchy import AMGLevel
from . import interpolators as _interpolators  # noqa: F401
from . import selectors as _selectors  # noqa: F401
from . import strength as _strength  # noqa: F401


@registry.amg_levels.register("CLASSICAL")
class ClassicalAMGLevel(AMGLevel):
    """The strength -> CF split -> P -> R = P^T -> R A P flow; a subclass
    (ENERGYMIN) names its own selector and interpolator parameters,
    registry and fallbacks through the class attributes."""

    algorithm = "CLASSICAL"
    selector_param = "selector"
    selector_fallback = "PMIS"
    interpolator_registry = registry.interpolators
    interpolator_param = "interpolator"
    interpolator_fallback = "D1"

    strong = None
    cf_map = None
    P = None
    R = None
    rap_plan = None       # the level's RAP structure (ops/spgemm.py)
    _aggressive = False
    _reused = False       # structure reuse: Galerkin values only

    def create_coarse_vertices(self):
        cfg, scope = self.cfg, self.scope
        st = registry.strength.create(str(cfg.get("strength", scope)),
                                      cfg, scope)
        self.strong = st.strong_mask(self.A)
        name = str(cfg.get(self.selector_param, scope))
        self._aggressive = self.level_index < int(
            cfg.get("aggressive_levels", scope))
        if self._aggressive:
            agg = str(cfg.get("aggressive_selector", scope))
            if agg == "DEFAULT":
                agg = name if name.startswith("AGGRESSIVE") \
                    else "AGGRESSIVE_" + name
            name = agg
        if not registry.classical_selectors.has(name):
            name = self.selector_fallback     # the JAX package's fallback
        sel = registry.classical_selectors.create(name, cfg, scope)
        self.cf_map = sel.mark_coarse_fine_points(self.A, self.strong)
        self.coarse_size = int((self.cf_map == 1).sum())

    def create_coarse_matrix(self) -> CsrMatrix:
        if self._reused:
            return self._galerkin_rap()
        cfg, scope = self.cfg, self.scope
        name = str(cfg.get("aggressive_interpolator" if self._aggressive
                           else self.interpolator_param, scope))
        if not self.interpolator_registry.has(name):
            name = self.interpolator_fallback  # the JAX package's fallback
        interp = self.interpolator_registry.create(name, cfg, scope)
        self.P = interp.generate(self.A, self.cf_map, self.strong).init()
        self.R = transpose(self.P).init()
        self._transfer_tables()
        return self._galerkin_rap()

    def _galerkin_rap(self) -> CsrMatrix:
        """R A P through the level's plan: the memo proves the pattern by
        the identity of P, R and A's pattern tensors (a structure resetup
        on `with_values` keeps them all); anything else takes the
        content-keyed cache, which never serves a stale plan."""
        if not spgemm.plan_enabled(self.cfg, self.scope):
            return spgemm.galerkin_rap(self.R, self.A, self.P)
        memo = getattr(self, "_rap_plan_memo", None)
        if memo is None or memo[0] is not self.P or memo[1] is not self.R \
                or memo[2] is not self.A.row_offsets \
                or memo[3] is not self.A.col_indices:
            memo = self._rap_plan_memo = (
                self.P, self.R, self.A.row_offsets, self.A.col_indices,
                spgemm.get_rap_plan(self.R, self.A, self.P))
        self.rap_plan = memo[4]
        return spgemm.rap_coarse_matrix(self.rap_plan, self.A, self.R,
                                        self.P)

    def reuse_structure(self, old):
        """structure_reuse_levels: keep the old level's strength, CF
        split, P and R, its RAP plan memo, and its transfer tables when
        A's DIA offsets match (they are a function of those offsets, P
        and R). A restored level's arrays move to this level's device."""
        dev = self.A.device
        self.strong = old.strong
        self.cf_map = old.cf_map if torch.is_tensor(old.cf_map) \
            else torch.from_numpy(np.asarray(old.cf_map)).to(dev)
        self.coarse_size = old.coarse_size
        self._aggressive = old._aggressive
        self.P, self.R = old.P.to(dev), old.R.to(dev)
        memo = getattr(old, "_xfer_memo", None)
        if memo is not None and self.A.dia_offsets == old.A.dia_offsets:
            self._xfer_memo = memo
        memo = getattr(old, "_rap_plan_memo", None)
        if memo is not None:
            self._rap_plan_memo = memo
        self._reused = True

    def structure_snapshot(self):
        if self.P is None or self.coarse_size is None:
            return None
        P = self.P
        meta = {"num_rows": int(self.A.num_rows),
                "coarse_size": int(self.coarse_size),
                "aggressive": bool(self._aggressive),
                "p_rows": int(P.num_rows), "p_cols": int(P.num_cols)}
        arrays = {"cf_map": self.cf_map.cpu().numpy(),
                  "p_row_offsets": P.row_offsets.cpu().numpy(),
                  "p_col_indices": P.col_indices.cpu().numpy(),
                  "p_values": P.values.cpu().numpy()}
        return meta, arrays

    @classmethod
    def structure_restore(cls, meta, arrays):
        """A ghost level on the CPU: the CF split, P from its arrays and
        R = P^T (as create_coarse_matrix builds it); no strength (only a
        fresh interpolation reads it)."""
        g = cls._ghost(meta["num_rows"])
        g.coarse_size = int(meta["coarse_size"])
        g._aggressive = bool(meta["aggressive"])
        g.cf_map = arrays["cf_map"]
        g.strong = None
        g.P = CsrMatrix.from_scipy_like(
            arrays["p_row_offsets"], arrays["p_col_indices"],
            arrays["p_values"], meta["p_rows"], meta["p_cols"]).init()
        g.R = transpose(g.P).init()
        return g

    def _transfer_tables(self):
        """The weighted transfer tables (ctab/cwt, ptab/pwt), built once
        per level; None with cycle_fusion=0 or when the level declines."""
        memo = getattr(self, "_xfer_memo", None)
        if memo is None:
            tables = None
            if bool(int(self.cfg.get("cycle_fusion", self.scope))) \
                    and self.P is not None and self.coarse_size:
                from ...ops.smooth import build_csr_transfer_tables
                tables = build_csr_transfer_tables(self.A, self.P, self.R)
            memo = self._xfer_memo = (tables,)
        return memo[0]

    def level_data(self):
        d = super().level_data()
        d["P"] = self.P
        d["R"] = self.R
        xfer = self._transfer_tables()
        if xfer is not None:
            d["xfer"] = xfer
        return d

    def supports_fusion(self, data):
        if data.get("xfer") is None or self.smoother is None:
            return ()
        return self.FUSION_CAPS

    def restrict_fused(self, data, b, x, sweeps: int):
        fn = getattr(self.smoother, "smooth_restrict", None)
        if fn is None:
            return None
        return fn(data["smoother"], b, x, sweeps, data["xfer"])

    def prolongate_smooth(self, data, b, x, xc, sweeps: int,
                          want_dot: bool = False):
        fn = getattr(self.smoother, "smooth_corr", None)
        if fn is None:
            return None
        return fn(data["smoother"], b, x, xc, sweeps, data["xfer"],
                  want_dot=want_dot)

    def restrict(self, data, r):
        return spmv(data["R"], r)

    def prolongate(self, data, xc):
        return spmv(data["P"], xc)
