"""Classical (Ruge-Stuben) AMG level (the port of
amgx_tpu/amg/classical/__init__.py): strength of connection -> CF split
(selector) -> interpolation P -> R = P^T -> Galerkin R A P, all on the
operator's device.

The Galerkin product takes the plan split (ops/spgemm.py) unless
`spgemm_plan=0`: the structure phase once per level (memoized on it),
then the value phase -- B10 for a float32 operator, the plain ordered
sums otherwise. With `cycle_fusion` the level builds the weighted
transfer tables of its fine operator (ops/smooth.py
`build_csr_transfer_tables`) on the CPU and the card alike (the JAX
package builds them only where its kernels run), so the cycle's
restriction rides B3's weighted epilogue and the prolongation B4's
weighted prologue; levels the caps decline, and every level whose
operator has no DIA view, compose the R / P products (B8 in float32).
Structure reuse on resetup is not ported.
"""
from __future__ import annotations

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
    algorithm = "CLASSICAL"

    strong = None
    cf_map = None
    P = None
    R = None
    rap_plan = None       # the level's RAP structure (ops/spgemm.py)

    def create_coarse_vertices(self):
        cfg, scope = self.cfg, self.scope
        if self.level_index < int(cfg.get("aggressive_levels", scope)):
            raise NotImplementedError(
                "aggressive coarsening (aggressive_levels > 0) is not "
                "ported yet (see ROADMAP.md)")
        st = registry.strength.create(str(cfg.get("strength", scope)),
                                      cfg, scope)
        self.strong = st.strong_mask(self.A)
        name = str(cfg.get("selector", scope))
        if not registry.classical_selectors.has(name):
            name = "PMIS"             # the JAX package's fallback
        sel = registry.classical_selectors.create(name, cfg, scope)
        self.cf_map = sel.mark_coarse_fine_points(self.A, self.strong)
        self.coarse_size = int((self.cf_map == 1).sum())

    def create_coarse_matrix(self) -> CsrMatrix:
        cfg, scope = self.cfg, self.scope
        name = str(cfg.get("interpolator", scope))
        if not registry.interpolators.has(name):
            name = "D1"               # the JAX package's fallback
        interp = registry.interpolators.create(name, cfg, scope)
        self.P = interp.generate(self.A, self.cf_map, self.strong).init()
        self.R = transpose(self.P).init()
        self._transfer_tables()
        return self._galerkin_rap()

    def _galerkin_rap(self) -> CsrMatrix:
        if not spgemm.plan_enabled(self.cfg, self.scope):
            return spgemm.galerkin_rap(self.R, self.A, self.P)
        Ac, self.rap_plan = spgemm.planned_rap(self.R, self.A, self.P)
        return Ac

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
