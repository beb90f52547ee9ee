"""AMG hierarchy driver (the port of amgx_tpu/amg/hierarchy.py).

Setup builds the level list on the operator's device: per level the
selector's aggregates, the Galerkin coarse operator, and the smoother
(set up as soon as its level exists). The coarsest operator gets the
coarse solver (DENSE_LU by default). The cycle's coarse-tail plans
(ops/smooth.py `coarse_tail_cycle`) are cached per hierarchy and dropped
at setup.

`amg_precision=float|bfloat16` (mixed-precision preconditioning; also
set by `solve_precision`): the hierarchy is built in the operator's
dtype; `solve_data` casts every floating leaf of the level data (value
slabs, dinv, damping factors, transfer weights, a matrix-free level's
stencil coefficients) to float32 or bfloat16 and the coarse-solver
subtree to the policy's coarse dtype (float32 under bfloat16), once per
setup (memoized by leaf), as the JAX package's `_cast_leaf` does; and
`cycle` casts b and x in and the result back. Such a cycle declines the
cycle-borne dot. A bf16 cycle runs the smoother kernels' bf16 forms
(ops/cuda_spmv.py on DIA levels and weighted transfer rows,
ops/cuda_csr.py on CSR levels) and solves its coarsest level in float32
(amg/cycles.py).

`matrix_free=auto|0|1` (ops/stencil.py): after each smoother's setup
the detector checks the level's operator for a constant-coefficient
grid stencil and, when the smoother can run from coefficients alone,
installs it on the smoother; the level data then carries "stencil" and
an operator without its value slab, and every smoothing entry runs the
coefficient-mode kernels. auto turns it on for operators on a CUDA
device (the counterpart of the JAX package's "on a real TPU"), 1 on
every device, 0 never. Only levels whose transfers the coefficient
kernels carry (`AMGLevel.matrix_free`: the unit-weight aggregation
levels) take it.

`resetup(A)` (AMGX_solver_resetup) honours `structure_reuse_levels`: 0
sets up anew. -1 (all levels) or at least the depth first tries the
value-only route (value_resetup.py: a GEO / CHEBYSHEV_POLY / DENSE_LU
hierarchy recomputes its values, taus, stencil coefficients and coarse
QR with one host read; `_last_resetup_value_only` says it ran). Else
the generic reuse loop: -1 or k (the first k) rebuild those levels from
the old levels' structure (`AMGLevel.reuse_structure`: no selector
runs; aggregation and classical levels keep their plans, so only the
Galerkin value phase reruns) on the new coefficients, and set up every
level below anew; the smoothers set up on the new values and the
matrix-free detector runs again. Every build defers the GEO wrap
checks to one host read (galerkin.py `deferred_wrap_checks`) and
rebuilds without the GEO product when one fails.

Structure snapshots: `AMGLevel.structure_snapshot()` gives (JSON-able
meta, numpy arrays) of what `reuse_structure` reads, the level class's
`structure_restore(meta, arrays)` a ghost level from them, and
`AMG.adopt_structure(ghosts)` makes the next `setup` take the reuse
loop on them (discarded on a row-count mismatch).

Telemetry: each setup route is counted (`amg.setup.full`,
`amg.setup.restored`, `amg.resetup.value`, `amg.resetup.structure`) and
recorded on the flight recorder (`resetup.route`); the build's phases
are disjoint host spans (`amg.L<k>.selector`, `amg.L<k>.galerkin`,
`amg.L<k>.smoother_setup`, `amg.coarse_solver_setup`,
`amg.value_resetup`). `diagnostics` (this scope) turns on the probe
cycle (telemetry/diagnostics.py). The fault harness's
`galerkin_perturb` scales a level's coarse operator right after its
Galerkin product (resilience/faultinject.py `perturb_galerkin`).

`print_grid_stats` (read in the AMG's own scope) prints the grid table
after each setup through output.py (`grid_stats`, rendered from
`grid_stats_dict`, the JAX package's text); `convergence_analysis=k`
then prints the per-level error-propagation report of amg/analysis.py
for the first k levels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .. import registry
from ..config import Config
from ..matrix import CsrMatrix
from ..ops.stencil import StencilOperator, detect_stencil, mf_slim
from ..precision import resolve_precision
from ..profiling import trace_region
from ..resilience import faultinject as _fault
from ..telemetry import metrics as _tm


def _cast_leaf(leaf, dtype):
    """One solve-data leaf in `dtype`: a tensor, a CsrMatrix (values and
    DIA view), or a StencilOperator (its coefficients, and the host
    floats the kernels take by value rounded the same way)."""
    if isinstance(leaf, CsrMatrix):
        return leaf.astype(dtype)
    if isinstance(leaf, StencilOperator):
        host = torch.tensor(leaf.host, dtype=leaf.coeffs.dtype).to(dtype)
        return dataclasses.replace(leaf, coeffs=leaf.coeffs.to(dtype),
                                   host=tuple(host.double().tolist()))
    return leaf.to(dtype)


class AMGLevel:
    """One level: fine matrix + transfer operators + smoother. Subclasses
    implement create_coarse_vertices / create_coarse_matrix / restrict /
    prolongate."""

    algorithm = "?"
    FUSION_CAPS = frozenset({"restrict", "prolongate"})
    # may the matrix-free detector install a stencil on this level's
    # smoother? (its fused transfers must have a coefficient form)
    matrix_free = False

    def __init__(self, A: CsrMatrix, cfg: Config, scope: str,
                 level_index: int):
        self.A = A
        self.cfg = cfg
        self.scope = scope
        self.level_index = level_index
        self.smoother = None           # set by AMG setup
        self.coarse_size: Optional[int] = None

    def create_coarse_vertices(self):
        raise NotImplementedError

    def create_coarse_matrix(self) -> CsrMatrix:
        raise NotImplementedError

    def reuse_structure(self, old: "AMGLevel"):
        """Take `old`'s coarsening structure for a structure-reuse
        resetup (create_coarse_matrix then recomputes only the Galerkin
        values)."""
        raise NotImplementedError(
            f"structure reuse of {self.algorithm} levels is not implemented "
            f"(structure_reuse_levels=0 sets up anew)")

    def structure_snapshot(self):
        """(meta, arrays): what `reuse_structure` reads, as JSON-able
        scalars and numpy arrays; None where the class does not persist
        its structure."""
        return None

    @classmethod
    def structure_restore(cls, meta, arrays):
        """A ghost level from a snapshot: only what `reuse_structure`
        reads, and A.num_rows for the reuse loop's check; never solved
        with."""
        raise NotImplementedError(
            f"{cls.__name__} does not restore a structure snapshot")

    @classmethod
    def _ghost(cls, num_rows: int):
        import types
        g = cls.__new__(cls)
        g.A = types.SimpleNamespace(num_rows=int(num_rows))
        g.smoother = None
        return g

    def level_data(self) -> Dict[str, Any]:
        d = {"A": self.A}
        if self.smoother is not None:
            d["smoother"] = self.smoother.solve_data()
            st = d["smoother"].get("stencil")
            if st is not None:
                # matrix-free level: the level's operator view drops its
                # value slab too; a consumer that needs the matrix
                # rebuilds it (ops/stencil.py level_operator)
                d["A"] = mf_slim(self.A)
                d["stencil"] = st
        return d

    def restrict(self, data, r):
        raise NotImplementedError

    def prolongate(self, data, xc):
        raise NotImplementedError

    def batch_refusal(self):
        """Why a batched cycle cannot run this level, or None."""
        return (f"{self.algorithm} levels have no batched cycle yet "
                f"(ROADMAP.md Queue A item 9: classical levels)")

    # fused cycle hooks (amg/cycles.py consults supports_fusion first)
    def supports_fusion(self, data):
        return ()

    def restrict_fused(self, data, b, x, sweeps: int):
        return None

    def prolongate_smooth(self, data, b, x, xc, sweeps: int,
                          want_dot: bool = False):
        return None


def _record_route(route: str, A):
    """Flight-recorder trail of the setup-routing decision (full build vs
    value / structure resetup vs restored-from-snapshot)."""
    from ..telemetry import flightrec
    flightrec.record("resetup.route", route=route, rows=int(A.num_rows))


class AMG:
    """Hierarchy owner + setup loop (AMG<>::setup analog)."""

    def __init__(self, cfg: Config, scope: str = "default"):
        self.cfg = cfg
        self.scope = scope
        self.algorithm = str(cfg.get("algorithm", scope)).upper()
        self.max_levels = int(cfg.get("max_levels", scope))
        self.min_coarse_rows = int(cfg.get("min_coarse_rows", scope))
        self.min_fine_rows = int(cfg.get("min_fine_rows", scope))
        self.coarsen_threshold = float(cfg.get("coarsen_threshold", scope))
        self.presweeps = int(cfg.get("presweeps", scope))
        self.postsweeps = int(cfg.get("postsweeps", scope))
        self.finest_sweeps = int(cfg.get("finest_sweeps", scope))
        self.coarsest_sweeps = int(cfg.get("coarsest_sweeps", scope))
        self.dense_lu_num_rows = int(cfg.get("dense_lu_num_rows", scope))
        self.cycle_name = str(cfg.get("cycle", scope)).upper()
        self.cycle_iters = int(cfg.get("cycle_iters", scope))
        self.cycle_fusion = bool(int(cfg.get("cycle_fusion", scope)))
        self.cycle_fusion_tail_rows = int(
            cfg.get("cycle_fusion_tail_rows", scope))
        self.intensive_smoothing = bool(cfg.get("intensive_smoothing",
                                                scope))
        self.matrix_free = str(cfg.get("matrix_free", scope))
        self.precision_policy = resolve_precision(cfg, scope)
        self.print_grid_stats = bool(cfg.get("print_grid_stats", scope))
        self.convergence_analysis = int(cfg.get("convergence_analysis",
                                                scope))
        self.diagnostics = bool(int(cfg.get("diagnostics", scope)))
        self.levels: List[AMGLevel] = []
        self.coarse_solver = None
        self.coarsest_A: Optional[CsrMatrix] = None
        # (shape, entry level, dtype, device) -> coarse-tail plan
        self._tail_plans: Dict[tuple, Any] = {}
        # id(leaf) -> (leaf, cast twin): the reduced-precision solve data
        self._cast_memo: Dict[int, tuple] = {}
        # the value-only resetup's plan (value_resetup.py; False: none)
        self._vr_plan = None
        self._last_resetup_value_only = False
        self._ghost_levels = None

    def _reset_caches(self):
        self._tail_plans = {}
        self._cast_memo = {}
        self._vr_plan = None

    # -- setup -----------------------------------------------------------
    def setup(self, A: CsrMatrix):
        """Build the hierarchy on A; after `adopt_structure`, the reuse
        loop on the adopted levels instead (when A's rows match)."""
        Af = A if A.initialized else A.init()
        ghosts, self._ghost_levels = self._ghost_levels, None
        self._last_resetup_value_only = False
        if ghosts and ghosts[0].A.num_rows == Af.num_rows:
            _tm.inc("amg.setup.restored")
            _record_route("restored", Af)
            self.levels = list(ghosts)
            return self._resetup_impl(Af, -1)
        _tm.inc("amg.setup.full")
        _record_route("full", Af)
        self.levels = []
        self._reset_caches()
        self._build_levels_checked(Af, 0)
        self._finalize_setup()
        return self

    def adopt_structure(self, ghost_levels):
        """Make the next `setup` rebuild from these levels' structure
        (`structure_restore` ghosts): Galerkin values and smoothers only,
        no selector. One-shot: that setup consumes the ghosts, or
        discards them when its operator has another row count."""
        self._ghost_levels = list(ghost_levels)

    def resetup(self, A: CsrMatrix):
        """Set up on new coefficients keeping the coarsening structure of
        the first `structure_reuse_levels` levels (-1: all); 0, an empty
        hierarchy or another row count set up anew (src/amg.cu's
        structure-reuse path). Reusing every level first tries the
        value-only route, as the JAX package does."""
        reuse = int(self.cfg.get("structure_reuse_levels", self.scope))
        if reuse == 0 or not self.levels \
                or A.num_rows != self.levels[0].A.num_rows:
            return self.setup(A)
        Af = A if A.initialized else A.init()
        self._last_resetup_value_only = False
        if reuse < 0 or reuse >= len(self.levels):
            from .value_resetup import try_value_resetup
            with trace_region("amg.value_resetup"):
                if try_value_resetup(self, Af):
                    self._last_resetup_value_only = True
                    _tm.inc("amg.resetup.value")
                    _record_route("value", Af)
                    return self
        _tm.inc("amg.resetup.structure")
        _record_route("structure", Af)
        return self._resetup_impl(Af, reuse)

    def _resetup_impl(self, Af: CsrMatrix, reuse: int):
        """The generic reuse loop over the first `reuse` (-1: all) of the
        current levels, then a fresh build below them."""
        k = len(self.levels) if reuse < 0 else min(reuse, len(self.levels))
        old_levels, self.levels = self.levels, []
        self._reset_caches()
        from .aggregation.galerkin import (deferred_wrap_checks,
                                           geo_dia_disabled)

        def reuse_loop(Af):
            lvl = 0
            while lvl < k:
                old = old_levels[lvl]
                if Af.num_rows != old.A.num_rows:
                    break
                level = type(old)(Af, self.cfg, self.scope, lvl)
                level.reuse_structure(old)
                Ac = self._galerkin(level, lvl)
                self.levels.append(level)
                self._attach_level_smoother(level)
                Af = Ac if Ac.initialized else Ac.init()
                lvl += 1
            return Af, lvl

        try:
            with deferred_wrap_checks() as flush:
                Ac, lvl = reuse_loop(Af)
                failed = flush()
            if failed:
                # values that break the GEO product's invariant: the same
                # structure through the relabel product
                self.levels = []
                with geo_dia_disabled():
                    Ac, lvl = reuse_loop(Af)
        except NotImplementedError:
            self.levels = old_levels     # a refused resetup changes nothing
            raise
        self._build_levels_checked(Ac, lvl)
        self._finalize_setup()
        return self

    def _build_levels_checked(self, Af: CsrMatrix, lvl: int):
        """`_build_levels` with the GEO wrap checks read once at the end;
        a failed check rebuilds those levels with the relabel product."""
        from .aggregation.galerkin import (deferred_wrap_checks,
                                           geo_dia_disabled)
        base = list(self.levels)
        with deferred_wrap_checks() as flush:
            self._build_levels(Af, lvl)
            failed = flush()
        if failed:
            self.levels = base
            with geo_dia_disabled():
                self._build_levels(Af, lvl)

    def _build_levels(self, Af: CsrMatrix, lvl: int):
        level_cls = registry.amg_levels.get(self.algorithm)
        while True:
            n = Af.num_rows
            if (lvl + 1 >= self.max_levels
                    or n <= max(self.min_coarse_rows, 1)
                    or n < self.min_fine_rows
                    or n <= self.dense_lu_num_rows and lvl > 0):
                break
            level = level_cls(Af, self.cfg, self.scope, lvl)
            with trace_region(f"amg.L{lvl}.selector"):
                level.create_coarse_vertices()
            nc = level.coarse_size
            # stalling coarsening stops the hierarchy
            if nc <= 0 or nc >= n or (n / max(nc, 1)) < \
                    self.coarsen_threshold:
                break
            Ac = self._galerkin(level, lvl)
            self.levels.append(level)
            self._attach_level_smoother(level)
            Af = Ac if Ac.initialized else Ac.init()
            lvl += 1
        self.coarsest_A = Af

    @staticmethod
    def _galerkin(level: AMGLevel, lvl: int) -> CsrMatrix:
        """The level's coarse operator; an armed `galerkin_perturb` scales
        it (resilience/faultinject.py; inert when nothing is armed)."""
        with trace_region(f"amg.L{lvl}.galerkin"):
            Ac = level.create_coarse_matrix()
        return _fault.perturb_galerkin(Ac, lvl)

    def _smoother_spec(self, level_index: int):
        """Smoother (name, scope) for one level: fine_levels >= 0 splits
        fine_smoother / coarse_smoother, -1 uses `smoother` everywhere."""
        fine_levels = int(self.cfg.get("fine_levels", self.scope))
        if fine_levels < 0:
            return self.cfg.get_solver("smoother", self.scope)
        if level_index < fine_levels:
            return self.cfg.get_solver("fine_smoother", self.scope)
        return self.cfg.get_solver("coarse_smoother", self.scope)

    def _attach_level_smoother(self, level: AMGLevel):
        from ..solvers.base import make_solver
        name, scope = self._smoother_spec(level.level_index)
        with trace_region(f"amg.L{level.level_index}.smoother_setup"):
            level.smoother = make_solver(name, self.cfg, scope,
                                         level.A.device)
            level.smoother._owns_scaling = False
            if getattr(level.smoother, "needs_cf_map", False) and \
                    getattr(level, "cf_map", None) is not None:
                # CF_JACOBI sweeps the level's CF split
                level.smoother.set_cf_map(level.cf_map)
            level.smoother.setup(level.A)
            self._maybe_install_stencil(level)

    def _maybe_install_stencil(self, level: AMGLevel, stencil=None):
        """Install the level's StencilOperator on its smoother when the
        `matrix_free` knob is on for the operator's device, the level
        and the smoother can run matrix-free and the operator is a
        constant-coefficient grid stencil (`stencil`, when given, is the
        one another implementation detected). The smoother's
        `_mf_stencil` is always reassigned, so no stale stencil survives
        a setup with new values."""
        sm = level.smoother
        on = self.matrix_free == "1" or (self.matrix_free == "auto"
                                         and level.A.device.type == "cuda")
        if not on or not level.matrix_free \
                or not getattr(sm, "supports_matrix_free", False) \
                or not getattr(sm, "fused_smoother", False):
            sm._mf_stencil = None
            return
        sm._mf_stencil = stencil if stencil is not None else detect_stencil(
            level.A, dinv_mode=sm.matrix_free_dinv)

    def _finalize_setup(self):
        from ..solvers.base import make_solver
        cs_name, cs_scope = self.cfg.get_solver("coarse_solver", self.scope)
        with trace_region("amg.coarse_solver_setup"):
            self.coarse_solver = make_solver(cs_name, self.cfg, cs_scope,
                                             self.coarsest_A.device)
            self.coarse_solver._owns_scaling = False
            self.coarse_solver.setup(self.coarsest_A)
        if self.print_grid_stats:
            from ..output import amgx_printf
            amgx_printf(self.grid_stats())
        if self.convergence_analysis > 0 and self.levels:
            # convergence_analysis.cu: an instrumented error-propagation
            # cycle over the first `convergence_analysis` levels
            from ..output import amgx_printf
            from .analysis import convergence_analysis
            amgx_printf(convergence_analysis(self) + "\n")

    # -- solve -------------------------------------------------------------
    def solve_data(self) -> Dict[str, Any]:
        data = {"levels": [lv.level_data() for lv in self.levels],
                "coarse": self.coarse_solver.solve_data()}
        dt = self.precision_policy.cast_dtype
        if dt is None:
            return data
        return {"levels": self._cast(data["levels"], dt),
                "coarse": self._cast(data["coarse"],
                                     self.precision_policy.coarse_dtype)}

    def _cast(self, tree, dtype):
        """`tree` with every floating tensor, CsrMatrix and stencil's
        coefficients in `dtype`; each leaf is cast once per setup."""
        if isinstance(tree, dict):
            return {k: self._cast(v, dtype) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._cast(v, dtype) for v in tree)
        if isinstance(tree, CsrMatrix):
            dt = tree.dtype
        elif isinstance(tree, StencilOperator):
            dt = tree.coeffs.dtype
        elif torch.is_tensor(tree) and tree.is_floating_point():
            dt = tree.dtype
        else:
            return tree
        if dt == dtype:
            return tree
        key = (id(tree), dtype)
        hit = self._cast_memo.get(key)
        if hit is None or hit[0] is not tree:
            hit = self._cast_memo[key] = (tree, _cast_leaf(tree, dtype))
        return hit[1]

    def _sweeps(self, level_index: int, pre: bool) -> int:
        s = self.presweeps if pre else self.postsweeps
        if level_index == 0 and self.finest_sweeps >= 0:
            s = self.finest_sweeps
        if self.intensive_smoothing:
            s = max(4 * s, 4)
        return s

    def cycle(self, data, b, x):
        """One multigrid cycle; a reduced-precision hierarchy computes it
        in its dtype and returns the result in the caller's."""
        from .cycles import run_cycle
        dt = self.precision_policy.cast_dtype
        if dt is None:
            return run_cycle(self, self.cycle_name, data, b, x)
        out = run_cycle(self, self.cycle_name, data, b.to(dt), x.to(dt))
        return out.to(x.dtype)

    def cycle_dot(self, data, b, x):
        """One cycle plus x'.b from its last kernel: (x', dot), dot None
        when the cycle cannot carry it. A reduced-precision cycle
        declines: its epilogue would reduce the rounded product while the
        caller needs x'.b in its own dtype."""
        from .cycles import run_cycle_dot
        if self.precision_policy.cast_dtype is not None or b.dim() == 2:
            # a batch declines too: no batched kernel carries the dot
            return self.cycle(data, b, x), None
        return run_cycle_dot(self, self.cycle_name, data, b, x)

    def level_rows(self) -> List[int]:
        """Rows per level, finest first, the coarsest operator last."""
        return [lv.A.num_rows for lv in self.levels] + [
            self.coarsest_A.num_rows]

    # -- observability -----------------------------------------------------
    @staticmethod
    def _layout_of(level: Optional[AMGLevel], M: CsrMatrix) -> str:
        """The port's storage of a level's operator: "dia", "csr", or
        "dia-mf" for a matrix-free level (its kernels synthesize the DIA
        values from stencil coefficients)."""
        if level is not None and level.smoother is not None \
                and getattr(level.smoother, "_mf_stencil", None) is not None:
            return "dia-mf"
        return "dia" if M.dia_offsets is not None else "csr"

    def grid_stats_dict(self) -> Dict[str, Any]:
        """Grid statistics as data (`grid_stats` renders its text from
        it); host metadata only."""
        pairs = [(lv, lv.A) for lv in self.levels]
        if self.coarsest_A is not None:
            pairs.append((None, self.coarsest_A))
        rows = [{"level": i, "rows": int(M.num_rows), "nnz": int(M.nnz),
                 "sparsity": M.nnz / max(M.num_rows, 1) ** 2,
                 "layout": self._layout_of(lv, M)}
                for i, (lv, M) in enumerate(pairs)]
        total_rows = sum(r["rows"] for r in rows)
        total_nnz = sum(r["nnz"] for r in rows)
        fine_rows = rows[0]["rows"] if rows else 0
        fine_nnz = rows[0]["nnz"] if rows else 0
        return {"algorithm": self.algorithm, "cycle": self.cycle_name,
                "num_levels": len(rows), "levels": rows,
                "total_rows": total_rows, "total_nnz": total_nnz,
                "grid_complexity": total_rows / max(fine_rows, 1),
                "operator_complexity": total_nnz / max(fine_nnz, 1)}

    def grid_stats(self) -> str:
        """The grid table of print_grid_stats (src/amg.cu:1231-1350)."""
        d = self.grid_stats_dict()
        rule = "         " + "-" * 50
        lines = ["AMG Grid:",
                 f"         Number of Levels: {d['num_levels']}",
                 "            LVL         ROWS               NNZ    SPRSTY",
                 rule]
        for row in d["levels"]:
            lines.append(f"           {row['level']:3d}  "
                         f"{row['rows']:11d}  {row['nnz']:16d}  "
                         f"{row['sparsity']:8.3g}")
        lines.append(rule)
        lines.append(f"         Grid Complexity: "
                     f"{d['grid_complexity']:.5g}")
        lines.append(f"         Operator Complexity: "
                     f"{d['operator_complexity']:.5g}")
        return "\n".join(lines)
