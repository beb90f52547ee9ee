"""AMG hierarchy driver (the port of amgx_tpu/amg/hierarchy.py).

Setup builds the level list on the operator's device: per level the
selector's aggregates, the Galerkin coarse operator, and the smoother
(set up as soon as its level exists). The coarsest operator gets the
coarse solver (DENSE_LU by default). The cycle's coarse-tail plans
(ops/smooth.py `coarse_tail_cycle`) are cached per hierarchy and dropped
at setup.

`amg_precision=float` (mixed-precision preconditioning): the hierarchy
is built in the operator's dtype; `solve_data` casts every floating leaf
of the level data to float32 and the coarse-solver subtree to the
policy's coarse dtype, once per setup (memoized by leaf), and `cycle`
casts b and x in and the result back. Such a cycle declines the
cycle-borne dot. Not ported yet: bfloat16 hierarchies, structure reuse
on resetup, the matrix-free detector and telemetry.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .. import registry
from ..config import Config
from ..matrix import CsrMatrix
from ..precision import resolve_precision


class AMGLevel:
    """One level: fine matrix + transfer operators + smoother. Subclasses
    implement create_coarse_vertices / create_coarse_matrix / restrict /
    prolongate."""

    algorithm = "?"
    FUSION_CAPS = frozenset({"restrict", "prolongate"})

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

    def level_data(self) -> Dict[str, Any]:
        d = {"A": self.A}
        if self.smoother is not None:
            d["smoother"] = self.smoother.solve_data()
        return d

    def restrict(self, data, r):
        raise NotImplementedError

    def prolongate(self, data, xc):
        raise NotImplementedError

    # fused cycle hooks (amg/cycles.py consults supports_fusion first)
    def supports_fusion(self, data):
        return ()

    def restrict_fused(self, data, b, x, sweeps: int):
        return None

    def prolongate_smooth(self, data, b, x, xc, sweeps: int,
                          want_dot: bool = False):
        return None


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
        self.cycle_fusion = bool(int(cfg.get("cycle_fusion", scope)))
        self.cycle_fusion_tail_rows = int(
            cfg.get("cycle_fusion_tail_rows", scope))
        self.intensive_smoothing = bool(cfg.get("intensive_smoothing",
                                                scope))
        self.precision_policy = resolve_precision(cfg, scope)
        if self.precision_policy.name == "bfloat16":
            raise NotImplementedError(
                "amg_precision=bfloat16 is not ported yet (double and "
                "float are)")
        if self.cycle_name not in ("V", "W", "F"):
            raise NotImplementedError(
                f"cycle={self.cycle_name} is not ported yet (V, W, F are)")
        self.levels: List[AMGLevel] = []
        self.coarse_solver = None
        self.coarsest_A: Optional[CsrMatrix] = None
        # (shape, entry level, dtype, device) -> coarse-tail plan
        self._tail_plans: Dict[tuple, Any] = {}
        # id(leaf) -> (leaf, cast twin): the reduced-precision solve data
        self._cast_memo: Dict[int, tuple] = {}

    # -- setup -----------------------------------------------------------
    def setup(self, A: CsrMatrix):
        self.levels = []
        self._tail_plans = {}
        self._cast_memo = {}
        self._build_levels(A if A.initialized else A.init(), 0)
        self._finalize_setup()
        return self

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
            level.create_coarse_vertices()
            nc = level.coarse_size
            # stalling coarsening stops the hierarchy
            if nc <= 0 or nc >= n or (n / max(nc, 1)) < \
                    self.coarsen_threshold:
                break
            Ac = level.create_coarse_matrix()
            self.levels.append(level)
            self._attach_level_smoother(level)
            Af = Ac if Ac.initialized else Ac.init()
            lvl += 1
        self.coarsest_A = Af

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
        level.smoother = make_solver(name, self.cfg, scope, level.A.device)
        level.smoother.setup(level.A)

    def _finalize_setup(self):
        from ..solvers.base import make_solver
        cs_name, cs_scope = self.cfg.get_solver("coarse_solver", self.scope)
        self.coarse_solver = make_solver(cs_name, self.cfg, cs_scope,
                                         self.coarsest_A.device)
        self.coarse_solver.setup(self.coarsest_A)

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
        """`tree` with every floating tensor (and CsrMatrix) in `dtype`;
        each leaf is cast once per setup."""
        if isinstance(tree, dict):
            return {k: self._cast(v, dtype) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._cast(v, dtype) for v in tree)
        floating = isinstance(tree, CsrMatrix) or (
            torch.is_tensor(tree) and tree.is_floating_point())
        if not floating or tree.dtype == dtype:
            return tree
        key = (id(tree), dtype)
        hit = self._cast_memo.get(key)
        if hit is None or hit[0] is not tree:
            hit = self._cast_memo[key] = (tree, tree.astype(dtype)
                                          if isinstance(tree, CsrMatrix)
                                          else tree.to(dtype))
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
        if self.precision_policy.cast_dtype is not None:
            return self.cycle(data, b, x), None
        return run_cycle_dot(self, self.cycle_name, data, b, x)

    def level_rows(self) -> List[int]:
        """Rows per level, finest first, the coarsest operator last."""
        return [lv.A.num_rows for lv in self.levels] + [
            self.coarsest_A.num_rows]

