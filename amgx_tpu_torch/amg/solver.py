"""AMG as a Solver, registry name "AMG" (the port of
amgx_tpu/amg/solver.py): setup builds the hierarchy, one solve iteration
is one multigrid cycle."""
from __future__ import annotations

import torch

from .. import registry
from ..solvers.base import Solver
from .hierarchy import AMG


@registry.solvers.register("AMG")
class AlgebraicMultigridSolver(Solver):
    def __init__(self, cfg, scope="default", name="AMG", device="cpu"):
        super().__init__(cfg, scope, name, device)
        self.amg = AMG(cfg, scope)

    def solver_setup(self):
        self.amg.setup(self.A)

    def solve_data(self):
        d = super().solve_data()
        d["amg"] = self.amg.solve_data()
        return d

    def computes_residual(self):
        return False

    def solve_iteration(self, data, b, st):
        out = dict(st)
        out["x"] = self.amg.cycle(data["amg"], b, st["x"])
        return out

    def breakdown(self, state) -> bool:
        # a non-finite cycle output means the hierarchy itself is broken:
        # BREAKDOWN, not a NaN storm at max_iters. Evaluated only by the
        # monitored driver, so a preconditioner application pays nothing
        return not bool(torch.isfinite(state["x"]).all())
