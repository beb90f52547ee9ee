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

    batched_iteration = True

    def batch_refusal(self):
        """A batched cycle needs a fixed cycle shape and levels with a
        batched form (AMGLevel.batch_refusal), in the operator's dtype:
        the batched kernels take float32 operands, so a hierarchy cast
        to another precision (amg_precision / solve_precision) is
        refused here on every device, not in the first cycle on the
        card. The smoothers and the coarse solver answer for
        themselves."""
        if self.amg.cycle_name not in ("V", "W", "F"):
            return (f"the {self.amg.cycle_name} cycle has no batched form "
                    f"yet (ROADMAP.md Queue A item 9)")
        cast = self.amg.precision_policy.cast_dtype
        if cast is not None:
            return (f"a {cast} hierarchy has no batched cycle yet "
                    f"(ROADMAP.md Queue A item 9: reduced-precision "
                    f"hierarchies)")
        for lv in self.amg.levels:
            why = lv.batch_refusal()
            if why is not None:
                return why
        return super().batch_refusal()

    def solver_setup(self):
        self.amg.setup(self.A)

    def solver_resetup(self):
        self.amg.resetup(self.A)

    def solve_data(self):
        d = super().solve_data()
        d["amg"] = self.amg.solve_data()
        return d

    def computes_residual(self):
        return False

    def apply_dot(self, data, rhs):
        """One cycle with x'.rhs from its last kernel (AMG.cycle_dot).
        Only a single cycle qualifies: with max_iters > 1 the dot of the
        last cycle's output would need that cycle's own epilogue, so it
        declines to (apply, None) and the caller reduces explicitly."""
        if self.max_iters != 1:
            return self.apply(data, rhs), None
        return self.amg.cycle_dot(data["amg"], rhs, torch.zeros_like(rhs))

    def solve_iteration(self, data, b, st):
        out = dict(st)
        out["x"] = self.amg.cycle(data["amg"], b, st["x"])
        return out

    def breakdown(self, state):
        # a non-finite cycle output means the hierarchy itself is broken:
        # BREAKDOWN, not a NaN storm at max_iters. Evaluated only by the
        # monitored loop, so a preconditioner application pays nothing;
        # one flag a system under a batch
        return ~torch.isfinite(state["x"]).all(-1)
