"""Mixed-precision defect correction (the port of
amgx_tpu/solvers/refinement.py):

    r_k = b - A x_k                   (f64)
    solve  A32 d = r_k  to tol_inner  (f32: the inner solver from the
                                       `preconditioner` role, e.g.
                                       FGMRES + GEO-aggregation AMG)
    x_{k+1} = x_k + d                 (f64)

Convergence is monitored on the true f64 residual. The f64 products
stay plain PyTorch on the card (the JAX package runs them in XLA, not
Pallas). The accumulated inner iteration count is reported in
`SolveResult.extra_stats["inner_iters"]` on every solve: the port's
loop counts on the host, so the count is free.
"""
from __future__ import annotations

import torch

from .. import registry
from ..errors import BadParametersError
from ..ops.spmv import residual
from .base import Solver


@registry.solvers.register("REFINEMENT")
@registry.solvers.register("DEFECT_CORRECTION")
class RefinementSolver(Solver):
    uses_preconditioner = True
    inner_dtype = torch.float32
    _child_data_key = "inner"

    def precond_operator(self, A):
        # the inner chain (and its AMG hierarchy) builds against the
        # reduced-precision operator
        return A.astype(self.inner_dtype)

    def solver_setup(self):
        if self.preconditioner is None:
            raise BadParametersError(
                "REFINEMENT needs an inner solver in the `preconditioner` "
                "role (e.g. preconditioner(in)=FGMRES)")

    def solve_data(self):
        return {"A": self.A, "inner": self.preconditioner.solve_data()}

    def computes_residual(self):
        return True

    def solve_init(self, data, b, x0, r0):
        return {"inner_iters": 0}

    def solve_iteration(self, data, b, st):
        r32 = st["r"].to(self.inner_dtype)
        d32, stats = self.preconditioner.run_loop(data["inner"], r32,
                                                  torch.zeros_like(r32))
        x = st["x"] + d32.to(st["x"].dtype)
        out = dict(st)
        out["x"] = x
        out["r"] = residual(data["A"], x, b)            # true f64 residual
        out["inner_iters"] = st["inner_iters"] + stats["iters"]
        return out

    def _precision_block(self, res):
        block = super()._precision_block(res)
        if block is None:
            return None
        block["inner_dtype"] = str(self.inner_dtype).replace("torch.", "")
        if res.extra_stats is not None:
            block["inner_iterations"] = int(round(
                res.extra_stats.get("inner_iters", 0.0)))
        return block

    def _extra_stats(self, final_state):
        return {"inner_iters": float(final_state.get("inner_iters", 0))}
