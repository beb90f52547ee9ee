"""Single-iteration (power-method family) eigensolver (the port of
amgx_tpu/eigen/power.py).

The analog of SingleIteration_EigenSolver
(src/eigensolvers/single_iteration_eigensolver.cu). One operator apply
per iteration + normalization + Rayleigh quotient. As in the reference
(solver_setup :187-214), the operator depends on `eig_which`:

- largest  -> A (shifted by eig_shift if set): classic power iteration;
- smallest -> SolveOperator wrapping the solver configured under the
  "solver" parameter (inverse iteration, :198-209);
- pagerank -> PageRankOperator (:193-196); the iterate is additionally
  L1-normalized so it stays a probability distribution.

Registered as SINGLE_ITERATION / POWER_ITERATION / INVERSE_ITERATION /
PAGERANK (src/eigensolvers/eigensolvers.cu:38-43).
"""
from __future__ import annotations

import torch

from .. import registry
from ..errors import BadParametersError
from ..ops import blas
from .base import EigenSolver
from .operators import PageRankOperator, SolveOperator


@registry.eigensolvers.register("SINGLE_ITERATION")
@registry.eigensolvers.register("POWER_ITERATION")
@registry.eigensolvers.register("INVERSE_ITERATION")
@registry.eigensolvers.register("PAGERANK")
class SingleIterationEigenSolver(EigenSolver):

    def __init__(self, cfg, scope="default", name="POWER_ITERATION",
                 device=None):
        super().__init__(cfg, scope, name=name, device=device)
        if name.upper() == "INVERSE_ITERATION":
            self.which = "smallest"
        elif name.upper() == "PAGERANK":
            self.which = "pagerank"

    def make_operator(self):
        if self.which == "pagerank":
            return PageRankOperator(self.A, self.damping)
        if self.which == "smallest":
            # inverse iteration: apply (A - shift I)^{-1} via the nested
            # solver configured under "solver" (reference :198-209)
            from ..solvers.base import make_solver
            sname, sscope = self.cfg.get_solver("solver", self.scope)
            if sname.upper() in ("NOSOLVER", "DUMMY"):
                raise BadParametersError(
                    "INVERSE_ITERATION needs a 'solver' parameter naming "
                    "the inner linear solver")
            solver = make_solver(sname, self.cfg, sscope, self.device)
            A = self.A
            if self.shift != 0.0:
                # build A - shift*I explicitly so the inner solver
                # factors/smooths the shifted matrix (reference :205-206)
                rows, cols, _ = A.coo()
                on = rows == cols.long()
                if int(torch.bincount(rows[on], minlength=A.num_rows)
                       .eq(0).sum()) > 0:
                    raise BadParametersError(
                        "eig_shift needs a stored diagonal in every row")
                A = A.with_values(A.values - self.shift * on.to(A.dtype))
            solver.setup(A)
            self._inner_solver = solver
            return SolveOperator(solver)
        return super().make_operator()

    def unshift(self, lam):
        if self.which == "smallest":
            # operator eigenvalue is 1/(lambda - shift)
            return self.shift + 1.0 / lam
        if self.which == "pagerank":
            return lam
        return super().unshift(lam)

    # -- pieces ----------------------------------------------------------
    def solve_init(self, data, x0):
        if self.which == "pagerank":
            v = x0.abs()
            v = v / torch.clamp(blas.nrm1(v), min=1e-30)
        else:
            v = x0 / torch.clamp(blas.nrm2(x0), min=1e-30)
        one = torch.ones((1,), dtype=x0.dtype, device=x0.device)
        return {"v": v, "lambdas": one,
                "resid": torch.full((1,), float("inf"), dtype=x0.dtype,
                                    device=x0.device)}

    def solve_iteration(self, data, state):
        v = state["v"]
        w = self.op.apply(data["op"], v)
        # Rayleigh quotient; the pagerank iterate is L1- (not L2-)
        # normalized, so divide by v.v explicitly
        vv = torch.clamp(torch.dot(v, v), min=1e-30)
        lam = torch.dot(v, w) / vv
        r = w - lam * v
        resid = blas.nrm2(r) / torch.sqrt(vv)
        if self.which == "pagerank":
            nrm = blas.nrm1(w)
        else:
            nrm = blas.nrm2(w)
        v_new = w / torch.clamp(nrm, min=1e-30)
        return {"v": v_new, "lambdas": lam.reshape(1),
                "resid": resid.reshape(1)}

    def finalize(self, data, state):
        vec = state["v"][:, None] if self.want_vectors or \
            self.which == "pagerank" else None
        return state["lambdas"], vec, state["resid"]
