"""EigenSolver base: the eigensolver skeleton (the port of
amgx_tpu/eigen/base.py).

The analog of EigenSolver<TConfig> (include/eigensolvers/eigensolver.h:25,
src/eigensolvers/eigensolver.cu): reads the eig_* parameter family,
applies the spectral shift, runs the iteration loop with its
convergence checks, and postprocesses (un-shift, optional eigenvector
extraction).

Execution model, as `solvers/base.py`: `setup(A)` is host-orchestrated
once per structure; `solve()` runs a host loop over device tensors --
each iteration is `solve_iteration` (SpMVs, dots, small dense
Rayleigh-Ritz problems, all on the device), and every
`eig_convergence_check_freq`-th iteration reads ONE device bool (the
JAX package checks the same condition inside its `lax.while_loop`).
Small dense symmetric eigenproblems (tridiagonal T, Rayleigh-Ritz Gram
matrices) use `torch.linalg.eigh` on the device in the iteration's
dtype; the nonsymmetric Hessenberg eigenproblem is solved on the host
after the loop (the reference likewise defers it to LAPACK geev,
src/amgx_lapack.cu). The result's eigenvalues and residuals are host
arrays (one device-to-host read at the end); its eigenvectors stay
tensors on the solver's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import registry
from ..config import Config
from ..device import resolve_device
from ..errors import BadParametersError
from ..matrix import CsrMatrix
from .operators import MatrixOperator, Operator, ShiftedOperator


@dataclasses.dataclass
class EigenResult:
    """Result of an eigensolve (AMGX_eigensolver_solve analog)."""
    eigenvalues: np.ndarray                 # (k,), host
    eigenvectors: Optional[torch.Tensor]    # (n, k) on the device, or None
    iterations: int
    converged: bool
    residuals: np.ndarray                   # (k,) final eigenpair residuals
    setup_time: float = 0.0
    solve_time: float = 0.0


def start_vector(n: int, dtype, device) -> torch.Tensor:
    """The deterministic pseudo-random start (the reference seeds its
    RNG; the JAX package draws the same numbers)."""
    return torch.from_numpy(np.random.default_rng(42).standard_normal(
        n)).to(device=device, dtype=dtype)


def seeded(seed: int, shape, like: torch.Tensor) -> torch.Tensor:
    """A seeded standard-normal block in `like`'s dtype and device: the
    JAX package's `np.random.default_rng(seed).standard_normal(shape)`."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).to(device=like.device, dtype=like.dtype)


class EigenSolver:
    """Base eigensolver (include/eigensolvers/eigensolver.h:25).

    Subclasses implement `solver_setup`, `solve_init`, `solve_iteration`,
    `finalize`; the base provides the shift, the driver loop, and the
    convergence plumbing."""

    def __init__(self, cfg: Config, scope: str = "default", name: str = "?",
                 device=None):
        self.cfg = cfg
        self.scope = scope
        self.name = name
        # the card unless device="cpu", as create_solver
        self.device = resolve_device(device)
        self.max_iters = int(cfg.get("eig_max_iters", scope))
        self.tolerance = float(cfg.get("eig_tolerance", scope))
        self.shift = float(cfg.get("eig_shift", scope))
        self.which = str(cfg.get("eig_which", scope)).lower()
        self.wanted_count = int(cfg.get("eig_wanted_count", scope))
        self.subspace_size = int(cfg.get("eig_subspace_size", scope))
        self.check_freq = max(1, int(cfg.get("eig_convergence_check_freq",
                                             scope)))
        self.want_vectors = bool(int(cfg.get("eig_eigenvector", scope)))
        self.damping = float(cfg.get("eig_damping_factor", scope))
        self.A: Optional[CsrMatrix] = None
        self.op: Optional[Operator] = None
        self.setup_time = 0.0

    # -- setup -----------------------------------------------------------
    def make_operator(self) -> Operator:
        """The operator the iteration applies. Default: (A - shift I)."""
        op: Operator = MatrixOperator(self.A)
        if self.shift != 0.0:
            op = ShiftedOperator(op, self.shift)
        return op

    def setup(self, A: CsrMatrix):
        t0 = time.perf_counter()
        A = A.to(self.device)
        if not A.initialized:
            A = A.init()
        self.A = A
        self.op = self.make_operator()
        self.solver_setup()
        self.setup_time = time.perf_counter() - t0
        return self

    def solver_setup(self):
        pass

    # -- pieces ----------------------------------------------------------
    def solve_data(self) -> Dict[str, Any]:
        return {"op": self.op.data()}

    def solve_init(self, data, x0) -> Dict[str, Any]:
        """Initial state. Must contain 'lambdas' (k,) and 'resid' (k,)."""
        raise NotImplementedError

    def solve_iteration(self, data, state) -> Dict[str, Any]:
        raise NotImplementedError

    def finalize(self, data, state):
        """Return (lambdas (k,), vectors (n,k) or None, resid (k,))."""
        raise NotImplementedError

    def unshift(self, lam):
        return lam + self.shift if self.shift != 0.0 else lam

    @staticmethod
    def _converged(lam, resid, tol):
        """Every residual within tol x max|lambda| (a 0-d device bool,
        in the iteration's dtype as the JAX package's check)."""
        scale = torch.clamp(lam.abs().max(), min=1e-30)
        return (resid <= tol * scale).all()

    def _x0(self, x0) -> torch.Tensor:
        if self.A is None:
            raise BadParametersError(
                f"eigensolver {self.name}: solve() before setup()")
        if x0 is None:
            return start_vector(self.A.num_rows, self.A.dtype, self.device)
        x0 = x0 if torch.is_tensor(x0) else torch.from_numpy(np.asarray(x0))
        return x0.to(device=self.device, dtype=self.A.dtype)

    # -- driver ----------------------------------------------------------
    def solve(self, x0=None) -> EigenResult:
        x0 = self._x0(x0)
        t0 = time.perf_counter()
        data = self.solve_data()
        state = self.solve_init(data, x0)
        iters = 0
        while iters < self.max_iters:
            state = self.solve_iteration(data, state)
            iters += 1
            if iters % self.check_freq == 0 and bool(self._converged(
                    state["lambdas"], state["resid"], self.tolerance)):
                break
        lam, vec, resid = self.finalize(data, state)
        conv = self._converged(lam, resid, self.tolerance)
        # one host read: the small stats
        stats = torch.cat([conv.to(lam.dtype).reshape(1), lam.reshape(-1),
                           resid.reshape(-1)]).double().cpu().numpy()
        solve_time = time.perf_counter() - t0
        m = (stats.size - 1) // 2
        conv, lam, resid = bool(stats[0]), stats[1:1 + m], stats[1 + m:]
        lam, vec, resid, iters, conv = self.postprocess(
            lam, vec, resid, iters, conv)
        return EigenResult(
            eigenvalues=np.atleast_1d(np.asarray(self.unshift(lam))),
            eigenvectors=vec, iterations=int(iters), converged=bool(conv),
            residuals=np.atleast_1d(np.asarray(resid)),
            setup_time=self.setup_time, solve_time=solve_time)

    def postprocess(self, lam, vec, resid, iters, conv):
        """Host-side post-loop hook."""
        return lam, vec, resid, iters, conv


def make_eigensolver(name: str, cfg: Config, scope: str = "default",
                     device=None) -> EigenSolver:
    """EigenSolverFactory::allocate analog."""
    cls = registry.eigensolvers.get(name)
    return cls(cfg, scope, name=name.upper(), device=device)


def create_eigensolver(cfg: Config, scope: str = "default",
                       device=None) -> EigenSolver:
    """AMG_EigenSolver analog (src/amg_eigensolver.cu): build the
    eigensolver named by eig_solver, on the card unless device="cpu"."""
    return make_eigensolver(str(cfg.get("eig_solver", scope)), cfg, scope,
                            device)
