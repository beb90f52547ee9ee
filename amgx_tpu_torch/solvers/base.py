"""Solver base: the composable solver tree (the port of
amgx_tpu/solvers/base.py).

The JAX package compiles each solve into one `lax.while_loop`; here the
driver is a Python loop over the same state keys (`x`, `r`, `iters`,
`done`, `converged`, `res_norm`, `norm0`, `res_hist`, `status`). The
tensors live on the solver's device; the per-iteration convergence
decision is made on the host from the monitored norm, so each monitored
iteration costs one device->host transfer of that scalar, the breakdown
flag riding along in the same transfer (FGMRES brings its Hessenberg
column instead).

State keys a solver maintains live in a plain dict; host scalars (norms,
flags, counters) are numpy scalars in the norm's dtype, so the
convergence arithmetic rounds as the JAX package's does.

`scaling` (scalers.py): the tree's root scales A before it builds the
tree, b and x0 on the way in and x on the way out; its children never
scale.

`print_solve_stats` prints the per-iteration residual table, the totals
and the status after a solve, and `obtain_timings` the setup and solve
seconds, through output.py, in the JAX package's text; the memory
column is the device's current allocation (`torch.cuda.memory_allocated`;
0 on the CPU, where the JAX package prints 0 too).

Batched solves (`solve_many`, amgx_tpu_torch/batch/): `run_loop_batched`
runs one loop over a batch of systems, b and x (B, n), the per-system
scalars (B,) tensors. It iterates while any system runs; each iteration
launches its kernels once for the whole batch and reads the host once
(the (B,) monitored norms with the breakdown flags). Each system's
status follows `run_loop`'s rules, and a system that has stopped is
frozen by a device mask (every state tensor `where(active, new, old)`),
so its x, residual norm, iterations and history are those of its own
stopping iteration, as the JAX package's `while_loop` batching rule
gives; its history past that is NaN. A solver class that runs a batch
sets `batched_iteration`; the others name the ROADMAP item that will
port theirs (`batch_refusal`).
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
from ..ops import blas
from ..ops.spmv import residual as _residual
from ..precision import resolve_precision
from ..resilience.status import RUNNING as _ST_RUNNING
from ..resilience.status import SolveStatus, status_string

# ---------------------------------------------------------------------------
# convergence criteria
# ---------------------------------------------------------------------------


class Convergence:
    """Predicate deciding convergence from host scalars (res_norm,
    norm0); the tolerance is rounded to the norms' dtype first, as the
    JAX package's weakly-typed arithmetic does."""

    def __init__(self, cfg: Config, scope: str):
        self.tolerance = float(cfg.get("tolerance", scope))
        self.alt_rel_tolerance = float(cfg.get("alt_rel_tolerance", scope))

    @staticmethod
    def _t(tol, like):
        return np.asarray(tol, dtype=np.asarray(like).dtype)

    def check(self, res_norm, norm0) -> bool:
        raise NotImplementedError

    def check_each(self, res_norm, norm0) -> np.ndarray:
        """`check` on each system of a batch's (B,) norms (host values)."""
        return np.array([self.check(r, n0)
                         for r, n0 in zip(res_norm, norm0)], dtype=bool)


@registry.convergence.register("ABSOLUTE")
class AbsoluteConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(res_norm <= self._t(self.tolerance, res_norm)))


@registry.convergence.register("RELATIVE_INI")
@registry.convergence.register("RELATIVE_INI_CORE")
class RelativeIniConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(res_norm <= self._t(self.tolerance, norm0)
                           * norm0))


@registry.convergence.register("RELATIVE_MAX")
@registry.convergence.register("RELATIVE_MAX_CORE")
class RelativeMaxConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(res_norm <= self._t(self.tolerance, norm0)
                           * np.max(norm0)))


@registry.convergence.register("COMBINED_REL_INI_ABS")
class CombinedRelIniAbsConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(
            (res_norm <= self._t(self.tolerance, res_norm))
            | (res_norm <= self._t(self.alt_rel_tolerance, norm0) * norm0)))


# ---------------------------------------------------------------------------
# solve result
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    converged: bool
    res_norm: np.ndarray
    norm0: np.ndarray
    res_history: Optional[np.ndarray] = None
    setup_time: float = 0.0
    solve_time: float = 0.0
    status_code: int = int(SolveStatus.MAX_ITERS)
    # solver-specific scalars (REFINEMENT: accumulated inner iterations)
    extra_stats: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.converged:
            self.status_code = int(SolveStatus.CONVERGED)

    @property
    def status(self) -> str:
        return status_string(self.status_code)


def _host(t) -> np.ndarray:
    """A device scalar as a numpy scalar of its dtype (one transfer)."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _host_norm_flags(norms, flags):
    """A batch's (B,) norms and breakdown flags (a (B,) device bool, or
    None / False) on the host with one device->host transfer."""
    if torch.is_tensor(flags):
        both = _host(torch.stack([norms, flags.to(norms.dtype).expand(
            norms.shape)]))
        return both[0], both[1] != 0
    return _host(norms), np.zeros(norms.shape, dtype=bool)


def _freeze(active, new, old):
    """The state after a batched iteration: each tensor with a leading
    batch axis takes the new value where its system is `active` and keeps
    the old one elsewhere (the while_loop batching rule's select)."""
    nb = active.shape[0]
    out = dict(new)
    for k, v in new.items():
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nb \
                and k in old:
            out[k] = torch.where(active.reshape((nb,) + (1,) * (v.dim() - 1)),
                                 v, old[k])
    return out


def _host_norm_flag(norm, flag):
    """(norm, flag) on the host, each given as a device tensor or a host
    value, with at most one device->host transfer."""
    if torch.is_tensor(norm) and torch.is_tensor(flag):
        both = _host(torch.stack([norm.reshape(()),
                                  flag.reshape(()).to(norm.dtype)]))
        return both[0], bool(both[1])
    return _host(norm), bool(_host(flag) if torch.is_tensor(flag) else flag)


# ---------------------------------------------------------------------------
# solver base
# ---------------------------------------------------------------------------


class Solver:
    """Base solver. Subclasses implement `solver_setup`, `solve_init`,
    `solve_iteration`, and may override `apply` (preconditioner
    action)."""

    uses_preconditioner = False
    is_smoother = False
    # solve_data key of the preconditioner's subtree
    _child_data_key = "precond"
    # runs a batch (vectors (B, n), scalars (B,)): run_loop_batched
    batched_iteration = False
    # where a class without it will get it (batch_refusal's message)
    batch_todo = "ROADMAP.md Queue A item 9"
    # value-derived scalars kept outside solve_data (CHEBYSHEV's spectral
    # bounds, host floats): one batch cannot give each system its own
    trace_bakes_values = False

    def __init__(self, cfg: Config, scope: str = "default", name: str = "?",
                 device="cpu"):
        self.cfg = cfg
        self.scope = scope
        self.name = name
        self.device = torch.device(device)
        self.A: Optional[CsrMatrix] = None
        self.max_iters = int(cfg.get("max_iters", scope))
        self.monitor_residual = bool(cfg.get("monitor_residual", scope))
        self.norm_type = str(cfg.get("norm", scope))
        self.store_res_history = bool(cfg.get("store_res_history", scope))
        self.print_solve_stats = bool(cfg.get("print_solve_stats", scope))
        self.obtain_timings = bool(cfg.get("obtain_timings", scope))
        self.rel_div_tolerance = float(cfg.get("rel_div_tolerance", scope))
        self.health_guards = bool(int(cfg.get("health_guards", scope)))
        self.stall_window = int(cfg.get("stall_detection_window", scope))
        self.stall_tolerance = float(cfg.get("stall_tolerance", scope))
        self.scaling = str(cfg.get("scaling", scope)).upper()
        self.scaler = None
        # only the tree's root scales the equations: children get the
        # scaled matrix and exchange vectors in its coordinates (their
        # creation sites clear the flag)
        self._owns_scaling = True
        # rejects contradictory precision knobs at construction
        resolve_precision(cfg, scope)
        self.convergence: Convergence = registry.convergence.create(
            str(cfg.get("convergence", scope)), cfg, scope)
        self.preconditioner: Optional[Solver] = None
        if self.uses_preconditioner:
            pname, pscope = cfg.get_solver("preconditioner", scope)
            if pname.upper() != "NOSOLVER":
                self.preconditioner = make_solver(pname, cfg, pscope,
                                                  self.device)
                self.preconditioner._owns_scaling = False
        self.setup_time = 0.0

    def _norm(self, v):
        return blas.norm(v, self.norm_type)

    # -- setup -----------------------------------------------------------
    def setup(self, A: CsrMatrix):
        """Build solver state for A (moved to the solver's device)."""
        return self._setup_impl(A, reuse=False)

    def resetup(self, A: CsrMatrix):
        """Set up on A's new coefficients, keeping what structure the
        tree can (AMGX_solver_resetup: an AMG preconditioner honours
        structure_reuse_levels); the same as setup for every other
        solver."""
        return self._setup_impl(A, reuse=True)

    def _setup_impl(self, A: CsrMatrix, reuse: bool):
        t0 = time.perf_counter()
        A = A.to(self.device)
        if not A.initialized:
            A = A.init()
        if self._owns_scaling and self.scaling not in ("NONE", ""):
            # the whole tree works on L A R (Solver::setup's scaler path,
            # src/solvers/solver.cu:465-476); with_values refills the DIA
            # view from the scaled values
            from ..scalers import make_scaler
            self.scaler = make_scaler(self.scaling, self.cfg, self.scope)
            A = self.scaler.setup(A).scale_matrix(A)
        self.A = A
        if self.preconditioner is not None:
            pre = self.preconditioner
            (pre.resetup if reuse else pre.setup)(self.precond_operator(A))
        (self.solver_resetup if reuse else self.solver_setup)()
        self.setup_time = time.perf_counter() - t0
        return self

    def precond_operator(self, A: CsrMatrix) -> CsrMatrix:
        """The operator the preconditioner tree is set up against."""
        return A

    def solver_setup(self):
        pass

    def solver_resetup(self):
        self.solver_setup()

    # -- pieces of the solve ---------------------------------------------
    def solve_data(self) -> Dict[str, Any]:
        """The tensors the solve reads, with the preconditioner's under
        'precond' (no copies: the same tensors the solver holds)."""
        d: Dict[str, Any] = {"A": self.A}
        if self.preconditioner is not None:
            d["precond"] = self.preconditioner.solve_data()
        return d

    def solve_init(self, data, b, x, r) -> Dict[str, Any]:
        """Extra solver state (beyond x/r) before the first iteration."""
        return {}

    def _guard_init(self) -> Dict[str, Any]:
        return {"breakdown": False} if self.health_guards else {}

    def solve_iteration(self, data, b, state) -> Dict[str, Any]:
        raise NotImplementedError

    def computes_residual(self) -> bool:
        return True

    def breakdown(self, state):
        """Has the recurrence broken down (read with health_guards)? A
        host bool or a 0-dim device bool: the solve loop moves it to the host
        together with the monitored norm."""
        return state.get("breakdown", False)

    def internal_res_norm(self, state):
        """A host residual-norm estimate the solver maintains (FGMRES's
        |g[i+1]|), or None to let the driver compute one."""
        return None

    def finalize(self, data, b, state):
        return state["x"]

    def apply(self, data, rhs):
        """Preconditioner action M^{-1} rhs: zero initial guess, a fixed
        number of iterations, no monitoring."""
        x0 = torch.zeros_like(rhs)
        st = {"x": x0, "r": rhs}
        st.update(self.solve_init(data, rhs, x0, rhs))
        for _ in range(self.max_iters):
            st = self.solve_iteration(data, rhs, st)
        return st["x"]

    def apply_dot(self, data, rhs):
        """(apply(rhs), x.rhs) when the application's last kernel can
        emit the dot as an epilogue, else (apply(rhs), None) and the
        caller reduces explicitly. PCG reads it as r.z."""
        return self.apply(data, rhs), None

    # -- the driver --------------------------------------------------------
    def run_loop(self, data, b, x0):
        """The solve loop on (data, b, x0): returns (x, stats) with stats
        a dict of host values (iters, converged, status, norm0,
        res_norm, res_hist, extra)."""
        S = SolveStatus
        A = data["A"]
        monitor = self.monitor_residual
        conv = self.convergence
        r0 = _residual(A, x0, b)
        norm0 = _host(self._norm(r0))
        state = {"x": x0, "r": r0}
        state.update(self.solve_init(data, b, x0, r0))
        zero0 = bool(np.all(norm0 == 0))
        done = (monitor and conv.check(norm0, norm0)) or zero0
        status = int(S.CONVERGED) if done else _ST_RUNNING
        hist = np.zeros((self.max_iters + 1,) + np.shape(norm0), norm0.dtype)
        hist[0] = norm0
        res_norm = norm0
        iters = 0
        while not done and iters < self.max_iters:
            state = self.solve_iteration(data, b, state)
            iters += 1
            if not monitor:
                continue
            rn = self.internal_res_norm(state)
            if rn is None:
                r = state["r"] if self.computes_residual() \
                    else _residual(A, state["x"], b)
                rn = self._norm(r)
            rn, broken = _host_norm_flag(
                rn, self.breakdown(state) if self.health_guards else False)
            rn = np.asarray(rn, norm0.dtype)
            res_norm = rn
            hist[iters] = rn
            status_now = _ST_RUNNING
            if self.stall_window > 0 and self.health_guards \
                    and iters >= self.stall_window:
                past = hist[iters - self.stall_window]
                if np.all(rn >= np.asarray(1.0 - self.stall_tolerance,
                                           rn.dtype) * past):
                    status_now = int(S.STALLED)
            if self.rel_div_tolerance > 0 and np.any(
                    rn > np.asarray(self.rel_div_tolerance, rn.dtype)
                    * norm0):
                status_now = int(S.DIVERGED)
            if self.health_guards and not np.all(np.isfinite(rn)):
                status_now = int(S.NAN_DETECTED)
            if self.health_guards and broken:
                status_now = int(S.BREAKDOWN)
            if conv.check(rn, norm0):
                status_now = int(S.CONVERGED)
            if status == _ST_RUNNING:
                status = status_now
            done = status != _ST_RUNNING
        x = self.finalize(data, b, state)
        if status == _ST_RUNNING:
            status = int(S.MAX_ITERS)
        stats = {"iters": iters, "converged": status == int(S.CONVERGED),
                 "status": status, "norm0": norm0, "res_norm": res_norm,
                 "res_hist": hist[:iters + 1],
                 "extra": self._extra_stats(state)}
        return x, stats

    def _extra_stats(self, final_state) -> Optional[Dict[str, float]]:
        return None

    # -- batched solves -----------------------------------------------------
    def batch_refusal(self) -> Optional[str]:
        """Why this node cannot run in a batched solve, or None."""
        if not self.batched_iteration:
            return (f"{self.name} has no batched iteration yet "
                    f"({self.batch_todo})")
        return None

    def run_loop_batched(self, data, b, x0):
        """`run_loop` on a batch: b, x0 (B, n). Returns (X, stats) with
        stats a dict of host arrays: iters, converged, status, norm0 and
        res_norm (B,), res_hist (B, max_iters + 1) (NaN past each
        system's stop)."""
        S = SolveStatus
        nb = b.shape[0]
        monitor = self.monitor_residual
        conv = self.convergence
        r0 = _residual(data["A"], x0, b)
        norm0 = _host(self._norm(r0))
        state = {"x": x0, "r": r0}
        state.update(self.solve_init(data, b, x0, r0))
        done = norm0 == 0
        if monitor:
            done |= conv.check_each(norm0, norm0)
        status = np.where(done, int(S.CONVERGED), _ST_RUNNING)
        hist = np.full((nb, self.max_iters + 1), np.nan, norm0.dtype)
        hist[:, 0] = norm0
        res_norm = norm0.copy()
        iters = np.zeros(nb, np.int64)
        active, active_host, it = None, None, 0
        while not done.all() and it < self.max_iters:
            run = ~done
            if active_host is None or not np.array_equal(active_host, run):
                active_host = run
                active = torch.from_numpy(run).to(b.device)
            new = self.solve_iteration(data, b, state)
            state = new if run.all() else _freeze(active, new, state)
            it += 1
            iters[run] = it
            if not monitor:
                continue
            rn = self.internal_res_norm(state)
            if rn is None:
                r = state["r"] if self.computes_residual() \
                    else _residual(data["A"], state["x"], b)
                rn = self._norm(r)
            rn, broken = _host_norm_flags(
                rn, self.breakdown(state) if self.health_guards else None)
            rn = np.asarray(rn, norm0.dtype)
            res_norm[run] = rn[run]
            hist[run, it] = rn[run]
            now = np.full(nb, _ST_RUNNING)
            if self.stall_window > 0 and self.health_guards \
                    and it >= self.stall_window:
                past = hist[:, it - self.stall_window]
                now[rn >= np.asarray(1.0 - self.stall_tolerance,
                                     rn.dtype) * past] = int(S.STALLED)
            if self.rel_div_tolerance > 0:
                now[rn > np.asarray(self.rel_div_tolerance, rn.dtype)
                    * norm0] = int(S.DIVERGED)
            if self.health_guards:
                now[~np.isfinite(rn)] = int(S.NAN_DETECTED)
                now[broken] = int(S.BREAKDOWN)
            now[conv.check_each(rn, norm0)] = int(S.CONVERGED)
            status[run] = now[run]
            done = status != _ST_RUNNING
        x = self.finalize(data, b, state)
        status[status == _ST_RUNNING] = int(S.MAX_ITERS)
        return x, {"iters": iters, "converged": status == int(S.CONVERGED),
                   "status": status, "norm0": norm0, "res_norm": res_norm,
                   "res_hist": hist}

    def solve_many(self, bs, matrices=None, x0s=None,
                   zero_initial_guess: bool = False):
        """Solve many systems in one batched loop (batch/core.py): `bs`
        stacks the right-hand sides (B, n). With matrices=None this is
        multi-RHS against the set-up matrix; with a list of same-pattern
        matrices each system gets its own coefficients (the hierarchy
        structure reused, values spliced through `resetup`). Returns a
        BatchedSolveResult. The batched wrapper is kept on the solver."""
        if getattr(self, "_batched", None) is None:
            from ..batch import BatchedSolver
            self._batched = BatchedSolver(solver=self)
        return self._batched.solve_many(
            bs, matrices=matrices, x0s=x0s,
            zero_initial_guess=zero_initial_guess)

    def solve(self, b, x0=None, zero_initial_guess: bool = False
              ) -> SolveResult:
        """Solve A x = b from x0 (zeros when absent)."""
        if self.A is None:
            raise BadParametersError(
                f"solver {self.name}: solve() before setup()")
        b = torch.as_tensor(b).to(device=self.device, dtype=self.A.dtype)
        if x0 is None or zero_initial_guess:
            x0 = torch.zeros_like(b)
        else:
            x0 = torch.as_tensor(x0).to(device=self.device, dtype=b.dtype)
        if self.scaler is not None:
            # solve (L A R) x' = L b and return x = R x'; the monitored
            # residuals are the scaled system's (solver.cu:449)
            b = self.scaler.scale_rhs(b)
            x0 = self.scaler.to_scaled_x(x0)
        t0 = time.perf_counter()
        x, st = self.run_loop(self.solve_data(), b, x0)
        if self.scaler is not None:
            x = self.scaler.from_scaled_x(x)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        solve_time = time.perf_counter() - t0
        res = SolveResult(
            x=x, iterations=st["iters"], converged=st["converged"],
            res_norm=np.asarray(st["res_norm"]),
            norm0=np.asarray(st["norm0"]),
            res_history=st["res_hist"] if self.store_res_history else None,
            setup_time=self.setup_time, solve_time=solve_time,
            status_code=st["status"], extra_stats=st["extra"])
        if self.print_solve_stats:
            self._print_stats(res, np.asarray(st["res_hist"]))
        return res

    def _print_stats(self, res: SolveResult, hist):
        """The solve table of print_solve_stats (and obtain_timings)."""
        from ..output import amgx_printf
        mem_gb = (torch.cuda.memory_allocated(self.device)
                  if self.device.type == "cuda" else 0) / 2**30
        rule = f"    {'-' * 62}"
        amgx_printf("    iter      Mem Usage (GB)       residual"
                    "           rate")
        amgx_printf(rule)
        for i in range(res.iterations + 1):
            rate = ""
            if i > 0 and np.all(hist[i - 1] > 0):
                rate = f"{float(np.max(hist[i] / hist[i - 1])):14.4f}"
            tag = "Ini" if i == 0 else f"{i - 1:4d}"
            amgx_printf(f"    {tag}         {mem_gb:10.4f}      "
                        f"{float(np.max(hist[i])):14.6e} {rate}")
        amgx_printf(rule)
        last, first = np.max(hist[res.iterations]), np.max(hist[0])
        rate = float((last / max(first, 1e-300))
                     ** (1.0 / max(res.iterations, 1)))
        amgx_printf(f"    Total Iterations: {res.iterations}")
        amgx_printf(f"    Avg Convergence Rate: {rate:10.4f}")
        amgx_printf(f"    Final Residual: {float(np.max(res.res_norm)):.6e}")
        amgx_printf(f"    Solve Status: {res.status}")
        if self.obtain_timings:
            amgx_printf(f"    Setup Time: {res.setup_time:.4f}s")
            amgx_printf(f"    Solve Time: {res.solve_time:.4f}s")

    # -- smoother interface (AMG levels) ---------------------------------
    def smooth(self, data, b, x, sweeps: int):
        """Apply `sweeps` relaxation sweeps to x. The state carries no
        residual (the JAX package's is dead code its compiler drops; here
        it would cost an SpMV): a smoother that needs one forms it in
        solve_init."""
        st = {"x": x}
        st.update(self.solve_init(data, b, x, None))
        for _ in range(sweeps):
            st = self.solve_iteration(data, b, st)
        return st["x"]

    def smooth_residual(self, data, b, x, sweeps: int):
        """(x', r) after `sweeps` sweeps plus r = b - A x'."""
        x = self.smooth(data, b, x, sweeps)
        return x, _residual(data["A"], x, b)


def make_solver(name: str, cfg: Config, scope: str = "default",
                device="cpu") -> Solver:
    """SolverFactory::allocate analog."""
    cls = registry.solvers.get(name)
    return cls(cfg, scope, name=name.upper(), device=device)


def create_solver(cfg: Config, scope: str = "default",
                  device=None) -> Solver:
    """Build the root solver tree from a config. `device=None` runs on
    the card and raises when there is none; pass device="cpu" for the
    CPU."""
    device = resolve_device(device)
    name, child_scope = cfg.get_solver("solver", scope)
    return make_solver(name, cfg, child_scope, device)
