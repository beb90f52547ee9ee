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
column is the device's current allocation (memory_info.py,
`torch.cuda.memory_allocated`; 0 on the CPU, where the JAX package
prints 0 too).

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
port theirs (`batch_refusal`). `_build_chunk_fns` is the same loop in
resumable chunks, its decisions made on the device (the serving engine's
continuous batching, amgx_tpu_torch/serving/engine.py).

Telemetry (amgx_tpu_torch/telemetry/): setup, resetup and solve are host
spans (`<NAME>.setup`, `<NAME>.resetup`, `<NAME>.solve`); with the
`telemetry` knob on (the default) a root solve attaches a SolveReport
built from the host values it already read, and the allocator's peaks
feed `memory.setup_peak_bytes` / `memory.solve_peak_bytes` (no device
synchronization). With `diagnostics=1` on an AMG member of the tree, the
root solve runs one probe cycle on its final residual
(telemetry/diagnostics.py) and reads its norms in one transfer.

Fault injection (resilience/faultinject.py): each loop is a
`solve_scope` (the outermost one, the root solve, consumes the armed
firings its hooks reached) and each iteration an `iteration_scope`, so
the hooks under `solve_iteration` know the iteration they run in.
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
from ..errors import BadParametersError, NotImplementedError_
from ..matrix import CsrMatrix
from ..ops import blas
from ..ops.spmv import residual as _residual
from ..precision import resolve_precision
from ..resilience import faultinject as _fi
from ..resilience.status import RUNNING as _ST_RUNNING
from ..resilience.status import SolveStatus, status_string
from ..telemetry import metrics as _tm

# ---------------------------------------------------------------------------
# convergence criteria
# ---------------------------------------------------------------------------


# the tolerance tensors of `Convergence._d`
_DEVICE_TOLS: Dict[Any, torch.Tensor] = {}


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

    @staticmethod
    def _d(tol, like):
        """The tolerance as a tensor of the norms' dtype (`_t`'s rounding)
        on their device, made once per (value, dtype, device): a step of
        the chunked entry then copies nothing to the device."""
        key = (float(tol), like.dtype, like.device)
        t = _DEVICE_TOLS.get(key)
        if t is None:
            t = _DEVICE_TOLS[key] = torch.tensor(tol, dtype=like.dtype,
                                                 device=like.device)
        return t

    def check_each(self, res_norm, norm0):
        """`check` on each system of a batch: a (B,) bool tensor from (B,)
        norm tensors (on the host or the device), with `check`'s
        arithmetic."""
        raise NotImplementedError(
            f"{type(self).__name__} has no per-system check")


@registry.convergence.register("ABSOLUTE")
class AbsoluteConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(res_norm <= self._t(self.tolerance, res_norm)))

    def check_each(self, res_norm, norm0):
        return res_norm <= self._d(self.tolerance, res_norm)


@registry.convergence.register("RELATIVE_INI")
@registry.convergence.register("RELATIVE_INI_CORE")
class RelativeIniConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(res_norm <= self._t(self.tolerance, norm0)
                           * norm0))

    def check_each(self, res_norm, norm0):
        return res_norm <= self._d(self.tolerance, norm0) * norm0


@registry.convergence.register("RELATIVE_MAX")
@registry.convergence.register("RELATIVE_MAX_CORE")
class RelativeMaxConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(res_norm <= self._t(self.tolerance, norm0)
                           * np.max(norm0)))

    def check_each(self, res_norm, norm0):
        # one norm a system (scalar matrices): its max is itself
        return res_norm <= self._d(self.tolerance, norm0) * norm0


@registry.convergence.register("COMBINED_REL_INI_ABS")
class CombinedRelIniAbsConvergence(Convergence):
    def check(self, res_norm, norm0):
        return bool(np.all(
            (res_norm <= self._t(self.tolerance, res_norm))
            | (res_norm <= self._t(self.alt_rel_tolerance, norm0) * norm0)))

    def check_each(self, res_norm, norm0):
        return (res_norm <= self._d(self.tolerance, res_norm)) | (
            res_norm <= self._d(self.alt_rel_tolerance, norm0) * norm0)


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
    # structured telemetry (telemetry/report.py SolveReport), attached by
    # a root solve when the `telemetry` knob is on
    report: Optional[Any] = None

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
                 device=None):
        self.cfg = cfg
        self.scope = scope
        self.name = name
        # no CPU default: None means the card, as in create_solver (a
        # tree built in a service's builder thread or rebuilt by a
        # supervisor lands on the device its builder names)
        self.device = resolve_device(device)
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
        # report construction and the memory watermarks (telemetry/);
        # telemetry_sync is a process mode latched by create_solver
        self.telemetry = bool(int(cfg.get("telemetry", scope)))
        self.scaling = str(cfg.get("scaling", scope)).upper()
        self.scaler = None
        # only the tree's root scales the equations: children get the
        # scaled matrix and exchange vectors in its coordinates (their
        # creation sites clear the flag)
        self._owns_scaling = True
        # rejects contradictory precision knobs at construction
        self._precision_policy = resolve_precision(cfg, scope)
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
        # solve keys seen (solver.retrace.solve: the JAX package's jit
        # cache key -- rhs shape, dtype, fault-injection epoch)
        self._solve_keys: Dict[Any, bool] = {}

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

    def setup_async(self, A: CsrMatrix):
        """Run setup on a worker thread (thread_manager.py; the reference's
        AsyncSolverSetupTask): returns a task whose wait() joins and
        re-raises. The worker builds on this solver's device and the
        caller's current stream; the solver must not be used before
        wait()."""
        from ..thread_manager import setup_async
        return setup_async(self, A)

    def _setup_impl(self, A: CsrMatrix, reuse: bool):
        from ..profiling import trace_region
        # two literal span names, so the span registry check covers them
        if reuse:
            with trace_region(f"{self.name}.resetup"):
                out = self._setup_body(A, reuse)
        else:
            with trace_region(f"{self.name}.setup"):
                out = self._setup_body(A, reuse)
        if self.telemetry:
            from ..memory_info import peak_bytes
            _tm.max_gauge("memory.setup_peak_bytes", peak_bytes([self.device]))
        return out

    def _setup_body(self, A: CsrMatrix, reuse: bool):
        t0 = time.perf_counter()
        if A.dtype.is_complex:
            raise NotImplementedError_(
                f"solver {self.name}: complex arithmetic is not ported to "
                "amgx_tpu_torch yet (ROADMAP.md Queue A item 15); read the "
                "system with complex_conversion set to solve its real "
                "K-formulation")
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
        with _fi.solve_scope():
            return self._run_loop(data, b, x0)

    def _run_loop(self, data, b, x0):
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
            with _fi.iteration_scope(iters):
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

    def _status_now(self, rn, norm0, past, broken):
        """The status a batch's residual norms `rn` (B,) call for after
        an iteration, the one rule of both batched loops (host tensors in
        `run_loop_batched`, device ones in `_build_chunk_fns`): a (B,)
        int64 tensor, RUNNING where no test holds, a later test taking
        precedence (stall, divergence, NaN, breakdown, convergence).
        `past`: the norms `stall_window` iterations back (NaN where a
        system has not run that long), or None; `broken`: (B,) bool
        breakdown flags, or None."""
        S = SolveStatus
        now = torch.full(rn.shape, _ST_RUNNING, dtype=torch.int64,
                         device=rn.device)
        guards = self.health_guards
        if guards and self.stall_window > 0 and past is not None:
            now.masked_fill_(rn >= Convergence._d(
                1.0 - self.stall_tolerance, rn) * past, int(S.STALLED))
        if self.rel_div_tolerance > 0:
            now.masked_fill_(rn > Convergence._d(
                self.rel_div_tolerance, rn) * norm0, int(S.DIVERGED))
        if guards:
            now.masked_fill_(~torch.isfinite(rn), int(S.NAN_DETECTED))
            if broken is not None:
                now.masked_fill_(broken, int(S.BREAKDOWN))
        now.masked_fill_(self.convergence.check_each(rn, norm0),
                         int(S.CONVERGED))
        return now

    def run_loop_batched(self, data, b, x0):
        """`run_loop` on a batch: b, x0 (B, n). Returns (X, stats) with
        stats a dict of host arrays: iters, converged, status, norm0 and
        res_norm (B,), res_hist (B, max_iters + 1) (NaN past each
        system's stop)."""
        with _fi.solve_scope():
            return self._run_loop_batched(data, b, x0)

    def _run_loop_batched(self, data, b, x0):
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
            n0 = torch.from_numpy(norm0)
            done |= conv.check_each(n0, n0).numpy()
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
            with _fi.iteration_scope(it):
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
            w = self.stall_window
            now = self._status_now(
                torch.from_numpy(rn), torch.from_numpy(norm0),
                torch.from_numpy(hist[:, it - w]) if 0 < w <= it else None,
                torch.from_numpy(broken)).numpy()
            status[run] = now[run]
            done = status != _ST_RUNNING
        x = self.finalize(data, b, state)
        status[status == _ST_RUNNING] = int(S.MAX_ITERS)
        return x, {"iters": iters, "converged": status == int(S.CONVERGED),
                   "status": status, "norm0": norm0, "res_norm": res_norm,
                   "res_hist": hist}

    # -- chunked stepping (serving/engine.py continuous batching) ---------
    # the state leaves the chunked entry keeps beside the solver's own
    CHUNK_BOOK = ("iters", "done", "converged", "status", "res_norm",
                  "norm0", "res_hist")

    def _build_chunk_fns(self, chunk: int):
        """Resumable chunked iteration over a batch -- the substrate of the
        serving layer's continuous batching (the counterpart of the JAX
        package's `_build_chunk_fns`). Returns three functions::

            init(data, b, x0)           -> state
            step(data, b, state, n_it)  -> state   # <= `chunk` more iters
            finish(data, b, state)      -> (x, stats)

        on a batch: b, x0 (B, n), the solve data shared or stacked as
        `run_loop_batched` takes it. The state is `run_loop_batched`'s
        recurrence with its host bookkeeping moved to the device as (B,)
        leaves (`CHUNK_BOOK`; `norm0` among them, so stepping resumes
        across host boundaries) and the history (B, max_iters + 1), NaN
        past each system's stop. `run_loop_batched`'s status rule
        (`_status_now`) runs here on the device tensors, so `step` reads
        the host nowhere: it launches `n_it` iterations (at most `chunk`; the
        caller knows from its last read how many can still run) and each
        freezes, by the device mask, the systems that are terminal or
        have run `chunk` iterations since the step's entry (the window
        is per system, `iters < entry + chunk`). A system stepped in
        chunks visits the iterates of a one-shot batched solve of the
        same width, bit for bit. `finish` returns x and the per-system
        stats in one host read: a (B, 5 + max_iters + 1) float64 array
        of iters, converged, status, norm0, res_norm and the history."""
        S = SolveStatus
        max_iters = self.max_iters
        monitor = self.monitor_residual
        conv = self.convergence
        guards = self.health_guards
        stall_w = self.stall_window if guards else 0
        chunk = int(chunk)
        book = self.CHUNK_BOOK
        running, converged_ = int(_ST_RUNNING), int(S.CONVERGED)

        def as_leaves(core, like):
            # a host flag (the guards' initial breakdown) as a (B,) leaf
            out = {}
            for k, v in core.items():
                if not torch.is_tensor(v):
                    v = torch.full(like.shape[:1], v, device=like.device)
                out[k] = v
            return out

        def init(data, b, x0):
            r0 = _residual(data["A"], x0, b)
            norm0 = self._norm(r0)
            core = {"x": x0, "r": r0}
            core.update(self.solve_init(data, b, x0, r0))
            st = as_leaves(core, b)
            done = norm0 == 0
            if monitor:
                done = done | conv.check_each(norm0, norm0)
            status = torch.full(norm0.shape, running, dtype=torch.int64,
                                device=b.device)
            st.update(
                iters=torch.zeros(norm0.shape, dtype=torch.int64,
                                  device=b.device),
                done=done, converged=done.clone(),
                status=torch.where(done, torch.full_like(status,
                                                         converged_),
                                   status),
                res_norm=norm0.clone(), norm0=norm0,
                res_hist=torch.cat([norm0[:, None], torch.full(
                    (norm0.shape[0], max_iters), float("nan"),
                    dtype=norm0.dtype, device=b.device)], 1))
            return st

        def iterate(data, b, st, active, it):
            core = {k: v for k, v in st.items() if k not in book}
            with _fi.iteration_scope(it):
                new = self.solve_iteration(data, b, core)
            core = _freeze(active, as_leaves(new, b), core)
            out = dict(st)
            out.update(core)
            iters = st["iters"] + active.to(torch.int64)
            out["iters"] = iters
            if not monitor:
                return out
            rn = self.internal_res_norm(core)
            if rn is None:
                r = core["r"] if self.computes_residual() \
                    else _residual(data["A"], core["x"], b)
                rn = self._norm(r)
            rn = rn.to(st["norm0"].dtype)
            norm0, hist = st["norm0"], st["res_hist"]
            out["res_norm"] = torch.where(active, rn, st["res_norm"])
            idx = iters.clamp(max=max_iters)[:, None]
            hist = hist.scatter(1, idx, torch.where(
                active, rn, hist.gather(1, idx)[:, 0])[:, None])
            out["res_hist"] = hist
            past = None
            if stall_w > 0:
                past = torch.where(iters >= stall_w, hist.gather(1, (
                    iters - stall_w).clamp(min=0)[:, None])[:, 0],
                    torch.full_like(rn, float("nan")))
            brk = self.breakdown(core) if guards else None
            now = self._status_now(rn, norm0, past, brk.to(torch.bool)
                                   if torch.is_tensor(brk) else None)
            status = torch.where(active & (st["status"] == running), now,
                                 st["status"])
            out["status"] = status
            out["done"] = status != running
            out["converged"] = status == converged_
            return out

        def step(data, b, st, n_it=None, first_iter=0):
            entry = st["iters"]
            with _fi.solve_scope():
                for k in range(chunk if n_it is None else min(n_it,
                                                              chunk)):
                    active = (~st["done"]) & (st["iters"] < max_iters) \
                        & (st["iters"] < entry + chunk)
                    st = iterate(data, b, st, active, first_iter + k)
            return st

        def finish(data, b, st):
            core = {k: v for k, v in st.items() if k not in book}
            x = self.finalize(data, b, core)
            status = torch.where(st["status"] == running,
                                 torch.full_like(st["status"],
                                                 int(S.MAX_ITERS)),
                                 st["status"])
            f64 = torch.float64
            stats = _host(torch.cat([
                torch.stack([st["iters"].to(f64),
                             st["converged"].to(f64), status.to(f64),
                             st["norm0"].to(f64), st["res_norm"].to(f64)],
                            1), st["res_hist"].to(f64)], 1))
            return x, stats

        return init, step, finish

    @staticmethod
    def unpack_stats(stats, hist_len: int):
        """One system's row of `finish`'s stats: (iters, converged,
        status, norm0, res_norm, res_hist), the history trimmed to iters
        + 1 entries; norms in float64 (the host view of the norms)."""
        stats = np.asarray(stats)
        iters = int(stats[0])
        hist = stats[5:5 + hist_len][: iters + 1]
        return (iters, bool(stats[1]), int(stats[2]), stats[3], stats[4],
                hist)

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
        from ..profiling import trace_region
        with trace_region(f"{self.name}.solve"):
            return self._solve(b, x0, zero_initial_guess)

    def _diag_probe_spec(self):
        """(amg, data_keys) when this tree owns an AMG hierarchy with
        `diagnostics` on: `data_keys` is the solve_data path from the
        root to the hierarchy's data, at any preconditioner depth. None
        when the knob is off or the hierarchy has no smoothed level."""
        s, keys = self, []
        for _ in range(8):
            if s is None:
                return None
            amg = getattr(s, "amg", None)
            if amg is not None:
                if amg.diagnostics and amg.levels:
                    return amg, keys + ["amg"]
                return None
            keys.append(s._child_data_key)
            s = s.preconditioner
        return None

    def _precision_block(self, res) -> Optional[Dict[str, Any]]:
        """SolveReport.precision, or None when solve_precision is unset."""
        pol = self._precision_policy
        if not pol.solve_precision:
            return None
        cast = pol.cast_dtype
        return {
            "solve_precision": pol.name,
            "cycle_dtype": "native" if cast is None
            else str(cast).replace("torch.", ""),
            "outer_dtype": None if self.A is None
            else str(self.A.dtype).replace("torch.", ""),
            "outer_iterations": int(res.iterations),
        }

    def _solve(self, b, x0, zero_initial_guess):
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
        key = (tuple(b.shape), str(b.dtype), _fi.epoch())
        if key not in self._solve_keys:
            _tm.inc("solver.retrace.solve")
            _fi.evict_stale_epochs(self._solve_keys, key[-1])
            self._solve_keys[key] = True
        t0 = time.perf_counter()
        data = self.solve_data()
        x, st = self.run_loop(data, b, x0)
        diag_spec = self._diag_probe_spec()
        probe = None
        if diag_spec is not None:
            # one instrumented cycle on the final residual, its norms
            # read in one transfer (telemetry/diagnostics.py)
            from ..telemetry import diagnostics as _dg
            amg, keys = diag_spec
            sub = data
            for k in keys:
                sub = sub[k]
            r_fin = _residual(data["A"], x, b)
            probe = _host(_dg.probe_cycle(
                amg, sub, r_fin, torch.promote_types(r_fin.dtype,
                                                     torch.float32)))
        if self.scaler is not None:
            x = self.scaler.from_scaled_x(x)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        solve_time = time.perf_counter() - t0
        hist = np.asarray(st["res_hist"])
        res = SolveResult(
            x=x, iterations=st["iters"], converged=st["converged"],
            res_norm=np.asarray(st["res_norm"]),
            norm0=np.asarray(st["norm0"]),
            res_history=hist if self.store_res_history else None,
            setup_time=self.setup_time, solve_time=solve_time,
            status_code=st["status"], extra_stats=st["extra"])
        if self.telemetry:
            # the report reads host values the loop already holds
            from ..memory_info import peak_bytes
            from ..telemetry import build_report
            diag = None
            if probe is not None:
                from ..telemetry import diagnostics as _dg
                diag = _dg.derive(probe, len(diag_spec[0].levels),
                                  res_hist=hist)
            res.report = build_report(self, res, hist=hist,
                                      diagnostics=diag,
                                      precision=self._precision_block(res))
            _tm.max_gauge("memory.solve_peak_bytes", peak_bytes([self.device]))
        if self.print_solve_stats:
            self._print_stats(res, hist)
        return res

    def _print_stats(self, res: SolveResult, hist):
        """The solve table of print_solve_stats (and obtain_timings)."""
        from ..memory_info import update_max_memory_usage
        from ..output import amgx_printf
        mem_gb = update_max_memory_usage([self.device]) / 2**30
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


def make_solver(name: str, cfg: Config, scope: str, device) -> Solver:
    """SolverFactory::allocate analog. `device` has no default: every
    node of a tree (and every tree a fallback rebuilds) is built on the
    device its caller names."""
    cls = registry.solvers.get(name)
    return cls(cfg, scope, name=name.upper(), device=device)


def create_solver(cfg: Config, scope: str = "default",
                  device=None) -> Solver:
    """Build the root solver tree from a config. `device=None` runs on
    the card and raises when there is none; pass device="cpu" for the
    CPU. A non-empty `fallback_policy` wraps the tree in a
    ResilientSolver (resilience/policy.py), so a failed solve runs its
    recovery chain; `telemetry_sync` latches the span fencing mode (in
    both directions; the AMGX_TPU_TELEMETRY_SYNC environment toggle
    keeps it on) and `flightrec_dir` attaches the flight recorder's
    disk mirror."""
    device = resolve_device(device)
    name, child_scope = cfg.get_solver("solver", scope)
    from ..telemetry import spans as _spans
    _spans.set_sync(bool(int(cfg.get("telemetry_sync", child_scope)))
                    or _spans.env_sync())
    fdir = str(cfg.get("flightrec_dir", child_scope)).strip()
    if fdir:
        from ..telemetry import flightrec
        flightrec.configure(fdir)
    slv = make_solver(name, cfg, child_scope, device)
    if str(cfg.get("fallback_policy", child_scope)).strip():
        from ..resilience.policy import ResilientSolver
        return ResilientSolver(cfg, child_scope, solver=slv)
    return slv
