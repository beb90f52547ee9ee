"""BatchedSolver: one loop solving many systems at once (the port of
amgx_tpu/batch/core.py).

Execution model
---------------
The JAX package vmaps its traced `while_loop` solve. The port has no
trace: a batch is an explicit leading axis. `Solver.run_loop_batched`
(solvers/base.py) runs the solver's own iteration on b and x of shape
(B, n) with (B,) scalars: each iteration launches every kernel once for
the whole batch (the batched kernels K1-K4, ops/cuda_batched.py, and
the JAX package's vmap compositions elsewhere) and reads the host once.
A system that has stopped is frozen by a device mask, so it keeps its
own iteration count, x, residual norm and history.

The solve data is the solver's own tree with each leaf either shared
(no batch axis) or stacked along a leading axis:

- multi-RHS: the solve data as it is; only b and x carry the batch axis;
- multi-matrix: same-pattern matrices with per-system values. The
  hierarchy structure is built once (`setup(A0)`); each system's
  coefficients come through `resetup` (structure_reuse_levels=-1: the
  aggregates, the Galerkin plans and the transfer tables are kept, only
  the values rerun), one resetup and one `solve_data()` per distinct
  matrix object. `stack_solve_datas` shares every leaf that is the same
  object in every system and stacks the rest: the batch holds one copy of
  the structure and B copies of the values (DIA slabs (B, k, n), CSR
  values (B, nnz), stencil coefficients (B, k), dinv (B, n), the coarse
  factors (B, nc, nc)).

Integer structure that is equal in content but not the same object
(matrices moved to the solver's device one by one, which copies their
index tensors) is shared too, after one comparison on the device: the
kernels never take per-system index arrays. A float leaf is stacked
unless it is the same object.

The JAX package's `_jit_cache`, `trace_count`, `_keep_batched_traces`
and the fault-injection epoch of its cache key have no counterpart: the
port traces nothing, so a value-only resetup never invalidates a
program. Its `telemetry` reports wait for ROADMAP.md Queue A item 10.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..errors import BadParametersError
from ..matrix import CsrMatrix
from ..ops.stencil import StencilOperator
from ..solvers.base import SolveResult, Solver


@dataclasses.dataclass
class BatchedSolveResult:
    """Per-system results of one batched solve (leading axis = system)."""

    x: torch.Tensor                 # (B, n)
    iterations: np.ndarray          # (B,) int
    converged: np.ndarray           # (B,) bool
    res_norm: np.ndarray            # (B,)
    norm0: np.ndarray               # (B,)
    # (B, max_iters + 1); entries past a system's own stop are NaN
    res_history: Optional[np.ndarray] = None
    setup_time: float = 0.0
    solve_time: float = 0.0
    # per-system SolveStatus codes (resilience/status.py), (B,) int
    status: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return int(self.x.shape[0])

    @property
    def all_converged(self) -> bool:
        return bool(np.all(self.converged))

    def per_system(self) -> List[SolveResult]:
        """Split into per-system SolveResult views."""
        out = []
        for i in range(self.batch_size):
            hist = None
            if self.res_history is not None:
                hist = self.res_history[i][: int(self.iterations[i]) + 1]
            out.append(SolveResult(
                x=self.x[i], iterations=int(self.iterations[i]),
                converged=bool(self.converged[i]),
                res_norm=self.res_norm[i], norm0=self.norm0[i],
                res_history=hist, setup_time=self.setup_time,
                solve_time=self.solve_time,
                status_code=int(self.status[i])
                if self.status is not None else 1))
        return out


def _structure_error(what):
    return BadParametersError(
        f"batched solve: solve-data structure differs between systems "
        f"({what}; the sparsity pattern or hierarchy structure drifted; "
        f"multi-matrix batching requires structure_reuse_levels=-1 so "
        f"every system reuses one hierarchy)")


# the fields of the solve data's dataclass leaves that carry values or
# structure arrays; every other field must be equal across systems
_ARRAY_FIELDS = {CsrMatrix: ("row_offsets", "col_indices", "values",
                             "dia_vals"),
                 StencilOperator: ("coeffs",)}


def stack_solve_datas(datas: Sequence[Any]):
    """Stack per-system solve-data trees along a new leading axis,
    sharing the leaves that are the same object in every system (and
    integer tensors equal in content). The trees hold dicts, lists,
    tuples, tensors, CsrMatrix and StencilOperator (whose coefficients
    stack to (B, k); `host` becomes the tuple of the systems' host
    coefficients) and static values. Returns (stacked, axes): axes has
    the stacked tree's structure with 0 at each stacked tensor and None
    at each shared one (a dataclass leaf: a dict of its array fields'
    axes). Leaves already stacked at another position (the operator
    every level view of A refers to) are stacked once."""
    memo = {}

    def tensors(leaves):
        first = leaves[0]
        shapes = {tuple(t.shape) for t in leaves}
        if len(shapes) != 1:
            raise BadParametersError(
                f"batched solve: per-system solve-data leaf shapes "
                f"differ ({sorted(shapes)}); matrices must share one "
                f"sparsity pattern and hierarchy structure")
        if not first.is_floating_point() and all(
                torch.equal(first, t) for t in leaves[1:]):
            return first, None
        return torch.stack(leaves), 0

    def fields(leaves, cls):
        first = leaves[0]
        arrays = _ARRAY_FIELDS[cls]
        for f in dataclasses.fields(cls):
            if f.name in arrays or f.name == "host":
                continue
            if any(getattr(lv, f.name) != getattr(first, f.name)
                   for lv in leaves[1:]):
                raise _structure_error(f"{cls.__name__}.{f.name}")
        new, axes = {}, {}
        for name in arrays:
            new[name], axes[name] = stack([getattr(lv, name)
                                           for lv in leaves])
        if cls is StencilOperator and axes["coeffs"] == 0:
            new["host"] = tuple(lv.host for lv in leaves)
        return dataclasses.replace(first, **new), axes

    def stack(leaves):
        first = leaves[0]
        if all(lv is first for lv in leaves[1:]):
            return first, None
        key = tuple(id(lv) for lv in leaves)
        if key in memo:
            return memo[key]
        if any(type(lv) is not type(first) for lv in leaves[1:]):
            raise _structure_error(
                f"types {sorted({type(lv).__name__ for lv in leaves})}")
        if isinstance(first, dict):
            if any(lv.keys() != first.keys() for lv in leaves[1:]):
                raise _structure_error("dict keys")
            pairs = {k: stack([lv[k] for lv in leaves]) for k in first}
            out = ({k: v[0] for k, v in pairs.items()},
                   {k: v[1] for k, v in pairs.items()})
        elif isinstance(first, (list, tuple)):
            if any(len(lv) != len(first) for lv in leaves[1:]):
                raise _structure_error("sequence lengths")
            pairs = [stack(list(col)) for col in zip(*leaves)]
            out = (type(first)(p[0] for p in pairs),
                   type(first)(p[1] for p in pairs))
        elif type(first) in _ARRAY_FIELDS:
            out = fields(leaves, type(first))
        elif torch.is_tensor(first):
            out = tensors(leaves)
        else:
            if any(lv != first for lv in leaves[1:]):
                raise _structure_error(f"static value {first!r}")
            out = (first, None)
        memo[key] = out
        return out

    return stack(list(datas))


def _solver_tree(s: Solver):
    """Every solver node reachable from s: the preconditioner chain,
    plus AMG level smoothers and coarse solvers."""
    while s is not None:
        yield s
        amg = getattr(s, "amg", None)
        if amg is not None:
            for lv in amg.levels:
                if lv.smoother is not None:
                    yield from _solver_tree(lv.smoother)
            if getattr(amg, "coarse_solver", None) is not None:
                yield from _solver_tree(amg.coarse_solver)
        s = s.preconditioner


def _amg_nodes(s: Solver):
    for node in _solver_tree(s):
        if hasattr(node, "amg"):
            yield node


class BatchedSolver:
    """Solve many systems in one batched loop (see module docs).

    Construct from a Config (builds its own solver tree on `device`: the
    card unless device="cpu") or wrap an existing root solver with
    ``BatchedSolver(solver=slv)``. The wrapped solver keeps working for
    single solves; both objects hold one tree."""

    def __init__(self, cfg: Optional[Config] = None, scope: str = "default",
                 solver: Optional[Solver] = None, device=None):
        if (cfg is None) == (solver is None):
            raise BadParametersError(
                "BatchedSolver: pass exactly one of cfg or solver")
        if solver is None:
            from ..solvers.base import create_solver
            solver = create_solver(cfg, scope, device=device)
        self.solver = solver
        # Solver.solve_many reuses the latest wrapper
        solver._batched = self
        self.setup_time = 0.0

    # -- setup ----------------------------------------------------------
    def setup(self, A: CsrMatrix) -> "BatchedSolver":
        """Build the solver (and for AMG, the hierarchy structure) from
        the batch's shared-pattern template matrix."""
        t0 = time.perf_counter()
        self.solver.setup(A)
        self.setup_time = time.perf_counter() - t0
        return self

    def _check_multi_matrix_config(self):
        for s in _amg_nodes(self.solver):
            if int(s.cfg.get("structure_reuse_levels", s.scope)) == 0:
                raise BadParametersError(
                    "multi-matrix batching needs the AMG hierarchy "
                    "structure shared across systems: set "
                    "structure_reuse_levels=-1 in the AMG scope so "
                    "resetup splices values instead of re-coarsening")
        for s in _solver_tree(self.solver):
            if s.trace_bakes_values:
                raise BadParametersError(
                    f"multi-matrix batching: solver {s.name} bakes "
                    f"value-derived scalars outside its solve data (see "
                    f"Solver.trace_bakes_values) -- one batch cannot "
                    f"give each system its own; use a solver whose value "
                    f"state flows through solve_data (e.g. JACOBI_L1)")

    def _check_batched(self):
        """Every node of the tree must have a batched iteration."""
        for s in _solver_tree(self.solver):
            why = s.batch_refusal()
            if why is not None:
                raise BadParametersError(f"batched solve: {why}")

    def _per_system_data(self, matrices: Sequence[CsrMatrix]):
        """Resetup the solver per system against the shared structure and
        snapshot each system's solve data. Snapshots are memoized per
        matrix OBJECT, so padded batches that replicate a system
        (batch/queue.py) pay one resetup, not one per duplicate."""
        fresh = self.solver.A is None
        if fresh:
            self.setup(matrices[0])
        self._check_multi_matrix_config()
        self._check_batched()
        datas, memo = [], {}
        if fresh:
            # the setup above already installed matrices[0]'s values
            memo[id(matrices[0])] = self.solver.solve_data()
        for A_i in matrices:
            if id(A_i) not in memo:
                self.solver.resetup(A_i)
                memo[id(A_i)] = self.solver.solve_data()
            datas.append(memo[id(A_i)])
        return datas

    # -- solve -----------------------------------------------------------
    def _stack_vectors(self, vs, what):
        slv = self.solver
        if torch.is_tensor(vs) or hasattr(vs, "ndim"):
            V = torch.as_tensor(vs)
        else:
            V = torch.stack([torch.as_tensor(v) for v in vs])
        V = V.to(device=slv.device, dtype=slv.A.dtype)
        if V.dim() != 2 or V.shape[1] != slv.A.num_rows:
            raise BadParametersError(
                f"batched solve: {what} must stack to (batch, "
                f"{slv.A.num_rows}), got {tuple(V.shape)}")
        return V.contiguous()

    def solve_many(self, bs, matrices: Optional[Sequence[CsrMatrix]] = None,
                   x0s=None, zero_initial_guess: bool = False
                   ) -> BatchedSolveResult:
        """Solve the batch: `bs` is (B, n) (or a sequence of B vectors).

        matrices=None       -> multi-RHS against the already-set-up matrix;
        matrices=[A_0..A_b] -> same-pattern multi-matrix batch (hierarchy
                               structure reused, values spliced per system).
        """
        slv = self.solver
        if slv.scaler is not None:
            raise BadParametersError(
                "batched solve: equation scaling is unsupported "
                "(set scaling=NONE)")
        nb = len(bs)
        if matrices is not None:
            if len(matrices) != nb:
                raise BadParametersError(
                    f"batched solve: {len(matrices)} matrices for "
                    f"{nb} right-hand sides")
            data, _ = stack_solve_datas(self._per_system_data(matrices))
        else:
            if slv.A is None:
                raise BadParametersError(
                    "batched solve: solve_many() before setup()")
            self._check_batched()
            data = slv.solve_data()
        B = self._stack_vectors(bs, "rhs")
        if x0s is None or zero_initial_guess:
            X0 = torch.zeros_like(B)
        else:
            X0 = self._stack_vectors(x0s, "x0s")
        t0 = time.perf_counter()
        X, st = slv.run_loop_batched(data, B, X0)
        if X.device.type == "cuda":
            torch.cuda.synchronize(X.device)
        solve_time = time.perf_counter() - t0
        return BatchedSolveResult(
            x=X, iterations=st["iters"], converged=st["converged"],
            res_norm=st["res_norm"], norm0=st["norm0"],
            res_history=st["res_hist"] if slv.store_res_history else None,
            setup_time=self.setup_time, solve_time=solve_time,
            status=st["status"])
