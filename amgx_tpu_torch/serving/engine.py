"""Continuous-batching bucket engine (the port of
amgx_tpu/serving/engine.py).

One `BucketEngine` owns a fixed-width batch of in-flight systems that
share a sparsity pattern (and therefore one AMG hierarchy structure).
Instead of the `RequestBatcher`'s drain-and-wait dispatch, where a batch
admitted together must finish together, the engine steps every occupied
slot by `chunk` iterations per scheduler cycle through the chunked solve
entry (`Solver._build_chunk_fns`), reads the per-slot done flags at the
cycle boundary (one host read a step), finalizes converged slots, and
lets the scheduler refill them with queued requests at once. A drained
slot's state is frozen by the device mask, so empty and finished slots
ride along unchanged.

The solve data is the solver's tree with each tensor leaf either shared
by the slots or stacked `(slots, ...)`. Which is which is found ONCE per
bucket by a probe value resetup (`_split_data`: the leaves a value-only
resetup replaces are per slot; the structure survives it as the same
objects, batch/core.py's identity contract) or read from the warm-start
store (serving/aot.py). The stacked tensors are allocated at build and
never again: an admit copies the system's rows into its slot in place
(`copy_` on the same storage), so the tree, its kernels' cached card
plans (ops/cuda_tail.py `_CardPlan`) and every pointer they hold stay
valid for the bucket's lifetime.

Device and streams: the bucket is built on the service's device (a
builder thread enters it) and records an event on its stream when the
build is complete; the scheduler's first use of the bucket waits on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..batch.core import BatchedSolver, _solver_tree
from ..config import Config
from ..errors import BadParametersError
from ..matrix import CsrMatrix
from ..profiling import trace_region
from ..resilience import faultinject as _fi
from ..solvers.base import Solver, SolveResult
from .aot import AotStore
from .hstore import HierarchyStore

_ENGINE_FNS = ("split", "libraries")


# ---------------------------------------------------------------------------
# the solve-data tree as a flat list of unique tensors
# ---------------------------------------------------------------------------


def _flatten(tree):
    """(leaves, spec): the tree's unique tensors in first-visit order (a
    tensor that recurs is one leaf) and the structure to rebuild it.
    Dicts, lists, tuples and dataclasses (CsrMatrix, StencilOperator)
    are walked; anything else is a static value."""
    leaves, index = [], {}

    def walk(node):
        if torch.is_tensor(node):
            i = index.get(id(node))
            if i is None:
                i = index[id(node)] = len(leaves)
                leaves.append(node)
            return ("T", i)
        if isinstance(node, dict):
            return ("D", tuple((k, walk(v)) for k, v in node.items()))
        if isinstance(node, (list, tuple)):
            return ("L", type(node), tuple(walk(v) for v in node))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return ("C", node, tuple((f.name, walk(getattr(node, f.name)))
                                     for f in dataclasses.fields(node)))
        return ("S", node)

    return leaves, walk(tree)


def _unflatten(spec, leaves):
    def build(s):
        kind = s[0]
        if kind == "T":
            return leaves[s[1]]
        if kind == "D":
            return {k: build(v) for k, v in s[1]}
        if kind == "L":
            items = [build(v) for v in s[2]]
            return s[1](*items) if hasattr(s[1], "_fields") else s[1](items)
        if kind == "C":
            return dataclasses.replace(s[1], **{
                n: build(v) for n, v in s[2] if v[0] != "S"})
        return s[1]

    return build(spec)


def _signature(spec):
    """The structure of a spec without its static values (a value
    resetup may change those, e.g. a stencil's host coefficients)."""
    kind = spec[0]
    if kind == "T":
        return spec
    if kind == "D":
        return ("D", tuple((k, _signature(v)) for k, v in spec[1]))
    if kind == "L":
        return ("L", spec[1].__name__, tuple(_signature(v)
                                             for v in spec[2]))
    if kind == "C":
        return ("C", type(spec[1]).__name__,
                tuple((n, _signature(v)) for n, v in spec[2]))
    return ("S",)


def _leaf_sig(t):
    return [list(t.shape), str(t.dtype).replace("torch.", "")]


class BucketEngine:
    """Continuous-batching engine for one (pattern, dtype) bucket."""

    def __init__(self, cfg: Config, scope: str, template: CsrMatrix,
                 *, slots: int, chunk: int, fingerprint: str = "",
                 aot: Optional[AotStore] = None,
                 hstore: Optional[HierarchyStore] = None, device=None):
        self.fingerprint = fingerprint
        self.slots = int(slots)
        if self.slots < 1:
            raise BadParametersError(
                f"serving: bucket width must be >= 1 slot, got {slots}")
        self.chunk = int(chunk)
        # bucket builds that had to probe the solve data's split (the
        # JAX package's engine traces; a warm start reads 0)
        self.trace_count = 0
        self.aot_warm = False    # the split came from the warm-start store
        self.hier_restored = False  # hierarchy came from the hstore
        # one host read per engine step (the serving cycle's cadence)
        self.host_reads = 0
        # chaos drill: a scripted builder crash fires here, BEFORE any
        # state exists -- exactly like an out-of-memory build would
        _fi.service_crash("build_crash")
        with trace_region("serving.bucket_build"):
            t0 = time.perf_counter()
            self.bs = BatchedSolver(cfg, scope, device=device)
            slv = self.bs.solver
            self.device = slv.device
            with self._on_device():
                self._build(cfg, template, aot, hstore)
            self.build_time = time.perf_counter() - t0
        from ..telemetry import metrics as _tm
        _tm.set_gauge("serving.bucket_width", self.slots)
        # slot bookkeeping is the scheduler's: the engine stores the
        # occupant object opaquely (a ticket, a request, anything)
        self.occupant: List[Optional[Any]] = [None] * self.slots
        # last pulled per-slot iteration counters (progress heartbeat)
        self.iters_snapshot: Optional[np.ndarray] = None

    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _build(self, cfg, template, aot, hstore):
        slv = self.bs.solver
        hkey = None
        if hstore is not None:
            hkey = hstore.key(self.fingerprint, slv.cfg)
            self.hier_restored = hstore.restore_into(hkey, slv)
        template = template.to(self.device)
        if not template.initialized:
            template = template.init()
        self._template = template
        self.bs.setup(template)
        if hkey is not None and not self.hier_restored:
            hstore.save(hkey, slv)
        if slv.scaler is not None:
            raise BadParametersError(
                "serving: equation scaling is unsupported in "
                "continuous batching (set scaling=NONE)")
        self.bs._check_multi_matrix_config()
        self.bs._check_batched()
        # the systems' dtype: the operator's (a request's rhs is cast)
        self.dtype = slv.A.dtype
        self.max_iters = slv.max_iters
        self.hist_len = slv.max_iters + 1
        self.n = template.num_rows
        self._split_data(aot)
        self._init, self._step, self._finish = \
            slv._build_chunk_fns(self.chunk)
        self._B = torch.zeros((self.slots, self.n), dtype=self.dtype,
                              device=self.device)
        # all slots empty: the zero rhs converges at 0 iterations
        state = self._init(self._data, self._B, torch.zeros_like(self._B))
        # one storage a leaf: an admit writes each leaf's row in place
        seen = set()
        self._state = {}
        for k, v in state.items():
            self._state[k] = v.clone() if id(v) in seen else v
            seen.add(id(v))
        self._iters_host = np.zeros(self.slots, np.int64)
        self._term_host = np.ones(self.slots, bool)
        self._maybe_export(aot)
        # the build is complete on this stream: the scheduler's first
        # use waits on this event (it may run on another thread)
        self._ready = None
        if self.device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self.device))

    def _wait_ready(self):
        if self._ready is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready)
            self._ready = None

    # -- structure/value split --------------------------------------------
    def _split_data(self, aot: Optional[AotStore]):
        """Which solve-data leaves a value-only resetup replaces (the
        per-slot half): read from the warm-start store, or found by
        probing with a same-valued copy of the template -- structure
        leaves survive the resetup as the SAME objects, value leaves come
        back fresh. The split is FIXED for the bucket's lifetime, so
        every admit is a row copy into the stacked tensors."""
        slv = self.bs.solver
        d0, spec0 = _flatten(slv.solve_data())
        self._aot_store, self._aot_saved = aot, False
        axes = None
        if aot is not None:
            loaded = aot.load_bundle(self._aot_key(aot), list(_ENGINE_FNS))
            if loaded is not None:
                axes = self._install_loaded(loaded, d0)
        if axes is not None:
            snap, spec = d0, spec0
            self._snap_src = self._template
        else:
            from ..telemetry import metrics as _tm
            self.trace_count += 1
            _tm.inc("serving.retrace")
            probe = self._template.with_values(self._template.values + 0)
            slv.resetup(probe)
            snap, spec = _flatten(slv.solve_data())
            if _signature(spec) != _signature(spec0):
                raise BadParametersError(
                    "serving: solve-data structure changed across a "
                    "value-only resetup; continuous batching needs "
                    "structure_reuse_levels=-1 so the hierarchy structure "
                    "survives per-system value splices")
            axes = [None if a is b else 0 for a, b in zip(d0, snap)]
            self._snap_src = probe
        self._spec = spec
        self._axes_flat = axes
        self._shared_ref = list(snap)
        self._ps_idx = [i for i, ax in enumerate(axes) if ax == 0]
        # shared leaves stay aliased; per-slot leaves start as copies of
        # the snapshot's row and are overwritten in place at admit
        self._data_flat = [
            torch.stack([leaf] * self.slots) if ax == 0 else leaf
            for ax, leaf in zip(axes, snap)]
        self._data = _unflatten(spec, self._data_flat)
        self._snap_flat = snap

    def _install_loaded(self, loaded, leaves):
        """The split of a warm-start bundle, when it fits this build's
        solve data (leaf count, shapes, dtypes), with the bundle's CUDA
        libraries loaded; None otherwise (the build probes)."""
        split = loaded["split"]
        if not isinstance(split, dict) or split.get("leaves") != [
                _leaf_sig(t) for t in leaves] \
                or len(split.get("axes", ())) != len(leaves):
            return None
        if self.device.type == "cuda":
            from ..ops import cuda_build
            for name in loaded["libraries"]:
                cuda_build.library(name)
        self.aot_warm = True
        return [None if a is None else 0 for a in split["axes"]]

    def _on_template(self, A: CsrMatrix) -> CsrMatrix:
        """A request's matrix on the bucket's template: the template's
        own index tensors with A's values (the same pattern, which the
        fingerprint promised), on the bucket's device."""
        if A.num_rows != self.n or A.nnz != self._template.nnz:
            raise BadParametersError(
                f"serving: a {A.num_rows}-row matrix with {A.nnz} entries "
                f"does not fit the bucket's pattern ({self.n} rows, "
                f"{self._template.nnz} entries)")
        return self._template.with_values(
            A.values.to(device=self.device, dtype=self.dtype))

    def _snapshot_for(self, A: CsrMatrix):
        """Per-system solve-data leaves for A, via the value-resetup path
        against the bucket's shared hierarchy structure (memoized on the
        matrix object: a stream resubmitting the same matrix pays zero
        resetups)."""
        if A is self._snap_src:
            return self._snap_flat
        self.bs.solver.resetup(self._on_template(A))
        flat, spec = _flatten(self.bs.solver.solve_data())
        if _signature(spec) != _signature(self._spec):
            raise BadParametersError(
                "serving: hierarchy structure drifted across an admit "
                "resetup (same-fingerprint systems must share one "
                "structure; check structure_reuse_levels=-1)")
        for i, ax in enumerate(self._axes_flat):
            if ax is None and flat[i] is not self._shared_ref[i]:
                raise BadParametersError(
                    "serving: a solve-data leaf the bucket shares across "
                    "slots changed on a value resetup -- the probe "
                    "misclassified it; this solver configuration cannot "
                    "run under continuous batching")
        self._snap_src = A
        self._snap_flat = flat
        return flat

    def _refresh_derived(self):
        """Recompute, in place, the tensors the tree derives from a
        per-slot leaf and caches (a smoother's tiled damping schedule)."""
        for node in _solver_tree(self.bs.solver):
            fn = getattr(node, "refresh_tau_cache", None)
            if fn is not None:
                fn()

    # -- warm-start store --------------------------------------------------
    def _aot_key(self, aot: AotStore) -> str:
        # the SOLVER CONFIG is part of the key: a config edit + restart
        # must MISS the store, never serve a stale split
        cfg = self.bs.solver.cfg
        cfg_sig = (tuple(sorted(cfg.values.items())),
                   tuple(sorted(cfg.param_scopes.items())))
        return aot.key((self.fingerprint, self.slots, self.chunk,
                        self._template.num_rows, str(self.dtype),
                        self.hist_len, self.device.type, cfg_sig))

    def _maybe_export(self, aot: Optional[AotStore]):
        """Persist the bucket's warm-start bundle once its state exists
        (serving/aot.py; a failed save only costs the next restart its
        warm start)."""
        if aot is None or self.aot_warm or self._aot_saved:
            return
        self._aot_saved = True
        from ..ops import cuda_build
        aot.save_bundle(
            self._aot_key(aot),
            {"split": {"axes": [None if a is None else 0
                                for a in self._axes_flat],
                       "leaves": [_leaf_sig(t) for t in self._snap_flat]},
             "libraries": list(dict.fromkeys(cuda_build.LOADED))},
            {"state_keys": sorted(self._state), "n": self.n,
             "slots": self.slots, "chunk": self.chunk,
             "dtype": str(self.dtype), "hist_len": self.hist_len})

    # -- scheduling surface ------------------------------------------------
    @property
    def idle(self) -> bool:
        return all(o is None for o in self.occupant)

    @property
    def inflight(self) -> int:
        return sum(o is not None for o in self.occupant)

    def free_slot(self) -> Optional[int]:
        for j, o in enumerate(self.occupant):
            if o is None:
                return j
        return None

    def footprint_tree(self):
        """The byte-accounting view (serving/cache.py
        solve_data_bytes): the stacked data plus the carried state."""
        return (self._data_flat, list(self._state.values()), self._B)

    def _splice_slot(self, slot: int, A: CsrMatrix, b):
        """Shared admit prologue: the system's value-resetup snapshot
        copied into the per-slot data rows and its rhs into the slot's
        row, all in place."""
        snap = self._snapshot_for(A)
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        if tuple(b.shape) != (self.n,):
            raise BadParametersError(
                f"serving: rhs shape {tuple(b.shape)} does not fit the "
                f"bucket's ({self.n},) systems")
        for i in self._ps_idx:
            self._data_flat[i][slot].copy_(snap[i])
        self._B[slot].copy_(b)
        self._refresh_derived()
        return snap, b

    def _check_reserved(self, slot: int, occupant: Any):
        # the lock-split scheduler reserves the slot (sets a UNIQUE
        # occupant object) under its lock, then runs the device splice
        # outside it -- admitting into your own reservation is fine,
        # anything else is a caller bug. The default occupant=True is
        # not a reservation, so direct engine users keep the strict
        # occupied-slot guard.
        if self.occupant[slot] is None:
            return
        if occupant is True or self.occupant[slot] is not occupant:
            raise BadParametersError(f"serving: slot {slot} is occupied")

    def _trace_args(self, *occupants):
        """Span args tagging a stage with its occupants' request trace
        ids (None when nothing is tagged)."""
        ids = [tr for o in occupants
               for tr in [getattr(o, "trace_id", None)] if tr]
        if not ids:
            return None
        if len(ids) == 1:
            return {"trace": ids[0]}
        return {"traces": ids}

    def admit(self, slot: int, A: CsrMatrix, b, x0=None,
              occupant: Any = True):
        """Fill `slot` with a new system at a cycle boundary: splice its
        values into the per-slot data rows (value-resetup path) and set
        its freshly initialized solve state. The initialization runs at
        the bucket's full width (a one-shot batched solve of this width
        initializes the same way, bit for bit) and only the slot's row
        is kept."""
        self._check_reserved(slot, occupant)
        with self._on_device(), trace_region(
                "serving.admit", args=self._trace_args(occupant)):
            self._wait_ready()
            self._splice_slot(slot, A, b)
            X0 = torch.zeros_like(self._B)
            if x0 is not None:
                X0[slot] = torch.as_tensor(x0).to(device=self.device,
                                                  dtype=self.dtype)
            row = self._init(self._data, self._B, X0)
            for k, v in row.items():
                self._state[k][slot] = v[slot]
            self._iters_host[slot] = 0
            self._term_host[slot] = False
        self.occupant[slot] = occupant

    def admit_resume(self, slot: int, A: CsrMatrix, b, state_row,
                     occupant: Any = True):
        """Refill `slot` from a checkpointed solve-state row (crash
        recovery / quarantine requeue): the same data splice as `admit`,
        but the state is RESTORED, not re-initialized -- the resumed
        system then visits bit-identical iterates to the uninterrupted
        solve (the chunk window is entry-relative). Raises
        BadParametersError on a state-layout mismatch (config drift
        across the restart); callers fall back to a fresh admit."""
        self._check_reserved(slot, occupant)
        if set(state_row) != set(self._state):
            raise BadParametersError(
                "serving: checkpointed state keys do not match this "
                "bucket's solve state (solver config drifted across "
                "the restart?)")
        rows = {}
        for k, v in state_row.items():
            ref = self._state[k]
            v = torch.as_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(ref.shape[1:]) \
                    or v.dtype != ref.dtype:
                raise BadParametersError(
                    f"serving: checkpointed state leaf {k!r} has "
                    f"{tuple(v.shape)}/{v.dtype}, bucket expects "
                    f"{tuple(ref.shape[1:])}/{ref.dtype}")
            rows[k] = v
        with self._on_device(), trace_region(
                "serving.admit", args=self._trace_args(occupant)):
            self._wait_ready()
            self._splice_slot(slot, A, b)
            for k, v in rows.items():
                self._state[k][slot] = v.to(self.device)
            self._iters_host[slot] = int(rows["iters"])
            self._term_host[slot] = bool(rows["done"]) \
                or int(rows["iters"]) >= self.max_iters
        self.occupant[slot] = occupant

    def state_rows(self, slots: List[int]) -> Dict[int, Dict[str, Any]]:
        """Host-pulled solve-state rows for `slots` -- the checkpoint
        source (and the quarantine salvage source): numpy copies of each
        slot's row of every state leaf."""
        host = {k: v.detach().cpu().numpy() for k, v in self._state.items()}
        return {j: {k: np.array(host[k][j]) for k in host} for j in slots}

    def step(self) -> List[int]:
        """One engine cycle: every occupied, unfinished slot advances up
        to `chunk` iterations (finished and empty slots are frozen by the
        device mask). Returns the occupied slots that are now terminal
        (converged, failed, or out of iterations) -- ONE small
        device->host read a cycle, the done flags with the iteration row
        (`iters_snapshot`, the supervisor's progress heartbeat)."""
        if self.idle:
            return []
        # chaos drills: a scripted device-step exception (the quarantine
        # path's food) or a silently wedged cycle (the heartbeat
        # detector's)
        _fi.service_crash("step_crash")
        if _fi.step_wedged():
            return []
        live = [j for j in range(self.slots)
                if self.occupant[j] is not None and not self._term_host[j]]
        with self._on_device(), trace_region(
                "serving.step", args=self._trace_args(*self.occupant)):
            self._wait_ready()
            if live:
                n_it = min(self.chunk, max(self.max_iters
                                           - int(self._iters_host[j])
                                           for j in live))
                first = min(int(self._iters_host[j]) for j in live)
                self._state = self._step(self._data, self._B, self._state,
                                         n_it, first)
            st = self._state
            buf = torch.stack([
                (st["done"] | (st["iters"] >= self.max_iters)).to(
                    torch.int64), st["iters"]]).cpu().numpy()
            self.host_reads += 1
            term = buf[0].astype(bool)
            self.iters_snapshot = buf[1]
            self._iters_host = buf[1].copy()
            self._term_host = term.copy()
        return [j for j in range(self.slots)
                if self.occupant[j] is not None and bool(term[j])]

    def finalize(self, slot_list: List[int]) -> Dict[int, SolveResult]:
        """Per-slot SolveResults for `slot_list` (one batched finalize
        pass and one host read; mid-flight neighbors' states are read,
        not disturbed). Does NOT free the slots -- the scheduler does,
        after deadline bookkeeping."""
        if not slot_list:
            return {}
        with self._on_device(), trace_region(
                "serving.finalize", args=self._trace_args(
                    *(self.occupant[j] for j in slot_list))):
            self._wait_ready()
            X, stats = self._finish(self._data, self._B, self._state)
        out = {}
        slv = self.bs.solver
        ndt = np.dtype(str(self._state["norm0"].dtype).replace("torch.",
                                                               ""))
        for j in slot_list:
            it, cv, sc, n0, rn, h = Solver.unpack_stats(stats[j],
                                                        self.hist_len)
            out[j] = SolveResult(
                x=X[j].clone(), iterations=it, converged=cv,
                res_norm=np.asarray(rn, ndt), norm0=np.asarray(n0, ndt),
                res_history=np.asarray(h, ndt) if slv.store_res_history
                else None,
                setup_time=self.bs.setup_time, status_code=sc)
        return out

    def release(self, slot: int):
        """Free a slot and FREEZE its lane: a released-but-unfinished
        system (deadline expiry) must not keep running in the vacant
        slot, so `done` is forced True -- idempotent for terminal slots;
        the next admit overwrites the whole state row anyway."""
        with self._on_device():
            self._state["done"][slot] = True
        self._term_host[slot] = True
        self.occupant[slot] = None
