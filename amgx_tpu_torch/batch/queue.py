"""Serving-style request batching for solves (the port of
amgx_tpu/batch/queue.py).

A stream of solve requests -- many users posting same-shaped systems
(one mesh, perturbed coefficients), a few distinct meshes, mixed dtypes
-- becomes a few batched dispatches:

- requests are bucketed by (sparsity-pattern fingerprint, dtype): only
  systems that can share one hierarchy structure land in one bucket;
- within a bucket, a batch is padded UP to the next size in a fixed
  ladder (`PAD_SIZES`) by replicating the last system (the JAX package
  pads so that its compiled programs stay few; the port keeps the ladder
  so both dispatch the same batches);
- each bucket keeps its own `BatchedSolver` (structure built once from
  the first request's pattern; later requests splice values only), in
  an LRU bounded by entry count and by bytes (`_BucketCache`, the port's
  copy of what it needs of amgx_tpu/serving/cache.py `HierarchyCache`).

Sync callers use `solve_many()`; streaming callers use `submit()` /
`drain()`. The JAX package's `telemetry` counters wait for ROADMAP.md
Queue A item 10; `dispatch_log` records every dispatch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..errors import BadParametersError
from ..matrix import CsrMatrix
from ..solvers.base import SolveResult
from .core import BatchedSolver

# batch-size ladder: requests pad up to the next rung
PAD_SIZES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)

# id(CsrMatrix) -> digest, dropped with the matrix (hashing a 128^3
# system's index arrays costs a device read and tens of ms: a stream
# resubmitting one matrix object must not repay it per request)
_FP_CACHE: Dict[int, str] = {}


def pattern_fingerprint(A: CsrMatrix) -> str:
    """Digest of the sparsity pattern + shape/dtype/grid: systems with
    equal fingerprints can share one hierarchy structure. Values do not
    enter the digest. Memoized per matrix object (CsrMatrix is
    immutable) and dropped with it."""
    cached = _FP_CACHE.get(id(A))
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((A.num_rows, A.num_cols, str(A.dtype),
                   A.grid_shape)).encode())
    for t in (A.row_offsets, A.col_indices):
        h.update(t.to(torch.int32).cpu().contiguous().numpy().tobytes())
    digest = h.hexdigest()
    weakref.finalize(A, _FP_CACHE.pop, id(A), None)
    _FP_CACHE[id(A)] = digest
    return digest


def pad_to_bucket_size(n: int, sizes: Sequence[int] = PAD_SIZES) -> int:
    """Smallest ladder rung >= n (requests beyond the top rung are split
    into top-rung chunks by the caller)."""
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


def solve_data_bytes(solver) -> int:
    """Device bytes of a solver's solve data: the unique tensor leaves
    (shared ones counted once)."""
    seen, total = set(), 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
        elif torch.is_tensor(node) and id(node) not in seen:
            seen.add(id(node))
            total += node.numel() * node.element_size()

    walk(solver.solve_data())
    return total


class _BucketCache:
    """LRU of bucket key -> BatchedSolver, bounded by entry count and by
    bytes (0 disables a bound). The most recently used entry is never
    evicted, so one oversized hierarchy stays servable under any byte
    budget."""

    def __init__(self, budget_bytes: int = 0, max_entries: int = 0,
                 on_evict: Optional[Callable[[str, Any], None]] = None):
        self.budget_bytes = int(budget_bytes)
        self.max_entries = int(max_entries)
        self.on_evict = on_evict
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._bytes: Dict[str, int] = {}
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def total_bytes(self) -> int:
        return sum(self._bytes.values())

    def get(self, key: str):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key: str, entry: Any, nbytes: int = 0):
        self._entries[key] = entry
        self._entries.move_to_end(key)
        self._bytes[key] = int(nbytes)
        while len(self._entries) > 1 and (
                (self.budget_bytes > 0
                 and self.total_bytes > self.budget_bytes)
                or (self.max_entries > 0
                    and len(self._entries) > self.max_entries)):
            victim, old = self._entries.popitem(last=False)
            self._bytes.pop(victim, None)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(victim, old)


@dataclasses.dataclass
class SolveRequest:
    """One pending solve. `result` is filled by drain()."""

    A: CsrMatrix
    b: torch.Tensor
    x0: Optional[torch.Tensor] = None
    fingerprint: str = ""
    result: Optional[SolveResult] = None
    # submission time (time.monotonic): drain() dispatches buckets
    # oldest-first by their earliest pending submit
    submit_t: float = 0.0

    @property
    def done(self) -> bool:
        return self.result is not None


class RequestBatcher:
    """Pattern-bucketed batching front end over BatchedSolver (see
    module docs). One Config serves every bucket; every bucket's solver
    runs on `device` (the card unless device="cpu")."""

    def __init__(self, cfg: Config, scope: str = "default",
                 batch_sizes: Sequence[int] = PAD_SIZES,
                 max_buckets: int = 16, max_bucket_bytes: int = 0,
                 device=None):
        if not batch_sizes or list(batch_sizes) != sorted(set(batch_sizes)):
            raise BadParametersError(
                "RequestBatcher: batch_sizes must be a sorted ladder of "
                "distinct sizes")
        self.cfg = cfg
        self.scope = scope
        self.device = device
        self.batch_sizes = tuple(int(s) for s in batch_sizes)
        self.max_buckets = int(max_buckets)
        self.max_bucket_bytes = int(max_bucket_bytes)
        self._solvers = _BucketCache(
            budget_bytes=self.max_bucket_bytes, max_entries=self.max_buckets,
            on_evict=lambda key, _bs: self._templates.pop(key, None))
        # the matrix object each bucket's solver currently holds values
        # from (detects when a shared-matrix bucket needs a resetup)
        self._templates: Dict[str, CsrMatrix] = {}
        self._pending: Dict[str, List[SolveRequest]] = {}
        # (bucket_key, real, padded) per dispatch
        self.dispatch_log: List[Tuple[str, int, int]] = []

    @property
    def live_buckets(self) -> int:
        return len(self._solvers)

    @property
    def bucket_evictions(self) -> int:
        return self._solvers.evictions

    # -- submit/drain -----------------------------------------------------
    def _bucket_key(self, A: CsrMatrix, b: torch.Tensor) -> str:
        return f"{pattern_fingerprint(A)}/{b.dtype}"

    def submit(self, A: CsrMatrix, b, x0=None) -> SolveRequest:
        """Enqueue one system; returns a ticket whose .result is filled
        by the next drain()."""
        b = torch.as_tensor(b)
        if b.dim() != 1:
            raise BadParametersError(
                f"submit: b must be one system's rhs, got shape "
                f"{tuple(b.shape)}")
        req = SolveRequest(A=A, b=b,
                           x0=None if x0 is None else torch.as_tensor(x0),
                           fingerprint=self._bucket_key(A, b),
                           submit_t=time.monotonic())
        self._pending.setdefault(req.fingerprint, []).append(req)
        return req

    def pending_count(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def drain(self) -> List[SolveRequest]:
        """Dispatch every pending bucket (each as one or more batched
        solves, padded to the ladder) and fill the tickets. Buckets go
        oldest-first by their earliest pending submit, so a hot pattern's
        backlog cannot starve a cold one's single request. Returns the
        completed requests in submission order per bucket."""
        done: List[SolveRequest] = []
        pending, self._pending = self._pending, {}
        for key in sorted(pending,
                          key=lambda k: min(r.submit_t for r in pending[k])):
            reqs = pending[key]
            top = self.batch_sizes[-1]
            for i in range(0, len(reqs), top):
                self._dispatch(key, reqs[i:i + top])
            done.extend(reqs)
        return done

    def solve_many(self, matrices: Sequence[CsrMatrix], bs,
                   x0s=None) -> List[SolveResult]:
        """Sync convenience: submit every system, drain, return results
        in order."""
        if x0s is None:
            x0s = [None] * len(matrices)
        reqs = [self.submit(A, b, x0)
                for A, b, x0 in zip(matrices, bs, x0s)]
        self.drain()
        return [r.result for r in reqs]

    # -- dispatch ---------------------------------------------------------
    def _solver_for(self, key: str, template: CsrMatrix) -> BatchedSolver:
        bs = self._solvers.get(key)
        if bs is None:
            bs = BatchedSolver(self.cfg, self.scope, device=self.device)
            bs.setup(template)
            self._templates[key] = template
            self._solvers.put(key, bs, nbytes=solve_data_bytes(bs.solver))
        return bs

    def _dispatch(self, key: str, reqs: List[SolveRequest]):
        size = pad_to_bucket_size(len(reqs), self.batch_sizes)
        pad = size - len(reqs)
        self.dispatch_log.append((key, len(reqs), size))
        solver = self._solver_for(key, reqs[0].A)
        matrices = [r.A for r in reqs] + [reqs[-1].A] * pad
        bs = torch.stack([r.b for r in reqs] + [reqs[-1].b] * pad)
        if any(r.x0 is not None for r in reqs):
            zeros = torch.zeros_like(reqs[0].b)
            x0s = torch.stack([r.x0 if r.x0 is not None else zeros
                               for r in reqs] + [zeros] * pad)
        else:
            x0s = None
        # single-matrix fast path: every request references the same
        # matrix object -> multi-RHS (no per-system data stacking)
        if all(r.A is reqs[0].A for r in reqs[1:]):
            if self._templates.get(key) is not reqs[0].A:
                solver.solver.resetup(reqs[0].A)
                self._templates[key] = reqs[0].A
            res = solver.solve_many(bs, x0s=x0s)
        else:
            res = solver.solve_many(bs, matrices=matrices, x0s=x0s)
            # the solver now holds the values of the last system the
            # memoized resetup loop visited, not necessarily matrices[-1]
            # (duplicates are skipped): the next fast-path dispatch must
            # resetup instead of trusting stale bookkeeping
            self._templates.pop(key, None)
        for req, r in zip(reqs, res.per_system()):
            req.result = r
        return res
