"""Batched solves: multi-RHS and same-pattern multi-matrix AMG in one
loop (the port of amgx_tpu/batch/).

- multi-RHS: many right-hand sides against one matrix (the solve data is
  shared; only b and x carry the batch axis);
- multi-matrix: many matrices sharing one sparsity pattern, each with its
  own right-hand side. The hierarchy structure is built once; each
  system's values are spliced through `resetup` and stacked along a
  leading batch axis, the structure shared.

A system that converges early is frozen by a device mask while the rest
iterate (solvers/base.py `run_loop_batched`). `queue.RequestBatcher`
buckets a stream of requests by (pattern fingerprint, dtype), pads each
bucket to a ladder of batch sizes and dispatches one batched solve per
bucket.
"""
from .core import BatchedSolveResult, BatchedSolver, stack_solve_datas
from .queue import (PAD_SIZES, RequestBatcher, SolveRequest,
                    pad_to_bucket_size, pattern_fingerprint)

__all__ = [
    "BatchedSolver", "BatchedSolveResult", "RequestBatcher",
    "SolveRequest", "pattern_fingerprint", "pad_to_bucket_size",
    "PAD_SIZES", "stack_solve_datas",
]
