"""amgx_tpu_torch: the PyTorch/CUDA port of amgx_tpu.

The JAX package `amgx_tpu` stays the reference; this package imports
neither it nor JAX. Entry points run on the CUDA card unless the caller
passes device="cpu"; the kernels on the solve path are hand-written
CUDA (amgx_tpu_torch/csrc/), built with nvcc at first use.

    import amgx_tpu_torch as amgx
    A = amgx.gallery.poisson("7pt", 64, 64, 64)
    slv = amgx.create_solver(amgx.Config.from_string(
        amgx.presets.FLAGSHIP))
    slv.setup(A)
    res = slv.solve(torch.ones(A.num_rows, dtype=torch.float64))
    res.report.to_json()              # telemetry=1 (the default)

Resilience: `create_solver` on a config with `fallback_policy` (e.g.
`presets.RESILIENT_CG`) returns a `resilience.ResilientSolver`;
`resilience.faultinject.inject(...)` arms the fault harness. Runtime
helpers: `profiling`, `memory_info`, `determinism`, `thread_manager`
(`Solver.setup_async`) and `Resources`.
"""
from . import amg, scalers, solvers  # noqa: F401  (register the solver tree)
from . import batch, gallery, presets
from . import (determinism, memory_info, profiling, resilience,  # noqa: F401
               telemetry, thread_manager)
from .config import Config
from .output import register_print_callback
from .matrix import CsrMatrix
from .resources import Resources
from .ops.cuda_spmv import LAUNCHES as _LAUNCHES
from .ops.spgemm import PLAN_COUNTS as _PLAN_COUNTS
from .resilience.status import SolveStatus
from .solvers.base import create_solver

__all__ = ["Config", "CsrMatrix", "Resources", "SolveStatus", "batch",
           "create_solver", "determinism", "gallery", "kernel_launches",
           "memory_info", "plan_counts", "presets", "profiling",
           "register_print_callback", "reset_kernel_launches", "resilience",
           "telemetry", "thread_manager"]


def kernel_launches() -> dict:
    """Launches of each CUDA kernel since the last reset, by name (B1-B10:
    ops/cuda_spmv.py, ops/cuda_krylov.py, ops/cuda_tail.py,
    ops/cuda_csr.py, ops/cuda_rap.py)."""
    return dict(_LAUNCHES)


def plan_counts() -> dict:
    """Galerkin plans built and served from the cross-setup caches since
    the last reset, by kind ("rap", "agg": ops/spgemm.py; "geo":
    amg/aggregation/galerkin.py)."""
    return dict(_PLAN_COUNTS)


def reset_kernel_launches():
    """Zero the launch counts and, beside them, the plan counts."""
    for counts in (_LAUNCHES, _PLAN_COUNTS):
        for name in counts:
            counts[name] = 0
