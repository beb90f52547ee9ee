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
"""
from . import amg, solvers  # noqa: F401  (register the solver tree)
from . import gallery, presets
from .config import Config
from .matrix import CsrMatrix
from .ops.cuda_spmv import LAUNCHES as _LAUNCHES
from .resilience.status import SolveStatus
from .solvers.base import create_solver

__all__ = ["Config", "CsrMatrix", "SolveStatus", "create_solver", "gallery",
           "presets", "kernel_launches", "reset_kernel_launches"]


def kernel_launches() -> dict:
    """Launches of each CUDA kernel since the last reset, by name (B1-B10:
    ops/cuda_spmv.py, ops/cuda_krylov.py, ops/cuda_tail.py,
    ops/cuda_csr.py, ops/cuda_rap.py)."""
    return dict(_LAUNCHES)


def reset_kernel_launches():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
