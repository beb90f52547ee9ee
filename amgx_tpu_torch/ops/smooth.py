"""Fused smoother + grid-transfer dispatch for the V-cycle (the port of
amgx_tpu/ops/smooth.py).

The damped-relaxation smoother family

    x_{s+1} = x_s + (tau_s * (b - A x_s)) * dinv        (dinv optional)

runs through the DIA kernels of `cuda_spmv` on float32 DIA levels:
B2 (steps + trailing residual), B3 (steps + restriction epilogue) and
B4 (prolongation prologue + steps). Every entry returns None when the
level is not a float32 square DIA operator; the calling smoother then
composes its unfused sweeps, exactly as the JAX package does off its
fused path (f64 hierarchies, non-DIA layouts, `fused_smoother=0`).

On CPU tensors the kernels' plain twins run, so the CPU route composes
the same arithmetic per level. The fused coarse-tail kernel (B5) is not
ported: the hierarchy refuses a CUDA configuration that asks for it
(amg/hierarchy.py).

Transfer tables (the JAX package's `build_transfer_slabs`, without the
TPU's quota padding and VMEM window bases): `ctab` (m, nc) int32, the
fine rows of each coarse row in ascending order, -1 where absent; `agg`
(n,) int32, the coarse row of each fine row.
"""
from __future__ import annotations

import torch

from . import cuda_spmv


def kernel_ok(A, x) -> bool:
    """Would the smoother kernels take this level and vector?"""
    return (getattr(A, "dia_vals", None) is not None
            and A.num_rows == A.num_cols
            and A.dia_vals.dtype == torch.float32
            and x.dtype == torch.float32)


def build_transfer_tables(agg: torch.Tensor, nc: int) -> dict:
    """{"ctab": (m, nc) int32 children table, "agg": (n,) int32} from an
    aggregates map, on agg's device."""
    agg = agg.to(torch.int64)
    n = agg.shape[0]
    order = torch.argsort(agg, stable=True)
    counts = torch.bincount(agg, minlength=nc)
    m = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=agg.device) - starts[agg[order]]
    ctab = torch.full((m, nc), -1, dtype=torch.int32, device=agg.device)
    ctab[pos, agg[order]] = order.to(torch.int32)
    return {"ctab": ctab, "agg": agg.to(torch.int32)}


def fused_smooth(data, b, x, taus, dinv=None, with_residual=True):
    """x' (and r = b - A x' when `with_residual`) after len(taus) damped
    steps through B2, or None when the kernels do not apply."""
    A = data["A"]
    if not kernel_ok(A, x) or taus.shape[0] < 1:
        return None
    return cuda_spmv.dia_smooth(A.dia_vals, A.dia_offsets, taus.to(x.dtype),
                                b, x, dinv, with_residual)


def fused_smooth_restrict(data, b, x, taus, xfer, dinv=None):
    """(x', bc) with bc = R (b - A x') after len(taus) damped steps
    through B3, or None (the caller composes smooth_residual +
    restrict)."""
    A = data["A"]
    if xfer is None or not kernel_ok(A, x) or taus.shape[0] < 1:
        return None
    return cuda_spmv.dia_smooth_restrict(A.dia_vals, A.dia_offsets,
                                         taus.to(x.dtype), b, x,
                                         xfer["ctab"], dinv)


def fused_corr_smooth(data, b, x, xc, taus, xfer, dinv=None):
    """x' after len(taus) damped steps from x + P xc through B4, or
    None (the caller composes prolongate + smooth)."""
    A = data["A"]
    if xfer is None or not kernel_ok(A, x) or taus.shape[0] < 1:
        return None
    return cuda_spmv.dia_prolong_smooth(A.dia_vals, A.dia_offsets,
                                        taus.to(x.dtype), b, x, xc,
                                        xfer["agg"], dinv)
