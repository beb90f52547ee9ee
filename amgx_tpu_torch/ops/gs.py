"""K6, the serial Gauss-Seidel sweep, with its plain twin.

One sweep over the rows of a CSR matrix in natural order, x updated in
place row after row (the JAX package's `GSSolver.solve_iteration`,
amgx_tpu/solvers/multicolor.py, a `lax.fori_loop` over rows):

    dot = sum_j a_ij x_j          (the stored row, a_ii included)
    x_i <- (1 - w) x_i + w dinv_i (b_i - dot + d_i x_i)

with d the diagonal (or its L1-strengthened form) and dinv = 1 / d.

On a CUDA tensor, float32 or float64, one sweep is one launch of K6
(`csrc/gs.cu`: one warp walks the rows, its lanes split a row's entries
and meet in a fixed butterfly). It replaces no TPU kernel: plain PyTorch
on the card would be about three launches a row. The plain twin, for
CPU tensors, is the row loop itself, on host lists: each row's dot in
float64 from left to right, x_i rounded to the tensor's dtype. Launches
count in `cuda_spmv.LAUNCHES["gs_sweep"]`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_spmv import _launch, _ptr, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("gs.cu")
    for fn in (lib.amgx_gs_sweep_f32, lib.amgx_gs_sweep_f64):
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_double, _P]
        fn.restype = _I
    return lib


def gs_sweep_plain(row_offsets, col_indices, values, b, d, dinv, x,
                   w: float) -> torch.Tensor:
    """One sweep as a row loop; returns the new x (x is not modified)."""
    ro = row_offsets.tolist()
    ci = col_indices.tolist()
    va = values.double().tolist()
    bb, dd, di = b.double().tolist(), d.double().tolist(), \
        dinv.double().tolist()
    xs = x.double().tolist()
    f32 = x.dtype != torch.float64
    rnd = (lambda v: float(np.float32(v))) if f32 else (lambda v: v)
    for i in range(len(xs)):
        s = 0.0
        for e in range(ro[i], ro[i + 1]):
            s += va[e] * xs[ci[e]]
        xi = xs[i]
        xs[i] = rnd((1.0 - w) * xi + w * (di[i] * (bb[i] - s + dd[i] * xi)))
    return torch.tensor(xs, dtype=x.dtype)


def gs_sweep(row_offsets, col_indices, values, b, d, dinv, x,
             w: float) -> torch.Tensor:
    """One GS sweep: the plain row loop for CPU tensors, one K6 launch on
    the card. Returns the new x."""
    if x.device.type == "cpu":
        return gs_sweep_plain(row_offsets, col_indices, values, b, d, dinv,
                              x, w)
    n = x.shape[0]
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gs_sweep: {x.dtype}; the kernel takes float32 or "
                        f"float64")
    for name, t, shape, dtype in (
            ("row_offsets", row_offsets, (n + 1,), torch.int32),
            ("col_indices", col_indices, (col_indices.shape[0],),
             torch.int32),
            ("values", values, (col_indices.shape[0],), x.dtype),
            ("b", b, (n,), x.dtype), ("d", d, (n,), x.dtype),
            ("dinv", dinv, (n,), x.dtype)):
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"gs_sweep: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; the kernel "
                             f"takes contiguous {dtype} {shape} on "
                             f"{x.device}")
    lib = _lib()
    fn = lib.amgx_gs_sweep_f64 if x.dtype == torch.float64 \
        else lib.amgx_gs_sweep_f32
    with torch.cuda.device(x.device):
        out = x.clone(memory_format=torch.contiguous_format)
        if n:
            _launch("gs_sweep", fn, _ptr(row_offsets), _ptr(col_indices),
                    _ptr(values), _ptr(b), _ptr(d), _ptr(dinv), _ptr(out), n,
                    float(w), _stream())
    return out
