"""B8 and B9, the unstructured (CSR) SpMV and damped-Jacobi sweep
kernels, with their plain PyTorch twins.

B8 `csr_spmv` replaces `_swell_spmv_call` (amgx_tpu/ops/pallas_swell.py:
   254, body `_swell_kernel`): y = A x over a float32 CSR matrix.
B9 `csr_smooth` replaces `_swell_smooth_call` (pallas_swell.py:412):
   len(taus) sweeps x <- x + (tau_t * (b - A x)) * dinv, one launch each,
   each sweep into a fresh buffer (neighbouring rows read the old x).

CUDA source `amgx_tpu_torch/csrc/csr.cu`. The port keeps CSR (no SWELL:
its 128-lane windows exist for the TPU's gathers). Each kernel walks a
row with `lanes` lanes of a warp (1 for short rows, up to 32), as
`CsrMatrix.init()` recorded in `csr_lanes`. Bound by bytes: B8 must read
nnz values and columns, the row offsets, x, and write y; B9 adds b, x
and dinv read once per sweep. Deterministic: every row sums in a fixed
order.

Routing as in `cuda_spmv`: the plain version for CPU tensors, the kernel
or an exception for CUDA tensors; float32 only (the JAX package's
`swell_spmv_supported` / `swell_smooth_supported` take float32, and
`ops/spmv.py` routes float64 to the plain product). Launches count in
`cuda_spmv.LAUNCHES` under "csr_spmv" and "csr_smooth".
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_spmv import _check, _launch, _ptr, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("csr.cu")
    lib.amgx_csr_spmv.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P]
    lib.amgx_csr_step.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                                  _I, _P]
    for fn in (lib.amgx_csr_spmv, lib.amgx_csr_step):
        fn.restype = _I
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU route and the kernels' on-card reference)
# ---------------------------------------------------------------------------


def csr_spmv_plain(row_offsets, col_indices, values, x):
    """y = A x: the products of each entry added into its row."""
    n = row_offsets.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), torch.diff(row_offsets.long()),
        output_size=values.shape[0])
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, values * x[col_indices.long()])


def csr_smooth_plain(row_offsets, col_indices, values, taus, b, x,
                     dinv=None):
    for t in range(taus.shape[0]):
        upd = taus[t] * (b - csr_spmv_plain(row_offsets, col_indices,
                                            values, x))
        if dinv is not None:
            upd = upd * dinv
        x = x + upd
    return x


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_csr(name, row_offsets, col_indices, values, x, floats=None):
    n = row_offsets.shape[0] - 1
    f = {"values": (values, (values.shape[0],)), "x": (x, (x.shape[0],))}
    f.update(floats or {})
    _check(name, None, n, f,
           {"row_offsets": (row_offsets, (n + 1,)),
            "col_indices": (col_indices, (values.shape[0],))})
    return n


def csr_spmv(row_offsets, col_indices, values, x, lanes: int = 1):
    """B8: y = A x (A: n x len(x) float32 CSR), each row walked by
    `lanes` lanes (1, 2, 4, ..., 32)."""
    if x.device.type == "cpu":
        return csr_spmv_plain(row_offsets, col_indices, values, x)
    n = _check_csr("csr_spmv", row_offsets, col_indices, values, x)
    with torch.cuda.device(x.device):
        y = torch.empty(n, dtype=x.dtype, device=x.device)
        _launch("csr_spmv", _lib().amgx_csr_spmv, _ptr(row_offsets),
                _ptr(col_indices), _ptr(values), _ptr(x), _ptr(y), n,
                int(lanes), _stream())
    return y


def csr_smooth(row_offsets, col_indices, values, taus, b, x, dinv=None,
               lanes: int = 1):
    """B9: len(taus) damped-Jacobi sweeps on a square float32 CSR
    matrix, one launch each. Returns x'."""
    if x.device.type == "cpu":
        return csr_smooth_plain(row_offsets, col_indices, values, taus, b,
                                x, dinv)
    n = x.shape[0]
    if taus.dim() != 1 or taus.shape[0] < 1:
        raise ValueError(f"csr_smooth: needs at least one sweep (taus "
                         f"{tuple(taus.shape)})")
    _check_csr("csr_smooth", row_offsets, col_indices, values, x,
               {"b": (b, (n,)), "dinv": (dinv, (n,)),
                "taus": (taus, (taus.shape[0],))})
    if row_offsets.shape[0] - 1 != n:
        raise ValueError("csr_smooth: the matrix must be square")
    lib = _lib()
    with torch.cuda.device(x.device):
        src = x
        for t in range(taus.shape[0]):
            dst = torch.empty_like(x)
            _launch("csr_smooth", lib.amgx_csr_step, _ptr(row_offsets),
                    _ptr(col_indices), _ptr(values), _ptr(src), _ptr(b),
                    _ptr(dinv), _ptr(taus), t, _ptr(dst), n, int(lanes),
                    _stream())
            src = dst
    return src
