"""Sparse matrix-vector product (the port of amgx_tpu/ops/spmv.py).

DIA matrices go through B1 (`cuda_spmv.dia_spmv`) in float32 -- the
kernel on the card, its plain twin on the CPU. Every other dtype takes
the plain PyTorch form on any device, because the JAX package routes
everything but float32 to XLA too (`dia_spmv_supported`,
amgx_tpu/ops/pallas_spmv.py:143): REFINEMENT's f64 outer residual is
the case on the flagship path. Matrices without a DIA view (classical coarse
operators, P and R) go through B8 (`cuda_csr.csr_spmv`) in float32, as
the JAX package sends its SWELL layout through `_swell_spmv_call`, and
through the plain CSR gather + scatter-add otherwise. `spmv_pdot` (the
Krylov shell's direction update + SpMV + dot) routes the same way
through B6.
"""
from __future__ import annotations

import torch

from ..matrix import CsrMatrix
from . import cuda_csr, cuda_krylov, cuda_spmv


def _check(A: CsrMatrix, x: torch.Tensor):
    if not A.initialized:
        raise ValueError("spmv requires an initialized matrix (A.init())")
    if tuple(x.shape) != (A.num_cols,):
        raise ValueError(f"spmv: x has shape {tuple(x.shape)}, expected "
                         f"({A.num_cols},)")


def spmv_dia(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and A.dia_vals.dtype == torch.float32:
        return cuda_spmv.dia_spmv(A.dia_vals, A.dia_offsets, x)
    return cuda_spmv.dia_spmv_plain(A.dia_vals, A.dia_offsets, x)


def spmv_csr(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and A.values.dtype == torch.float32:
        return cuda_csr.csr_spmv(A.row_offsets, A.col_indices, A.values, x,
                                 lanes=A.csr_lanes or 1)
    return cuda_csr.csr_spmv_plain(A.row_offsets, A.col_indices,
                                   A.values.to(x.dtype), x)


def spmv(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x, dispatching on the layout built by A.init()."""
    _check(A, x)
    if A.dia_offsets is not None:
        return spmv_dia(A, x)
    return spmv_csr(A, x)


def residual(A: CsrMatrix, x: torch.Tensor, b: torch.Tensor):
    """r = b - A x."""
    return b - spmv(A, x)


def spmv_pdot(A: CsrMatrix, p, z, beta):
    """p' = z + beta p, A p', and p'.A p' (beta a 0-dim tensor): one B6
    launch on a float32 DIA operator, the unfused compose otherwise
    (float64, CSR), as the JAX package routes it to XLA."""
    _check(A, p)
    if A.dia_offsets is not None and p.dtype == torch.float32 \
            and A.dia_vals.dtype == torch.float32:
        return cuda_krylov.dia_spmv_dot(A.dia_vals, A.dia_offsets, p, z,
                                        beta)
    p = (z + beta * p).to(p.dtype)
    ap = spmv(A, p)
    return p, ap, torch.dot(p, ap)
