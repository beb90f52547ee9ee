"""Sparse matrix-vector product (the port of amgx_tpu/ops/spmv.py).

DIA matrices go through B1 (`cuda_spmv.dia_spmv`) in float32 -- the
kernel on the card, its plain twin on the CPU. Every other dtype takes
the plain PyTorch form on any device, because the JAX package routes
everything but float32 to XLA too (`dia_spmv_supported`,
amgx_tpu/ops/pallas_spmv.py:143): REFINEMENT's f64 outer residual is
the case on the flagship path. Matrices without a DIA view (classical coarse
operators, P and R) go through B8 (`cuda_csr.csr_spmv`) in float32, as
the JAX package sends its SWELL layout through `_swell_spmv_call`, and
in bfloat16 through B8's bf16 form (float32 row sums, one rounding:
the JAX package's compiled `swell_spmv_xla` on bf16 operands); through
the plain CSR gather + scatter-add otherwise (float64). `spmv_pdot` (the
Krylov shell's direction update + SpMV + dot) and `spmv_ddot` (SpMV
with dots against a streamed operand, BiCGStab's) route the same way
through B6's two forms.

A batch (amgx_tpu_torch/batch/): x of shape (B, num_cols), and A shared
or per system (`dia_vals` (B, k, n), `values` (B, nnz): a multi-matrix
batch's stacked operator). Float32 DIA products run K1 and float32 CSR
products K3 (ops/cuda_batched.py: B1 and B8 over the batch, one launch
for all systems); other dtypes the plain forms, which take the batch
axis. `spmv_pdot` / `spmv_ddot` under a batch compute the JAX package's
vmap route of B6, `spmv_dot_multi` (ops/batched.py): the prologue, one
K1 launch and the row dots in float32 or wider.
"""
from __future__ import annotations

import torch

from ..matrix import CsrMatrix
from ..precision import SMOOTH_DTYPES
from . import cuda_batched, cuda_csr, cuda_krylov, cuda_spmv


def _check(A: CsrMatrix, x: torch.Tensor):
    if not A.initialized:
        raise ValueError("spmv requires an initialized matrix (A.init())")
    batched = A.values.dim() == 2
    if x.dim() not in (1, 2) or x.shape[-1] != A.num_cols \
            or (batched and (x.dim() != 2
                             or x.shape[0] != A.values.shape[0])):
        want = f"({A.values.shape[0]}, {A.num_cols})" if batched \
            else f"({A.num_cols},) or (batch, {A.num_cols})"
        raise ValueError(f"spmv: x has shape {tuple(x.shape)}, expected "
                         f"{want}")


def spmv_dia(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and A.dia_vals.dtype == torch.float32:
        if x.dim() == 2:
            return cuda_batched.dia_spmv_multi(A.dia_vals, A.dia_offsets, x)
        return cuda_spmv.dia_spmv(A.dia_vals, A.dia_offsets, x)
    return cuda_spmv.dia_spmv_plain(A.dia_vals, A.dia_offsets, x)


def spmv_csr(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    if x.dtype in SMOOTH_DTYPES and A.values.dtype == x.dtype:
        if x.dim() == 2:
            # the batched form is float32: a bf16 batch raises on the card
            return cuda_batched.csr_spmv_multi(A.row_offsets,
                                               A.col_indices, A.values, x)
        return cuda_csr.csr_spmv(A.row_offsets, A.col_indices, A.values, x)
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


def _shell_kernel_ok(A: CsrMatrix, p) -> bool:
    """B6 takes a float32 DIA operator and float32 vectors; the JAX
    package's `_shell_kernel_ok` declines everything else to XLA."""
    return A.dia_offsets is not None and p.dtype == torch.float32 \
        and A.dia_vals.dtype == torch.float32


def spmv_pdot(A: CsrMatrix, p, z, beta):
    """p' = z + beta p, A p', and p'.A p' (beta a 0-dim tensor): one B6
    launch on a float32 DIA operator, the unfused compose otherwise
    (float64, CSR), as the JAX package routes it to XLA."""
    _check(A, p)
    if p.dim() == 2:
        from .batched import spmv_dot_multi
        return spmv_dot_multi(A, p, z, beta, product=spmv)
    if _shell_kernel_ok(A, p):
        return cuda_krylov.dia_spmv_dot(A.dia_vals, A.dia_offsets, p, z,
                                        beta)
    p = (z + beta * p).to(p.dtype)
    ap = spmv(A, p)
    return p, ap, torch.dot(p, ap)


def spmv_ddot(A: CsrMatrix, p, d, self_dot: bool = False):
    """A p with d.A p and, when `self_dot`, (A p).(A p): one B6 launch
    (its streamed-dot form) on a float32 DIA operator, the unfused
    compose `_spmv_ddot_xla` otherwise. d may be p."""
    _check(A, p)
    if p.dim() == 2:
        from .batched import spmv_dot_multi
        return spmv_dot_multi(A, p, D=d, self_dot=self_dot, product=spmv)
    if _shell_kernel_ok(A, p):
        return cuda_krylov.dia_spmv_dot(A.dia_vals, A.dia_offsets, p, d=d,
                                        self_dot=self_dot)
    ap = spmv(A, p)
    out = (ap, torch.dot(d, ap))
    return out + (torch.dot(ap, ap),) if self_dot else out
