"""Matrix permutation, sorting and analysis (the port of
amgx_tpu/ops/permute.py; the reference's src/permute.cu and
matrix_analysis.cu roles).

`permute_matrix` (B[i, j] = A[row_perm[i], col_perm[j]]),
`sort_rows_by` (the symmetric reordering by a key) and `analyze_matrix`
(structural diagnostics) work on the host with numpy, as fixture and
diagnostic tools: the CSR arrays come to the host once, and a permuted
matrix goes back to A's device. A permutation moves entries and never
adds them, so P^T (P A P^T) P gives A's arrays bit for bit.
`permute_vector` gathers on the vector's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..matrix import CsrMatrix


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _iperm(perm: np.ndarray) -> np.ndarray:
    ip = np.empty_like(perm)
    ip[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return ip


def permute_matrix(A: CsrMatrix, row_perm=None, col_perm=None) -> CsrMatrix:
    """B = P_r A P_c^T, B[i, j] = A[row_perm[i], col_perm[j]]: each
    permutation maps a new index to an old one (the same array for the
    symmetric reordering); None is the identity."""
    ro = _host(A.row_offsets).astype(np.int64)
    rows = np.repeat(np.arange(A.num_rows), np.diff(ro))
    cols = _host(A.col_indices).astype(np.int64)
    vals = _host(A.values)
    if row_perm is not None:
        rows = _iperm(_host(row_perm).astype(np.int64))[rows]
    if col_perm is not None:
        cols = _iperm(_host(col_perm).astype(np.int64))[cols]
    # the (row, col) order: a stable sort of one int64 key, lexsort's
    # order (a quarter of its time at 10^7 entries)
    order = np.argsort(rows * max(A.num_cols, 1) + cols, kind="stable")
    offsets = np.zeros(A.num_rows + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=A.num_rows), out=offsets[1:])
    return CsrMatrix.from_scipy_like(
        offsets, cols[order].astype(np.int32), torch.from_numpy(vals[order]),
        A.num_rows, A.num_cols, device=A.device)


def permute_vector(x: torch.Tensor, perm, block_dim: int = 1):
    """y[i] = x[perm[i]] (blockwise for block_dim > 1)."""
    perm = torch.as_tensor(perm, device=x.device).long()
    if block_dim == 1:
        return x[perm]
    return x.reshape(-1, block_dim)[perm].reshape(-1)


def sort_rows_by(A: CsrMatrix, key) -> tuple:
    """(the symmetric reordering of A that sorts its rows by `key`
    ascending, stable; the permutation as int32 on A's device). Square
    matrices only."""
    if A.num_rows != A.num_cols:
        raise ValueError(
            "sort_rows_by: symmetric reordering requires a square matrix; "
            "use permute_matrix with separate row/col permutations")
    perm = np.argsort(_host(key), kind="stable").astype(np.int32)
    return permute_matrix(A, perm, perm), torch.from_numpy(perm).to(A.device)


class MatrixAnalysis(NamedTuple):
    """Structural diagnostics (matrix_analysis.cu role)."""
    is_structurally_symmetric: bool
    is_symmetric: bool
    diag_dominant_rows: int      # rows with |a_ii| >= sum_{j != i} |a_ij|
    num_rows: int
    nnz: int
    bandwidth: int               # max |i - j| over stored entries
    min_row_nnz: int
    max_row_nnz: int
    has_zero_diag: bool


def analyze_matrix(A: CsrMatrix, tol: float = 0.0) -> MatrixAnalysis:
    """The diagnostics of A, computed on the host (row sums added left to
    right)."""
    n = A.num_rows
    ro = _host(A.row_offsets).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    cols = _host(A.col_indices).astype(np.int64)
    vals = _host(A.values)
    nnz = vals.shape[0]
    key = rows * A.num_cols + cols
    key_t = cols * A.num_cols + rows
    order = np.argsort(key_t, kind="stable")
    kt_sorted = key_t[order]
    pos = np.clip(np.searchsorted(kt_sorted, key), 0, max(nnz - 1, 0))
    struct_sym = bool(np.all(kt_sorted[pos] == key)) if nnz else True
    vt = vals[order][pos]
    num_sym = struct_sym and bool(
        np.all(np.abs(vt - vals) <= tol + 1e-12 * np.abs(vals)))
    d = _host(A.diagonal())
    absrow = np.zeros(n, vals.dtype)
    np.add.at(absrow, rows, np.abs(vals))
    row_nnz = np.diff(ro)
    return MatrixAnalysis(
        is_structurally_symmetric=struct_sym, is_symmetric=num_sym,
        diag_dominant_rows=int(np.sum(np.abs(d) >= absrow - np.abs(d))),
        num_rows=n, nnz=int(nnz),
        bandwidth=int(np.max(np.abs(rows - cols))) if nnz else 0,
        min_row_nnz=int(row_nnz.min()) if n else 0,
        max_row_nnz=int(row_nnz.max()) if n else 0,
        has_zero_diag=bool(np.any(d == 0)))
