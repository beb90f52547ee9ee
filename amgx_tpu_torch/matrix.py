"""Core sparse-matrix container (the port of amgx_tpu/matrix.py).

A scalar CSR matrix held as PyTorch tensors on one device, plus the DIA
view the kernels stream. Differences from the JAX package, by design:

- `dia_vals` is a contiguous (k, n) tensor, vals[d, i] = A[i, i +
  dia_offsets[d]] with 0 where that column leaves [0, n). The JAX
  package's (k, rows_pad, 128) tiling exists for the TPU's lanes;
- no ELL/SWELL layouts and no block or external-diagonal matrices yet:
  a matrix that is not banded keeps CSR only (`ops/spmv.py` then runs
  the plain CSR product).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .errors import BadParametersError


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    row_offsets: torch.Tensor          # (n+1,) int32
    col_indices: torch.Tensor          # (nnz,) int32
    values: torch.Tensor               # (nnz,)
    num_rows: int = 0
    num_cols: int = 0
    # structured-grid annotation (nx, ny, nz), x fastest -- set by the
    # gallery and propagated by the GEO aggregation path
    grid_shape: Optional[tuple] = None
    dia_offsets: Optional[tuple] = None   # ascending diagonal offsets
    dia_vals: Optional[torch.Tensor] = None   # (k, n), contiguous
    initialized: bool = False

    DIA_MAX_OFFSETS = 32
    DIA_FILL_RATIO = 3.0

    # ------------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    # ------------------------------------------------------------------
    def row_ids(self) -> torch.Tensor:
        """Row index of every stored entry (int64)."""
        return torch.repeat_interleave(
            torch.arange(self.num_rows, device=self.device),
            torch.diff(self.row_offsets.long()), output_size=self.nnz)

    def coo(self):
        """(row_ids, col_indices, values) triplets."""
        return self.row_ids(), self.col_indices, self.values

    def init(self) -> "CsrMatrix":
        """Build the DIA view when the sparsity is banded with few
        distinct offsets (at most DIA_MAX_OFFSETS, and k * n at most
        DIA_FILL_RATIO * nnz); duplicates sum. Other matrices stay CSR."""
        if self.initialized:
            return self
        n = self.num_rows
        out = dataclasses.replace(self, initialized=True)
        if n == 0 or self.nnz == 0 or self.num_rows != self.num_cols:
            return out
        rows = self.row_ids()
        diffs = self.col_indices.long() - rows
        offs = torch.unique(diffs)
        k = int(offs.numel())
        if k > self.DIA_MAX_OFFSETS or k * n > self.DIA_FILL_RATIO * self.nnz:
            return out
        d_idx = torch.searchsorted(offs, diffs)
        flat = torch.zeros(k * n, dtype=self.dtype, device=self.device)
        flat.index_add_(0, d_idx * n + rows, self.values)
        return dataclasses.replace(
            out, dia_offsets=tuple(int(o) for o in offs.tolist()),
            dia_vals=flat.reshape(k, n))

    # ------------------------------------------------------------------
    def to(self, device) -> "CsrMatrix":
        device = torch.device(device)
        if self.values.device == device:
            return self

        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, row_offsets=mv(self.row_offsets),
            col_indices=mv(self.col_indices), values=mv(self.values),
            dia_vals=mv(self.dia_vals))

    def astype(self, dtype) -> "CsrMatrix":
        """Cast the values (and the DIA view) to `dtype`, keeping the
        structure (the reduced-precision operator of REFINEMENT)."""
        return dataclasses.replace(
            self, values=self.values.to(dtype),
            dia_vals=None if self.dia_vals is None
            else self.dia_vals.to(dtype))

    def to_dense(self) -> torch.Tensor:
        rows, cols, vals = self.coo()
        dense = torch.zeros((self.num_rows, self.num_cols), dtype=self.dtype,
                            device=self.device)
        dense.index_put_((rows, cols.long()), vals, accumulate=True)
        return dense

    # ------------------------------------------------------------------
    @staticmethod
    def from_scipy_like(row_offsets, col_indices, values, num_rows,
                        num_cols, grid_shape=None,
                        device="cpu") -> "CsrMatrix":
        """A CSR matrix from its raw components (numpy arrays or
        tensors), moved to `device`."""
        def put(x, dtype=None):
            # a copy: the caller may reuse its buffers after the upload
            t = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
            return t.to(device=device, dtype=dtype or t.dtype)

        ro = put(row_offsets, torch.int32)
        if ro.shape[0] != int(num_rows) + 1:
            raise BadParametersError(
                f"row_offsets has {ro.shape[0]} entries for {num_rows} rows")
        return CsrMatrix(row_offsets=ro,
                         col_indices=put(col_indices, torch.int32),
                         values=put(values), num_rows=int(num_rows),
                         num_cols=int(num_cols),
                         grid_shape=None if grid_shape is None
                         else tuple(int(e) for e in grid_shape))
