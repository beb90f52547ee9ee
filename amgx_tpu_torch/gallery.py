"""Matrix gallery (the port of amgx_tpu/gallery.py): Poisson stencils on
regular grids (`poisson`) and random sparse matrices (`random_matrix`).
Assembly is host numpy -- a fixture generator, not a solve-path kernel
-- and the matrix lands on the requested device with the same CSR arrays
as the JAX package's (`random_matrix` draws the same numbers from the
same seed)."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .errors import BadParametersError
from .matrix import CsrMatrix

_STENCILS = {
    "5pt": [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0)],
    "7pt": [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
            (0, 0, -1), (0, 0, 1)],
    "9pt": [(dx, dy, 0) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    "27pt": [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)],
}


def poisson(points: str, nx: int, ny: int = 1, nz: int = 1,
            dtype=torch.float64, device=None) -> CsrMatrix:
    """Finite-difference Poisson matrix on an nx x ny x nz grid with
    Dirichlet boundaries, rows numbered x fastest: the diagonal is the
    stencil size minus one, off-diagonals are -1. `device=None` puts it
    on the card (see device.resolve_device)."""
    device = resolve_device(device)
    if points not in _STENCILS:
        raise BadParametersError(f"unknown poisson stencil {points!r}")
    offsets = sorted(_STENCILS[points], key=lambda o: (o[2], o[1], o[0]))
    n = nx * ny * nz
    # one column a stencil point, the points in ascending column order
    # (z, then y, then x offset): the (n, k) table read row by row is the
    # CSR order, rows ascending and each row's columns ascending
    ix = np.arange(nx, dtype=np.int32)
    iy = np.arange(ny, dtype=np.int32)[:, None]
    iz = np.arange(nz, dtype=np.int32)[:, None, None]
    row = np.arange(n, dtype=np.int32)
    mask = np.empty((n, len(offsets)), dtype=bool)
    cols = np.empty((n, len(offsets)), dtype=np.int32)
    vals = np.empty((n, len(offsets)))
    for k, (dx, dy, dz) in enumerate(offsets):
        mask[:, k] = (((ix + dx >= 0) & (ix + dx < nx))
                      & ((iy + dy >= 0) & (iy + dy < ny))
                      & ((iz + dz >= 0) & (iz + dz < nz))).ravel()
        cols[:, k] = row + ((dz * ny + dy) * nx + dx)
        vals[:, k] = float(len(offsets) - 1) if (dx, dy, dz) == (0, 0, 0) \
            else -1.0
    row_offsets = np.zeros(n + 1, np.int32)
    np.cumsum(mask.sum(axis=1), out=row_offsets[1:])
    return CsrMatrix.from_scipy_like(
        row_offsets, cols[mask], torch.from_numpy(vals[mask]).to(dtype), n,
        n, grid_shape=(nx, ny, nz), device=device)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def random_matrix(n: int, max_nnz_per_row: int = 8, seed: int = 0,
                  symmetric: bool = False, diag_dominant: bool = True,
                  block_dims=(1, 1), dtype=torch.float64,
                  device=None) -> CsrMatrix:
    """A random sparse n x n matrix with its diagonal stored, optionally
    symmetric and diagonally dominant (generateMatrixRandomStruct,
    include/test_utils.h:541-701): each row draws up to max_nnz_per_row
    - 1 distinct columns, values standard normal, the diagonal (with
    `diag_dominant`) one more than the row's absolute sum. Block values
    (`block_dims` other than (1, 1)) come with ROADMAP.md Queue A item
    8.4 and raise. `device=None` puts it on the card."""
    device = resolve_device(device)
    if tuple(block_dims) != (1, 1):
        raise NotImplementedError(
            f"random_matrix: block_dims={tuple(block_dims)}: block matrices "
            f"are not ported to amgx_tpu_torch yet (ROADMAP.md Queue A item "
            f"8.4)")
    if dtype not in _NP_DTYPES:
        raise BadParametersError(f"random_matrix: dtype {dtype}; float32 or "
                                 f"float64")
    npdt = _NP_DTYPES[dtype]
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [np.arange(n)], [np.arange(n)]       # diagonal first
    for i in range(n):
        k = rng.integers(0, max_nnz_per_row)
        if k:
            c = rng.choice(n, size=min(k, n), replace=False)
            c = c[c != i]
            rows_l.append(np.full(c.size, i))
            cols_l.append(c)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    _, uniq = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = rng.standard_normal(rows.size).astype(npdt)
    if symmetric:
        # (i, j) and (j, i) both take their mean
        order = np.lexsort((cols, rows))
        order_t = np.lexsort((rows, cols))
        vals = 0.5 * (vals[order] + vals[order_t])
        rows, cols = rows[order], cols[order]
    if diag_dominant:
        abssum = np.zeros(n, npdt)
        np.add.at(abssum, rows, np.abs(vals))
        is_diag = rows == cols
        vals[is_diag] = abssum[rows[is_diag]] + 1.0
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_offsets = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=row_offsets[1:])
    return CsrMatrix.from_scipy_like(row_offsets, cols.astype(np.int32),
                                     torch.from_numpy(vals), n, n,
                                     device=device)
