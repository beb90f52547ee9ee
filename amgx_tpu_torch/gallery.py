"""Matrix gallery: Poisson stencils on regular grids (the port of
amgx_tpu/gallery.py `poisson`). Assembly is host numpy -- a fixture
generator, not a solve-path kernel -- and the matrix lands on the
requested device with the same CSR arrays as the JAX package's."""
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
    offsets = _STENCILS[points]
    n = nx * ny * nz
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    idx = (iz * ny + iy) * nx + ix
    rows_l, cols_l, vals_l = [], [], []
    diag_val = float(len(offsets) - 1)
    # per-offset blocks in ascending column order: one stable row sort
    # then yields (row, col) order
    for (dx, dy, dz) in sorted(offsets, key=lambda o: (o[2], o[1], o[0])):
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        mask = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                & (jz >= 0) & (jz < nz))
        rows_l.append(idx[mask].ravel())
        cols_l.append(((jz * ny + jy) * nx + jx)[mask].ravel())
        vals_l.append(np.full(mask.sum(),
                              diag_val if (dx, dy, dz) == (0, 0, 0)
                              else -1.0))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_offsets = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=row_offsets[1:])
    return CsrMatrix.from_scipy_like(
        row_offsets, cols.astype(np.int32),
        torch.from_numpy(vals).to(dtype), n, n, grid_shape=(nx, ny, nz),
        device=device)
