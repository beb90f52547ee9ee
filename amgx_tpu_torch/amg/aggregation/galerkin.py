"""Structured (GEO) Galerkin product for aggregation AMG (the port of the
GEO fast path of amgx_tpu/amg/aggregation/galerkin.py).

With the GEO selector's 2x2x2 aggregates on a grid operator, the coarse
operator R A P of a stencil matrix is again a stencil matrix: a fine
entry A[i, i+d] with grid shift (dx, dy, dz) lands, along each paired
axis, on coarse shift floor((x+dx)/2) - floor(x/2) -- one of at most
two values chosen by the parity of x. Each fine diagonal therefore
feeds a statically known set of coarse diagonals through parity masks,
and the aggregate sum is the same pair-sum the restriction uses. No
sort, no scatter: plain tensor ops on the device.
"""
from __future__ import annotations

import functools

import torch

from ...matrix import CsrMatrix


def _decompose(d: int, nx: int, ny: int, nz: int):
    """Split a linear DIA offset into (dx, dy, dz) grid shifts; None when
    the offset is not a small stencil shift."""
    for dz in (0, -1, 1, -2, 2):
        if abs(dz) > min(2, nz - 1):
            continue
        for dy in (0, -1, 1, -2, 2):
            if abs(dy) > min(2, ny - 1):
                continue
            dx = d - dz * nx * ny - dy * nx
            if abs(dx) <= min(3, nx - 1):
                return dx, dy, dz
    return None


def pair_sum_axis(v3, e: int, axis: int):
    """Pair-sum a (nz, ny, nx) tensor along one grid axis of extent e
    (an odd extent keeps a singleton tail): the aggregation map
    agg(x, y, z) = (x//2, y//2, z//2) along that axis, shared by the
    transfer operators and the Galerkin product."""
    dims = 2 - axis

    def sl(start, stop):
        s = [slice(None)] * 3
        s[dims] = slice(start, stop, 2)
        return v3[tuple(s)]

    out = sl(0, e - 1) + sl(1, e)
    if e % 2:
        out = torch.cat([out, v3.narrow(dims, e - 1, 1)], dim=dims)
    return out


def geo_shapes(fine_shape, axes):
    """Intermediate grid shapes of the per-axis pairing sequence."""
    shapes = [tuple(fine_shape)]
    for a in axes:
        s = list(shapes[-1])
        s[a] = (s[a] + 1) // 2
        shapes.append(tuple(s))
    return shapes


def _pair_sum3(v3, axes, shapes):
    for k, a in enumerate(axes):
        v3 = pair_sum_axis(v3, shapes[k][a], a)
    return v3


@functools.lru_cache(maxsize=256)
def _geo_contrib_table(dia_offsets, shifts, axes, coarse_shape):
    """Which fine diagonals (with which parity masks) land on which
    coarse diagonals: (coffsets, contribs), coffsets ascending."""
    cnx, cny, cnz = coarse_shape
    paired = set(axes)

    def splits(delta, axis):
        if axis not in paired:
            return [(delta, None)]
        lo = delta // 2                      # x even: (x+d)//2 - x//2
        hi = (delta + 1) // 2                # x odd
        if lo == hi:
            return [(lo, None)]
        return [(lo, 0), (hi, 1)]            # (coarse shift, fine parity)

    table = {}
    for t in range(len(dia_offsets)):
        dx, dy, dz = shifts[t]
        for cdx, px in splits(dx, 0):
            for cdy, py in splits(dy, 1):
                for cdz, pz in splits(dz, 2):
                    cd = (cdz * cny + cdy) * cnx + cdx
                    table.setdefault((cd, cdx, cdy, cdz), []).append(
                        (t, px, py, pz))
    coffsets = tuple(sorted(table, key=lambda k: k[0]))
    contribs = tuple(tuple(table[k]) for k in coffsets)
    return coffsets, contribs


def _geo_compute(vals, contribs, fine_shape, axes):
    """Parity-masked accumulation + pair sums: the coarse diagonals
    (kc, nc)."""
    nx, ny, nz = fine_shape
    shapes = geo_shapes(fine_shape, axes)
    v3 = vals.reshape(len(vals), nz, ny, nx)
    par = [torch.arange(e, device=vals.device) % 2 for e in (nx, ny, nz)]
    outs = []
    for entries in contribs:
        acc = torch.zeros((nz, ny, nx), dtype=vals.dtype, device=vals.device)
        for (t, px, py, pz) in entries:
            m = v3[t]
            if px is not None:
                m = m * (par[0] == px)[None, None, :]
            if py is not None:
                m = m * (par[1] == py)[None, :, None]
            if pz is not None:
                m = m * (par[2] == pz)[:, None, None]
            acc = acc + m
        outs.append(_pair_sum3(acc, axes, shapes).reshape(-1))
    return torch.stack(outs)


def _any_wrapped(vals, shifts, shape) -> bool:
    """True when a nonzero sits where its geometric shift leaves the
    grid (the parity classification would be wrong there)."""
    nx, ny, nz = shape
    i = torch.arange(nx * ny * nz, device=vals.device)
    g = (i % nx, (i // nx) % ny, i // (nx * ny))
    bad = torch.zeros((), dtype=torch.bool, device=vals.device)
    for t, (dx, dy, dz) in enumerate(shifts):
        ok = ((g[0] + dx >= 0) & (g[0] + dx < nx) & (g[1] + dy >= 0)
              & (g[1] + dy < ny) & (g[2] + dz >= 0) & (g[2] + dz < nz))
        bad = bad | torch.any((vals[t] != 0) & ~ok)
    return bool(bad)


def geo_coarse_values(A: CsrMatrix, fine_shape, axes, coarse_shape):
    """(cvals (kc, nc), coffsets) of the structured Galerkin product, or
    None when it does not apply (no DIA view, non-stencil offsets, or
    values that wrap grid rows)."""
    nx, ny, nz = fine_shape
    if A.dia_offsets is None or A.grid_shape != tuple(fine_shape):
        return None
    shifts = []
    for d in A.dia_offsets:
        g = _decompose(int(d), nx, ny, nz)
        if g is None:
            return None
        shifts.append(g)
    shifts = tuple(shifts)
    if _any_wrapped(A.dia_vals, shifts, tuple(fine_shape)):
        return None
    coffsets, contribs = _geo_contrib_table(
        tuple(A.dia_offsets), shifts, tuple(axes), tuple(coarse_shape))
    return _geo_compute(A.dia_vals, contribs, tuple(fine_shape),
                        tuple(axes)), coffsets


def geo_assemble_dia(cvals, coffsets, coarse_shape) -> CsrMatrix:
    """The coarse operator from its diagonals: exact-size CSR (entries
    inside the coarse grid, (row, column) order) plus the DIA view."""
    cnx, cny, cnz = coarse_shape
    nc = cnx * cny * cnz
    dev = cvals.device
    ci = torch.arange(nc, device=dev)
    cx, cy, cz = ci % cnx, (ci // cnx) % cny, ci // (cnx * cny)
    valid = torch.stack([
        (cx + cdx >= 0) & (cx + cdx < cnx) & (cy + cdy >= 0)
        & (cy + cdy < cny) & (cz + cdz >= 0) & (cz + cdz < cnz)
        for (_, cdx, cdy, cdz) in coffsets])               # (kc, nc)
    row_e, off_e = torch.nonzero(valid.T, as_tuple=True)
    offs = torch.tensor([k[0] for k in coffsets], device=dev)
    row_offsets = torch.zeros(nc + 1, dtype=torch.int32, device=dev)
    row_offsets[1:] = torch.cumsum(valid.sum(dim=0), 0)
    return CsrMatrix(
        row_offsets=row_offsets,
        col_indices=(row_e + offs[off_e]).to(torch.int32),
        values=cvals[off_e, row_e], num_rows=nc, num_cols=nc,
        grid_shape=tuple(coarse_shape),
        dia_offsets=tuple(int(k[0]) for k in coffsets),
        dia_vals=cvals.contiguous(), initialized=True)
