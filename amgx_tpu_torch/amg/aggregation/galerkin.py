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

`GeoRapPlan` is the product's recipe for one (fine offsets, fine shape,
axes, coarse shape) on one device: the contribution table and the
coarse CSR structure (`row_offsets`, `off_e`, `row_e`, `col_e`), built
once without a host read (the entry count is known from the shapes) and
kept in the bounded `_GEO_PLAN_CACHE`. Its `values` is the whole value
phase, `coarse_coeffs` its constant-stencil twin on k numbers. The wrap
check (a nonzero whose grid shift leaves the grid would be misfiled)
depends on the values: inside `deferred_wrap_checks` each level appends
its device flag and the hierarchy reads them all once at the end,
rebuilding under `geo_dia_disabled` (the relabel product) in the rare
case one is set; outside it the check blocks.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading

import torch

from ...matrix import CsrMatrix
from ...telemetry import metrics as _tm


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


def _parity_masks(fine_shape, dtype, device):
    """Per axis, the (0-parity, 1-parity) masks of the grid coordinate in
    `dtype`, shaped to broadcast over a (nz, ny, nx) tensor."""
    out = []
    for axis, e in enumerate(fine_shape):
        par = torch.arange(e, device=device) % 2
        shape = [1, 1, 1]
        shape[2 - axis] = e
        out.append(tuple((par == p).to(dtype).reshape(shape) for p in (0, 1)))
    return out


def _geo_compute(vals, contribs, fine_shape, axes, masks):
    """Parity-masked accumulation + pair sums: the coarse diagonals
    (kc, nc). `masks`: `_parity_masks` of the fine grid."""
    nx, ny, nz = fine_shape
    shapes = geo_shapes(fine_shape, axes)
    v3 = vals.reshape(len(vals), nz, ny, nx)
    outs = []
    for entries in contribs:
        acc = torch.zeros((nz, ny, nx), dtype=vals.dtype, device=vals.device)
        for (t, px, py, pz) in entries:
            m = v3[t]
            for axis, p in enumerate((px, py, pz)):
                if p is not None:
                    m = m * masks[axis][p]
            acc = acc + m
        outs.append(_pair_sum3(acc, axes, shapes).reshape(-1))
    return torch.stack(outs)


class _DeferredChecks(threading.local):
    """The wrap-check flags of the hierarchy build in progress (None
    outside one), and whether the GEO product is switched off for the
    rebuild after a failed check."""

    def __init__(self):
        self.items = None
        self.disable_fast = False


_deferred = _DeferredChecks()


@contextlib.contextmanager
def deferred_wrap_checks():
    """Collect the wrap-check flags of a hierarchy build instead of
    reading each; yields `flush()`, True when any collected flag is set
    (one host read)."""
    prev = _deferred.items
    _deferred.items = []

    def flush() -> bool:
        flags, _deferred.items = _deferred.items, []
        return bool(flags) and bool(torch.stack(flags).any())

    try:
        yield flush
    finally:
        _deferred.items = prev


@contextlib.contextmanager
def geo_dia_disabled():
    """Build with the relabel Galerkin product in place of the GEO one
    (the rebuild after a failed deferred wrap check)."""
    prev = _deferred.disable_fast
    _deferred.disable_fast = True
    try:
        yield
    finally:
        _deferred.disable_fast = prev


def _geo_structure(coffsets, coarse_shape, device):
    """(row_offsets int32, off_e, row_e, col_e int32) of the coarse
    stencil: its in-grid entries in (row, ascending column) order. The
    entry count comes from the shapes, so the compaction is a scatter
    with no host read."""
    cnx, cny, cnz = coarse_shape
    nc, kc = cnx * cny * cnz, len(coffsets)
    ci = torch.arange(nc, device=device)
    cx, cy, cz = ci % cnx, (ci // cnx) % cny, ci // (cnx * cny)
    valid = torch.stack([
        (cx + cdx >= 0) & (cx + cdx < cnx) & (cy + cdy >= 0)
        & (cy + cdy < cny) & (cz + cdz >= 0) & (cz + cdz < cnz)
        for (_, cdx, cdy, cdz) in coffsets], dim=1)      # (nc, kc)
    total = sum(max(0, cnx - abs(cdx)) * max(0, cny - abs(cdy))
                * max(0, cnz - abs(cdz)) for (_, cdx, cdy, cdz) in coffsets)
    flat = valid.reshape(-1)
    slot = torch.where(flat, torch.cumsum(flat, 0) - 1, total)
    f = torch.empty(total + 1, dtype=torch.int64, device=device)
    f.scatter_(0, slot, torch.arange(nc * kc, device=device))
    f = f[:total]
    row_e, off_e = f // kc, f % kc
    offs = torch.tensor([k[0] for k in coffsets], device=device)
    row_offsets = torch.zeros(nc + 1, dtype=torch.int32, device=device)
    row_offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)
    return row_offsets, off_e, row_e, (row_e + offs[off_e]).to(torch.int32)


class GeoRapPlan:
    """The structured Galerkin product of one (fine offsets, fine shape,
    axes, coarse shape) on one device: offset shifts, contribution table
    and coarse structure, so a warm setup or a value resetup rebuilds
    nothing but values."""

    def __init__(self, dia_offsets, shifts, fine_shape, axes, coarse_shape,
                 device):
        self.dia_offsets = dia_offsets
        self.shifts = shifts
        self.fine_shape = fine_shape
        self.axes = axes
        self.coarse_shape = coarse_shape
        self.coffsets, self.contribs = _geo_contrib_table(
            dia_offsets, shifts, axes, coarse_shape)
        self.kc = len(self.coffsets)
        self.nc = coarse_shape[0] * coarse_shape[1] * coarse_shape[2]
        (self.row_offsets, self.off_e, self.row_e,
         self.col_e) = _geo_structure(self.coffsets, coarse_shape, device)
        self._coeff_mat = {}
        self._masks = {}            # dtype -> parity masks
        self._offgrid = None        # (k, n) bool, made at the first check

    def nbytes(self) -> int:
        kept = [self.row_offsets, self.off_e, self.row_e, self.col_e]
        if self._offgrid is not None:
            kept.append(self._offgrid)
        return sum(t.numel() * t.element_size() for t in kept)

    def wrap_flag(self, vals):
        """0-dim bool tensor on the values' device: a nonzero of the
        (k, n) fine slab sits where its diagonal's grid shift leaves the
        grid (the parity classification would be wrong there)."""
        if self._offgrid is None:
            from ...ops.stencil import _in_grid
            self._offgrid = ~torch.stack(_in_grid(
                self.shifts, self.fine_shape, vals.shape[1], vals.device))
        return ((vals != 0) & self._offgrid).any()

    def wrapped(self, vals):
        """The wrap flag of a (k, n) fine value slab: deferred inside a
        hierarchy build (returns False), else read (a Python bool)."""
        flag = self.wrap_flag(vals)
        if _deferred.items is not None:
            _deferred.items.append(flag)
            return False
        return bool(flag)

    def values(self, vals):
        """(values_c, dia_c) from a (k, n) fine value slab: the coarse
        CSR values and the (kc, nc) coarse slab. No host read."""
        masks = self._masks.get(vals.dtype)
        if masks is None:
            masks = self._masks[vals.dtype] = _parity_masks(
                self.fine_shape, vals.dtype, vals.device)
        cvals = _geo_compute(vals, self.contribs, self.fine_shape,
                             self.axes, masks)
        return cvals[self.off_e, self.row_e], cvals

    def assemble(self, values_c, dia_c) -> CsrMatrix:
        return CsrMatrix(
            row_offsets=self.row_offsets, col_indices=self.col_e,
            values=values_c, num_rows=self.nc, num_cols=self.nc,
            grid_shape=tuple(self.coarse_shape),
            dia_offsets=tuple(int(k[0]) for k in self.coffsets),
            dia_vals=dia_c, initialized=True)

    def coarse_matrix(self, A: CsrMatrix):
        """The coarse operator of A, or None when A's values wrap (only
        outside a deferred build)."""
        if self.wrapped(A.dia_vals):
            return None
        return self.assemble(*self.values(A.dia_vals))

    def coarse_coeffs(self, coeffs):
        """The coarse constant-stencil coefficients (kc,) from the fine
        ones (k,): each in-grid coarse entry is the same contraction of
        the fine coefficients, weighted by how many fine cells of an
        aggregate carry each contribution (2 per paired axis its parity
        mask leaves free). None when a paired axis has an odd extent (the
        last aggregate is then a singleton and the coarse operator is not
        constant)."""
        if any(self.fine_shape[a] % 2 for a in self.axes):
            return None
        key = (coeffs.dtype, coeffs.device)
        M = self._coeff_mat.get(key)
        if M is None:
            M = torch.zeros((self.kc, len(self.dia_offsets)),
                            dtype=torch.float64)
            for ci, entries in enumerate(self.contribs):
                for (t, px, py, pz) in entries:
                    w = 1
                    for a, p in zip((0, 1, 2), (px, py, pz)):
                        if a in self.axes and p is None:
                            w *= 2
                    M[ci, t] += w
            M = self._coeff_mat[key] = M.to(dtype=coeffs.dtype,
                                            device=coeffs.device)
        return M @ coeffs


_GEO_PLAN_CACHE = collections.OrderedDict()     # LRU order
GEO_PLAN_CACHE_MAX = 256
GEO_PLAN_CACHE_MAX_BYTES = 2 << 30


def get_geo_plan(A: CsrMatrix, fine_shape, axes, coarse_shape):
    """The GeoRapPlan of A's offsets on A's device, from the cache, or
    None when the GEO product does not apply (no DIA view, another grid,
    a non-stencil offset, or the product switched off)."""
    from ...ops import spgemm
    nx, ny, nz = fine_shape
    if A.dia_offsets is None or A.dia_vals is None \
            or A.grid_shape != tuple(fine_shape) or _deferred.disable_fast:
        return None
    shifts = []
    for d in A.dia_offsets:
        g = _decompose(int(d), nx, ny, nz)
        if g is None:
            return None
        shifts.append(g)
    key = (tuple(int(d) for d in A.dia_offsets), tuple(fine_shape),
           tuple(axes), tuple(coarse_shape), str(A.device))
    plan = _GEO_PLAN_CACHE.get(key)
    if plan is not None:
        _GEO_PLAN_CACHE.move_to_end(key)
        spgemm.PLAN_COUNTS["geo_hit"] += 1
        # the plan carries the coarse CSR structure: its cache is the
        # JAX package's plan cache and structure cache at once
        _tm.inc("amg.spgemm.plan_hit")
        _tm.inc("amg.geo_struct_cache.hit")
        return plan
    spgemm.PLAN_COUNTS["geo_build"] += 1
    _tm.inc("amg.spgemm.plan_build")
    _tm.inc("amg.geo_struct_cache.miss")
    plan = _GEO_PLAN_CACHE[key] = GeoRapPlan(
        key[0], tuple(shifts), key[1], key[2], key[3], A.device)
    total = 0
    for k in reversed(list(_GEO_PLAN_CACHE)):
        total += _GEO_PLAN_CACHE[k].nbytes()
        if k != key and (total > GEO_PLAN_CACHE_MAX_BYTES
                         or len(_GEO_PLAN_CACHE) > GEO_PLAN_CACHE_MAX):
            del _GEO_PLAN_CACHE[k]
    return plan


def geo_coarse_values(A: CsrMatrix, fine_shape, axes, coarse_shape):
    """(cvals (kc, nc), coffsets) of the structured Galerkin product, or
    None when it does not apply (no DIA view, non-stencil offsets, or
    values that wrap grid rows: checked at once outside a deferred
    build)."""
    plan = get_geo_plan(A, fine_shape, axes, coarse_shape)
    if plan is None or plan.wrapped(A.dia_vals):
        return None
    return plan.values(A.dia_vals)[1], plan.coffsets


def geo_assemble_dia(cvals, coffsets, coarse_shape) -> CsrMatrix:
    """The coarse operator from its diagonals: exact-size CSR (entries
    inside the coarse grid, (row, column) order) plus the DIA view."""
    ro, off_e, row_e, col_e = _geo_structure(coffsets, tuple(coarse_shape),
                                             cvals.device)
    nc = cvals.shape[1]
    return CsrMatrix(
        row_offsets=ro, col_indices=col_e, values=cvals[off_e, row_e],
        num_rows=nc, num_cols=nc, grid_shape=tuple(coarse_shape),
        dia_offsets=tuple(int(k[0]) for k in coffsets),
        dia_vals=cvals.contiguous(), initialized=True)
