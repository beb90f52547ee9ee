"""Aggregation selectors (the port of amgx_tpu/amg/aggregation/selectors.py):
GEO, the parallel-matching selectors SIZE_2 / SIZE_4 / SIZE_8,
MULTI_PAIRWISE and PARALLEL_GREEDY, SERIAL_GREEDY(_BFS), ADAPTIVE and
DUMMY.

The matching is the JAX package's handshake fixed point, on the
operator's device:

  repeat (at most max_matching_iterations times):
    every unaggregated vertex proposes its strongest unaggregated
    neighbour (segment max of the perturbed edge weights, smallest
    column on a tie); mutual proposals (handshakes) become aggregates
    of two.

SIZE_4 / SIZE_8 run 2 / 3 passes, pairing the previous pass's
aggregates through the collapsed weight graph (`_coarse_graph`).
The JAX package compiles the whole selection into one program with a
`lax.while_loop`; here each matching iteration is one Python step that
reads one flag on the host (is any active vertex left?), so a pass costs
at most max_matching_iterations host reads, and one more reads the
coarse size per level.

Every step gives the JAX package's bits, on the CPU and on the card:
the weights are separately rounded elementwise operations in the JAX
package's order, the maxima and minima are order-free scatter
reductions, and the one float sum (`_coarse_graph`'s weight sum, which
later handshakes compare) is ordered (ops/segment.py).

PARALLEL_GREEDY is SIZE_2's matching (one pass), as in the JAX package.
SERIAL_GREEDY / SERIAL_GREEDY_BFS is host-serial by design, as in the
JAX package and the reference (serial_greedy.cu copies the matrix to the
host): the edge weights are formed on A's device, then a Python loop
seeds each aggregate at the unaggregated vertex of least degree and
grows it by its strongest edge to `aggregate_size` members; the
aggregates go back to A's device. ADAPTIVE relaxes a random vector
(`default_rng(1234)` under `determinism_flag`, else unseeded) by 15
damped-Jacobi sweeps of A x = 0 (SpMVs through ops/spmv.py) and bins
its entries into n / 4 equal bins; each bin is an aggregate.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import registry
from ...config import Config
from ...errors import BadParametersError
from ...matrix import CsrMatrix, lexsort_rc
from ...ops.segment import ordered_segment_sum, starts_from_ids
from ...ops.spmv import spmv

_MASK32 = 0xFFFFFFFF


def _edge_weights(A: CsrMatrix, formula: int = 0):
    """(rows, cols, w) of A's entries in (row, col) order, int64 indices:
    w_ij = 0.5 (|a_ij| + |a_ji|) / max(|a_ii|, |a_jj|) (weight_formula
    0) or Notay's signed -0.5 (a_ij / a_ii + a_ji / a_jj) (1); 0 on the
    diagonal. a_ji is found by the positional transpose alignment (the
    (col, row) order puts each entry's partner at its own position when
    the pattern is symmetric); a one-sided entry uses its own side."""
    rows, cols, v = A.coo()
    cols = cols.long()
    d = A.diagonal()
    absd = torch.abs(d)
    canon = lexsort_rc(rows, cols)
    rows, cols, v = rows[canon], cols[canon], v[canon]
    order = lexsort_rc(cols, rows)
    match = (rows[order] == cols) & (cols[order] == rows)
    v_t = torch.where(match, v[order], torch.zeros_like(v))
    if formula == 1:
        one = torch.ones_like(d)
        dr = torch.where(d[rows] == 0, one[rows], d[rows])
        dc = torch.where(d[cols] == 0, one[cols], d[cols])
        w = -0.5 * (v / dr + v_t / dc)
    else:
        denom = torch.maximum(absd[rows], absd[cols])
        w = 0.5 * (torch.abs(v) + torch.abs(v_t)) / torch.where(
            denom == 0, torch.ones_like(denom), denom)
    w = torch.where(rows == cols, torch.zeros_like(w), w)
    return rows, cols, w


def _edge_hash(rows, cols):
    """Symmetric per-edge value in [0, 1): a 32-bit hash of the unordered
    pair (the JAX package's uint32 arithmetic, carried in int64 and
    masked to 32 bits), as float64."""
    a = torch.minimum(rows, cols).long() & _MASK32
    b = torch.maximum(rows, cols).long() & _MASK32
    h = ((a * 73856093) & _MASK32) ^ ((b * 19349663) & _MASK32)
    h = ((h ^ (h >> 13)) * 0x5BD1E995) & _MASK32
    return (h & 0xFFFFF).to(torch.float64) / float(1 << 20)


def _seg_max(values, ids, n):
    """max over each of n segments (-inf where empty); ids == n drop."""
    out = torch.full((n + 1,), float("-inf"), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, ids, values, "amax",
                               include_self=True)[:n]


def _seg_min(values, ids, n):
    """min over each of n segments of int64 values (n where empty);
    ids == n drop."""
    out = torch.full((n + 1,), n, dtype=torch.int64, device=values.device)
    return out.scatter_reduce_(0, ids, values, "amin",
                               include_self=True)[:n]


def _padded(mask, n):
    """mask with one False appended: a vertex lookup tolerant of the
    sentinel n."""
    return torch.cat([mask, mask.new_zeros(1)])


def _best_neighbour(rows, cols, we, valid, n):
    """(has, best): whether each vertex has a positive candidate, and the
    smallest column among its maximal ones (n where none)."""
    wmax = _seg_max(we, rows, n)
    has = wmax > 0
    is_best = valid & (we == wmax[rows.clamp(max=n - 1)])
    best = _seg_min(torch.where(is_best, cols, torch.full_like(cols, n)),
                    rows, n)
    return has, torch.where(has, best, torch.full_like(best, n))


def _matching_pass(rows, cols, w, n, max_iters: int, active=None):
    """One size-2 matching: aggregate ids (pairs take the smaller vertex
    id, leftovers their own), not yet renumbered. Entries with rows == n
    are drop sentinels; `active` restricts the matching to a vertex
    subset (the padded coarse passes)."""
    dev = w.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    w = w * (1.0 + 1e-3 * _edge_hash(rows, cols).to(w.dtype))
    neg = torch.full_like(w, -1.0)
    rows_c, cols_c = rows.clamp(max=n), cols.clamp(max=n)
    agg = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        un = (agg < 0) & active
        if not bool(un.any()):                  # one host read
            break
        pad = _padded(un, n)
        valid = pad[rows_c] & pad[cols_c] & (w > 0)
        has, best = _best_neighbour(rows, cols, torch.where(valid, w, neg),
                                    valid, n)
        bob = torch.where(best < n, best[best.clamp(max=n - 1)],
                          torch.full_like(best, n))
        paired = (best < n) & (bob == idx)
        leader = paired & (idx < best)
        agg = torch.where(leader, idx, agg)
        agg = torch.where(paired & ~leader, best, agg)
    return torch.where(agg < 0, idx, agg)


def _merge_singletons(rows, cols, w, agg, n):
    """Each singleton aggregate joins its strongest neighbour's aggregate
    (merge_singletons), all singletons at once from the same state."""
    sizes = torch.bincount(agg, minlength=n)
    single = sizes[agg] == 1
    pad = _padded(single, n)
    valid = pad[rows.clamp(max=n)] & ~pad[cols.clamp(max=n)] & (w > 0) \
        & (cols < n)
    has, best = _best_neighbour(
        rows, cols, torch.where(valid, w, torch.full_like(w, -1.0)), valid, n)
    target = torch.where(has & single, agg[best.clamp(max=n - 1)], agg)
    return torch.where(single, target, agg)


def _renumber(agg, n, active=None):
    """Aggregate ids compacted to 0..nc-1 in order: (ids, nc as a 0-dim
    tensor)."""
    slot = agg if active is None else torch.where(
        active, agg, torch.full_like(agg, n))
    present = torch.zeros(n + 1, dtype=torch.int64, device=agg.device)
    present[slot] = 1
    new_id = torch.cumsum(present[:n], 0) - 1
    return new_id[agg], new_id[-1] + 1


def _coarse_graph(rows, cols, w, agg, n):
    """The weight graph collapsed onto aggregates, at the input's length:
    entries sorted by (coarse row, coarse col), each coordinate's weights
    summed (in sorted order, ops/segment.py) onto its first occurrence,
    every other entry a drop sentinel (row == col == n, w == 0)."""
    e = rows.shape[0]
    aggp = torch.cat([agg, agg.new_full((1,), n)])
    cr, cc = aggp[rows.clamp(max=n)], aggp[cols.clamp(max=n)]
    valid = (cr != cc) & (w > 0) & (rows < n)
    sentinel = torch.full_like(cr, n)
    cr_k = torch.where(valid, cr, sentinel)
    cc_k = torch.where(valid, cc, sentinel)
    order = lexsort_rc(cr_k, cc_k)
    cr_s, cc_s, w_s = cr_k[order], cc_k[order], w[order]
    valid_s = cr_s < n
    first = torch.ones(e, dtype=torch.bool, device=w.device)
    first[1:] = (cr_s[1:] != cr_s[:-1]) | (cc_s[1:] != cc_s[:-1])
    first &= valid_s
    seg = torch.cumsum(first.long(), 0) - 1
    # the invalid entries sort last; the JAX segment_sum adds their zeros
    # to the last segment, which changes no bit of its positive sum, so
    # they are left out: the longest segment is then a coarse edge's few
    # entries, not the thousands collapsed inside aggregates (the ordered
    # sum takes one step per position of the longest segment)
    wsum = ordered_segment_sum(w_s[valid_s],
                               starts_from_ids(seg[valid_s], e))
    crows = torch.where(first, cr_s, sentinel)
    ccols = torch.where(first, cc_s, sentinel)
    cw = torch.where(first, wsum[seg.clamp(0, e - 1)], torch.zeros_like(w))
    return crows, ccols, cw


def _set_aggregates_impl(A: CsrMatrix, passes: int, max_iters: int,
                         merge: bool, formula: int):
    """The multi-pass matching: (aggregates (n,) int64, nc 0-dim). Later
    passes run on the collapsed graph padded to the fine vertex count,
    with an `active` mask, as in the JAX package."""
    n = A.num_rows
    rows, cols, w = _edge_weights(A, formula)
    agg = _matching_pass(rows, cols, w, n, max_iters)
    if merge:
        agg = _merge_singletons(rows, cols, w, agg, n)
    agg, nc = _renumber(agg, n)
    for _ in range(passes - 1):
        crows, ccols, cw = _coarse_graph(rows, cols, w, agg, n)
        active = torch.arange(n, device=agg.device) < nc
        cagg = _matching_pass(crows, ccols, cw, n, max_iters, active=active)
        if merge:
            cagg = _merge_singletons(crows, ccols, cw, cagg, n)
        cagg, nc = _renumber(cagg, n, active=active)
        agg = cagg[agg]
    return agg, nc


class AggregationSelector:
    def __init__(self, cfg: Config, scope: str = "default"):
        self.cfg = cfg
        self.scope = scope

    def set_aggregates(self, A: CsrMatrix):
        """(aggregates (n,) int32 tensor on A's device, coarse size)."""
        raise NotImplementedError


class _SizeNSelector(AggregationSelector):
    passes = 1          # SIZE_2; 2 -> SIZE_4; 3 -> SIZE_8

    def __init__(self, cfg: Config, scope: str = "default"):
        super().__init__(cfg, scope)
        self.max_matching_iterations = int(
            cfg.get("max_matching_iterations", scope))
        self.merge_singletons = int(cfg.get("merge_singletons", scope))
        self.weight_formula = int(cfg.get("weight_formula", scope))

    def set_aggregates(self, A: CsrMatrix):
        agg, nc = _set_aggregates_impl(
            A, passes=self.passes, max_iters=self.max_matching_iterations,
            merge=bool(self.merge_singletons), formula=self.weight_formula)
        return agg.to(torch.int32), int(nc)


@registry.aggregation_selectors.register("SIZE_2")
class Size2Selector(_SizeNSelector):
    passes = 1


@registry.aggregation_selectors.register("SIZE_4")
class Size4Selector(_SizeNSelector):
    passes = 2


@registry.aggregation_selectors.register("SIZE_8")
class Size8Selector(_SizeNSelector):
    passes = 3


@registry.aggregation_selectors.register("MULTI_PAIRWISE")
class MultiPairwiseSelector(_SizeNSelector):
    """Pairwise matching repeated `aggregation_passes` times on the
    weight graph of the previous pass's aggregates; notay_weights=1
    takes Notay's signed coupling (weight_formula 1)."""

    def __init__(self, cfg: Config, scope: str = "default"):
        super().__init__(cfg, scope)
        self.passes = int(cfg.get("aggregation_passes", scope))
        if int(cfg.get("notay_weights", scope)):
            self.weight_formula = 1


@registry.aggregation_selectors.register("PARALLEL_GREEDY")
class ParallelGreedySelector(_SizeNSelector):
    """parallel_greedy_selector.cu's role: SIZE_2's handshake matching."""

    passes = 1


@registry.aggregation_selectors.register("SERIAL_GREEDY")
@registry.aggregation_selectors.register("SERIAL_GREEDY_BFS")
class SerialGreedySelector(AggregationSelector):
    """Serial greedy BFS aggregation (serial_greedy.cu), on the host."""

    def set_aggregates(self, A: CsrMatrix):
        size = max(int(self.cfg.get("aggregate_size", self.scope)), 2)
        n = A.num_rows
        rows, cols, w = _edge_weights(
            A, int(self.cfg.get("weight_formula", self.scope)))
        # (row, col) order: each vertex's edges are one run
        starts = torch.searchsorted(
            rows, torch.arange(n + 1, device=rows.device)).tolist()
        cols, w = cols.tolist(), w.tolist()
        agg = [-1] * n
        deg = np.diff(np.asarray(starts))
        for seed in np.argsort(deg, kind="stable").tolist():
            if agg[seed] >= 0:
                continue
            agg[seed] = seed
            members = [seed]
            while len(members) < size:
                best_w, best_v = 0.0, -1
                for m in members:
                    for e in range(starts[m], starts[m + 1]):
                        v = cols[e]
                        if agg[v] < 0 and w[e] > best_w:
                            best_w, best_v = w[e], v
                if best_v < 0:
                    break
                agg[best_v] = seed
                members.append(best_v)
        ids, nc = _renumber(torch.tensor(agg, dtype=torch.int64), n)
        return ids.to(device=A.device, dtype=torch.int32), int(nc)


@registry.aggregation_selectors.register("ADAPTIVE")
class AdaptiveSelector(AggregationSelector):
    """Smoothed-vector binning (adaptive.cu's documented algorithm)."""

    def set_aggregates(self, A: CsrMatrix):
        n = A.num_rows
        seeded = bool(int(self.cfg.get("determinism_flag", self.scope)))
        rng = np.random.default_rng(1234 if seeded else None)
        x = torch.tensor(rng.uniform(-1.0, 1.0, n), dtype=A.dtype,
                         device=A.device)
        d = A.diagonal()
        dinv = torch.where(d == 0, torch.zeros_like(d),
                           1.0 / torch.where(d == 0, torch.ones_like(d), d))
        for _ in range(15):
            x = x - 0.66 * dinv * spmv(A, x)
        lo = x.min()
        width = torch.clamp(x.max() - lo, min=1e-30)
        n_bins = max(n // 4, 1)
        bins = ((x - lo) / width * n_bins).to(torch.int32).clamp(
            0, n_bins - 1).long()
        # each bin stamped with its first member, then compacted
        first = torch.full((n_bins,), n, dtype=torch.int64,
                           device=A.device).scatter_reduce_(
            0, bins, torch.arange(n, device=A.device), "amin")
        ids, nc = _renumber(first[bins], n)
        return ids.to(torch.int32), int(nc)


@registry.aggregation_selectors.register("DUMMY")
class DummySelector(AggregationSelector):
    """Blocks of `aggregate_size` consecutive rows."""

    def set_aggregates(self, A: CsrMatrix):
        size = int(self.cfg.get("aggregate_size", self.scope))
        n = A.num_rows
        agg = torch.arange(n, dtype=torch.int32, device=A.device) // size
        return agg, int(np.ceil(n / size))


@registry.aggregation_selectors.register("GEO")
class GeoSelector(AggregationSelector):
    """Geometric aggregation on a structured grid (CsrMatrix.grid_shape):
    each aggregate is the 2x2x2 block of grid points, every axis with
    extent >= 2 halved (rounding up):

      agg(x, y, z) = linear coarse index of (x//2, y//2, z//2).

    Sets `pair_axes`, `fine_shape` and `coarse_shape` for the level's
    structured transfers and Galerkin product."""

    def set_aggregates(self, A: CsrMatrix):
        shape = A.grid_shape
        n = A.num_rows
        if shape is None or int(np.prod(shape)) != n:
            raise BadParametersError(
                "GEO selector requires a structured-grid matrix "
                "(CsrMatrix.grid_shape)")
        nx, ny, nz = shape
        axes = tuple(a for a, e in enumerate((nx, ny, nz)) if e >= 2)
        self.fine_shape = tuple(shape)
        i = torch.arange(n, dtype=torch.int32, device=A.device)
        if not axes:
            self.pair_axes = None
            self.coarse_shape = tuple(shape)
            return i, n
        cnx = (nx + 1) // 2 if 0 in axes else nx
        cny = (ny + 1) // 2 if 1 in axes else ny
        cnz = (nz + 1) // 2 if 2 in axes else nz
        x, t = i % nx, i // nx
        y, z = t % ny, t // ny
        cx = x // 2 if 0 in axes else x
        cy = y // 2 if 1 in axes else y
        cz = z // 2 if 2 in axes else z
        self.pair_axes = axes
        self.coarse_shape = (cnx, cny, cnz)
        return (cz * cny + cy) * cnx + cx, int(cnx * cny * cnz)
