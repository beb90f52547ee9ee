"""Parallel graph coloring for the multicolor smoothers (the port of
amgx_tpu/ops/coloring.py).

The workhorse is Jones-Plassmann-Luby as segment-max fixed points,
computed with torch on the matrix's device (on the card when the matrix
is there):

- MIN_MAX (also PARALLEL_GREEDY, LOCALLY_DOWNWIND): per round the
  uncolored local maxima of a hash weight take the round's low color and
  the local minima its high color;
- MULTI_HASH: the same fixed point with more rounds;
- MIN_MAX_2RING / GREEDY_MIN_MAX_2RING, and `coloring_level` 2: the
  fixed point on the pattern of A A (distance-2 coloring);
- GREEDY_RECOLOR: MIN_MAX, then a host pass that moves each color class
  to its smallest neighbour-free color;
- ROUND_ROBIN / UNIFORM: the row index modulo `num_colors`;
- SERIAL_GREEDY_BFS: host-side first-fit greedy in row order.

The hash is uint32 arithmetic. It is computed in int64 and masked to 32
bits after every add and multiply (an int64 product wraps, but its low
32 bits stay right) and before every right shift, so the colors equal
the JAX package's bit for bit. The per-row maximum and minimum over the
neighbours are order-free (`scatter_reduce`). Each round's "any row
uncolored?" is a host read: at most one per color at setup.

A coloring attached by the user (AMGX_matrix_attach_coloring, the
matrix's `user_colors`) overrides the configured scheme.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import registry
from ..matrix import CsrMatrix

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Coloring:
    row_colors: torch.Tensor       # (n,) int32
    num_colors: int

    def color_counts(self):
        return torch.bincount(self.row_colors.long(),
                              minlength=self.num_colors)


def _hash_w(n: int, salt: int, device="cpu") -> torch.Tensor:
    """The JAX package's uint32 hash of the row index, as int64 values in
    [0, 2^32)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    h = ((i + ((salt * 0x9E3779B9) & _M32)) & _M32) * 2654435761 & _M32
    h = ((h ^ (h >> 15)) * 0x85EBCA6B) & _M32
    return h ^ (h >> 13)


def _sym_edges(A: CsrMatrix):
    """The off-diagonal edges in both directions, stably sorted by row:
    (rows, cols), int64."""
    rows, cols, _ = A.coo()
    cols = cols.long()
    offd = rows != cols
    r = torch.cat([rows[offd], cols[offd]])
    c = torch.cat([cols[offd], rows[offd]])
    order = torch.argsort(r, stable=True)
    return r[order], c[order]


def _square_edges(A: CsrMatrix):
    """The distance-2 adjacency (pattern of A A) as symmetric edges,
    stably sorted by row."""
    from .spgemm import csr_multiply
    pattern = CsrMatrix(row_offsets=A.row_offsets, col_indices=A.col_indices,
                        values=torch.ones(A.nnz, dtype=torch.float64,
                                          device=A.device),
                        num_rows=A.num_rows, num_cols=A.num_cols)
    r2, c2, v2 = csr_multiply(pattern, pattern).coo()
    c2 = c2.long()
    keep = (v2 > 0) & (r2 != c2)
    r = torch.cat([r2[keep], c2[keep]])
    c = torch.cat([c2[keep], r2[keep]])
    order = torch.argsort(r, stable=True)
    return r[order], c[order]


def _jpl_min_max(A: CsrMatrix, max_rounds: int = 64, use_min: bool = True,
                 edges=None) -> Coloring:
    """Jones-Plassmann-Luby with (max, min) extraction per round; rows
    still uncolored after `max_rounds` take one last color."""
    n = A.num_rows
    dev = A.device
    sr, sc = _sym_edges(A) if edges is None else edges
    colors = torch.full((n,), -1, dtype=torch.int32, device=dev)
    has_nbr = torch.zeros(n, dtype=torch.bool, device=dev)
    has_nbr[sr] = True
    colors[~has_nbr] = 0                         # isolated: color 0
    next_color = 0

    def extract(colors, w, ncol, maximize):
        un = colors < 0
        active = un[sr] & un[sc]
        fill = 0 if maximize else _M32
        best = torch.full((n,), fill, dtype=torch.int64, device=dev)
        best.scatter_reduce_(
            0, sr, torch.where(active, w[sc], torch.full_like(w[sc], fill)),
            "amax" if maximize else "amin", include_self=True)
        take = un & ((w > best) if maximize else (w < best))
        return torch.where(take, torch.full_like(colors, ncol), colors)

    for rnd in range(max_rounds):
        if not bool((colors < 0).any()):
            break
        w = _hash_w(n, rnd, dev)
        colors = extract(colors, w, next_color, True)
        next_color += 1
        if use_min:
            if not bool((colors < 0).any()):
                break
            colors = extract(colors, w, next_color, False)
            next_color += 1
    colors = torch.where(colors < 0, torch.full_like(colors, next_color),
                         colors)                 # stragglers
    num = int(colors.max()) + 1 if n else 0
    return Coloring(colors, num)


class MatrixColoring:
    """Base (include/matrix_coloring/matrix_coloring.h:27)."""

    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope
        self.coloring_level = int(cfg.get("coloring_level", scope))

    def color_matrix(self, A: CsrMatrix) -> Coloring:
        raise NotImplementedError


@registry.matrix_coloring.register("MIN_MAX")
@registry.matrix_coloring.register("PARALLEL_GREEDY")
@registry.matrix_coloring.register("LOCALLY_DOWNWIND")
class MinMaxColoring(MatrixColoring):
    """LOCALLY_DOWNWIND aliases MIN_MAX, as in the JAX package."""

    def color_matrix(self, A):
        if self.coloring_level >= 2:
            return _jpl_min_max(A, edges=_square_edges(A))
        return _jpl_min_max(A)


def _greedy_recolor_np(n, ro_e, sc, colors, num_colors):
    """Descending-class first-fit recolor over the symmetrized edges
    (rows CSR-ordered): each color class is an independent set, so its
    vertices move at once to their smallest neighbour-free color. One
    pass; the count never grows."""
    colors = colors.copy()
    K = int(num_colors)
    if K <= 2 or n == 0:
        return colors, K
    for c in range(K - 1, 0, -1):
        rows_c = np.flatnonzero(colors == c)
        if rows_c.size == 0:
            continue
        used = np.zeros((rows_c.size, K), bool)
        cnt = ro_e[rows_c + 1] - ro_e[rows_c]
        tot = int(cnt.sum())
        if tot:
            tgt = np.repeat(np.arange(rows_c.size), cnt)
            pos = (np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
                   + np.repeat(ro_e[rows_c], cnt))
            used[tgt, colors[sc[pos]]] = True
        colors[rows_c] = np.argmax(~used, axis=1)   # smallest free color
    return colors, int(colors.max()) + 1


@registry.matrix_coloring.register("GREEDY_RECOLOR")
class GreedyRecolorColoring(MatrixColoring):
    """MIN_MAX, then the greedy recoloring pass on the host (the
    reference's greedy_recolor.cu role: fewer colors, shorter sweeps)."""

    def color_matrix(self, A):
        n = A.num_rows
        edges = _square_edges(A) if self.coloring_level >= 2 \
            else _sym_edges(A)
        base = _jpl_min_max(A, edges=edges)
        if base.num_colors <= 2:
            return base
        sr, sc = (e.cpu().numpy() for e in edges)
        ro_e = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(sr, minlength=n), out=ro_e[1:])
        colors, num = _greedy_recolor_np(
            n, ro_e, sc, base.row_colors.cpu().numpy(), base.num_colors)
        return Coloring(torch.from_numpy(colors).to(A.device), num)


@registry.matrix_coloring.register("MIN_MAX_2RING")
@registry.matrix_coloring.register("GREEDY_MIN_MAX_2RING")
class MinMax2RingColoring(MatrixColoring):
    def color_matrix(self, A):
        return _jpl_min_max(A, edges=_square_edges(A))


@registry.matrix_coloring.register("MULTI_HASH")
class MultiHashColoring(MatrixColoring):
    def __init__(self, cfg, scope):
        super().__init__(cfg, scope)
        self.max_num_hash = int(cfg.get("max_num_hash", scope))

    def color_matrix(self, A):
        return _jpl_min_max(A, max_rounds=max(self.max_num_hash * 4, 16))


@registry.matrix_coloring.register("ROUND_ROBIN")
@registry.matrix_coloring.register("UNIFORM")
class RoundRobinColoring(MatrixColoring):
    """The row index modulo `num_colors` (round_robin.cu; UNIFORM's
    striping, valid for banded stencils whose bandwidth is below
    num_colors)."""

    def __init__(self, cfg, scope):
        super().__init__(cfg, scope)
        self.num_colors = int(cfg.get("num_colors", scope))

    def color_matrix(self, A):
        c = torch.arange(A.num_rows, dtype=torch.int32,
                         device=A.device) % self.num_colors
        return Coloring(c, min(self.num_colors, max(A.num_rows, 1)))


@registry.matrix_coloring.register("SERIAL_GREEDY_BFS")
class SerialGreedyBfsColoring(MatrixColoring):
    """Host-side first-fit greedy in row order (serial_greedy_bfs.cu):
    the quality reference the parallel schemes are judged against."""

    def color_matrix(self, A):
        n = A.num_rows
        ro = A.row_offsets.cpu().numpy()
        ci = A.col_indices.cpu().numpy()
        colors = np.full(n, -1, np.int32)
        for i in range(n):
            nbr = ci[ro[i]:ro[i + 1]]
            used = set(colors[j] for j in nbr if j != i and colors[j] >= 0)
            c = 0
            while c in used:
                c += 1
            colors[i] = c
        return Coloring(torch.from_numpy(colors).to(A.device),
                        int(colors.max()) + 1 if n else 0)


def color_matrix(A: CsrMatrix, cfg, scope: str = "default") -> Coloring:
    """MatrixColoringFactory entry (src/core.cu:669): the configured
    `matrix_coloring_scheme`. A user-attached coloring
    (AMGX_matrix_attach_coloring) overrides it, as the reference's
    attach does."""
    if A.user_colors is not None:
        return Coloring(A.user_colors.to(device=A.device, dtype=torch.int32),
                        int(A.user_num_colors))
    name = str(cfg.get("matrix_coloring_scheme", scope))
    return registry.matrix_coloring.create(name, cfg, scope).color_matrix(A)
