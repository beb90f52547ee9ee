"""CF-splitting selectors (the port of PMIS in
amgx_tpu/amg/classical/selectors.py).

PMIS is a data-parallel fixed point over the symmetrized strength graph:

    w_i = strong-degree(i) / 2 + hash(i)        (a deterministic "random")
    repeat: an undecided i whose weight beats every undecided strong
            neighbour's becomes COARSE; undecided neighbours of COARSE
            points become FINE.

The degree is a count of halves and the hash has 20 bits, so w is exact
in float64 and every comparison is strict: the split is identical on
the CPU, on the card and in the JAX package. The hash needs uint32
wrap-around multiplication; it runs in int64 masked to 32 bits after
each step. RS, HMIS, CR and the aggressive selectors are not ported.
"""
from __future__ import annotations

import torch

from ... import registry
from ...matrix import CsrMatrix
from ...ops.segment import segment_any, segment_max

FINE, COARSE, UNDECIDED = 0, 1, -1
_MASK32 = 0xFFFFFFFF


def _hash01(n: int, device) -> torch.Tensor:
    """The JAX package's `_hash01` in float64: an integer hash of the
    index, its low 20 bits over 2^20."""
    h = torch.arange(n, dtype=torch.int64, device=device)
    h = (h * 2654435761) & _MASK32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK32
    h = h ^ (h >> 16)
    return (h & 0xFFFFF).to(torch.float64) / float(1 << 20)


def _symmetrize(rows, cols, mask):
    """Edges of S | S^T grouped by row (duplicates kept: harmless for
    the max / any reductions, and they make deg = (out + in) / 2)."""
    r = torch.cat([rows[mask], cols[mask]])
    c = torch.cat([cols[mask], rows[mask]])
    order = torch.argsort(r, stable=True)
    return r[order], c[order]


def pmis_split(A: CsrMatrix, strong: torch.Tensor,
               max_iters: int = 30) -> torch.Tensor:
    """cf_map (n,) int32 in {FINE, COARSE}."""
    n = A.num_rows
    dev = A.device
    rows, cols, _ = A.coo()
    sr, sc = _symmetrize(rows, cols.long(), strong)
    deg = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, sr, torch.ones(sr.shape[0], dtype=torch.float64, device=dev))
    w = deg * 0.5 + _hash01(n, dev)
    # isolated points (no strong connection) cannot interpolate: COARSE
    has_nbr = segment_any(torch.ones_like(sr, dtype=torch.bool), sr, n)
    state = torch.where(has_nbr, UNDECIDED, COARSE).to(torch.int32)
    for _ in range(max_iters):
        und = state == UNDECIDED
        if not bool(und.any()):
            break
        active = und[sr] & und[sc]
        nbr_max = segment_max(torch.where(active, w[sc], float("-inf")),
                              sr, n)
        state = torch.where(und & (w > nbr_max), COARSE, state)
        c_nbr = segment_any(state[sc] == COARSE, sr, n)
        state = torch.where((state == UNDECIDED) & c_nbr, FINE, state)
    return torch.where(state == UNDECIDED, FINE, state).to(torch.int32)


class ClassicalSelector:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope

    def mark_coarse_fine_points(self, A: CsrMatrix, strong):
        raise NotImplementedError


@registry.classical_selectors.register("PMIS")
class PMISSelector(ClassicalSelector):
    def mark_coarse_fine_points(self, A, strong):
        return pmis_split(A, strong)


def _unported(name):
    class _Unported(ClassicalSelector):
        def mark_coarse_fine_points(self, A, strong):
            raise NotImplementedError(
                f"selector={name} is not ported yet (PMIS is; see "
                f"ROADMAP.md)")
    return _Unported


for _name in ("RS", "HMIS", "CR", "AGGRESSIVE_PMIS", "AGGRESSIVE_HMIS",
              "DUMMY_CLASSICAL"):
    registry.classical_selectors.register(_name)(_unported(_name))
