"""Strength of connection (the port of amgx_tpu/amg/classical/strength.py).

AHAT marks a_ij strong when it is a large enough coupling opposite in
sign to the diagonal, relative to the row's largest one:

    -a_ij * sign(a_ii) >= theta * max_k(-a_ik * sign(a_ii)),   k != i,

and with `max_row_sum` < 1 weakens every connection of a row whose
|row sum| exceeds max_row_sum * |a_ii| (an almost-Dirichlet row). The
row maximum is exact in any order; the row sum is an ordered segment
sum (ops/segment.py), so the mask is the same bits on the CPU and on
the card. Returns a boolean mask over the CSR entries. AFFINITY is not
ported.
"""
from __future__ import annotations

import torch

from ... import registry
from ...matrix import CsrMatrix
from ...ops.segment import segment_max, segment_sum


class Strength:
    def __init__(self, cfg, scope):
        self.theta = float(cfg.get("strength_threshold", scope))
        self.max_row_sum = float(cfg.get("max_row_sum", scope))

    def strong_mask(self, A: CsrMatrix) -> torch.Tensor:
        raise NotImplementedError


@registry.strength.register("AHAT")
class AhatStrength(Strength):
    def strong_mask(self, A: CsrMatrix) -> torch.Tensor:
        rows, cols, vals = A.coo()
        n = A.num_rows
        offdiag = rows != cols.long()
        diag = A.diagonal()
        sgn = torch.sign(torch.where(diag == 0, torch.ones_like(diag),
                                     diag))
        coupling = torch.where(offdiag, -vals * sgn[rows],
                               torch.zeros_like(vals))
        row_max = segment_max(coupling, rows, n).clamp(min=0.0)
        strong = offdiag & (coupling >= self.theta * row_max[rows]) \
            & (coupling > 0)
        if self.max_row_sum < 1.0:
            rowsum = segment_sum(vals, rows, n)
            weak_row = rowsum.abs() > self.max_row_sum * diag.abs()
            strong = strong & ~weak_row[rows]
        return strong


@registry.strength.register("ALL")
class AllStrength(Strength):
    def strong_mask(self, A: CsrMatrix) -> torch.Tensor:
        rows, cols, _ = A.coo()
        return rows != cols.long()


@registry.strength.register("AFFINITY")
class AffinityStrength(Strength):
    def strong_mask(self, A: CsrMatrix) -> torch.Tensor:
        raise NotImplementedError(
            "strength=AFFINITY is not ported yet (see ROADMAP.md); AHAT "
            "and ALL are")
