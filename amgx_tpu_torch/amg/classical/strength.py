"""Strength of connection (the port of amgx_tpu/amg/classical/strength.py).

AHAT marks a_ij strong when it is a large enough coupling opposite in
sign to the diagonal, relative to the row's largest one:

    -a_ij * sign(a_ii) >= theta * max_k(-a_ik * sign(a_ii)),   k != i,

and with `max_row_sum` < 1 weakens every connection of a row whose
|row sum| exceeds max_row_sum * |a_ii| (an almost-Dirichlet row). The
row maximum is exact in any order; the row sum is an ordered segment
sum (ops/segment.py), so the mask is the same bits on the CPU and on
the card. Returns a boolean mask over the CSR entries.

AFFINITY (affinity.cu; the JAX package's `AffinityStrength`): K =
`affinity_vectors` random test vectors (`default_rng(12345)`) relaxed by
`affinity_iterations` damped-Jacobi sweeps of A z = 0, run as one (K, n)
sweep an iteration; the affinity of an edge, <z_i, z_j>^2 / (<z_i, z_i>
<z_j, z_j>), replaces the coefficient in AHAT's test. Its dots over the
K vectors are added left to right (ops/segment.py `ordered_rows_sum`).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import registry
from ...matrix import CsrMatrix
from ...ops.segment import ordered_rows_sum, segment_max, segment_sum
from ...ops.spmv import spmv


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
    def __init__(self, cfg, scope):
        super().__init__(cfg, scope)
        self.iters = int(cfg.get("affinity_iterations", scope))
        self.k = int(cfg.get("affinity_vectors", scope))

    def strong_mask(self, A: CsrMatrix) -> torch.Tensor:
        n = A.num_rows
        rng = np.random.default_rng(12345)
        Z = torch.tensor(rng.uniform(-1, 1, (self.k, n)), dtype=A.dtype,
                         device=A.device)
        d = A.diagonal()
        dinv = torch.where(d == 0, torch.zeros_like(d),
                           1.0 / torch.where(d == 0, torch.ones_like(d), d))
        for _ in range(self.iters):
            Z = Z - 0.7 * (dinv * spmv(A, Z))
        rows, cols, _ = A.coo()
        cols = cols.long()
        zi, zj = Z[:, rows], Z[:, cols]
        num = ordered_rows_sum(zi * zj) ** 2
        den = ordered_rows_sum(zi * zi) * ordered_rows_sum(zj * zj)
        aff = num / torch.where(den == 0, torch.ones_like(den), den)
        offdiag = rows != cols
        aff = torch.where(offdiag, aff, torch.zeros_like(aff))
        row_max = segment_max(aff, rows, n)
        return offdiag & (aff >= self.theta * row_max[rows]) & (aff > 0)
