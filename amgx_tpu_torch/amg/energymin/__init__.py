"""Energy-minimization AMG level (the port of
amgx_tpu/amg/energymin/__init__.py): the classical level flow with the
energymin selector and interpolator registries.

The EM interpolator: column j of P, for coarse point c_j, is the local
harmonic extension over the F points F_j among c_j's neighbours,

    p_F = - A[F_j, F_j]^{-1} A[F_j, c_j],

the energy minimizer with unit value at c_j. Every coarse point's patch
is padded to the widest column's k (padding rows are identity rows with
a zero right-hand side, so their unknowns come out 0) and the whole set
is ONE batched solve, ops/dense.py `solve_qr`: K7 on the card, one
launch a level. A singular patch comes out non-finite and its F entries
are zeroed (the coarse point degrades to injection). F rows covered by
several columns are rescaled to preserve constants; their row sums are
ordered (ops/segment.py). The JAX package builds the patches in numpy
on the host; here they are built on A's device with torch (the port's
classical setup runs where the operator lives), with the same F, A_FF
and right-hand sides.
"""
from __future__ import annotations

import torch

from ... import registry
from ...matrix import CsrMatrix
from ...ops.dense import solve_qr
from ...ops.segment import ordered_segment_sum, starts_from_ids
from ..classical import ClassicalAMGLevel


class EnergyminInterpolator:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope

    def generate(self, A: CsrMatrix, cf_map, strong) -> CsrMatrix:
        raise NotImplementedError


def _column_patches(rows, cols, is_C, cidx, c_rows):
    """F (nc, kmax) int64: the F neighbours of each coarse point in its
    row's stored order, -1 padding (kmax >= 1)."""
    nc = c_rows.numel()
    keep = is_C[rows] & ~is_C[cols] & (rows != cols)
    s_rows, s_cols = rows[keep], cols[keep]
    kmax = max(int(torch.bincount(s_rows).max()) if s_rows.numel() else 0,
               1)
    col_of = cidx[s_rows]
    order = torch.argsort(col_of, stable=True)
    col_sorted = col_of[order]
    F = torch.full((nc, kmax), -1, dtype=torch.int64, device=rows.device)
    if order.numel():
        new_grp = torch.ones_like(col_sorted, dtype=torch.bool)
        new_grp[1:] = col_sorted[1:] != col_sorted[:-1]
        grp_start = torch.nonzero(new_grp)[:, 0]
        gid = torch.cumsum(new_grp.long(), 0) - 1
        first = torch.arange(order.numel(), device=rows.device) \
            - grp_start[gid]
        F[col_sorted, first] = s_cols[order]
    return F


def em_patches(A: CsrMatrix, cf_map):
    """The EM interpolator's batch: (A_FF (nc, k, k), rhs (nc, k), F (nc,
    k) the patches' fine rows with -1 padding, cidx the coarse id of each
    row, c_rows the fine row of each coarse point). Padding rows of A_FF
    are identity rows and their right-hand sides 0."""
    n = A.num_rows
    dev = A.device
    rows, cols, vals = A.coo()
    cols = cols.long()
    is_C = torch.as_tensor(cf_map, device=dev) == 1
    cidx = torch.cumsum(is_C.long(), 0) - 1              # coarse ids
    c_rows = torch.nonzero(is_C)[:, 0]                   # fine index
    F = _column_patches(rows, cols, is_C, cidx, c_rows)
    mask = F >= 0
    Fsafe = torch.where(mask, F, c_rows[:, None])
    # A[r, c] (0 where absent) by a search over the sorted (r, c) keys
    skeys, korder = torch.sort(rows * n + cols)
    svals = vals[korder]
    top = max(skeys.numel() - 1, 0)

    def lookup(r, c):
        k = r * n + c
        pos = torch.searchsorted(skeys, k).clamp_(0, top)
        return torch.where(skeys[pos] == k, svals[pos],
                           torch.zeros((), dtype=vals.dtype, device=dev))

    A_FF = lookup(Fsafe[:, :, None], Fsafe[:, None, :])
    rhs = lookup(Fsafe, c_rows[:, None])
    m2 = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(F.shape[1], dtype=vals.dtype, device=dev)[None]
    A_FF = torch.where(m2, A_FF, eye)
    rhs = torch.where(mask, rhs, torch.zeros_like(rhs))
    return A_FF, rhs, F, cidx, c_rows


@registry.energymin_interpolators.register("EM")
class EMInterpolator(EnergyminInterpolator):
    """Batched local energy-minimization interpolation (em.cu)."""

    def generate(self, A: CsrMatrix, cf_map, strong) -> CsrMatrix:
        n = A.num_rows
        dev = A.device
        vals = A.values
        A_FF, rhs, F, cidx, c_rows = em_patches(A, cf_map)
        nc = c_rows.numel()
        mask = F >= 0
        pF = -solve_qr(A_FF, rhs)
        pF = torch.where(torch.isfinite(pF), pF, torch.zeros_like(pF))
        # P: injection on the C rows, the patch values on the F rows
        ccol = cidx[c_rows]
        pr = torch.cat([c_rows, F[mask]])
        pc = torch.cat([ccol, torch.repeat_interleave(ccol, mask.sum(1))])
        pv = torch.cat([torch.ones(nc, dtype=vals.dtype, device=dev),
                        pF[mask]])
        # preserve constants where several columns cover a row: the row
        # sums added in the order of the entries (np.add.at's)
        order = torch.argsort(pr, stable=True)
        rowsum = ordered_segment_sum(pv[order],
                                     starts_from_ids(pr[order], n))
        one = torch.ones_like(rowsum)
        scale = torch.where(rowsum.abs() > 1e-12, 1.0 / torch.where(
            rowsum == 0, one, rowsum), one)
        return CsrMatrix.from_coo(pr, pc, pv * scale[pr], n, nc)


@registry.amg_levels.register("ENERGYMIN")
class EnergyminAMGLevel(ClassicalAMGLevel):
    """Energymin_AMG_Level: the classical flow with the energymin
    selector (default CR) and interpolator (EM) registries
    (energymin_amg_level.cu:62-90). Structure reuse, snapshots and the
    weighted transfers are the classical level's."""

    algorithm = "ENERGYMIN"
    selector_param = "energymin_selector"
    selector_fallback = "CR"
    interpolator_registry = registry.energymin_interpolators
    interpolator_param = "energymin_interpolator"
    interpolator_fallback = "EM"
