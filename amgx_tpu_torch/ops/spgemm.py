"""Sparse matrix products and the Galerkin triple product (the port of
amgx_tpu/ops/spgemm.py), on the operands' device.

The sort-based expand/coalesce formulation of the JAX package: every
(i, k, a) of A pairs with every (k, j, b) of row k of B, the candidates
are sorted by (i, j) with a stable sort, and each run of equal
coordinates is added left to right (ops/segment.py). `csr_multiply` and
`galerkin_rap` (R A P as two products) are the eager route that
`spgemm_plan=0` takes.

The plan split (`spgemm_plan` auto/1): `build_rap_plan` runs the
STRUCTURE phase of R A P once per pattern -- stage 1 expands and
coalesces T = A P, stage 2 C = R T -- and keeps the gather indices (sa,
sp, sr, st), the segment boundaries (starts1, starts2) and the output
CSR pattern. It runs on the operands' device with stable torch sorts,
and its arrays equal those of the JAX package's numpy `build_rap_plan`.
The VALUE phase (`rap_values`) recomputes the numerics through those
indices: float32 through B10 (`ops/cuda_rap.py`; its plain twin on the
CPU), every other dtype through the plain ordered segment sums. Both
add each segment left to right, so a plan gives the same bits on the
CPU and on the card (the eager route associates R A P as (R A) P and
rounds differently). Each classical level keeps its plan (`rap_plan`);
the JAX package's digest-keyed cross-setup cache and the relabel
(aggregation) plan are not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..matrix import CsrMatrix
from . import cuda_rap
from .segment import coalesce, ordered_segment_sum


def expand(a_ro, a_ci, b_ro, b_ci):
    """Candidate coordinates of A B from the two patterns: (rows, cols,
    src_a, src_b), int64, in (A entry, B row position) order."""
    a_ro, b_ro = a_ro.long(), b_ro.long()
    dev = a_ci.device
    a_rows = torch.repeat_interleave(
        torch.arange(a_ro.numel() - 1, device=dev), torch.diff(a_ro),
        output_size=a_ci.numel())
    a_ci = a_ci.long()
    counts = torch.diff(b_ro)[a_ci]
    total = int(counts.sum())
    src_a = torch.repeat_interleave(
        torch.arange(a_ci.numel(), device=dev), counts, output_size=total)
    cum = torch.zeros(a_ci.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=cum[1:])
    src_b = b_ro[a_ci[src_a]] + (torch.arange(total, device=dev)
                                 - cum[src_a])
    return a_rows[src_a], b_ci[src_b].long(), src_a, src_b


def csr_multiply(A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """C = A B."""
    assert A.num_cols == B.num_rows, (A.num_cols, B.num_rows)
    rows, cols, src_a, src_b = expand(A.row_offsets, A.col_indices,
                                      B.row_offsets, B.col_indices)
    prods = A.values[src_a] * B.values[src_b]
    order, starts, rows_u, cols_u = coalesce(rows, cols, B.num_cols)
    return CsrMatrix.from_rows(rows_u, cols_u,
                               ordered_segment_sum(prods[order], starts),
                               A.num_rows, B.num_cols)


def galerkin_rap(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix) -> CsrMatrix:
    """A_c = (R A) P, the eager composition."""
    return csr_multiply(csr_multiply(R, A), P)


def plan_enabled(cfg, scope) -> bool:
    """`spgemm_plan`: '0' takes the eager composition, 'auto'/'1' the
    plan split."""
    return str(cfg.get("spgemm_plan", scope)) != "0"


@dataclasses.dataclass
class RapPlan:
    """The structure of one Galerkin product R A P: stage 1 (T = A P)
    candidate gathers `sa`/`sp` into A's and P's values in coalesced
    order with run boundaries `starts1` (nT + 1); stage 2 (C = R T)
    gathers `sr`/`st` into R's values and T with `starts2` (nU + 1); the
    output CSR pattern. Index arrays are int32 on the operands' device."""
    sa: torch.Tensor
    sp: torch.Tensor
    starts1: torch.Tensor
    sr: torch.Tensor
    st: torch.Tensor
    starts2: torch.Tensor
    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    num_rows: int
    num_cols: int

    @property
    def nT(self) -> int:
        return self.starts1.numel() - 1

    @property
    def nU(self) -> int:
        return self.starts2.numel() - 1

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.sa, self.sp, self.starts1, self.sr, self.st, self.starts2,
            self.row_offsets, self.col_indices))


def _i32(t):
    if t.numel() and int(t.max()) > torch.iinfo(torch.int32).max:
        raise ValueError("RAP plan index exceeds int32")
    return t.to(torch.int32)


def build_rap_plan(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix) -> RapPlan:
    """Structure phase of R A P on the operands' device."""
    t_rows, t_cols, s1a, s1p = expand(A.row_offsets, A.col_indices,
                                      P.row_offsets, P.col_indices)
    order1, starts1, tr, tc = coalesce(t_rows, t_cols, P.num_cols)
    sa, sp = s1a[order1], s1p[order1]
    del t_rows, t_cols, s1a, s1p, order1
    t_ro = torch.zeros(A.num_rows + 1, dtype=torch.int64, device=A.device)
    torch.cumsum(torch.bincount(tr, minlength=A.num_rows), 0, out=t_ro[1:])
    c_rows, c_cols, s2r, s2t = expand(R.row_offsets, R.col_indices, t_ro,
                                      tc)
    order2, starts2, cr, cc = coalesce(c_rows, c_cols, P.num_cols)
    sr, st = s2r[order2], s2t[order2]
    ro = torch.zeros(R.num_rows + 1, dtype=torch.int32, device=A.device)
    torch.cumsum(torch.bincount(cr, minlength=R.num_rows), 0, out=ro[1:])
    return RapPlan(sa=_i32(sa), sp=_i32(sp), starts1=_i32(starts1),
                   sr=_i32(sr), st=_i32(st), starts2=_i32(starts2),
                   row_offsets=ro, col_indices=cc.to(torch.int32),
                   num_rows=R.num_rows, num_cols=P.num_cols)


def rap_values(plan: RapPlan, a, r, p) -> torch.Tensor:
    """The coarse values through the plan: B10 for float32 (its plain
    twin on the CPU), the plain ordered segment sums otherwise -- the
    JAX package routes only float32 to its kernel (`rap_kernel_ready`)."""
    if a.dtype == torch.float32 and r.dtype == p.dtype == torch.float32:
        return cuda_rap.rap_values(plan, a, r, p)
    return cuda_rap.rap_values_plain(plan, a, r, p)


def planned_rap(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix):
    """(coarse matrix, plan): the structure phase, then the value phase
    on the plan's output pattern."""
    plan = build_rap_plan(R, A, P)
    vals = rap_values(plan, A.values, R.values, P.values).to(A.dtype)
    return CsrMatrix(row_offsets=plan.row_offsets,
                     col_indices=plan.col_indices, values=vals,
                     num_rows=plan.num_rows, num_cols=plan.num_cols), plan
