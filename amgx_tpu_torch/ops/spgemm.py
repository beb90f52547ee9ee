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
rounds differently). Each classical level keeps its plan (`rap_plan`).

The relabel plan (`build_agg_plan`, kind "agg" in the JAX package): the
Galerkin product of unsmoothed aggregation, A_c[I, J] = sum of A[i, j]
over agg[i] = I, agg[j] = J, needs no multiply. Its structure phase
relabels A's entries (with an external diagonal folded in, when given)
by aggregate id and keeps their stable (I, J) sort `st` with the run
boundaries `starts2` and the coarse CSR pattern; its value phase
(`agg_values`) is one gather and one ordered segment sum per run: B10's
relabel form in float32 (`cuda_rap.rap_values_relabel`), the plain sum
otherwise. The aggregation level memoizes its plan, so a structure-reuse
resetup reruns only the value phase. `spgemm_plan=0` (the JAX package's
eager `coarse_a_from_aggregates`) takes the planned product here too.

The cross-setup plan cache (`get_rap_plan`, `get_agg_plan`; the JAX
package's digest-keyed `_PLAN_CACHE`): a warm setup of a pattern seen
before, or a resetup on new pattern tensors of the same content, builds
no plan. An entry is keyed on the pattern's content: a fingerprint
computed on the patterns' device (two int64 sums a tensor, one host
read) finds it, and `_same_content` then holds the tensors the entry
keeps against the new ones, so a same-size pattern of other content
(a permutation) is never served a stale plan. The cache is LRU and
bounded in bytes (plans and kept patterns, PLAN_CACHE_MAX_BYTES).
`PLAN_COUNTS` counts its builds and hits, and the GEO plan cache's
(amg/aggregation/galerkin.py), beside the kernel launch counts.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from ..matrix import CsrMatrix
from ..telemetry import metrics as _tm
from . import cuda_rap
from .segment import coalesce, ordered_segment_sum

_INT32_MAX = torch.iinfo(torch.int32).max


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
    if t.numel() and int(t.max()) > _INT32_MAX:
        raise ValueError("RAP plan index exceeds int32")
    return t.to(torch.int32)


def _csr_offsets(rows_u, num_rows, device):
    ro = torch.zeros(num_rows + 1, dtype=torch.int32, device=device)
    torch.cumsum(torch.bincount(rows_u, minlength=num_rows), 0, out=ro[1:])
    return ro


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
    return RapPlan(sa=_i32(sa), sp=_i32(sp), starts1=_i32(starts1),
                   sr=_i32(sr), st=_i32(st), starts2=_i32(starts2),
                   row_offsets=_csr_offsets(cr, R.num_rows, A.device),
                   col_indices=cc.to(torch.int32),
                   num_rows=R.num_rows, num_cols=P.num_cols)


def rap_values(plan: RapPlan, a, r, p) -> torch.Tensor:
    """The coarse values through the plan: B10 for float32 (its plain
    twin on the CPU), the plain ordered segment sums otherwise -- the
    JAX package routes only float32 to its kernel (`rap_kernel_ready`)."""
    if a.dtype == torch.float32 and r.dtype == p.dtype == torch.float32:
        return cuda_rap.rap_values(plan, a, r, p)
    return cuda_rap.rap_values_plain(plan, a, r, p)


def rap_coarse_matrix(plan: RapPlan, A: CsrMatrix, R: CsrMatrix,
                      P: CsrMatrix) -> CsrMatrix:
    """The coarse operator of a RAP plan: the value phase on the plan's
    output pattern."""
    vals = rap_values(plan, A.values, R.values, P.values).to(A.dtype)
    return CsrMatrix(row_offsets=plan.row_offsets,
                     col_indices=plan.col_indices, values=vals,
                     num_rows=plan.num_rows, num_cols=plan.num_cols)


def planned_rap(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix):
    """(coarse matrix, plan): the structure phase (or the cached plan of
    the same patterns), then the value phase."""
    plan = get_rap_plan(R, A, P)
    return rap_coarse_matrix(plan, A, R, P), plan


# -- the cross-setup plan cache ----------------------------------------------

_PLAN_CACHE = collections.OrderedDict()   # key -> (patterns, plan), LRU
PLAN_CACHE_MAX_BYTES = 4 << 30
PLAN_COUNTS = {"rap_build": 0, "rap_hit": 0, "agg_build": 0, "agg_hit": 0,
               "geo_build": 0, "geo_hit": 0}


def clear_plan_cache():
    """Drop every cached plan (RAP, relabel and GEO): a measurement's
    device memory then holds only the live hierarchies'."""
    from ..amg.aggregation.galerkin import _GEO_PLAN_CACHE
    _PLAN_CACHE.clear()
    _GEO_PLAN_CACHE.clear()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _fingerprint(tensors) -> tuple:
    """Two int64 sums a tensor (of its entries, and of its entries times
    their position + 1; wrapping), on its device, read in one go."""
    parts = []
    for t in tensors:
        v = t.reshape(-1).long()
        parts.append(v.sum())
        parts.append((v * torch.arange(1, v.numel() + 1, device=v.device)
                      ).sum())
    return tuple(torch.stack(parts).tolist())


def _same_content(kept, new) -> bool:
    """Every tensor of `new` equals its counterpart in `kept` (one host
    read for all of them)."""
    if any(a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
           for a, b in zip(kept, new)):
        return False
    eq = [(a == b).all() for a, b in zip(kept, new) if a is not b]
    return not eq or bool(torch.stack(eq).all())


def _cached_plan(kind: str, meta: tuple, patterns: tuple, build):
    """The plan of `patterns` (plus `meta`) from the cache, else
    `build()` stored there."""
    key = (kind, meta, str(patterns[0].device), _fingerprint(patterns))
    hit = _PLAN_CACHE.get(key)
    if hit is not None and _same_content(hit[0], patterns):
        _PLAN_CACHE.move_to_end(key)
        PLAN_COUNTS[kind + "_hit"] += 1
        _tm.inc("amg.spgemm.plan_hit")
        return hit[1]
    plan = build()
    PLAN_COUNTS[kind + "_build"] += 1
    _tm.inc("amg.spgemm.plan_build")
    _PLAN_CACHE[key] = (patterns, plan)
    _PLAN_CACHE.move_to_end(key)
    total = 0
    for k in reversed(list(_PLAN_CACHE)):
        kept, p = _PLAN_CACHE[k]
        total += p.nbytes() + sum(_nbytes(t) for t in kept)
        if total > PLAN_CACHE_MAX_BYTES and k != key:
            del _PLAN_CACHE[k]
    return plan


def get_rap_plan(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix) -> RapPlan:
    """The RAP plan of (R, A, P)'s patterns, built or from the cache."""
    return _cached_plan(
        "rap", (R.num_rows, A.num_rows, A.num_cols, P.num_cols),
        (R.row_offsets, R.col_indices, A.row_offsets, A.col_indices,
         P.row_offsets, P.col_indices),
        lambda: build_rap_plan(R, A, P))


def get_agg_plan(A: CsrMatrix, agg: torch.Tensor, nc: int,
                 fold_diag: bool = False) -> "AggPlan":
    """The relabel plan of (A's pattern, aggregates), built or from the
    cache."""
    agg = agg.to(A.device)
    return _cached_plan(
        "agg", (A.num_rows, A.num_cols, int(nc), bool(fold_diag)),
        (A.row_offsets, A.col_indices, agg),
        lambda: build_agg_plan(A, agg, nc, fold_diag))


# -- the relabel (aggregation) Galerkin ------------------------------------


@dataclasses.dataclass
class AggPlan:
    """The structure of one relabel Galerkin product: `st` gathers A's
    values (the external diagonal appended when `fold_diag`) in the
    stable (agg[i], agg[j]) order, `starts2` (nU + 1) bounds each coarse
    entry's run, and the coarse CSR pattern. int32 on A's device."""
    st: torch.Tensor
    starts2: torch.Tensor
    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    num_rows: int
    num_cols: int
    fold_diag: bool = False

    @property
    def nU(self) -> int:
        return self.starts2.numel() - 1

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.st, self.starts2, self.row_offsets, self.col_indices))


def build_agg_plan(A: CsrMatrix, agg: torch.Tensor, nc: int,
                   fold_diag: bool = False) -> AggPlan:
    """Structure phase of the relabel Galerkin on A's device: A's
    entries (then, with `fold_diag`, one diagonal entry per row) relabeled
    by aggregate id and stably sorted by (row, col), as the JAX package's
    `build_agg_plan` lexsorts them."""
    aggv = agg.to(device=A.device, dtype=torch.int64)
    rows = aggv[A.row_ids()]
    cols = aggv[A.col_indices.long()]
    if fold_diag:
        rows = torch.cat([rows, aggv])
        cols = torch.cat([cols, aggv])
    if rows.numel() >= _INT32_MAX:
        raise ValueError("relabel plan: candidates exceed int32")
    order, starts, rows_u, cols_u = coalesce(rows, cols, int(nc))
    return AggPlan(st=_i32(order), starts2=_i32(starts),
                   row_offsets=_csr_offsets(rows_u, int(nc), A.device),
                   col_indices=cols_u.to(torch.int32), num_rows=int(nc),
                   num_cols=int(nc), fold_diag=fold_diag)


def fold_values(plan: AggPlan, values, diag=None):
    """The value vector the plan gathers from: A's values, with the
    external diagonal appended when the plan folds it (the JAX package's
    `_fold_values`)."""
    if not plan.fold_diag:
        return values
    if diag is None:
        raise ValueError("relabel plan folds an external diagonal; none "
                         "was given")
    return torch.cat([values, diag.to(values.dtype)])


def agg_values(plan: AggPlan, values, diag=None) -> torch.Tensor:
    """The coarse values through the relabel plan: B10's relabel form
    for float32 (its plain twin on the CPU), the plain ordered segment
    sum otherwise."""
    af = fold_values(plan, values, diag)
    if af.dtype == torch.float32:
        return cuda_rap.rap_values_relabel(plan, af)
    return cuda_rap.rap_values_relabel_plain(plan, af)


def plan_coarse_matrix(plan: AggPlan, A: CsrMatrix, diag=None) -> CsrMatrix:
    """The coarse operator of a relabel plan: the value phase on the
    plan's pattern, a plain CSR (the hierarchy's `init()` picks its
    layout, as the JAX package's `build_spmv_layout` does)."""
    return CsrMatrix(row_offsets=plan.row_offsets,
                     col_indices=plan.col_indices,
                     values=agg_values(plan, A.values, diag).to(A.dtype),
                     num_rows=plan.num_rows, num_cols=plan.num_cols)


def csr_add(A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """C = A + B: the two entry lists concatenated, then coalesced (a
    stable (row, col) sort, equal coordinates added in order)."""
    assert (A.num_rows, A.num_cols) == (B.num_rows, B.num_cols)
    ar, ac, av = A.coo()
    br, bc, bv = B.coo()
    return CsrMatrix.from_coo(torch.cat([ar, br]),
                              torch.cat([ac.long(), bc.long()]),
                              torch.cat([av, bv.to(av.dtype)]),
                              A.num_rows, A.num_cols)
