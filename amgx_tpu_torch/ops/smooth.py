"""Fused smoother + grid-transfer dispatch for the V-cycle (the port of
amgx_tpu/ops/smooth.py).

The damped-relaxation smoother family

    x_{s+1} = x_s + (tau_s * (b - A x_s)) * dinv        (dinv optional)

runs through the DIA kernels of `cuda_spmv` on float32 DIA levels:
B2 (steps + trailing residual), B3 (steps + restriction epilogue) and
B4 (prolongation prologue + steps). `fused_smooth` takes DIA first, then
the unstructured route of a float32 CSR level (classical coarse
operators): one B9 launch per sweep (`cuda_csr.csr_smooth`) and the
trailing residual through B8, as the JAX package's `swell_fused_smooth`
does. Every entry returns None when no kernel takes the level; the
calling smoother then composes its unfused sweeps, exactly as the JAX
package does off its fused path (f64 hierarchies, `fused_smoother=0`).

On CPU tensors the kernels' plain twins run, so the CPU and the card
take the same route. `coarse_tail_cycle` runs the whole sub-cycle below
an entry level through B5 (ops/cuda_tail.py) with the JAX package's
eligibility rules.

Transfer tables (the JAX package's `build_transfer_slabs`, without the
TPU's quota padding and VMEM window bases): `ctab` (m, nc) int32, the
fine rows of each coarse row in ascending order, -1 where absent; `agg`
(n,) int32, the coarse row of each fine row. Classical levels carry the
weighted form (`build_csr_transfer_tables`): `ctab`/`cwt` (m, nc) for
R's rows and `ptab`/`pwt` (mp, n) for P's rows.
"""
from __future__ import annotations

import torch

from . import cuda_csr, cuda_spmv, cuda_tail

# the JAX package's child caps (amgx_tpu/ops/pallas_spmv.py), kept so the
# same levels fuse in both packages: R rows of at most
# CSR_TRANSFER_MAX_CHILD entries, P rows of at most TRANSFER_MAX_CHILD
CSR_TRANSFER_MAX_CHILD = 32
TRANSFER_MAX_CHILD = 16


def kernel_ok(A, x) -> bool:
    """Would the smoother kernels take this level and vector?"""
    return (getattr(A, "dia_vals", None) is not None
            and A.num_rows == A.num_cols
            and A.dia_vals.dtype == torch.float32
            and x.dtype == torch.float32)


def build_transfer_tables(agg: torch.Tensor, nc: int) -> dict:
    """{"ctab": (m, nc) int32 children table, "agg": (n,) int32} from an
    aggregates map, on agg's device."""
    agg = agg.to(torch.int64)
    n = agg.shape[0]
    order = torch.argsort(agg, stable=True)
    counts = torch.bincount(agg, minlength=nc)
    m = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=agg.device) - starts[agg[order]]
    ctab = torch.full((m, nc), -1, dtype=torch.int32, device=agg.device)
    ctab[pos, agg[order]] = order.to(torch.int32)
    return {"ctab": ctab, "agg": agg.to(torch.int32)}


def _rows_table(ro, ci, vals, num_rows, width):
    """(width, num_rows) tables of each CSR row's columns (-1 past its
    end) and values (0 there), entry j of row i at [j, i]."""
    counts = torch.diff(ro.long())
    rows = torch.repeat_interleave(torch.arange(num_rows, device=ci.device),
                                   counts, output_size=ci.shape[0])
    j = torch.arange(ci.shape[0], device=ci.device) - ro.long()[rows]
    tab = torch.full((width, num_rows), -1, dtype=torch.int32,
                     device=ci.device)
    wt = torch.zeros((width, num_rows), dtype=vals.dtype, device=ci.device)
    tab[j, rows] = ci.to(torch.int32)
    wt[j, rows] = vals
    return tab, wt


def build_csr_transfer_tables(A, P, R):
    """The weighted transfer tables of a classical level (the JAX
    package's `build_csr_transfer_slabs` on the port's layout): `ctab` /
    `cwt` (m, nc), entry j of R's row c; `ptab` / `pwt` (mp, n), entry j
    of P's row i. None when A has no square DIA view or a row outgrows
    the caps (m <= CSR_TRANSFER_MAX_CHILD, mp <= TRANSFER_MAX_CHILD), as
    in the JAX package; the cycle then composes the R / P products."""
    if getattr(A, "dia_vals", None) is None or A.num_rows != A.num_cols:
        return None
    n, nc = A.num_rows, P.num_cols
    if P.num_rows != n or nc < 1 or R.num_rows != nc or R.num_cols != n:
        return None
    m = int(torch.diff(R.row_offsets.long()).max())
    mp = int(torch.diff(P.row_offsets.long()).max())
    if not (1 <= m <= CSR_TRANSFER_MAX_CHILD
            and 1 <= mp <= TRANSFER_MAX_CHILD):
        return None
    ctab, cwt = _rows_table(R.row_offsets, R.col_indices, R.values, nc, m)
    ptab, pwt = _rows_table(P.row_offsets, P.col_indices, P.values, n, mp)
    return {"ctab": ctab, "cwt": cwt, "ptab": ptab, "pwt": pwt}


def fused_smooth(data, b, x, taus, dinv=None, with_residual=True):
    """x' (and r = b - A x' when `with_residual`) after len(taus) damped
    steps through B2 on a DIA level, or through B9 sweeps and a B8
    residual on a float32 CSR level; None when no kernel applies."""
    A = data["A"]
    if taus.shape[0] < 1:
        return None
    if kernel_ok(A, x):
        return cuda_spmv.dia_smooth(A.dia_vals, A.dia_offsets,
                                    taus.to(x.dtype), b, x, dinv,
                                    with_residual)
    if getattr(A, "dia_vals", None) is not None or A.num_rows != A.num_cols \
            or A.values.dtype != torch.float32 or x.dtype != torch.float32:
        return None
    x = cuda_csr.csr_smooth(A.row_offsets, A.col_indices, A.values,
                            taus.to(x.dtype), b, x, dinv,
                            lanes=A.csr_lanes or 1)
    if not with_residual:
        return x
    from .spmv import residual
    return x, residual(A, x, b)


def fused_smooth_restrict(data, b, x, taus, xfer, dinv=None):
    """(x', bc) with bc = R (b - A x') after len(taus) damped steps
    through B3, or None (the caller composes smooth_residual +
    restrict)."""
    A = data["A"]
    if xfer is None or not kernel_ok(A, x) or taus.shape[0] < 1:
        return None
    return cuda_spmv.dia_smooth_restrict(A.dia_vals, A.dia_offsets,
                                         taus.to(x.dtype), b, x,
                                         xfer["ctab"], dinv,
                                         weights=xfer.get("cwt"))


def fused_corr_smooth(data, b, x, xc, taus, xfer, dinv=None,
                      want_dot=False):
    """x' after len(taus) damped steps from x + P xc through B4, or
    None (the caller composes prolongate + smooth). `want_dot` returns
    (x', x'.b) with the dot from the last step's launch (PCG's r.z: the
    cycle's rhs is r and its output z)."""
    A = data["A"]
    if xfer is None or not kernel_ok(A, x) or taus.shape[0] < 1:
        return None
    return cuda_spmv.dia_prolong_smooth(A.dia_vals, A.dia_offsets,
                                        taus.to(x.dtype), b, x, xc,
                                        xfer.get("agg"), dinv,
                                        with_dot=want_dot,
                                        ptab=xfer.get("ptab"),
                                        pwt=xfer.get("pwt"))


# ---------------------------------------------------------------------------
# the coarse tail (B5)
# ---------------------------------------------------------------------------


def _tail_plan(amg, shape, data, lvl, x):
    """(spec, arrs) of the tail entered at level `lvl`, or None when it
    is not eligible."""
    levels = amg.levels
    specs, arrs = [], []
    for i in range(lvl, len(levels)):
        ld = data["levels"][i]
        xfer, smd = ld.get("xfer"), ld.get("smoother")
        spec_fn = getattr(levels[i].smoother, "fused_tail_spec", None)
        # weighted (classical) tables decline: B5's transfers are
        # unit-weight, as the JAX package's tail
        if xfer is None or "cwt" in xfer or smd is None or spec_fn is None \
                or not kernel_ok(ld["A"], x):
            return None
        pre = spec_fn(smd, amg._sweeps(i, pre=True), x.dtype)
        post = spec_fn(smd, amg._sweeps(i, pre=False), x.dtype)
        if pre is None or post is None:
            return None
        A = ld["A"]
        m, nc = xfer["ctab"].shape
        specs.append(cuda_tail.TailLevelSpec(
            offsets=tuple(A.dia_offsets), n=A.num_rows,
            n_pre=int(pre[0].shape[0]), n_post=int(post[0].shape[0]),
            has_dinv=pre[1] is not None, nc=int(nc), m=int(m)))
        arrs.append({"vals": A.dia_vals, "dinv": pre[1],
                     "taus_pre": pre[0].contiguous(),
                     "taus_post": post[0].contiguous(),
                     "ctab": xfer["ctab"], "agg": xfer["agg"]})
    cd = data["coarse"]
    nz = specs[-1].nc
    if amg.coarse_solver.name in ("NOSOLVER", "DUMMY"):
        coarse = ("none", nz)
    elif "inv" in cd and tuple(cd["inv"].shape) == (nz, nz) \
            and cd["inv"].dtype == torch.float32:
        arrs.append({"inv": cd["inv"]})
        coarse = ("inv", nz)
    else:
        return None
    return cuda_tail.TailSpec(shape, tuple(specs), coarse), tuple(arrs)


def coarse_tail_cycle(amg, shape, data, lvl, b, x, want_dot=False):
    """Run the whole sub-cycle at levels >= lvl as ONE B5 launch, or
    return None when the tail is not eligible (the caller recurses per
    level). Eligible, as in the JAX package: a fixed cycle shape; a
    float32 vector; every level from lvl down a float32 DIA level with
    transfer tables and a smoother that has `fused_tail_spec`; the coarse
    solver NOSOLVER/DUMMY or holding a float32 `inv`; the entry level at
    most cycle_fusion_tail_rows rows. The JAX package also declines when
    the tail outgrows the TPU's VMEM budget; the Hopper kernel keeps its
    levels in device memory and has no such cap (for the 7-pt operator at
    the default threshold the cap never binds, so both enter the tail at
    the same level). `want_dot` returns (x', x'.b).

    The plan (spec and arrays, the tiled damping schedules) is built once
    per (entry level, shape, dtype) and cached on the hierarchy; B5's card
    tables and workspace are cached beside it (ops/cuda_tail.py)."""
    levels = amg.levels
    if shape not in ("V", "W", "F") or x.dtype != torch.float32 \
            or lvl >= len(levels) \
            or levels[lvl].A.num_rows > amg.cycle_fusion_tail_rows:
        return None
    key = (shape, lvl, x.dtype, x.device)
    sources = tuple(ld["A"] for ld in data["levels"][lvl:]) + (
        data["coarse"].get("inv"),)
    hit = amg._tail_plans.get(key)
    if hit is None or any(a is not b_ for a, b_ in zip(hit[0], sources)):
        hit = amg._tail_plans[key] = (sources, _tail_plan(amg, shape, data,
                                                          lvl, x))
    if hit[1] is None:
        return None
    spec, arrs = hit[1]
    return cuda_tail.dia_coarse_tail(spec, arrs, b, x, with_dot=want_dot)
