"""Fused smoother + grid-transfer dispatch for the V-cycle (the port of
amgx_tpu/ops/smooth.py).

The damped-relaxation smoother family

    x_{s+1} = x_s + (tau_s * (b - A x_s)) * dinv        (dinv optional)

runs through the DIA kernels of `cuda_spmv` on float32 and bfloat16 DIA
levels: B2 (steps + trailing residual), B3 (steps + restriction
epilogue) and B4 (prolongation prologue + steps), with a classical
level's weighted transfer rows (B3w / B4w) in either dtype. B3 and B4
hand the kernels the level's grid shape: on a 7-point star level they
run temporally blocked (ops/cuda_spmv.py `slab_grid`). The damping
factors go to the kernels in the compute dtype
(`precision.compute_dtype`: float32 for bf16 operands). `fused_smooth`
takes DIA first, then the unstructured route of a float32 or bfloat16
CSR level (aggregation and classical coarse operators): one B9 launch
per sweep (`cuda_csr.csr_smooth`; in bf16 each sweep's x' rounded to
bf16, as the JAX package's `swell_smooth_step`) and the trailing
residual through B8 (in bf16 A x rounded once, then b - y), as
the JAX package's `swell_fused_smooth` does. Every entry returns None
when no kernel takes the level; the calling smoother then composes its
unfused sweeps, exactly as the JAX package does off its fused path (f64
hierarchies, `fused_smoother=0`).

On CPU tensors the kernels' plain twins run, so the CPU and the card
take the same route. The JAX package sends a bf16 CSR level to its
sweep kernel only where the level's SWELL layout fits its VMEM budget
and composes per-operation bf16 sweeps elsewhere; the port takes the
kernel's rounding on every such level.
`coarse_tail_cycle` runs the whole sub-cycle below an entry level through
B5 (ops/cuda_tail.py) with the JAX package's eligibility rules.

A matrix-free level (the hierarchy's `matrix_free` detector installed a
StencilOperator, solve data "stencil"; its A has no value slab) routes
every entry to ops/stencil.py: the coefficient-mode kernels B2-mf,
B3-mf, B4-mf, and B5's matrix-free levels.

A batch (x and b (B, n); the level's operator, dinv and stencil shared or
per system, amgx_tpu_torch/batch/) runs `fused_smooth` through the
batched kernels (ops/cuda_batched.py): K2 on a DIA level (K2's
coefficient mode on a matrix-free one), K4's sweeps and K3's residual
on a CSR level. The transfer-carrying entries and the coarse tail
decline (None) under a batch: the cycle composes the smoothing, the
residual and the transfers, as the JAX package's vmap rules
(`smooth_restrict_dia_multi`, `corr_smooth_dia_multi`) compute them.

Transfer tables (the JAX package's `build_transfer_slabs`, without the
TPU's quota padding and VMEM window bases): `ctab` (m, nc) int32, the
fine rows of each coarse row in ascending order, -1 where absent; `agg`
(n,) int32, the coarse row of each fine row. Classical levels carry the
weighted form (`build_csr_transfer_tables`): `ctab`/`cwt` (m, nc) for
R's rows and `ptab`/`pwt` (mp, n) for P's rows, and R's compact rows
`rro`/`rci`/`rwt` (row offsets, columns, values: ctab / cwt's entries in
the same order), over which B3w restricts on the card.
"""
from __future__ import annotations

import torch

from ..precision import SMOOTH_DTYPES, compute_dtype
from . import cuda_batched, cuda_csr, cuda_spmv, cuda_tail
from . import stencil as mf

# the JAX package's child caps (amgx_tpu/ops/pallas_spmv.py), kept so the
# same levels fuse in both packages: R rows of at most
# CSR_TRANSFER_MAX_CHILD entries, P rows of at most TRANSFER_MAX_CHILD
CSR_TRANSFER_MAX_CHILD = 32
TRANSFER_MAX_CHILD = 16


def kernel_ok(A, x) -> bool:
    """Would the smoother kernels take this level and vector? A DIA slab
    of the vector's dtype, float32 or bfloat16 (the JAX package's
    `smooth_dtype_ok`)."""
    return (getattr(A, "dia_vals", None) is not None
            and A.num_rows == A.num_cols
            and A.dia_vals.dtype == x.dtype
            and x.dtype in SMOOTH_DTYPES)


def children_table(agg: torch.Tensor, nc: int) -> torch.Tensor:
    """(m, nc) int32 table of each aggregate's fine rows in ascending
    order, -1 where absent (m: the largest aggregate), on agg's device."""
    agg = agg.to(torch.int64)
    n = agg.shape[0]
    order = torch.argsort(agg, stable=True)
    counts = torch.bincount(agg, minlength=nc)
    m = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=agg.device) - starts[agg[order]]
    ctab = torch.full((m, nc), -1, dtype=torch.int32, device=agg.device)
    ctab[pos, agg[order]] = order.to(torch.int32)
    return ctab


def restrict_children(ctab: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """bc[c] = 0 + r[first child] + r[second child] + ...: the
    piecewise-constant restriction through a children table, each coarse
    row's children added in ascending fine index (the order of a
    sequential scatter-add, `index_add_` on the CPU), the same bits on
    the CPU and on the card, run after run. `ctab` is int64 with the
    fine size n where a child is absent (`children_index`): one gather
    of the whole table from r with a 0 appended, then one add per row.
    A batch r (B, n) gives (B, nc), row by row the same sums."""
    g = torch.cat([r, r.new_zeros(r.shape[:-1] + (1,))], -1)[..., ctab]
    out = torch.zeros(r.shape[:-1] + (ctab.shape[1],), dtype=r.dtype,
                      device=r.device)
    for j in range(ctab.shape[0]):
        out += g[..., j, :]
    return out


def children_index(ctab: torch.Tensor, n: int) -> torch.Tensor:
    """A children table as `restrict_children` reads it: int64, n where
    a child is absent."""
    ctab = ctab.long()
    return torch.where(ctab < 0, torch.full_like(ctab, n), ctab)


def build_transfer_tables(A, agg: torch.Tensor, nc: int):
    """{"ctab": (m, nc) int32 children table, "agg": (n,) int32} from an
    aggregates map, on agg's device; None (no fused B3/B4 transfers,
    the cycle composes them) when A has no DIA view or an aggregate has
    more than TRANSFER_MAX_CHILD children, as the JAX package's
    `build_transfer_slabs` declines."""
    if getattr(A, "dia_offsets", None) is None or nc < 1 \
            or agg.shape[0] != A.num_rows:
        return None
    ctab = children_table(agg, nc)
    if not 1 <= ctab.shape[0] <= TRANSFER_MAX_CHILD:
        return None
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
    of P's row i; `rro` / `rci` / `rwt`, R's own CSR arrays (its compact
    rows, which B3w's restriction walks; `rwt` is cast with `cwt` in a
    bf16 hierarchy). None when A has no square DIA view or a row outgrows
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
    return {"ctab": ctab, "cwt": cwt, "ptab": ptab, "pwt": pwt,
            **r_rows(R)}


def r_rows(R):
    """R's compact rows as B3w's restriction takes them (`rro`, `rci`,
    `rwt`): R's own CSR arrays, int32 structure."""
    return {"rro": R.row_offsets.to(torch.int32),
            "rci": R.col_indices.to(torch.int32), "rwt": R.values}


def fused_smooth(data, b, x, taus, dinv=None, with_residual=True):
    """x' (and r = b - A x' when `with_residual`) after len(taus) damped
    steps through B2 on a DIA level (B2-mf on a matrix-free one), or
    through B9 sweeps and a B8 residual on a float32 or bfloat16 CSR
    level; None when no kernel applies."""
    st = data.get("stencil")
    if st is not None:
        return mf.stencil_fused_smooth(st, taus, b, x, with_residual)
    A = data["A"]
    if taus.shape[0] < 1:
        return None
    batch = x.dim() == 2
    if kernel_ok(A, x):
        taus = taus.to(compute_dtype(x.dtype))
        if batch:
            return cuda_batched.dia_smooth_multi(
                A.dia_vals, A.dia_offsets, taus, b, x, dinv, with_residual)
        return cuda_spmv.dia_smooth(A.dia_vals, A.dia_offsets, taus, b, x,
                                    dinv, with_residual, grid=A.grid_shape)
    if getattr(A, "dia_vals", None) is not None or A.num_rows != A.num_cols \
            or A.values.dtype != x.dtype or x.dtype not in SMOOTH_DTYPES:
        return None
    sweep = cuda_batched.csr_smooth_multi if batch else cuda_csr.csr_smooth
    x = sweep(A.row_offsets, A.col_indices, A.values,
              taus.to(compute_dtype(x.dtype)), b, x, dinv,
              lanes=A.csr_lanes or 1)
    if not with_residual:
        return x
    from .spmv import residual
    return x, residual(A, x, b)


def fused_smooth_restrict(data, b, x, taus, xfer, dinv=None):
    """(x', bc) with bc = R (b - A x') after len(taus) damped steps
    through B3 (B3-mf on a matrix-free level), or None (the caller
    composes smooth_residual + restrict)."""
    if x.dim() == 2:
        return None
    st = data.get("stencil")
    if st is not None:
        return mf.stencil_smooth_restrict(st, taus, b, x, xfer)
    A = data["A"]
    if xfer is None or not kernel_ok(A, x) or taus.shape[0] < 1:
        return None
    rows = None if "rwt" not in xfer \
        else (xfer["rro"], xfer["rci"], xfer["rwt"])
    return cuda_spmv.dia_smooth_restrict(A.dia_vals, A.dia_offsets,
                                         taus.to(compute_dtype(x.dtype)), b,
                                         x,
                                         xfer["ctab"], dinv,
                                         weights=xfer.get("cwt"),
                                         grid=A.grid_shape, rows=rows)


def fused_corr_smooth(data, b, x, xc, taus, xfer, dinv=None,
                      want_dot=False):
    """x' after len(taus) damped steps from x + P xc through B4 (B4-mf on
    a matrix-free level), or None (the caller composes prolongate +
    smooth). `want_dot` returns (x', x'.b) with the dot from the last
    step's launch (PCG's r.z: the cycle's rhs is r and its output z)."""
    if x.dim() == 2:
        return None
    st = data.get("stencil")
    if st is not None:
        return mf.stencil_corr_smooth(st, taus, b, x, xc, xfer,
                                      want_dot=want_dot)
    A = data["A"]
    if xfer is None or not kernel_ok(A, x) or taus.shape[0] < 1:
        return None
    return cuda_spmv.dia_prolong_smooth(A.dia_vals, A.dia_offsets,
                                        taus.to(compute_dtype(x.dtype)), b,
                                        x, xc,
                                        xfer.get("agg"), dinv,
                                        with_dot=want_dot,
                                        ptab=xfer.get("ptab"),
                                        pwt=xfer.get("pwt"),
                                        grid=A.grid_shape)


# ---------------------------------------------------------------------------
# the coarse tail (B5)
# ---------------------------------------------------------------------------


def _tail_plan(amg, shape, data, lvl, x):
    """(spec, arrs) of the tail entered at level `lvl`, or None when it
    is not eligible. A matrix-free level enters with its coefficients in
    place of the value slab and no dinv (the kernel synthesizes it).
    Coefficients and damping factors are float32 (a bf16 level's values
    widened); slabs and dinv keep the level's dtype."""
    levels = amg.levels
    specs, arrs = [], []
    for i in range(lvl, len(levels)):
        ld = data["levels"][i]
        xfer, smd = ld.get("xfer"), ld.get("smoother")
        spec_fn = getattr(levels[i].smoother, "fused_tail_spec", None)
        st = None if smd is None else smd.get("stencil")
        # weighted (classical) tables decline: B5's transfers are
        # unit-weight, as the JAX package's tail
        if xfer is None or "cwt" in xfer or smd is None or spec_fn is None \
                or not (kernel_ok(ld["A"], x) if st is None
                        else x.dtype in SMOOTH_DTYPES):
            return None
        pre = spec_fn(smd, amg._sweeps(i, pre=True), torch.float32)
        post = spec_fn(smd, amg._sweeps(i, pre=False), torch.float32)
        if pre is None or post is None:
            return None
        A = ld["A"]
        m, nc = xfer["ctab"].shape
        specs.append(cuda_tail.TailLevelSpec(
            offsets=tuple(A.dia_offsets), n=A.num_rows,
            n_pre=int(pre[0].shape[0]), n_post=int(post[0].shape[0]),
            has_dinv=pre[1] is not None, nc=int(nc), m=int(m),
            mf=None if st is None else st.spec()))
        arrs.append({"vals": A.dia_vals, "dinv": pre[1],
                     "coeffs": None if st is None
                     else st.coeffs.to(torch.float32),
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
    spec = cuda_tail.TailSpec(shape, tuple(specs), coarse)
    # the kernel keeps the tail's vectors in one cluster's shared memory
    if not cuda_tail.tail_fits(spec):
        return None
    return spec, tuple(arrs)


def coarse_tail_cycle(amg, shape, data, lvl, b, x, want_dot=False):
    """Run the whole sub-cycle at levels >= lvl as ONE B5 launch, or
    return None when the tail is not eligible (the caller recurses per
    level). Eligible, as in the JAX package: a fixed cycle shape; a
    float32 or bfloat16 vector; every level from lvl down a DIA level of
    the vector's dtype with transfer tables and a smoother that has
    `fused_tail_spec`; the coarse solver NOSOLVER/DUMMY or holding a
    float32 `inv` (under bf16 too); the entry level at most
    cycle_fusion_tail_rows rows. A bf16 tail runs in float32 inside and
    rounds its result once. The JAX package also declines when
    the tail outgrows the TPU's VMEM budget; the port declines when the
    tail's vectors outgrow one thread-block cluster's shared memory
    (`cuda_tail.tail_fits`; for the 7-pt operator at the default
    threshold neither cap binds, so both enter the tail at the same
    level). `want_dot` returns (x', x'.b).

    The plan (spec and arrays, the tiled damping schedules) is built once
    per (entry level, shape, dtype) and cached on the hierarchy; B5's card
    tables are cached beside it (ops/cuda_tail.py)."""
    levels = amg.levels
    if shape not in ("V", "W", "F") or x.dtype not in SMOOTH_DTYPES \
            or x.dim() != 1 or lvl >= len(levels) \
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
