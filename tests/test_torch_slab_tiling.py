"""The temporally blocked slab smoothers B3 and B4 (csrc/stencil_tb.cu with
a stored value slab; ops/tiling.py `plan_calls`, `emulate_calls`;
ops/cuda_spmv.py `slab_route`) on the CPU.

The emulation computes what the launches of a slab call compute, block by
block, reading each row's values from the slab. On random per-row values
(a 7-point operator with a distinct value in every entry, zero where a
shift leaves the grid) it must give the untiled plain forms
(`dia_smooth_restrict_plain`, `dia_prolong_smooth_plain`: the CPU route
and the kernels' reference on the card) bit for bit, in float32 and
bfloat16, with and without dinv, in one launch and split over several
(each later launch reading the float32 state the one before left). On a
constant slab a row or plane indexing error would not show; here it
does. The dispatch sends the 7-point star on a grid whose slab is zero
off the grid to the tiled launches, SIZE_2 pair tables to the tiled steps
and the untiled restriction, and everything else to the per-step route.
One case is held to the JAX package's own slab forms, and the flagship on
a variable-coefficient operator (D A D) to the JAX package's iterations.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import batched
from amgx_tpu.ops import smooth as fused
from amgx_tpu.presets import FLAGSHIP as JAX_FLAGSHIP

import amgx_tpu_torch as pt
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.ops import tiling as TL
from amgx_tpu_torch.ops.smooth import children_table
from amgx_tpu_torch.presets import FLAGSHIP
from amgx_tpu_torch.solvers.polynomial import chebyshev_poly_coeffs

from _torch_util import geo_agg, grid_operator, vectors
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

# f32 kernel math in two implementations (ROADMAP.md)
TOL32 = 1e-6


def _level(shape, dtype, seed=0):
    """(spec, vals, dinv, agg, nc, ctab, b, x, xc) on a 7-point operator
    with random per-row values, the operands in `dtype`."""
    _, A = grid_operator(shape, seed=seed)
    spec = mf.detect_stencil(pt.gallery.poisson(
        "7pt", *shape, dtype=torch.float32, device="cpu").init()).spec()
    agg, nc = geo_agg(shape)
    agg = torch.from_numpy(agg)
    b, x, dinv, xc = (torch.from_numpy(v).to(dtype) for v in
                      vectors(A.num_rows, nc, np.float32, seed=seed + 1))
    return (spec, A.dia_vals.to(dtype), dinv, agg, nc,
            children_table(agg, nc), b, x, xc)


def _taus(s):
    if s == 5:
        return torch.from_numpy(
            (chebyshev_poly_coeffs(5) / 12.0).astype(np.float32))
    return torch.full((s,), 0.75)


def _calls(shape, apps, residual, dinv, launches):
    """The launches of a call split as evenly as may be over `launches`
    launches (or, where the kernel takes no such split, the nearest one
    it takes), on a small card."""
    for k in sorted(range(1, 4), key=lambda k: (abs(k - launches), k)):
        try:
            return TL.split_plans(shape, TL._parts(apps, k), residual,
                                  sms=6, ring=7 + int(dinv is not None))
        except ValueError:
            continue
    raise AssertionError("no plan")


# (shape, dtype, steps, dinv, launches)
CASES = [
    ((12, 10, 8), torch.float32, 3, False, 1),
    ((12, 10, 8), torch.float32, 5, False, 2),
    ((9, 7, 5), torch.float32, 2, True, 1),
    ((10, 12, 16), torch.float32, 4, True, 2),
    ((17, 6, 12), torch.float32, 1, False, 1),
    ((13, 11, 9), torch.bfloat16, 5, False, 2),
    ((11, 9, 7), torch.bfloat16, 4, True, 2),
    ((8, 8, 8), torch.bfloat16, 1, True, 1),
    ((9, 7, 6), torch.bfloat16, 2, False, 2),
]


@pytest.mark.parametrize(
    "case", CASES, ids=[f"{'x'.join(map(str, c[0]))}-"
                        f"{str(c[1]).split('.')[-1]}-s{c[2]}-"
                        f"{'dinv' if c[3] else 'nodinv'}-l{c[4]}"
                        for c in CASES])
def test_slab_emulation_equals_the_plain_forms(case):
    """B3 (steps, residual, in-tile restriction) and B4 (x + xc[agg]
    prologue, steps) from a random-valued slab, in one launch or split,
    give the plain forms' bits and dtypes."""
    shape, dt, s, with_dinv, launches = case
    spec, vals, dinv, agg, nc, ctab, b, x, xc = _level(shape, dt)
    dinv = dinv if with_dinv else None
    offs = spec.offsets
    taus = _taus(s)
    p3 = _calls(shape, s + 1, True, dinv, launches)
    assert sum(p.apps for p in p3) == s + 1 and p3[-1].residual \
        and not any(p.residual for p in p3[:-1])
    assert TL.restrict_lists(p3[-1], ctab) is not None
    got = TL.emulate_calls(p3, spec, None, taus, b, x, ctab=ctab, vals=vals,
                           dinv=dinv)
    want = K.dia_smooth_restrict_plain(vals, offs, taus, b, x, ctab, dinv)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dt and torch.equal(g, w)
    p4 = _calls(shape, s, False, dinv, launches)
    got = TL.emulate_calls(p4, spec, None, taus, b, x, xc=xc, agg=agg,
                           vals=vals, dinv=dinv)
    want = K.dia_prolong_smooth_plain(vals, offs, taus, b, x, xc, agg, dinv)
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("shape,launches", [((10, 9, 8), 1),
                                            ((17, 6, 12), 2)])
def test_slab_dot_is_the_plain_dot(shape, launches):
    """B4's x'.b (PCG's shapes: two steps with dinv): x' to the bit, the
    dot (block partials added in block order; the kernel's tree inside a
    block differs) within 4 eps of sum |x'_i b_i|."""
    spec, vals, dinv, agg, nc, _, b, x, xc = _level(shape, torch.float32,
                                                    seed=4)
    taus = _taus(2)
    plans = _calls(shape, 2, False, dinv, launches)
    assert len(plans) == launches
    gx, gd = TL.emulate_calls(plans, spec, None, taus, b, x, xc=xc, agg=agg,
                              with_dot=True, vals=vals, dinv=dinv)
    wx, wd = K.dia_prolong_smooth_plain(vals, spec.offsets, taus, b, x, xc,
                                        agg, dinv, with_dot=True)
    assert torch.equal(gx, wx)
    scale = float((wx * b).abs().sum())
    assert abs(float(gd) - float(wd)) <= 4 * np.finfo(np.float32).eps * scale


def test_slab_emulation_matches_jax_slab_forms():
    """One case against the JAX package's XLA slab forms of
    `_dia_smooth_restrict_call` and `_dia_prolong_smooth_call`
    (amgx_tpu/ops/batched.py, the bodies of amgx_tpu/ops/smooth.py
    `_xla_restrict_single`, `_xla_corr_single`) on the same random
    operator: two float32 implementations, 1e-6."""
    shape = (9, 7, 5)
    Aj, _ = grid_operator(shape)
    spec, vals, dinv, agg, nc, ctab, b, x, xc = _level(shape, torch.float32)
    taus = _taus(5)
    jxfer = fused.build_transfer_slabs(Aj, agg.numpy(), nc)
    B, X, XC = (jnp.asarray(v.numpy())[None] for v in (b, x, xc))
    jt, jd = jnp.asarray(taus.numpy()), jnp.asarray(dinv.numpy())
    wx, wbc = batched.smooth_restrict_dia_multi(Aj, B, X, jt, jd, jxfer)
    wy = batched.corr_smooth_dia_multi(Aj, B, X, XC, jt, jd, jxfer)
    p3 = _calls(shape, 6, True, dinv, 2)
    gx, gbc = TL.emulate_calls(p3, spec, None, taus, b, x, ctab=ctab,
                               vals=vals, dinv=dinv)
    gy = TL.emulate_calls(_calls(shape, 5, False, dinv, 2),
                          spec, None, taus, b, x, xc=xc, agg=agg, vals=vals,
                          dinv=dinv)
    for g, w in ((gx, wx[0]), (gbc, wbc[0]), (gy, wy[0])):
        w = np.asarray(w, dtype=np.float32)
        assert float(np.max(np.abs(g.numpy() - w))) <= \
            TOL32 * max(float(np.max(np.abs(w))), 1.0)


def _route(A, s, ctab=None, weighted=False, dinv=None):
    x = torch.zeros(A.num_rows)
    return K.slab_route(A.dia_vals, A.dia_offsets, A.grid_shape, dinv, x, s,
                        ctab, weighted)


def test_dispatch_by_structure():
    """GEO tables on the 7-point star: B3 and B4 tiled (B3 restricting in
    the tile); a SIZE_2 pair table: B3's steps tiled, then the untiled
    restriction; a weighted B3 (classical R rows): tiled, the residual
    stored for the restriction after; a weighted B4, a 27-point level, a
    level without `grid_shape`, a single plane and a schedule of more
    than STAR_MAX_APPS applications: the per-step route."""
    shape = (12, 10, 8)
    _, A = grid_operator(shape)
    agg, nc = geo_agg(shape)
    ctab = children_table(torch.from_numpy(agg), nc)
    route, plans, lists = _route(A, 5, ctab)
    assert route == "tiled" and lists is not None
    assert [p.apps for p in plans] == [p.apps for p in TL.plan_calls(
        shape, 6, True, dinv=False)]
    assert _route(A, 5)[0] == "tiled"
    pairs = (torch.arange(A.num_rows) + 1) // 2
    route, plans, lists = _route(A, 3, children_table(
        pairs, int(pairs.max()) + 1))
    assert route == "tiled+epilogue" and lists is None \
        and not any(p.residual for p in plans)
    route, plans, lists = _route(A, 5, ctab, weighted=True)
    assert route == "tiled" and lists is None and plans[-1].residual
    assert _route(A, 5, weighted=True) == ("step", None, None)
    assert _route(A, TL.STAR_MAX_APPS, ctab)[0] == "tiled+epilogue"
    assert _route(A, TL.STAR_MAX_APPS + 1, ctab)[0] == "step"
    assert _route(A, TL.STAR_MAX_APPS + 1)[0] == "step"
    A27 = pt.gallery.poisson("27pt", *shape, dtype=torch.float32,
                             device="cpu").init()
    assert K.slab_grid(A27.dia_vals, A27.dia_offsets, shape) is None
    assert _route(A27, 5, ctab)[0] == _route(A27, 5)[0] == "step"
    flat = pt.gallery.poisson("7pt", 12, 10, 1, dtype=torch.float32,
                              device="cpu").init()
    assert _route(flat, 2)[0] == "step"
    assert K.slab_route(A.dia_vals, A.dia_offsets, None, None,
                        torch.zeros(A.num_rows), 5)[0] == "step"


def test_off_grid_entry_keeps_the_per_step_route():
    """A slab that couples across the grid's edge (a periodic x
    neighbour: the x - 1 diagonal nonzero on the rows at x = 0) is not
    zero off the grid, so the tiled kernel, which skips off-grid
    neighbours, must not take it: slab_grid says no once, and both B3
    and B4 take the per-step route. Zeroing the entry back lets it in."""
    shape = (8, 6, 4)
    _, A = grid_operator(shape)
    agg, nc = geo_agg(shape)
    ctab = children_table(torch.from_numpy(agg), nc)
    d = A.dia_offsets.index(-1)
    vals = A.dia_vals.clone()
    vals[d, 0] = -0.5                        # row (0, 0, 0)'s x - 1
    spec = mf.detect_stencil(pt.gallery.poisson(
        "7pt", *shape, dtype=torch.float32, device="cpu").init()).spec()
    assert not bool(mf.off_grid_zero(vals, spec.shifts, shape))
    assert bool(mf.off_grid_zero(A.dia_vals, spec.shifts, shape))
    x = torch.zeros(A.num_rows)
    assert K.slab_grid(vals, A.dia_offsets, shape) is None
    for c in (ctab, None):
        assert K.slab_route(vals, A.dia_offsets, shape, None, x, 5, c) \
            == ("step", None, None)
    fixed = vals.clone()
    fixed[d, 0] = 0.0
    assert K.slab_grid(fixed, A.dia_offsets, shape) == shape
    assert K.slab_route(fixed, A.dia_offsets, shape, None, x, 5,
                        ctab)[0] == "tiled"


def test_slab_verdict_is_cached_per_slab():
    """The off-grid check runs once per slab (the verdict is kept on the
    tensor), and a rounded copy (the bf16 cycle's cast of the level)
    gets the same verdict from one check of its own."""
    shape = (6, 6, 4)
    _, A = grid_operator(shape)
    calls = []
    real = mf.off_grid_zero

    def counted(*a):
        calls.append(1)
        return real(*a)

    mf.off_grid_zero = counted
    try:
        assert K.slab_grid(A.dia_vals, A.dia_offsets, shape) == shape
        assert K.slab_grid(A.dia_vals, A.dia_offsets, shape) == shape
        assert len(calls) == 1
        half = A.dia_vals.to(torch.bfloat16)
        assert K.slab_grid(half, A.dia_offsets, shape) == shape
        assert K.slab_grid(half, A.dia_offsets, shape) == shape
    finally:
        mf.off_grid_zero = real
    assert len(calls) == 2


# (label, shape, applications, residual, dinv, launches): the flagship's
# slab levels 0 and 1 (CHEBYSHEV_POLY's 5 steps), PCG's (JACOBI_L1: 1
# presweep + residual, 2 postsweeps)
SPLITS = [("F l0 B3", (128,) * 3, 6, True, False, 2),
          ("F l0 B4", (128,) * 3, 5, False, False, 2),
          ("F l1 B3", (64,) * 3, 6, True, False, 2),
          ("F l1 B4", (64,) * 3, 5, False, False, 2),
          ("P l0 B3", (128,) * 3, 2, True, True, 1),
          ("P l0 B4", (128,) * 3, 2, False, True, 1)]


@pytest.mark.parametrize("label,shape,apps,residual,dinv,launches", SPLITS,
                         ids=[c[0].replace(" ", "-") for c in SPLITS])
def test_recorded_splits_of_the_driven_levels(label, shape, apps, residual,
                                              dinv, launches):
    """The planner's split on each driven slab level (132 SMs, the
    values in the shared ring): 3 + 3 for the flagship's B3, 3 + 2 for
    its B4, one launch for PCG's; every launch within 227 KB, 1024
    threads and SLAB_MAX_APPS applications, the residual in the last."""
    plans = TL.plan_calls(shape, apps, residual, dinv=dinv)
    assert len(plans) == launches
    assert [p.apps for p in plans] == list(TL._parts(apps, launches))
    for i, p in enumerate(plans):
        assert p.ring == 7 + int(dinv)
        assert p.residual == (residual and i == len(plans) - 1)
        assert p.smem_bytes <= TL.SMEM_BLOCK_MAX - TL.SMEM_STATIC
        assert p.threads <= TL.MAX_THREADS and p.apps <= TL.SLAB_MAX_APPS


def test_new_counters_are_reported():
    names = ("dia_smooth_restrict_step", "dia_smooth_restrict_epilogue",
             "dia_prolong_smooth_step", "dia_prolong_smooth_step_dot",
             "dia_smooth_restrict_step_bf16",
             "dia_smooth_restrict_epilogue_bf16",
             "dia_prolong_smooth_step_bf16")
    counts = pt.kernel_launches()
    assert all(n in K.LAUNCHES and n in counts for n in names)


def _dad_values(ro, ci, v):
    from chip_smoke import scaled_values
    return scaled_values(ro, ci, v).astype(np.float64)


def test_dad_flagship_matches_jax():
    """The untouched FLAGSHIP on A2 = D A D (variable coefficients: no
    level is a constant stencil, so every level keeps its slab) at 12^3:
    the port's CPU route gives the JAX package's status, outer and inner
    iterations (the JAX package reports its inner count with
    solve_precision=float, the cycle's precision already)."""
    n = 12
    Pj = jx.gallery.poisson("7pt", n, n, n).init()
    vals = _dad_values(np.asarray(Pj.row_offsets),
                       np.asarray(Pj.col_indices), np.asarray(Pj.values))
    js = jx.create_solver(JaxConfig.from_string(
        JAX_FLAGSHIP + ", solve_precision=float"))
    js.setup(Pj.with_values(jnp.asarray(vals)))
    rj = js.solve(np.ones(n ** 3))
    Pp = pt.gallery.poisson("7pt", n, n, n, device="cpu").init()
    ps = pt.create_solver(Config.from_string(
        FLAGSHIP + ", solve_precision=float"), device="cpu")
    ps.setup(Pp.with_values(torch.from_numpy(vals)))
    rp = ps.solve(torch.ones(n ** 3, dtype=torch.float64))
    assert str(rp.status) == str(rj.status) == "success"
    assert rp.iterations == rj.iterations
    assert rp.extra_stats["inner_iters"] == rj.extra_stats["inner_iters"]
    amg = ps.preconditioner.preconditioner.amg
    assert amg.level_rows() == [1728, 216, 27]
    assert all(lv.smoother._mf_stencil is None for lv in amg.levels)
