"""The temporally blocked B2 and B2-mf (the unfused DIA smoothers:
csrc/stencil_tb.cuh from a stored slab or from the coefficients;
ops/cuda_spmv.py `smooth_plans`, `mf_smooth_plans`; ops/tiling.py
`plan_calls`, `emulate_calls`) on the CPU.

The emulation computes what the launches of a B2 call compute, block by
block, each later launch reading the float32 state the one before left
and the last storing r = b - A x' rounded once to the operands' dtype. On
the launches the dispatch plans it must give the untiled plain forms
(`dia_smooth_plain`, `stencil._xla_smooth`: the CPU route and the
kernels' reference on the card) bit for bit, in float32 and bfloat16,
with and without dinv and the residual, for schedules of one, five and
eight steps (a call longer than a launch takes is split). Two cases are
held to the JAX package's smoother kernels in interpret mode; the
dispatch sends every level of the unfused 128^3 flagship to the tiled
route with its recorded split, and other levels to the per-step route;
the unfused flagship at 12^3 takes the JAX package's iterations.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as jps
from amgx_tpu.ops import smooth as jfused
from amgx_tpu.ops import stencil as jst
from amgx_tpu.presets import FLAGSHIP as JAX_FLAGSHIP

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.ops import tiling as TL
from amgx_tpu_torch.presets import FLAGSHIP
from amgx_tpu_torch.solvers.polynomial import chebyshev_poly_coeffs
from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                               safe_recip)

from _torch_util import grid_operator
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

# f32 kernel math in two implementations (ROADMAP.md)
TOL32 = 1e-6
SHAPE = (10, 8, 6)
BF = torch.bfloat16


def _taus(s):
    if s == 5:
        return torch.from_numpy(
            (chebyshev_poly_coeffs(5) / 12.0).astype(np.float32))
    return torch.full((s,), 0.75)


def _vectors(n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(dtype) for _ in range(2))


def _slab_level(dinv_mode, dtype):
    """(spec, vals, dinv) of a 7-point operator with random per-row values
    (zero off the grid), its dinv none / jacobi / l1, in `dtype`."""
    _, A = grid_operator(SHAPE, seed=2)
    spec = mf.detect_stencil(pt.gallery.poisson(
        "7pt", *SHAPE, dtype=torch.float32, device="cpu").init()).spec()
    dinv = None if dinv_mode is None else safe_recip(
        A.diagonal() if dinv_mode == "jacobi" else l1_strengthened_diag(A))
    return spec, A.dia_vals.to(dtype), \
        None if dinv is None else dinv.to(dtype)


def _coef_level(dinv_mode, dtype):
    """(StencilOperator-like spec, coeffs) of a constant 7-point operator
    with seeded coefficients (a diagonal of 6.5, off-diagonals in
    [-1.2, -0.8]), its dinv synthesized as `dinv_mode`; the coefficients
    rounded to `dtype` (the bf16 cycle's cast)."""
    st = mf.detect_stencil(pt.gallery.poisson(
        "7pt", *SHAPE, dtype=torch.float32, device="cpu").init())
    rng = np.random.default_rng(5)
    c = torch.tensor([6.5 if s == (0, 0, 0) else -rng.uniform(0.8, 1.2)
                      for s in st.shifts], dtype=torch.float32)
    return st.spec()._replace(dinv=dinv_mode), c.to(dtype)


def _route(form, spec, vals, dinv, x, steps, with_residual):
    """The launches the card's dispatch plans for this call."""
    if form == "slab":
        return K.smooth_plans(vals, spec.offsets, SHAPE, dinv, x, steps,
                              with_residual)
    return K.mf_smooth_plans(spec, x, steps, with_residual)


CASES = [(form, dt, dinv, wr, s)
         for form in ("slab", "coef")
         for dt in (torch.float32, BF)
         for dinv in (None, "jacobi", "l1")
         for wr in (True, False)
         for s in (1, 5, 8)]


@pytest.mark.parametrize(
    "form,dt,dinv,with_residual,steps", CASES,
    ids=[f"{c[0]}-{str(c[1]).split('.')[-1]}-{c[2]}-"
         f"{'r' if c[3] else 'x'}-s{c[4]}" for c in CASES])
def test_b2_emulation_equals_the_plain_forms(form, dt, dinv, with_residual,
                                             steps):
    """The planned launches of B2 (from a random-valued slab) and B2-mf
    (from the coefficients) give the plain forms' bits and dtypes: x',
    and r rounded once to the operands' dtype."""
    if form == "slab":
        spec, vals, dv = _slab_level(dinv, dt)
        coeffs = None
    else:
        (spec, coeffs), vals, dv = _coef_level(dinv, dt), None, None
    b, x = _vectors(spec.n, dt)
    taus = _taus(steps)
    plans = _route(form, spec, vals, dv, x, steps, with_residual)
    most = TL.SLAB_MAX_APPS if form == "slab" else TL.COEF_MAX_APPS
    apps = steps + int(with_residual)
    assert len(plans) == -(-apps // most)
    assert sum(p.apps for p in plans) == apps
    assert [p.residual for p in plans] == \
        [with_residual and p is plans[-1] for p in plans]
    assert all(p.ring == (0 if vals is None else 7 + int(dv is not None))
               for p in plans)
    got = TL.emulate_calls(plans, spec, coeffs, taus, b, x, vals=vals,
                           dinv=dv, resid_io=True)
    if form == "slab":
        want = K.dia_smooth_plain(vals, spec.offsets, taus, b, x, dv,
                                  with_residual)
    else:
        want = mf._xla_smooth(spec, coeffs, taus, b, x, with_residual)
    got = got if with_residual else (got,)
    want = want if with_residual else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dt and torch.equal(g, w)


def _close(got, want):
    w = np.asarray(want, dtype=np.float32)
    assert float(np.max(np.abs(got.numpy() - w))) <= \
        TOL32 * max(float(np.max(np.abs(w))), 1.0)


def test_slab_b2_matches_the_jax_kernel():
    """The tiled slab B2 route (eight JACOBI steps with dinv and the
    residual: three launches) against the JAX package's
    `_dia_smooth_call` in interpret mode (which chains its fused
    sub-calls past SMOOTH_MAX_APPS) on the same random operator."""
    Aj, Ap = grid_operator(SHAPE, seed=3)
    dinv = safe_recip(Ap.diagonal())
    b, x = _vectors(Ap.num_rows, torch.float32, seed=4)
    taus = _taus(8)
    spec = mf.detect_stencil(pt.gallery.poisson(
        "7pt", *SHAPE, dtype=torch.float32, device="cpu").init()).spec()
    plans = K.smooth_plans(Ap.dia_vals, Ap.dia_offsets, SHAPE, dinv, x, 8,
                           True)
    assert [p.apps for p in plans] == [3, 3, 3]
    gx, gr = TL.emulate_calls(plans, spec, None, taus, b, x,
                              vals=Ap.dia_vals, dinv=dinv, resid_io=True)
    jd = jnp.asarray(dinv.numpy())
    with jps.force_pallas_interpret():
        slabs = jfused.build_fused_slabs(Aj, jd)
        wx, wr = jfused.dia_fused_smooth(
            Aj, slabs, jnp.asarray(b.numpy()), jnp.asarray(x.numpy()),
            jnp.asarray(taus.numpy()), dinv=jd, with_residual=True)
    _close(gx, wx)
    _close(gr, wr)


def test_coef_b2_matches_the_jax_kernel():
    """The tiled B2-mf route (CHEBYSHEV_POLY's five steps with an l1
    dinv and the residual) against the JAX package's
    `_dia_stencil_smooth_call` in interpret mode, on a constant 7-point
    operator both packages detect as a stencil."""
    P = jx.gallery.poisson("7pt", *SHAPE)
    ro, ci = np.asarray(P.row_offsets), np.asarray(P.col_indices)
    vals = (np.asarray(P.values) / 3.0).astype(np.float32)
    n = P.num_rows
    Aj = dataclasses.replace(jx.CsrMatrix.from_scipy_like(ro, ci, vals, n, n),
                             grid_shape=SHAPE).init()
    Ap = pti.matrix_from_numpy(ro, ci, vals, n, n, grid_shape=SHAPE,
                               device="cpu")
    stp = mf.detect_stencil(Ap, dinv_mode="l1")
    stj = jst.detect_stencil(Aj, dinv_mode="l1")
    b, x = _vectors(n, torch.float32, seed=6)
    taus = _taus(5)
    plans = K.mf_smooth_plans(stp, x, 5, True)
    gx, gr = TL.emulate_calls(plans, stp.spec(), stp.coeffs, taus, b, x,
                              resid_io=True)
    with jps.force_pallas_interpret():
        wx, wr = jst.stencil_fused_smooth(
            stj, jnp.asarray(taus.numpy()), jnp.asarray(b.numpy()),
            jnp.asarray(x.numpy()), True)
    _close(gx, wx)
    _close(gr, wr)


# the unfused 128^3 flagship's smoothed levels (FLAGSHIP_TAIL_OFF, GEO:
# 128^3 .. 8^3; the coarsest 4^3 is solved directly), CHEBYSHEV_POLY's
# five steps: the presmoother with the residual, the postsmoother without
FLAGSHIP_LEVELS = [(n,) * 3 for n in (128, 64, 32, 16, 8)]


@pytest.mark.parametrize("shape", FLAGSHIP_LEVELS,
                         ids=[f"{s[0]}^3" for s in FLAGSHIP_LEVELS])
def test_recorded_splits_of_the_unfused_flagship(shape):
    """The tiled route on each level of the unfused 128^3 flagship (132
    SMs): the slab B2 3 + 3 with the residual and 3 + 2 without; B2-mf
    the fewest launches of at most COEF_MAX_APPS applications; every
    launch within 227 KB and 1024 threads, the residual in the last."""
    for coef, most in ((False, TL.SLAB_MAX_APPS),
                       (True, TL.COEF_MAX_APPS)):
        for apps, residual in ((6, True), (5, False)):
            plans = TL.plan_calls(shape, apps, residual, coef=coef)
            assert [p.apps for p in plans] == list(
                TL._parts(apps, -(-apps // most)))
            for i, p in enumerate(plans):
                assert p.ring == (0 if coef else 7)
                assert p.residual == (residual and i == len(plans) - 1)
                assert p.smem_bytes <= TL.SMEM_BLOCK_MAX - TL.SMEM_STATIC
                assert p.threads <= TL.MAX_THREADS
    assert [p.apps for p in TL.plan_calls(shape, 6, True)] == [3, 3]
    assert [p.apps for p in TL.plan_calls(shape, 5, False)] == [3, 2]


def test_dispatch_by_structure():
    """The slab B2 and B2-mf take the tiled route on the 7-point star
    (the slab's grid given and zero off the grid), whatever the schedule's
    length; a 27-point level, a slab with an off-grid entry, a slab
    without its grid and a single plane take the per-step route (no
    plans)."""
    shape = (12, 10, 8)
    A = pt.gallery.poisson("7pt", *shape, dtype=torch.float32,
                           device="cpu").init()
    st = mf.detect_stencil(A)
    x = torch.zeros(A.num_rows)
    for s, wr in ((1, False), (5, True), (20, True), (20, False)):
        plans = K.smooth_plans(A.dia_vals, A.dia_offsets, shape, None, x, s,
                               wr)
        assert sum(p.apps for p in plans) == s + int(wr)
        assert max(p.apps for p in plans) <= TL.SLAB_MAX_APPS
        plans = K.mf_smooth_plans(st, x, s, wr)
        assert sum(p.apps for p in plans) == s + int(wr)
        assert max(p.apps for p in plans) <= TL.COEF_MAX_APPS
    assert K.smooth_plans(A.dia_vals, A.dia_offsets, None, None, x, 5,
                          True) is None
    vals = A.dia_vals.clone()
    vals[A.dia_offsets.index(-1), 0] = -0.5     # a periodic x coupling
    assert K.smooth_plans(vals, A.dia_offsets, shape, None, x, 5,
                          True) is None
    A27 = pt.gallery.poisson("27pt", *shape, dtype=torch.float32,
                             device="cpu").init()
    assert K.smooth_plans(A27.dia_vals, A27.dia_offsets, shape, None,
                          torch.zeros(A27.num_rows), 5, True) is None
    assert K.mf_smooth_plans(mf.detect_stencil(A27),
                             torch.zeros(A27.num_rows), 5, True) is None
    flat = pt.gallery.poisson("7pt", 12, 10, 1, dtype=torch.float32,
                              device="cpu").init()
    xf = torch.zeros(flat.num_rows)
    assert K.smooth_plans(flat.dia_vals, flat.dia_offsets, (12, 10, 1),
                          None, xf, 2, True) is None
    assert K.mf_smooth_plans(mf.detect_stencil(flat), xf, 2, True) is None


def test_step_counters_are_reported():
    names = ("dia_smooth_step", "dia_smooth_step_bf16", "dia_smooth_mf_step",
             "dia_smooth_mf_step_bf16")
    counts = pt.kernel_launches()
    assert all(n in K.LAUNCHES and n in counts for n in names)


def test_unfused_flagship_matches_jax():
    """FLAGSHIP with amg:cycle_fusion=0 at 12^3 (B2 / B2-mf on every
    level: the CPU route), slab pinned and matrix-free: the JAX package's
    status, outer and inner iterations."""
    n = 12
    js = jx.create_solver(JaxConfig.from_string(
        JAX_FLAGSHIP + ", amg:cycle_fusion=0, solve_precision=float"))
    js.setup(jx.gallery.poisson("7pt", n, n, n).init())
    rj = js.solve(np.ones(n ** 3))
    for pin in ("0", "1"):
        ps = pt.create_solver(Config.from_string(
            FLAGSHIP + ", amg:cycle_fusion=0, solve_precision=float, "
            "amg:matrix_free=" + pin), device="cpu")
        ps.setup(pt.gallery.poisson("7pt", n, n, n, device="cpu").init())
        rp = ps.solve(torch.ones(n ** 3, dtype=torch.float64))
        assert str(rp.status) == str(rj.status) == "success"
        assert rp.iterations == rj.iterations
        assert rp.extra_stats["inner_iters"] == rj.extra_stats["inner_iters"]
        amg = ps.preconditioner.preconditioner.amg
        assert not amg.cycle_fusion
        assert all((lv.smoother._mf_stencil is not None) == (pin == "1")
                   for lv in amg.levels)
