"""B3w and B4w, the weighted transfer smoothers of a classical level 0,
on the CPU: the card's routes compute each fine row's transfer quantity
once (B3w: r = b - A x' in float32, by the tiled slab launches on a
7-point star grid or by a residual launch after the per-step ones, then
bc = R r over R's compact rows in entry order; B4w: x + P xc summed once
a row, then the steps from it as the float32 state). An emulation of
each route (the tiles through `tiling.emulate_calls`, the restriction
and the prologue in numpy walking R's and P's CSR rows) equals the plain
forms (`dia_smooth_restrict_plain`, `dia_prolong_smooth_plain`) to the
bit, in float32 and bfloat16, with dinv and without, on the port's
classical level 0 of a 12^3 and a ragged 13x11x9 grid; R's rows hold
ctab / cwt's entries in order; the weighted dispatch goes by structure;
and the routes agree with the JAX package's weighted Pallas calls
(interpreter) within TOL_CHAIN, the JAX slabs built from the port's P
and R (no JAX classical setup).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.ops import smooth as jfused

import amgx_tpu_torch as pt
from amgx_tpu_torch.amg.hierarchy import AMG
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.ops import tiling as TL
from amgx_tpu_torch.ops.smooth import build_csr_transfer_tables

from _torch_util import rel
from chip_smoke import CLASSICAL

# CLASSICAL's AMG block in the default scope (the level setup alone)
LEVEL_CFG = CLASSICAL[CLASSICAL.index("amg:algorithm"):].replace(
    "amg:", "").replace(", amg_precision=float", "")
SHAPES = [(12, 12, 12), (13, 11, 9)]
BF = torch.bfloat16
# the JAX package's Pallas route against the port's: a damped step, a
# residual through A and the weighted transfer, each summed in its own
# order (test_torch_classical.py's limit)
TOL_CHAIN = 1e-5


@functools.lru_cache(maxsize=None)
def _level0(shape):
    """The port's classical level 0 of the 7-pt Poisson on `shape` (f64
    setup), its A, P and R in float32 and their weighted tables."""
    amg = AMG(Config.from_string(LEVEL_CFG)).setup(
        pt.gallery.poisson("7pt", *shape, device="cpu"))
    lv = amg.levels[0]
    A, P, R = (M.astype(torch.float32) for M in (lv.A, lv.P, lv.R))
    return A, P, R, build_csr_transfer_tables(A, P, R)


def _inputs(shape, dtype, with_dinv, seed):
    """(A, P, R, xfer, taus, b, x, xc, dinv) in `dtype` (taus float32:
    two JACOBI_L1-like steps), from numpy."""
    A, P, R, xf = _level0(shape)
    n, nc = A.num_rows, P.num_cols
    rng = np.random.default_rng(seed)
    b, x = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    xc = torch.from_numpy(rng.standard_normal(nc).astype(np.float32))
    dinv = torch.from_numpy((1.0 / rng.uniform(5, 7, n)).astype(np.float32)) \
        if with_dinv else None
    taus = torch.tensor([0.9, 0.7], dtype=torch.float32)
    if dtype == BF:
        A, P, R = (M.astype(BF) for M in (A, P, R))
        xf = {k: v.to(BF) if v.is_floating_point() else v
              for k, v in xf.items()}
        b, x, xc = b.to(BF), x.to(BF), xc.to(BF)
        dinv = None if dinv is None else dinv.to(BF)
        taus = taus.to(BF).float()
    return A, P, R, xf, taus, b, x, xc, dinv


def _rows(ro, ci):
    """(entry index, mask) by position j of each CSR row, numpy."""
    ro, ci = ro.numpy().astype(np.int64), ci.numpy().astype(np.int64)
    lens = np.diff(ro)
    for j in range(int(lens.max())):
        yield np.minimum(ro[:-1] + j, len(ci) - 1), j < lens


def _emulate_restrict(ro, ci, w, r):
    """bc = R r walking R's compact rows: each product rounded to
    float32, then added in entry order (csr.cu's row-block sum)."""
    w = w.float().numpy()
    r = r.numpy()
    ci_np = ci.numpy().astype(np.int64)
    acc = np.zeros(ro.shape[0] - 1, np.float32)
    for e, live in _rows(ro, ci):
        prod = (w[e] * r[ci_np[e]]).astype(np.float32)
        acc = np.where(live, (acc + prod).astype(np.float32), acc)
    return torch.from_numpy(acc)


def _emulate_prologue(ro, ci, w, x, xc):
    """x + P xc walking P's rows: a fused multiply-add a term onto the
    row's sum from 0 (float64 holds a product of two float32 values
    exactly; rounded once a term), then x added (csrc/dia.cu
    WeightedXT)."""
    w = w.float().numpy().astype(np.float64)
    xc = xc.float().numpy().astype(np.float64)
    ci_np = ci.numpy().astype(np.int64)
    corr = np.zeros(ro.shape[0] - 1, np.float32)
    for e, live in _rows(ro, ci):
        fma = (w[e] * xc[ci_np[e]] + corr.astype(np.float64)).astype(
            np.float32)
        corr = np.where(live, fma, corr)
    return (x.float() + torch.from_numpy(corr)).float()


CASES = [pytest.param(shape, dt, d, id=f"{'x'.join(map(str, shape))}-"
                      f"{'bf16' if dt == BF else 'f32'}-"
                      f"{'dinv' if d else 'nodinv'}")
         for shape in SHAPES for dt in (torch.float32, BF)
         for d in (True, False)]


@pytest.mark.parametrize("route", ["tiled", "step"])
@pytest.mark.parametrize("shape,dtype,with_dinv", CASES)
def test_b3w_route_emulation_equals_plain(shape, dtype, with_dinv, route):
    """B3w on the card: the steps and r once a row in float32 (never
    rounded to bf16) -- the tiled launches the wrapper plans on the
    level's grid, tile by tile, or the per-step launches and a residual
    launch (a level without a grid) -- then bc = R r over R's rows; the
    same bits as the plain form (x' and bc)."""
    A, P, R, xf, taus, b, x, xc, dinv = _inputs(shape, dtype, with_dinv, 1)
    if route == "tiled":
        kind, plans, _ = K.slab_route(A.dia_vals, A.dia_offsets,
                                      A.grid_shape, dinv, x, len(taus),
                                      xf["ctab"], weighted=True)
        assert kind == "tiled" and plans[-1].residual
        spec = mf.detect_stencil(pt.gallery.poisson(
            "7pt", *shape, dtype=torch.float32, device="cpu").init()).spec()
        s, r = TL.emulate_calls(plans, spec, None, taus, b, x,
                                vals=A.dia_vals, dinv=dinv)
        assert r.dtype == torch.float32
    else:
        s, b32, v32 = K._smooth_state(A.dia_vals, A.dia_offsets, taus, b,
                                      x, dinv)
        r = b32 - K.dia_spmv_plain(v32, A.dia_offsets, s)
    bc = _emulate_restrict(xf["rro"], xf["rci"], xf["rwt"], r).to(dtype)
    want_x, want_bc = K.dia_smooth_restrict(
        A.dia_vals, A.dia_offsets, taus, b, x, xf["ctab"], dinv,
        weights=xf["cwt"], grid=A.grid_shape,
        rows=(xf["rro"], xf["rci"], xf["rwt"]))
    assert torch.equal(s.to(dtype), want_x)
    assert torch.equal(bc, want_bc)


@pytest.mark.parametrize("shape,dtype,with_dinv", CASES)
def test_b4w_route_emulation_equals_plain(shape, dtype, with_dinv):
    """B4w on the card: x0 = x + P xc once a row in float32, then the
    steps from x0 as the float32 state; the same bits as the plain form,
    its dot too (float32)."""
    A, P, R, xf, taus, b, x, xc, dinv = _inputs(shape, dtype, with_dinv, 2)
    x0 = _emulate_prologue(P.row_offsets, P.col_indices, P.values, x, xc)
    got = K.dia_smooth_plain(A.dia_vals, A.dia_offsets, taus, b, x, dinv,
                             with_residual=False, x32=x0)
    kw = dict(dinv=dinv, ptab=xf["ptab"], pwt=xf["pwt"], grid=A.grid_shape)
    want = K.dia_prolong_smooth(A.dia_vals, A.dia_offsets, taus, b, x, xc,
                                **kw)
    assert torch.equal(got, want)
    if dtype == torch.float32:
        xd, dot = K.dia_prolong_smooth(A.dia_vals, A.dia_offsets, taus, b, x,
                                       xc, with_dot=True, **kw)
        assert torch.equal(xd, want) and torch.equal(dot, torch.dot(got, b))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_r_rows_hold_ctab_entries(shape):
    """R's compact rows (`rro`, `rci`, `rwt`), which B3w's restriction
    walks, hold ctab / cwt's entries in the same order (and nothing
    else); a bf16 hierarchy casts `rwt` with `cwt` and keeps the
    structure."""
    _, _, R, xf = _level0(shape)
    ctab, cwt = xf["ctab"], xf["cwt"]
    lens = torch.diff(xf["rro"].long())
    assert torch.equal(lens, (ctab >= 0).sum(0))
    live = torch.arange(ctab.shape[0])[:, None] < lens[None, :]
    assert torch.equal(ctab >= 0, live)
    # column-major walk of the live table entries = R's entry order
    assert torch.equal(ctab.T[live.T], xf["rci"])
    assert torch.equal(cwt.T[live.T], xf["rwt"])
    assert xf["rro"].dtype == xf["rci"].dtype == torch.int32
    amg = AMG(Config.from_string(LEVEL_CFG + ", amg_precision=bfloat16")) \
        .setup(pt.gallery.poisson("7pt", *shape, device="cpu"))
    x16 = amg.solve_data()["levels"][0]["xfer"]
    assert x16["rwt"].dtype == x16["cwt"].dtype == BF
    assert torch.equal(x16["rwt"], x16["cwt"].T[live.T])
    assert torch.equal(x16["rro"], xf["rro"])


def test_weighted_dispatch_by_structure():
    """`slab_route(..., weighted=True)`: B3w (with its children table)
    runs tiled, the last launch storing r, on the 7-point star slab of a
    classical level 0 with its grid (one launch for one step + the
    residual, the planner's split for longer schedules), and the
    per-step route without a grid, on a slab with an entry off its grid
    (a periodic x coupling) and on a schedule the tiled kernel does not
    take; B4w (no table) takes its prologue and per-step route on every
    level."""
    A, _, _, xf = _level0((12, 12, 12))
    x = torch.zeros(A.num_rows)
    args = (A.dia_vals, A.dia_offsets)
    ctab = xf["ctab"]
    assert K.slab_grid(*args, A.grid_shape) == A.grid_shape
    for steps, split in ((1, [2]), (5, [3, 3])):
        kind, plans, lists = K.slab_route(*args, A.grid_shape, None, x,
                                          steps, ctab, True)
        assert (kind, lists) == ("tiled", None)
        assert [p.apps for p in plans] == split and plans[-1].residual
    step = ("step", None, None)
    assert K.slab_route(*args, None, None, x, 1, ctab, True) == step
    assert K.slab_route(*args, A.grid_shape, None, x, TL.STAR_MAX_APPS,
                        ctab, True) == step
    for grid in (A.grid_shape, None):
        assert K.slab_route(*args, grid, None, x, 1, None, True) == step
    vals = A.dia_vals.clone()
    vals[2, 0] = -1.0                       # row 0's x - 1 neighbour
    assert K.slab_grid(vals, A.dia_offsets, A.grid_shape) is None
    assert K.slab_route(vals, A.dia_offsets, A.grid_shape, None, x, 1,
                        ctab, True) == step


def _jax_f32(M):
    return jx.CsrMatrix.from_scipy_like(
        np.asarray(M.row_offsets), np.asarray(M.col_indices),
        np.asarray(M.values, np.float32), M.num_rows, M.num_cols).init()


@pytest.mark.parametrize("with_dinv", [True, False],
                         ids=["dinv", "nodinv"])
def test_weighted_routes_match_jax(with_dinv):
    """The JAX package's weighted Pallas calls (B3w and B4w, interpreter)
    on the JAX slabs of the port's 12^3 level 0 (`build_csr_transfer_slabs`
    from the port's P and R) against the routes' bits (the plain forms,
    which the emulation equals), within TOL_CHAIN."""
    A, P, R, xf, taus, b, x, xc, dinv = _inputs((12, 12, 12), torch.float32,
                                                with_dinv, 3)
    Aj = jx.gallery.poisson("7pt", 12, 12, 12, dtype=jnp.float32).init()
    jd = None if dinv is None else jnp.asarray(dinv.numpy())
    jb, jxx, jxc, jt_ = (jnp.asarray(t.numpy()) for t in (b, x, xc, taus))
    with ps.force_pallas_interpret():
        slabs = jfused.build_fused_slabs(Aj, jd)
        jt = jfused.build_csr_transfer_slabs(Aj, _jax_f32(P), _jax_f32(R))
        xj, bcj = jfused.fused_smooth_restrict(
            {"A": Aj, "fused": slabs}, jb, jxx, jt_, jt, dinv=jd)
        yj = jfused.fused_corr_smooth(
            {"A": Aj, "fused": slabs}, jb, jxx, jxc, jt_, jt, dinv=jd)
    xp, bcp = K.dia_smooth_restrict(
        A.dia_vals, A.dia_offsets, taus, b, x, xf["ctab"], dinv,
        weights=xf["cwt"], grid=A.grid_shape,
        rows=(xf["rro"], xf["rci"], xf["rwt"]))
    yp = K.dia_prolong_smooth(A.dia_vals, A.dia_offsets, taus, b, x, xc,
                              dinv=dinv, ptab=xf["ptab"], pwt=xf["pwt"],
                              grid=A.grid_shape)
    assert rel(xp, xj) < TOL_CHAIN
    assert rel(bcp, bcj) < TOL_CHAIN
    assert rel(yp, yj) < TOL_CHAIN
