"""IDR / IDRMSYNC and the equation scalers of amgx_tpu_torch against the
JAX package's, on the CPU, and AmgX's stock configs/ files that name the
multicolor smoothers, IDR or a scaler, read verbatim in both packages.

- IDR's shadow space P has the JAX package's bits; IDR(s) solves (with
  and without a preconditioner) take its iterations, x within 1e-12
  (float64) or 1e-5 (float32);
- each scaler's left and right vectors within 1e-14 (float64), and a
  scaled solve takes the JAX package's iterations;
- the 12 stock files at 10^3 in float64: the JAX package's status and
  iterations, x within 1e-12 relative; in float32 the same status, and
  iterations within 1 where the file succeeds (the standalone AMG files
  stop near float32's rounding floor, where a rounding moves the count).
"""
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu import scalers as jsc

import amgx_tpu_torch as pt
from amgx_tpu_torch import scalers as psc

from _torch_util import (assert_same_solve, grid_operator, rel,  # noqa: F401
                         single_torch_thread, stock_pair)

N = 10
IDR_CFG = ("solver(main)={solver}, main:max_iters=80, main:tolerance=1e-8,"
           " main:monitor_residual=1, main:convergence=RELATIVE_INI,"
           " main:norm=L2, main:store_res_history=1,"
           " main:subspace_dim_s={s}, main:preconditioner(pre)={pre},"
           " pre:max_iters=1")
STOCK = ["AGGREGATION_DILU", "AGGREGATION_LOW_DEG_DILU",
         "AGGREGATION_THRUST_DILU", "AGGREGATION_GS",
         "AGGREGATION_LOW_DEG_GS", "AGGREGATION_THRUST_GS",
         "FGMRES_AGGREGATION", "FGMRES_AGGREGATION_DILU", "PCG_DILU",
         "IDR_DILU", "IDRMSYNC_DILU"]
# the JAX package's float64 anchors at 10^3 (tools/jax_anchors.py)
STOCK_F64 = {"AGGREGATION_DILU": 13, "AGGREGATION_LOW_DEG_DILU": 13,
             "AGGREGATION_THRUST_DILU": 13, "AGGREGATION_GS": 18,
             "AGGREGATION_LOW_DEG_GS": 18, "AGGREGATION_THRUST_GS": 13,
             "FGMRES_AGGREGATION": 5, "FGMRES_AGGREGATION_DILU": 5,
             "PCG_DILU": 2, "IDR_DILU": 9, "IDRMSYNC_DILU": 9,
             "V-cheby-smoother": 94}


def _solvers(text, Aj, Ap):
    js = jx.create_solver(jx.Config.from_string(text))
    js.setup(Aj)
    ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
    ps.setup(Ap)
    return js, ps


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("n", [1000, 315])
def test_idr_shadow_space_bits(s, n):
    shape = (10, 10, 10) if n == 1000 else (7, 5, 9)
    for dtype in (np.float32, np.float64):
        Aj, Ap = grid_operator(shape, dtype)
        js, ps = _solvers(IDR_CFG.format(solver="IDR", s=s, pre="NOSOLVER"),
                          Aj, Ap)
        want = np.asarray(js._P)
        got = ps._P.numpy()
        assert got.dtype == want.dtype and got.shape == (n, s)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("solver,s,pre", [
    ("IDR", 4, "NOSOLVER"), ("IDRMSYNC", 2, "MULTICOLOR_DILU"),
    ("IDR", 1, "JACOBI")])
def test_idr_solve_matches_jax(solver, s, pre, dtype):
    """IDR(s) on a random-valued, unsymmetric 7-point operator: float64
    the JAX package's iterations and history, x within 1e-12 (1e-10 for
    s = 4, whose (n, s) products add in another order and whose shadow
    space amplifies it); float32 the same status, iterations within 1
    and x within 1e-5."""
    Aj, Ap = grid_operator((7, 5, 9), dtype, seed=7)
    js, ps = _solvers(IDR_CFG.format(solver=solver, s=s, pre=pre), Aj, Ap)
    b = np.random.default_rng(8).standard_normal(Ap.num_rows).astype(dtype)
    rj, rp = js.solve(b), ps.solve(torch.from_numpy(b))
    assert rj.status == rp.status == "success"
    if dtype == np.float64:
        assert_same_solve(rj, rp, 1e-12 if s < 4 else 1e-10, 1e-10)
    else:
        assert abs(rp.iterations - int(rj.iterations)) <= 1
        assert rel(rp.x, np.asarray(rj.x)) <= 1e-5


def test_idr_breakdown_guard():
    """health_guards: omega = 0 (b orthogonal to A's range direction
    here: A = 0) ends the solve as a breakdown, as in the JAX package."""
    n = 8
    ro = np.arange(n + 1, dtype=np.int32)
    ci = np.arange(n, dtype=np.int32)
    vals = np.zeros(n)
    text = IDR_CFG.format(solver="IDR", s=1, pre="NOSOLVER") + \
        ", main:health_guards=1"
    Aj = jx.CsrMatrix.from_scipy_like(ro, ci, vals, n, n).init()
    Ap = pt.CsrMatrix.from_scipy_like(ro, ci, vals, n, n).init()
    js, ps = _solvers(text, Aj, Ap)
    b = np.ones(n)
    rj, rp = js.solve(b), ps.solve(torch.from_numpy(b))
    assert rp.status == rj.status == "breakdown"
    assert rp.iterations == int(rj.iterations)


@pytest.mark.parametrize("case", ["grid", "unsym_pattern"])
@pytest.mark.parametrize("name", ["DIAGONAL_SYMMETRIC", "BINORMALIZATION",
                                  "NBINORMALIZATION"])
def test_scaler_vectors_match_jax(name, case):
    Aj, Ap = grid_operator((7, 5, 9), np.float64, seed=9)
    if case == "unsym_pattern":
        from test_torch_multicolor import _unsym_pattern
        Aj, Ap = _unsym_pattern(np.float64, seed=9)
    jc, pc = jx.Config.from_string(""), pt.Config.from_string("")
    sj = jsc.make_scaler(name, jc).setup(Aj)
    sp_ = psc.make_scaler(name, pc).setup(Ap)
    for side in ("left", "right"):
        want = np.asarray(getattr(sj, side))
        got = getattr(sp_, side).numpy()
        assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    Sj, Sp = sj.scale_matrix(Aj), sp_.scale_matrix(Ap)
    assert rel(Sp.values, np.asarray(Sj.values)) <= 1e-14
    # the DIA view is refilled from the scaled values
    fresh = pt.CsrMatrix(row_offsets=Sp.row_offsets,
                         col_indices=Sp.col_indices, values=Sp.values,
                         num_rows=Sp.num_rows, num_cols=Sp.num_cols).init()
    assert torch.equal(Sp.dia_vals, fresh.dia_vals)


@pytest.mark.parametrize("name", ["DIAGONAL_SYMMETRIC", "BINORMALIZATION",
                                  "NBINORMALIZATION"])
def test_scaled_solve_matches_jax(name):
    """Only the root scales: a PCG + JACOBI_L1 solve of a scaled system
    takes the JAX package's iterations, x (unscaled) within 1e-12."""
    text = ("solver(main)=PCG, main:max_iters=100, main:tolerance=1e-8,"
            " main:monitor_residual=1, main:convergence=RELATIVE_INI,"
            " main:norm=L2, main:store_res_history=1,"
            f" main:scaling={name}, main:preconditioner(pre)=JACOBI_L1,"
            " pre:max_iters=2")
    Aj, Ap = grid_operator((7, 5, 9), np.float64, seed=10)
    js, ps = _solvers(text, Aj, Ap)
    assert ps.scaler is not None and ps.preconditioner.scaler is None
    assert not ps.preconditioner._owns_scaling
    b = np.random.default_rng(11).standard_normal(Ap.num_rows)
    rj, rp = js.solve(b), ps.solve(torch.from_numpy(b))
    assert rj.status == "success"
    assert_same_solve(rj, rp, 1e-12, 1e-10)


@pytest.fixture(scope="module", params=STOCK)
def stock64(request):
    return (request.param,) + stock_pair(request.param, N, np.float64)


def test_stock_file_float64(stock64):
    name, rj, rp, _ = stock64
    assert rj.status == "success" and int(rj.iterations) == STOCK_F64[name]
    assert_same_solve(rj, rp, 1e-12, 1e-10)


def test_stock_trees(stock64):
    """The smoothers and colorings the files name are the port's own."""
    name, _, _, ps = stock64
    s = ps
    while s is not None and not hasattr(s, "amg"):
        if type(s).__name__ == "MulticolorDILUSolver":
            break
        s = s.preconditioner
    if hasattr(s, "amg"):
        sm = s.amg.levels[0].smoother
    else:
        sm = s
    want = "MulticolorGSSolver" if "_GS" in name else "MulticolorDILUSolver"
    assert type(sm).__name__ == want
    assert sm.num_colors >= 2 and sm.row_colors.shape == (N ** 3,)


@pytest.mark.parametrize("name", STOCK)
def test_stock_file_float32(name):
    rj, rp, _ = stock_pair(name, N, np.float32)
    assert rp.status == rj.status
    if rj.status == "success":
        assert abs(rp.iterations - int(rj.iterations)) <= 1
    assert rel(rp.x, np.asarray(rj.x)) <= 1e-5


def test_stock_v_cheby_smoother_float64():
    """DIAGONAL_SYMMETRIC scaling around classical D2 + CHEBYSHEV: the one
    solve test of this file (the JAX package's classical setup of each
    new shape costs ~40 s)."""
    rj, rp, ps = stock_pair("V-cheby-smoother", N, np.float64)
    assert ps.scaler is not None
    assert ps.amg.levels[0].smoother.scaler is None
    assert rj.status == "success" and int(rj.iterations) == 94
    assert_same_solve(rj, rp, 1e-12, 1e-10)
