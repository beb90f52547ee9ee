"""GMRES and the CHEBYSHEV solver of amgx_tpu_torch against the JAX
package's, on the CPU, and AmgX's stock configs/ files GMRES,
GMRES_AMG_D2 and agg_cheb4, read verbatim in both packages (the
PBICGSTAB files are in tests/test_torch_bicgstab.py).

GMRES shares FGMRES's Arnoldi (one base class with a `flexible` flag, as
in the JAX package); without a preconditioner the two give the same
residual history, bit for bit. CHEBYSHEV's four
chebyshev_lambda_estimate_modes run with and without a JACOBI_L1
preconditioner, as a solver and as an AMG smoother. A power-iteration
estimate (modes 0 and 1) may differ from the JAX package's in its last
float32 bits, and every Chebyshev coefficient follows it: the estimate is
held to 1e-6 on its own, and the float32 solves then run on the JAX
package's bounds (as `interop.hierarchy_from_numpy` carries them).
"""
import dataclasses

import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti

from _torch_util import (assert_same_solve, jax_hierarchy_arrays, rel,
                         stock_pair)
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

N = 10
STOCK_N = 8
TOL = {np.float32: 1e-6, np.float64: 1e-12}
# x and residual histories (relative to the initial residual) of whole
# solves: float32 rounding grown over the iterations; float64 the same
# arithmetic to rounding
X_TOL = {np.float32: 1e-5, np.float64: 1e-10}
HIST_TOL = {np.float32: 1e-5, np.float64: 1e-10}
AMG = ("preconditioner(amg)=AMG, amg:algorithm=AGGREGATION,"
       " amg:selector=GEO, amg:smoother=JACOBI_L1,"
       " amg:relaxation_factor=0.75, amg:presweeps=1, amg:postsweeps=2,"
       " amg:max_iters=1, amg:cycle=V, amg:max_levels=10,"
       " amg:min_coarse_rows=32")
GMRES_CFG = ("solver={solver}, max_iters=60, monitor_residual=1,"
             " tolerance=1e-6, convergence=RELATIVE_INI, norm=L2,"
             " store_res_history=1, gmres_n_restart=8, {pre}")
CHEB_CFG = ("solver=CHEBYSHEV, max_iters=25, monitor_residual=1,"
            " tolerance=1e-6, convergence=RELATIVE_INI, norm=L2,"
            " store_res_history=1, chebyshev_lambda_estimate_mode={mode},"
            " preconditioner(pre)={pre}, pre:max_iters=1")
# standalone AMG with a CHEBYSHEV smoother (the agg_cheb4 layout on GEO
# aggregates), its preconditioner in the smoother's scope; two levels, so
# the smoother runs on the unit-diagonal operator only (the Gershgorin
# estimate bounds no Galerkin coarse operator: see _poisson)
CHEB_AMG_CFG = ("solver(main)=AMG, main:max_iters=30, main:tolerance=1e-5,"
                " main:monitor_residual=1, main:convergence=RELATIVE_INI,"
                " main:store_res_history=1, main:algorithm=AGGREGATION,"
                " main:selector=GEO, main:presweeps=1, main:postsweeps=1,"
                " main:max_levels=2, main:min_coarse_rows=32,"
                " main:smoother(sm)=CHEBYSHEV,"
                " sm:chebyshev_lambda_estimate_mode={mode}, sm:max_iters=1,"
                " sm:preconditioner(pre)={pre}, pre:max_iters=1")
MODES = [0, 1, 2, 3]
PRES = ["JACOBI_L1", "NOSOLVER"]


def _poisson(n, dtype, unit=False):
    """The 7-pt n^3 Poisson in both packages; with `unit` divided by its
    diagonal 6. The Gershgorin estimate (mode 2 and 3 without a
    preconditioner) is the diagonally scaled row sum in both packages, a
    bound of the spectrum only where the diagonal is 1."""
    if not unit:
        return (jx.gallery.poisson("7pt", n, n, n, dtype=dtype).init(),
                pt.gallery.poisson("7pt", n, n, n, device="cpu",
                                   dtype=getattr(torch, np.dtype(dtype).name)))
    P = jx.gallery.poisson("7pt", n, n, n)
    ro, ci = np.asarray(P.row_offsets), np.asarray(P.col_indices)
    vals = (np.asarray(P.values, np.float64) / 6.0).astype(dtype)
    m, shape = n ** 3, (n, n, n)
    return (dataclasses.replace(jx.CsrMatrix.from_scipy_like(
                ro, ci, vals, m, m), grid_shape=shape).init(),
            pti.matrix_from_numpy(ro, ci, vals, m, m, grid_shape=shape,
                                  device="cpu"))


def _pair(cfg, n, dtype, jcfg=None, pcfg=None, bounds=False, unit=False):
    """Set up and solve the n^3 Poisson with b = 1 in both packages:
    (JAX result, port result, JAX solver, port solver). With `bounds`
    the port's CHEBYSHEV solver takes the JAX one's spectral bounds."""
    Aj, Ap = _poisson(n, dtype, unit)
    js = jx.create_solver(jcfg or JaxConfig.from_string(cfg))
    js.setup(Aj)
    ps = pt.create_solver(pcfg or pt.Config.from_string(cfg), device="cpu")
    ps.setup(Ap)
    if bounds:
        ps.set_bounds(js.lmax, js.lmin)
    b = np.ones(n ** 3, dtype)
    return js.solve(b), ps.solve(torch.from_numpy(b)), js, ps


def _assert_same_solve(rj, rp, dtype, iterations=True):
    assert_same_solve(rj, rp, X_TOL[dtype], HIST_TOL[dtype], iterations)


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pre", ["amg", "none"])
def test_gmres_matches_jax(pre, dtype):
    """Restarted every 8 steps, under the GEO / JACOBI_L1 AMG (applied
    once more when x is rebuilt: x = x0 + M V^T y) or none."""
    cfg = GMRES_CFG.format(solver="GMRES", pre=AMG if pre == "amg" else
                           "preconditioner=NOSOLVER")
    rj, rp, _, _ = _pair(cfg, N, dtype)
    assert rp.status == "success"
    _assert_same_solve(rj, rp, dtype)


def test_gmres_without_preconditioner_is_fgmres():
    """With M = I, GMRES's x0 + V^T y and FGMRES's x0 + Z^T y (Z = V)
    are the same Arnoldi steps and restarts: the same residual history,
    bit for bit. Only an exit inside a cycle differs, in the JAX
    package's GMRES as here: its masked triangular solve leaves y[i] =
    g[i] for the next, not yet used, basis vector V[i], which GMRES
    multiplies and FGMRES (whose Z[i] is still zero) does not."""
    _, Ap = _poisson(N, np.float32)
    out, final = {}, {}
    for solver in ("GMRES", "FGMRES"):
        cfg = GMRES_CFG.format(solver=solver, pre="preconditioner=NOSOLVER")
        slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
        slv.setup(Ap)
        real = slv.finalize
        slv.finalize = (lambda data, b, st, _s=solver, _r=real:
                        final.setdefault(_s, dict(st)) and _r(data, b, st))
        out[solver] = slv.solve(torch.ones(N ** 3))
    g, f = out["GMRES"], out["FGMRES"]
    assert g.iterations == f.iterations > 8
    assert np.array_equal(g.res_history, f.res_history)
    st = final["GMRES"]
    i = st["i"]
    assert 0 < i < 8 and st["g"][i] != 0
    extra = float(st["g"][i]) * st["V"][i]
    assert rel(g.x, f.x + extra) < 1e-6


# ---------------------------------------------------------------------------
# CHEBYSHEV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pre", PRES)
@pytest.mark.parametrize("mode", MODES)
def test_chebyshev_estimate_matches_jax(mode, pre, dtype):
    """lmax and lmin of every estimate mode: the power iteration (modes
    0/1, 20 steps from numpy's default_rng(0) vector), the Gershgorin
    bound or 0.9 under a preconditioner (2), the user's bounds under a
    preconditioner (3)."""
    cfg = CHEB_CFG.format(mode=mode, pre=pre)
    Aj, Ap = _poisson(N, dtype, unit=True)
    js = jx.create_solver(JaxConfig.from_string(cfg))
    js.setup(Aj)
    ps = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    ps.setup(Ap)
    for a, b in ((ps.lmax, js.lmax), (ps.lmin, js.lmin)):
        assert isinstance(a, float)
        assert abs(a - b) <= TOL[dtype] * abs(b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pre", PRES)
@pytest.mark.parametrize("mode", MODES)
def test_chebyshev_solver_matches_jax(mode, pre, dtype):
    rj, rp, _, _ = _pair(CHEB_CFG.format(mode=mode, pre=pre), N, dtype,
                         bounds=dtype == np.float32, unit=True)
    _assert_same_solve(rj, rp, dtype)


@pytest.mark.parametrize("pre", PRES)
@pytest.mark.parametrize("mode", MODES)
def test_chebyshev_smoother_matches_jax(mode, pre):
    """The AMG smoother in float64, each package estimating its own
    bounds; then the JAX package's float32 hierarchy carried across
    with its bounds (interop), one cycle to 1e-6 and the same solve."""
    cfg = CHEB_AMG_CFG.format(mode=mode, pre=pre)
    rj, rp, _, ps = _pair(cfg, N, np.float64, unit=True)
    _assert_same_solve(rj, rp, np.float64)
    sm = ps.amg.levels[0].smoother
    assert type(sm).__name__ == "ChebyshevSolver"
    assert (sm.preconditioner is None) == (pre == "NOSOLVER")

    Aj, Ap = _poisson(N, np.float32, unit=True)
    js = jx.create_solver(JaxConfig.from_string(cfg))
    js.setup(Aj)
    levels, coarse = jax_hierarchy_arrays(js)
    assert all(lv["lmax"] is not None for lv in levels)
    amg = pti.hierarchy_from_numpy(levels, coarse, pt.Config.from_string(
        cfg), "main", device="cpu")
    b = np.random.default_rng(5).standard_normal(N ** 3).astype(np.float32)
    xj = js.amg.cycle(js.solve_data()["amg"], b, np.zeros_like(b))
    xp = amg.cycle(amg.solve_data(), torch.from_numpy(b),
                   torch.zeros(N ** 3))
    assert rel(xp, np.asarray(xj)) < TOL[np.float32]
    ps = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    ps.A = amg.levels[0].A
    ps.amg = amg
    rp = ps.solve(torch.ones(N ** 3))
    _assert_same_solve(js.solve(np.ones(N ** 3, np.float32)), rp,
                       np.float32)


# ---------------------------------------------------------------------------
# the stock configs/ files of this slice, verbatim
# ---------------------------------------------------------------------------

STOCK = ["GMRES", "GMRES_AMG_D2", "agg_cheb4"]


@pytest.fixture(scope="module", params=STOCK)
def stock(request):
    """(file, JAX result, port result, port solver) at 8^3 in float32."""
    return (request.param,) + stock_pair(request.param, STOCK_N, np.float32)


def test_stock_file_matches_jax(stock):
    """Status, x and the residual history of each file; the iterations
    too, except agg_cheb4's: its float32 run ends where the monitored
    residual, 1e-6 of the initial one, is at float32's rounding floor
    (both histories wander by ~10 % there, and which iteration crosses
    first is decided by rounding). test_stock_agg_cheb4_float64 holds
    its iterations."""
    name, rj, rp, _ = stock
    assert rp.status == "success"
    _assert_same_solve(rj, rp, np.float32, iterations=name != "agg_cheb4")


def test_stock_solver_trees(stock):
    """The port built the tree the file names: GMRES without a
    preconditioner, GMRES around classical PMIS + D2 levels with
    JACOBI_L1, standalone SIZE_8 aggregation AMG with CHEBYSHEV smoothers
    (mode 2 under JACOBI_L1: lmax 0.9)."""
    name, _, _, ps = stock
    if name == "GMRES":
        assert ps.name == "GMRES" and ps.preconditioner is None
        return
    amg = ps.amg if name == "agg_cheb4" else ps.preconditioner.amg
    kind, smoother = {"GMRES_AMG_D2": ("ClassicalAMGLevel", "JACOBI_L1"),
                      "agg_cheb4": ("AggregationAMGLevel", "CHEBYSHEV")}[name]
    assert amg.levels
    for lv in amg.levels:
        assert type(lv).__name__ == kind
        assert lv.smoother.name == smoother
    if name == "agg_cheb4":
        sm = amg.levels[0].smoother
        assert sm.preconditioner.name == "JACOBI_L1" and sm.lmax == 0.9


def test_stock_agg_cheb4_float64():
    rj, rp, _ = stock_pair("agg_cheb4", STOCK_N, np.float64)
    assert rp.status == "success"
    _assert_same_solve(rj, rp, np.float64)
