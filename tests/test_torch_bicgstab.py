"""BiCGStab and PBiCGStab of amgx_tpu_torch against the JAX package's, on
the CPU: B6's streamed-dot form (Ap, d.Ap and, with self_dot, Ap.Ap) as
its plain PyTorch twin (the CPU route) against the JAX package's XLA
compose and its Pallas kernel under the interpreter; then both solvers
with the GEO-aggregation / JACOBI_L1 hierarchy on both krylov_fusion
routes, in float32 and float64, each route against the same route of the
JAX package (its own fused and unfused float64 BiCGStab do not agree with
each other: `tests/test_krylov_fusion.py`); and AmgX's stock PBICGSTAB*
configs/ files, read verbatim in both packages.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.ops.spmv import _spmv_ddot_xla

import amgx_tpu_torch as pt
from amgx_tpu_torch.ops import cuda_krylov as KK
from amgx_tpu_torch.ops import spmv as pspmv
from amgx_tpu_torch.solvers import base as pbase

from _torch_util import assert_same_solve, grid_operator, rel, stock_pair

GRIDS = [(8, 8, 8), (13, 9, 7), (12, 11, 10)]
# one pass of arithmetic with the dots summed in another order than XLA's
TOL = {np.float32: 1e-6, np.float64: 1e-12}
N = 10
CFG = ("solver={solver}, max_iters=60, monitor_residual=1,"
       " tolerance=1e-6, convergence=RELATIVE_INI, norm=L2,"
       " store_res_history=1, preconditioner(amg)=AMG,"
       " amg:algorithm=AGGREGATION, amg:selector=GEO,"
       " amg:smoother=JACOBI_L1, amg:relaxation_factor=0.75,"
       " amg:presweeps=1, amg:postsweeps=2, amg:max_iters=1, amg:cycle=V,"
       " amg:max_levels=10, amg:min_coarse_rows=32,"
       " krylov_fusion={fusion}")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ddot_case(shape, dtype, same):
    """(JAX matrix, port matrix, p, d): d is p itself when `same`."""
    Aj, Ap = grid_operator(shape, dtype)
    rng = np.random.default_rng(11)
    p = rng.standard_normal(Aj.num_rows).astype(dtype)
    d = p if same else rng.standard_normal(Aj.num_rows).astype(dtype)
    return Aj, Ap, p, d


def _check_ddot(got, want, p, d, self_dot, tol):
    """Ap to `tol` in norm; each dot to `tol` of its terms' absolute sum
    (sum |d_i Ap_i|, the scale of a dot's rounding: with random d the
    dot cancels, and its value says nothing of its error)."""
    assert len(got) == len(want) == (3 if self_dot else 2)
    ap = np.asarray(want[0], np.float64)
    assert rel(got[0], want[0]) < tol
    scales = [np.abs(np.asarray(d, np.float64) * ap).sum()]
    if self_dot:
        scales.append((ap * ap).sum())
    for g, w, sc in zip(got[1:], want[1:], scales):
        assert g.dim() == 0
        assert abs(float(g) - float(w)) <= tol * sc


def _port_ddot(Ap, p, d, same, self_dot):
    pt_ = _t(p)
    dt_ = pt_ if same else _t(d)
    return KK.dia_spmv_dot(Ap.dia_vals, Ap.dia_offsets, pt_, d=dt_,
                           self_dot=self_dot)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("self_dot", [False, True])
@pytest.mark.parametrize("same", [False, True], ids=["d", "d_is_p"])
@pytest.mark.parametrize("shape", GRIDS)
def test_b6_ddot_plain_matches_xla_compose(shape, same, self_dot, dtype):
    Aj, Ap, p, d = _ddot_case(shape, dtype, same)
    want = _spmv_ddot_xla(Aj, jnp.asarray(p), jnp.asarray(d), self_dot)
    got = _port_ddot(Ap, p, d, same, self_dot)
    assert all(g.dtype == getattr(torch, np.dtype(dtype).name) for g in got)
    _check_ddot(got, want, p, d, self_dot, TOL[dtype])


@pytest.mark.parametrize("self_dot", [False, True])
@pytest.mark.parametrize("same", [False, True], ids=["d", "d_is_p"])
@pytest.mark.parametrize("shape", GRIDS)
def test_b6_ddot_plain_matches_pallas_kernel(shape, same, self_dot):
    Aj, Ap, p, d = _ddot_case(shape, np.float32, same)
    pj = jnp.asarray(p)
    with ps.force_pallas_interpret():
        want = ps.dia_spmv_dot(Aj, pj, d=pj if same else jnp.asarray(d),
                               self_dot=self_dot)
    got = _port_ddot(Ap, p, d, same, self_dot)
    _check_ddot(got, want, p, d, self_dot, TOL[np.float32])


def test_b6_ddot_routes(monkeypatch):
    """spmv_ddot takes B6 on a float32 DIA operator and composes the
    float64 one itself (the JAX package's XLA route); the forms of B6
    with no caller raise."""
    calls = []
    real = KK.dia_spmv_dot
    monkeypatch.setattr(KK, "dia_spmv_dot",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    for dtype in (np.float32, np.float64):
        _, Ap, p, d = _ddot_case((8, 8, 8), dtype, False)
        pspmv.spmv_ddot(Ap, _t(p), _t(d), self_dot=True)
    assert len(calls) == 1 and calls[0]["self_dot"]
    _, Ap, p, d = _ddot_case((8, 8, 8), np.float32, False)
    one = torch.tensor(1.0)
    with pytest.raises(NotImplementedError):
        real(Ap.dia_vals, Ap.dia_offsets, _t(p), _t(d), one, d=_t(d))
    with pytest.raises(NotImplementedError):
        real(Ap.dia_vals, Ap.dia_offsets, _t(p), self_dot=True)


# ---------------------------------------------------------------------------
# BiCGStab / PBiCGStab end to end
# ---------------------------------------------------------------------------


def _solve_pair(solver, fusion, dtype):
    """The same 10^3 system in both packages; the JAX package's kernels
    under the interpreter when its route is fused float32, its plain
    route otherwise."""
    cfg = CFG.format(solver=solver, fusion=fusion)
    b = np.ones(N ** 3, dtype)

    def jax_solve():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", N, N, N, dtype=dtype).init())
        return js.solve(b)

    if fusion and dtype == np.float32:
        with ps.force_pallas_interpret():
            rj = jax_solve()
    else:
        rj = jax_solve()
    ptd = getattr(torch, np.dtype(dtype).name)
    slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    slv.setup(pt.gallery.poisson("7pt", N, N, N, dtype=ptd, device="cpu"))
    return rj, slv.solve(torch.from_numpy(b))


# f32: float32 rounding grown over the iterations; f64: the same
# arithmetic to rounding. Histories relative to the initial residual.
X_TOL = {np.float32: 1e-5, np.float64: 1e-12}
HIST_TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fusion", [1, 0])
@pytest.mark.parametrize("solver", ["BICGSTAB", "PBICGSTAB"])
def test_bicgstab_family_matches_jax(solver, fusion, dtype):
    rj, rp = _solve_pair(solver, fusion, dtype)
    assert rp.status == rj.status == "success"
    assert rp.iterations == int(rj.iterations)
    assert rp.x.dtype == getattr(torch, np.dtype(dtype).name)
    assert rel(rp.x, np.asarray(rj.x)) < X_TOL[dtype]
    hj = np.asarray(rj.res_history, np.float64).ravel()
    hp = np.asarray(rp.res_history, np.float64).ravel()
    assert hp.shape == hj.shape
    assert np.abs(hp - hj).max() <= HIST_TOL[dtype] * hj[0]


@pytest.mark.parametrize("fusion", [1, 0])
def test_pbicgstab_meets_the_host_once_per_iteration(monkeypatch, fusion):
    """The monitored norm with the breakdown flag is the only value an
    iteration moves to the host: alpha, omega, rho and beta stay 0-dim
    tensors."""
    calls = []
    real = pbase._host
    monkeypatch.setattr(pbase, "_host",
                        lambda t: calls.append(1) or real(t))
    cfg = CFG.format(solver="PBICGSTAB", fusion=fusion)
    slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    slv.setup(pt.gallery.poisson("7pt", 8, 8, 8, dtype=torch.float32,
                                 device="cpu"))
    res = slv.solve(torch.ones(512, dtype=torch.float32))
    assert res.status == "success"
    assert len(calls) == res.iterations + 1


def test_fused_pbicgstab_runs_b6_ddot(monkeypatch):
    """krylov_fusion=1 on a float32 DIA operator: two B6 calls with d per
    iteration, one of them with self_dot (t = A s^ with t.s, t.t), and
    d is s itself when there is no preconditioner; =0: none."""
    seen = []
    real = KK.dia_spmv_dot
    monkeypatch.setattr(KK, "dia_spmv_dot", lambda *a, **k: seen.append(
        (k.get("d") is not None, k.get("self_dot", False),
         k.get("d") is a[2])) or real(*a, **k))
    for solver, fusion in (("PBICGSTAB", 1), ("BICGSTAB", 1),
                           ("PBICGSTAB", 0)):
        seen.clear()
        cfg = CFG.format(solver=solver, fusion=fusion)
        slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
        slv.setup(pt.gallery.poisson("7pt", 8, 8, 8, dtype=torch.float32,
                                     device="cpu"))
        n = slv.solve(torch.ones(512, dtype=torch.float32)).iterations
        if not fusion:
            assert seen == []
            continue
        assert len(seen) == 2 * n
        assert all(with_d for with_d, _, _ in seen)
        assert sum(sd for _, sd, _ in seen) == n
        # BiCGStab's t.s: d is the very tensor B6 multiplies (s); under
        # a preconditioner B6 multiplies s^ and streams s
        assert all(same == (solver == "BICGSTAB")
                   for _, sd, same in seen if sd)


@pytest.mark.parametrize("solver", ["BICGSTAB", "PBICGSTAB"])
def test_bicgstab_breakdown_matches_jax(solver):
    """On a zero operator v = A p^ = 0, so alpha and omega are 0 (the
    guarded divisions) and the health guard reports BREAKDOWN after the
    first iteration, as in the JAX package, with a finite x."""
    cfg = (f"solver={solver}, max_iters=10, monitor_residual=1,"
           " tolerance=1e-12, health_guards=1")
    n = 27
    ro, ci, vals = np.arange(n + 1), np.arange(n), np.zeros(n)
    js = jx.create_solver(JaxConfig.from_string(cfg))
    js.setup(jx.CsrMatrix.from_scipy_like(ro, ci, vals, n, n).init())
    rj = js.solve(np.ones(n))
    slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    slv.setup(pt.interop.matrix_from_numpy(ro, ci, vals, n, n,
                                           device="cpu"))
    res = slv.solve(torch.ones(n, dtype=torch.float64))
    assert res.status == rj.status == "breakdown"
    assert res.iterations == int(rj.iterations)
    assert rel(res.x, np.asarray(rj.x)) == 0.0


# ---------------------------------------------------------------------------
# the stock PBICGSTAB files, verbatim
# ---------------------------------------------------------------------------

STOCK = ["PBICGSTAB", "PBICGSTAB_CLASSICAL_JACOBI", "PBICGSTAB_NOPREC",
         "PBICGSTAB_AGGREGATION_W_JACOBI", "PBICGSTAB_W"]
# the AMG block of each file: level class, smoother, cycle
TREES = {"PBICGSTAB": ("ClassicalAMGLevel", "V"),
         "PBICGSTAB_CLASSICAL_JACOBI": ("ClassicalAMGLevel", "V"),
         "PBICGSTAB_AGGREGATION_W_JACOBI": ("AggregationAMGLevel", "W"),
         "PBICGSTAB_W": ("AggregationAMGLevel", "W")}


@pytest.fixture(scope="module", params=STOCK)
def stock(request):
    """(file, JAX result, port result, port solver) at 8^3 in float32."""
    return (request.param,) + stock_pair(request.param, 8, np.float32)


def test_stock_pbicgstab_matches_jax(stock):
    """The same iterations and status, x and the residual history to
    float32 rounding grown over the solve."""
    _, rj, rp, _ = stock
    assert rp.status == "success"
    assert_same_solve(rj, rp, X_TOL[np.float32], HIST_TOL[np.float32])


def test_stock_pbicgstab_trees(stock):
    """PBICGSTAB fused (krylov_fusion's default) around the AMG block the
    file names, BLOCK_JACOBI smoothing; NOSOLVER leaves no
    preconditioner."""
    name, _, _, ps = stock
    assert ps.name == "PBICGSTAB" and ps.krylov_fusion
    if name == "PBICGSTAB_NOPREC":
        assert ps.preconditioner is None
        return
    kind, cycle = TREES[name]
    amg = ps.preconditioner.amg
    assert amg.cycle_name == cycle and amg.levels
    for lv in amg.levels:
        assert type(lv).__name__ == kind
        assert lv.smoother.name == "BLOCK_JACOBI"
