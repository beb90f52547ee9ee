"""The Krylov shell of amgx_tpu_torch against the JAX package's: the kernels
B6 (SpMV with the direction-update prologue and p'.Ap'), B7 (the CG
update with r'.r') and B4's x'.b epilogue, each as its plain PyTorch
twin (the CPU route) against the JAX package's XLA compose and its
Pallas kernel under the interpreter; then CG, PCG and PCGF with the
GEO-aggregation / JACOBI_L1 hierarchy, both krylov_fusion routes, in
float32 and float64.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import blas as jblas
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.ops import smooth as fused
from amgx_tpu.ops.spmv import _spmv_pdot_xla

import amgx_tpu_torch as pt
from amgx_tpu_torch.ops import cuda_krylov as KK
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops.smooth import build_transfer_tables
from amgx_tpu_torch.solvers import base as pbase

from _torch_util import geo_agg, grid_operator, rel, vectors
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

GRIDS = [(8, 8, 8), (13, 9, 7)]
# one pass of float32 arithmetic summed in another order (the dots over
# n terms) against XLA's; float64 likewise
TOL = {np.float32: 1e-6, np.float64: 1e-12}
PCG_CFG = ("solver={solver}, max_iters=80, monitor_residual=1,"
           " tolerance=1e-8, convergence=RELATIVE_INI, norm=L2,"
           " preconditioner(amg)=AMG, amg:algorithm=AGGREGATION,"
           " amg:selector=GEO, amg:smoother=JACOBI_L1,"
           " amg:relaxation_factor=0.75, amg:presweeps=1,"
           " amg:postsweeps=2, amg:max_iters=1, amg:cycle=V,"
           " amg:max_levels=10, amg:min_coarse_rows=32,"
           " krylov_fusion={fusion}")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vecs(shape, dtype):
    Aj, Ap = grid_operator(shape, dtype)
    rng = np.random.default_rng(7)
    v = [rng.standard_normal(Aj.num_rows).astype(dtype) for _ in range(4)]
    return Aj, Ap, v, dtype(0.37)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", GRIDS)
def test_b6_plain_matches_xla_compose(shape, dtype):
    Aj, Ap, (p, z, _, _), beta = _vecs(shape, dtype)
    want = _spmv_pdot_xla(Aj, jnp.asarray(p), jnp.asarray(z),
                          jnp.asarray(beta))
    got = KK.dia_spmv_dot(Ap.dia_vals, Ap.dia_offsets, _t(p), _t(z),
                          torch.tensor(beta))
    for g, w in zip(got, want):
        assert rel(g, w) < TOL[dtype]


@pytest.mark.parametrize("shape", GRIDS)
def test_b6_plain_matches_pallas_kernel(shape):
    Aj, Ap, (p, z, _, _), beta = _vecs(shape, np.float32)
    with ps.force_pallas_interpret():
        want = ps.dia_spmv_dot(Aj, jnp.asarray(p), z=jnp.asarray(z),
                               beta=jnp.asarray(beta))
    got = KK.dia_spmv_dot(Ap.dia_vals, Ap.dia_offsets, _t(p), _t(z),
                          torch.tensor(beta))
    for g, w in zip(got, want):
        assert rel(g, w) < TOL[np.float32]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", GRIDS)
def test_b7_plain_matches_xla_compose(shape, dtype):
    _, _, (x, p, r, ap), alpha = _vecs(shape, dtype)
    want = jblas.cg_update(*(jnp.asarray(v) for v in (x, p, r, ap)),
                           jnp.asarray(alpha))
    got = KK.cg_update(_t(x), _t(p), _t(r), _t(ap), torch.tensor(alpha))
    for g, w in zip(got, want):
        assert rel(g, w) < TOL[dtype]


@pytest.mark.parametrize("shape", GRIDS)
def test_b7_plain_matches_pallas_kernel(shape):
    _, _, (x, p, r, ap), alpha = _vecs(shape, np.float32)
    want = ps._cg_update_call(*(jnp.asarray(v) for v in (x, p, r, ap)),
                              jnp.asarray(alpha), interpret=True)
    got = KK.cg_update(_t(x), _t(p), _t(r), _t(ap), torch.tensor(alpha))
    for g, w in zip(got, want):
        assert rel(g, w) < TOL[np.float32]


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("with_dinv", [False, True])
def test_b4_dot_epilogue_matches_pallas_kernel(shape, with_dinv):
    """x' to 1e-6 (three damped float32 steps), and x'.b to 1e-5 (a sum
    of n products of x' in another order)."""
    Aj, Ap = grid_operator(shape, np.float32)
    agg, nc = geo_agg(shape)
    b, x, dinv, xc = vectors(Aj.num_rows, nc, np.float32)
    dinv = dinv if with_dinv else None
    taus = np.full(3, 0.75, np.float32)
    jd = None if dinv is None else jnp.asarray(dinv)
    with ps.force_pallas_interpret():
        slabs = fused.build_fused_slabs(Aj, jd)
        jxfer = fused.build_transfer_slabs(Aj, agg, nc)
        xj, dj = fused.fused_corr_smooth(
            {"A": Aj, "fused": slabs}, jnp.asarray(b), jnp.asarray(x),
            jnp.asarray(xc), jnp.asarray(taus), jxfer, dinv=jd,
            want_dot=True)
    xfer = build_transfer_tables(Ap, torch.from_numpy(agg), nc)
    xp, dp = K.dia_prolong_smooth(Ap.dia_vals, Ap.dia_offsets, _t(taus),
                                  _t(b), _t(x), _t(xc), xfer["agg"],
                                  None if dinv is None else _t(dinv),
                                  with_dot=True)
    assert rel(xp, xj) < 1e-6
    assert abs(float(dp) - float(dj)) <= 1e-5 * abs(float(dj))


# ---------------------------------------------------------------------------
# CG / PCG / PCGF end to end
# ---------------------------------------------------------------------------


def _solve_pair(solver, fusion, dtype):
    """The same 16^3 system in both packages; the JAX package's kernels
    under the interpreter when the port's route is fused (float32,
    krylov_fusion=1), its plain route otherwise."""
    cfg = PCG_CFG.format(solver=solver, fusion=fusion)
    b = np.ones(16 ** 3, dtype)

    def jax_solve():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", 16, 16, 16, dtype=dtype).init())
        return js.solve(b)

    if fusion and dtype == np.float32:
        with ps.force_pallas_interpret():
            rj = jax_solve()
    else:
        rj = jax_solve()
    ptd = getattr(torch, np.dtype(dtype).name)
    slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    slv.setup(pt.gallery.poisson("7pt", 16, 16, 16, dtype=ptd, device="cpu"))
    rp = slv.solve(torch.from_numpy(b))
    return rj, rp


# f32: two implementations stop at the same iteration of a 1e-8 relative
# residual; their iterates differ by float32 rounding grown over ~20
# iterations. f64: the same arithmetic to rounding.
X_TOL = {np.float32: 1e-4, np.float64: 1e-10}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fusion", [1, 0])
@pytest.mark.parametrize("solver", ["CG", "PCG", "PCGF"])
def test_cg_family_matches_jax(solver, fusion, dtype):
    rj, rp = _solve_pair(solver, fusion, dtype)
    assert rp.status == rj.status == "success"
    assert rp.iterations == int(rj.iterations)
    assert rp.x.dtype == getattr(torch, np.dtype(dtype).name)
    assert rel(rp.x, np.asarray(rj.x)) < X_TOL[dtype]


@pytest.mark.parametrize("fusion", [1, 0])
def test_pcg_meets_the_host_once_per_iteration(monkeypatch, fusion):
    """The monitored norm (with the breakdown flag) is the only value a
    PCG iteration moves to the host: one transfer per iteration plus the
    initial norm."""
    calls = []
    real = pbase._host
    monkeypatch.setattr(pbase, "_host",
                        lambda t: calls.append(1) or real(t))
    cfg = PCG_CFG.format(solver="PCG", fusion=fusion)
    slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    slv.setup(pt.gallery.poisson("7pt", 8, 8, 8, dtype=torch.float32,
                                 device="cpu"))
    res = slv.solve(torch.ones(512, dtype=torch.float32))
    assert res.status == "success"
    assert len(calls) == res.iterations + 1


def test_fused_pcg_runs_the_shell_kernels(monkeypatch):
    """krylov_fusion=1 routes every iteration through B6 and B7 and takes
    r.z from the cycle (the whole 8^3 cycle is one tail); =0 through
    none of them."""
    seen = []
    for mod, name in ((KK, "dia_spmv_dot"), (KK, "cg_update")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            seen.append(_n) or _r(*a, **k))
    for fusion in (1, 0):
        seen.clear()
        cfg = PCG_CFG.format(solver="PCG", fusion=fusion)
        slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
        slv.setup(pt.gallery.poisson("7pt", 8, 8, 8, dtype=torch.float32,
                                     device="cpu"))
        res = slv.solve(torch.ones(512, dtype=torch.float32))
        n = res.iterations
        want = 2 * n if fusion else 0
        assert len(seen) == want
        assert seen.count("dia_spmv_dot") == (n if fusion else 0)
