"""Matrix-free GEO levels in amgx_tpu_torch (ops/stencil.py, the
coefficient mode of B2-B5) against the JAX package's
amgx_tpu/ops/stencil.py on the same inputs.

The detector, the materialized slab, the plain masked forms (the CPU
route and the coefficient-mode kernels' plain versions: held to the JAX
package's XLA forms and, bit for bit, to the port's own slab forms on
the same level), B5's plain twin with matrix-free levels, the
hierarchy's `matrix_free` routing, one cycle against the JAX package's
coefficient-mode Pallas kernels in interpret mode (its stencils handed
to the port through interop), and whole FLAGSHIP and PCG solves with
`matrix_free=1` in both packages. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.amg.cycles import run_cycle_dot
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as jps
from amgx_tpu.ops import stencil as jst
from amgx_tpu.presets import FLAGSHIP as JAX_FLAGSHIP

import amgx_tpu_torch as pt
from amgx_tpu_torch.amg.aggregation.galerkin import (geo_assemble_dia,
                                                     geo_coarse_values)
from amgx_tpu_torch.interop import hierarchy_from_numpy
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import cuda_tail as T
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.ops.smooth import _tail_plan, build_transfer_tables
from amgx_tpu_torch.presets import FLAGSHIP
from amgx_tpu_torch.solvers.polynomial import chebyshev_poly_coeffs
from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                               safe_recip)

from _torch_util import geo_agg, grid_operator, jax_hierarchy_arrays, rel

# f32 kernel math in two implementations (ROADMAP.md): 1e-6
TOL32 = 1e-6
# one cycle through a few levels of dependent f32 steps, and whole
# solves: as tests/test_torch_tail.py and tests/test_torch_flagship.py
CYCLE_TOL = 1e-5
X_TOL = 1e-5
AMG_CFG = ("solver=AMG, algorithm=AGGREGATION, selector=GEO,"
           " smoother={smoother}, relaxation_factor=0.75, presweeps=1,"
           " postsweeps=2, max_iters=1, cycle={cycle}, max_levels=10,"
           " min_coarse_rows=32, matrix_free={mf}{extra}")
PCG16 = ("solver=PCG, max_iters=80, monitor_residual=1, tolerance=1e-8,"
         " convergence=RELATIVE_INI, norm=L2, preconditioner(amg)=AMG,"
         " amg:algorithm=AGGREGATION, amg:selector=GEO,"
         " amg:smoother=JACOBI_L1, amg:relaxation_factor=0.75,"
         " amg:presweeps=1, amg:postsweeps=2, amg:max_iters=1,"
         " amg:cycle=V, amg:max_levels=10, amg:min_coarse_rows=32,"
         " krylov_fusion=1, amg:matrix_free=1")


def _poisson(shape):
    """The 7-pt operator on `shape` in float32: (JAX, port)."""
    return (jx.gallery.poisson("7pt", *shape, dtype=np.float32).init(),
            pt.gallery.poisson("7pt", *shape, dtype=torch.float32,
                               device="cpu").init())


def _geo_coarse(shape):
    """The GEO Galerkin coarse operator of the 7-pt operator on `shape`
    (2x2x2 aggregates), built by the port: (JAX, port) from the same CSR
    arrays."""
    _, Ap = _poisson(shape)
    cshape = tuple((e + 1) // 2 for e in shape)
    cvals, coffs = geo_coarse_values(Ap, shape, (0, 1, 2), cshape)
    Ac = geo_assemble_dia(cvals, coffs, cshape)
    n = Ac.num_rows
    Aj = jx.CsrMatrix.from_scipy_like(
        Ac.row_offsets.numpy(), Ac.col_indices.numpy(), Ac.values.numpy(),
        n, n)
    Aj = dataclasses.replace(Aj, grid_shape=cshape).init()
    return Aj, Ac


OPERATORS = {"poisson_12^3": lambda: _poisson((12, 12, 12)),
             "geo_coarse_of_12^3": lambda: _geo_coarse((12, 12, 12))}


# ---------------------------------------------------------------------------
# detection and materialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dinv_mode", [None, "l1"])
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_detect_stencil_matches_jax(op, dinv_mode):
    Aj, Ap = OPERATORS[op]()
    sj = jst.detect_stencil(Aj, dinv_mode=dinv_mode)
    sp = mf.detect_stencil(Ap, dinv_mode=dinv_mode)
    assert sj is not None and sp is not None
    assert sp.spec() == tuple(sj.spec())
    assert np.array_equal(sp.coeffs.numpy(), np.asarray(sj.coeffs))
    assert sp.host == tuple(float(c) for c in np.asarray(sj.coeffs))


@pytest.mark.parametrize("case", ["variable_coefficients", "no_grid"])
def test_detect_stencil_rejects(case):
    if case == "variable_coefficients":
        Aj, Ap = grid_operator((8, 8, 8))
    else:
        Aj, Ap = _poisson((8, 8, 8))
        Aj = dataclasses.replace(Aj, grid_shape=None)
        Ap = dataclasses.replace(Ap, grid_shape=None)
    assert jst.detect_stencil(Aj) is None
    assert mf.detect_stencil(Ap) is None


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_stencil_matrix_is_the_slab(op):
    _, Ap = OPERATORS[op]()
    st = mf.detect_stencil(Ap)
    slim = mf.mf_slim(Ap)
    assert slim.dia_vals is None and mf.mf_slim(Ap) is slim
    assert torch.equal(mf.stencil_matrix(slim, st).dia_vals, Ap.dia_vals)
    assert torch.equal(mf.level_operator({"A": slim, "stencil": st}
                                         ).dia_vals, Ap.dia_vals)


# ---------------------------------------------------------------------------
# the plain masked forms (B2-mf, B3-mf, B4-mf on the CPU)
# ---------------------------------------------------------------------------

SHAPE = (9, 7, 5)       # ragged: every axis's edges in every mask
TAUS = (chebyshev_poly_coeffs(2) / 12.0).astype(np.float32)


def _slab_dinv(A, mode):
    if mode is None:
        return None
    return safe_recip(A.diagonal() if mode == "jacobi"
                      else l1_strengthened_diag(A))


@pytest.mark.parametrize("dinv_mode", [None, "jacobi", "l1"])
@pytest.mark.parametrize("kind", ["smooth", "smooth_residual", "restrict",
                                  "corr", "corr_dot"])
def test_plain_forms_match_jax_and_the_slab(kind, dinv_mode):
    Aj, Ap = _poisson(SHAPE)
    sj = jst.detect_stencil(Aj, dinv_mode=dinv_mode)
    sp = mf.detect_stencil(Ap, dinv_mode=dinv_mode)
    agg, nc = geo_agg(SHAPE)
    xfer = build_transfer_tables(Ap, torch.from_numpy(agg), nc)
    rng = np.random.default_rng(5)
    n = Ap.num_rows
    b, x = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    xc = rng.standard_normal(nc).astype(np.float32)
    tb, tx, txc, tt = (torch.from_numpy(v) for v in (b, x, xc, TAUS))
    vals, offs = Ap.dia_vals, Ap.dia_offsets
    dinv = _slab_dinv(Ap, dinv_mode)
    spec, c = sj.spec(), sj.coeffs
    jt, jb, jx_ = jnp.asarray(TAUS), jnp.asarray(b), jnp.asarray(x)
    if kind in ("smooth", "smooth_residual"):
        wr = kind == "smooth_residual"
        got = K.dia_smooth_mf(sp, tt, tb, tx, with_residual=wr)
        slab = K.dia_smooth_plain(vals, offs, tt, tb, tx, dinv, wr)
        want = jst._xla_smooth(spec, c, jt, jb, jx_, wr)
    elif kind == "restrict":
        got = K.dia_smooth_restrict_mf(sp, tt, tb, tx, xfer["ctab"])
        slab = K.dia_smooth_restrict_plain(vals, offs, tt, tb, tx,
                                           xfer["ctab"], dinv)
        ctab = jnp.asarray(xfer["ctab"].numpy())[:, :, None]
        want = jst._xla_restrict(spec, c, jt, jb, jx_, ctab, nc)
    else:
        dot = kind == "corr_dot"
        got = K.dia_prolong_smooth_mf(sp, tt, tb, tx, txc, xfer["agg"],
                                      with_dot=dot)
        slab = K.dia_prolong_smooth_plain(vals, offs, tt, tb, tx, txc,
                                          xfer["agg"], dinv, with_dot=dot)
        want = jst._xla_corr(spec, c, jt, jb, jx_, jnp.asarray(xc),
                             jnp.asarray(agg))
        if dot:
            want = (want, jst._xb_dot(want, jb))
    got, slab, want = (v if isinstance(v, tuple) else (v,)
                       for v in (got, slab, want))
    for g, s, w in zip(got, slab, want):
        assert torch.equal(g, s)
        w = np.asarray(w)
        assert float(np.max(np.abs(g.numpy() - w))) <= \
            TOL32 * max(float(np.max(np.abs(w))), 1.0)


def test_fast_div_constants():
    """The multiply-high constants the coefficient kernels divide row
    indices by the grid extents with (csrc/common.cuh `FastDiv`): n // d
    for every row of a 128^3 grid and for the largest int32 indices."""
    n = np.concatenate([np.arange(1 << 21, dtype=np.uint64),
                        np.array([2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30 + 1],
                                 dtype=np.uint64)])
    for d in list(range(1, 17)) + [43, 61, 64, 97, 127, 128, 255, 4096,
                                   2 ** 20 + 7]:
        mul, shr = K.fast_div(d)
        q = n if mul == 0 else ((n * np.uint64(mul)) >> np.uint64(32)) \
            >> np.uint64(shr)
        assert mul < 2 ** 32 and np.array_equal(q, n // np.uint64(d)), d


def test_unported_coefficient_forms_raise():
    """B6's coefficient mode is not ported; the coefficient wrappers
    refuse any tensor that is not on the CPU (here the meta device) before
    a launch, so they never run the plain version there."""
    _, Ap = _poisson((4, 4, 4))
    st = mf.detect_stencil(Ap, dinv_mode="l1")
    p = torch.zeros(64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mf.stencil_spmv_pdot(st, p, p, torch.tensor(0.5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mf.stencil_spmv_ddot(st, p, p)
    m = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.dia_smooth_mf(st, torch.empty(2, device="meta"), m, m)
    with pytest.raises(ValueError, match="grid"):
        K.dia_smooth_mf(st, torch.empty(2, device="meta"),
                        torch.empty(63, device="meta"),
                        torch.empty(63, device="meta"))


# ---------------------------------------------------------------------------
# the hierarchy: routing and B5's plain twin
# ---------------------------------------------------------------------------


def _port_amg(smoother, cycle, n, mode, extra=""):
    cfg = pt.Config.from_string(AMG_CFG.format(
        smoother=smoother, cycle=cycle, mf=mode, extra=extra))
    slv = pt.create_solver(cfg, device="cpu")
    slv.setup(pt.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                                 device="cpu"))
    return slv.amg


@pytest.mark.parametrize("mode", ["1", "auto", "0"])
@pytest.mark.parametrize("smoother", ["CHEBYSHEV_POLY", "JACOBI_L1"])
def test_hierarchy_routing(smoother, mode):
    amg = _port_amg(smoother, "V", 12, mode)
    for lv, ld in zip(amg.levels, amg.solve_data()["levels"]):
        smd = ld["smoother"]
        if mode == "1":
            st = ld["stencil"]
            assert smd["stencil"] is st and st.shape == lv.A.grid_shape
            assert ld["A"].dia_vals is None and smd["A"] is ld["A"]
            assert "dinv" not in smd
            assert st.dinv_mode == (None if smoother == "CHEBYSHEV_POLY"
                                    else "l1")
            assert "matrix_free" in lv.supports_fusion(ld)
        else:
            assert "stencil" not in ld and "stencil" not in smd
            assert ld["A"] is lv.A and ld["A"].dia_vals is not None
            assert ("dinv" in smd) == (smoother == "JACOBI_L1")
            assert "matrix_free" not in lv.supports_fusion(ld)


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("smoother,cycle", [("CHEBYSHEV_POLY", "V"),
                                            ("JACOBI_L1", "V"),
                                            ("JACOBI_L1", "W")])
def test_tail_plain_twin_mf_levels_match_slab(smoother, cycle, with_dot):
    """B5's plain twin on the same 16^3 tail with matrix-free levels and
    with slab levels: the same bits."""
    rng = np.random.default_rng(9)
    b, x = (torch.from_numpy(rng.standard_normal(16 ** 3).astype(
        np.float32)) for _ in range(2))
    out = {}
    for mode in ("1", "0"):
        amg = _port_amg(smoother, cycle, 16, mode)
        spec, arrs = _tail_plan(amg, cycle, amg.solve_data(), 0, b)
        assert all((ls.mf is None) == (mode == "0") for ls in spec.levels)
        assert all((ar["vals"] is None) == (mode == "1")
                   for ar in arrs[:len(spec.levels)])
        out[mode] = T.dia_coarse_tail_plain(spec, arrs, b, x, with_dot)
    got, want = out["1"], out["0"]
    for g, w in zip(got if with_dot else (got,),
                    want if with_dot else (want,)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("smoother,with_dot", [("CHEBYSHEV_POLY", False),
                                               ("JACOBI_L1", True)])
def test_cycle_matches_jax_coefficient_kernels(monkeypatch, smoother,
                                               with_dot):
    """One V-cycle on 12^3 with matrix_free=1 and the tail entered at
    level 1: the JAX package's coefficient-mode Pallas kernels (B3-mf,
    B4-mf on level 0, B5-mf below) in interpret mode against the port's
    plain versions, on the stencils the JAX package detected (handed over
    through interop)."""
    cfg = AMG_CFG.format(smoother=smoother, cycle="V", mf="1",
                         extra=", cycle_fusion_tail_rows=300")
    with jps.force_pallas_interpret():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", 12, 12, 12,
                                    dtype=np.float32).init())
        levels, coarse = jax_hierarchy_arrays(js)
    assert all(d["stencil"] is not None for d in levels)
    amg = hierarchy_from_numpy(levels, coarse, pt.Config.from_string(cfg),
                               device="cpu")
    rng = np.random.default_rng(3)
    b, x = (rng.standard_normal(12 ** 3).astype(np.float32)
            for _ in range(2))
    with jps.force_pallas_interpret():
        jd = js.solve_data()["amg"]
        xj, dj = run_cycle_dot(js.amg, "V", jd, jnp.asarray(b),
                               jnp.asarray(x))
    seen = []
    real = T.dia_coarse_tail

    def spy(spec, arrs, b_, x_, with_dot=False):
        seen.append(spec)
        return real(spec, arrs, b_, x_, with_dot)

    monkeypatch.setattr(T, "dia_coarse_tail", spy)
    data = amg.solve_data()
    assert all("stencil" in ld for ld in data["levels"])
    tb, tx = torch.from_numpy(b), torch.from_numpy(x)
    if with_dot:
        xp, dp = amg.cycle_dot(data, tb, tx)
        assert abs(float(dp) - float(dj)) <= CYCLE_TOL * abs(float(dj))
    else:
        xp = amg.cycle(data, tb, tx)
    assert [s.levels[0].n for s in seen] == [amg.levels[1].A.num_rows]
    assert all(ls.mf is not None for ls in seen[0].levels)
    assert rel(xp, xj) < CYCLE_TOL


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", ["flagship", "pcg"])
def test_solve_matches_jax(config):
    """FLAGSHIP and PCG + GEO + JACOBI_L1 at 16^3 with matrix_free=1 in
    both packages: the same status and iterations, x within X_TOL; the
    port's solve equals its own slab solve bit for bit."""
    n = 16
    if config == "flagship":
        cfg, dt, tdt = FLAGSHIP + ", amg:matrix_free=1", np.float64, \
            torch.float64
        assert FLAGSHIP == JAX_FLAGSHIP
    else:
        cfg, dt, tdt = PCG16, np.float32, torch.float32
    js = jx.create_solver(JaxConfig.from_string(cfg))
    js.setup(jx.gallery.poisson("7pt", n, n, n, dtype=dt).init())
    rj = js.solve(np.ones(n ** 3, dt))
    out = []
    for c in (cfg, cfg.replace("amg:matrix_free=1", "amg:matrix_free=0")):
        ps_ = pt.create_solver(pt.Config.from_string(c), device="cpu")
        ps_.setup(pt.gallery.poisson("7pt", n, n, n, dtype=tdt,
                                     device="cpu"))
        out.append(ps_.solve(torch.ones(n ** 3, dtype=tdt)))
    rp, rs = out
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL
    assert torch.equal(rp.x, rs.x) and rp.iterations == rs.iterations
