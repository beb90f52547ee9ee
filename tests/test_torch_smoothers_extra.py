"""Item 8's smoothers of amgx_tpu_torch against the JAX package's, on the
CPU: POLYNOMIAL, KPZ_POLYNOMIAL, KACZMARZ (colored and naive), GS (and
its L1 variant), MULTICOLOR_ILU (sparsity levels 0 and 1) and CF_JACOBI.

- one sweep of each from the same x and b, on the same random-valued
  7-pt operator set up by each package: within 1e-12 in float64 and
  1e-6 in float32 (K6's plain twin is GS's CPU route);
- MULTICOLOR_ILU's factors L, U and u_diag within 1e-12 (float64); level
  1 fill without a distance-2 coloring raises in both packages;
- the JAX tests' solves (tests/test_smoothers_extra.py,
  tests/test_multicolor.py's standalone ILU / GS and CF_JACOBI under a
  classical PCG): the same status and iterations;
- one V-cycle of the port on the JAX package's hierarchy with each new
  smoother (interop.py carries its setup) within 1e-12.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.amg.classical.selectors import pmis_split as jx_pmis
from amgx_tpu.amg.classical.strength import AhatStrength as JaxAhat
from amgx_tpu.errors import BadParametersError as JaxBadParameters
from amgx_tpu.solvers.base import make_solver as jx_make_solver

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch.errors import BadParametersError
from amgx_tpu_torch.ops.gs import gs_sweep
from amgx_tpu_torch.solvers.base import make_solver as pt_make_solver

from _torch_util import grid_operator, jax_hierarchy_arrays, rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

SHAPE = (7, 5, 9)
TOL = {np.float64: 1e-12, np.float32: 1e-6}
# name -> (solver, extra config)
SWEEPS = {
    "POLYNOMIAL": ("POLYNOMIAL", ""),
    "KPZ_POLYNOMIAL": ("KPZ_POLYNOMIAL", ", kpz_order=4"),
    "KACZMARZ": ("KACZMARZ", ""),
    "KACZMARZ_naive": ("KACZMARZ", ", kaczmarz_coloring_needed=0"),
    "GS": ("GS", ""),
    "GS_L1": ("GS", ", GS_L1_variant=1"),
    "MULTICOLOR_ILU": ("MULTICOLOR_ILU", ""),
    "MULTICOLOR_ILU_1": ("MULTICOLOR_ILU", ", ilu_sparsity_level=1,"
                         " coloring_level=2"),
    "CF_JACOBI": ("CF_JACOBI", ""),
    "CF_JACOBI_FC": ("CF_JACOBI", ", cf_smoothing_mode=1"),
}


@functools.lru_cache(maxsize=None)
def _setup_pair(key, dtype, jax_dtype=None):
    """Both packages' smoother set up on the random-valued operator in
    `dtype` (the JAX package's on its values in `jax_dtype` when given),
    made once per module."""
    name, extra = SWEEPS[key]
    Aj, Ap = grid_operator(SHAPE, dtype, seed=7)
    if jax_dtype is not None:
        Aj = jx.CsrMatrix.from_scipy_like(
            np.asarray(Aj.row_offsets), np.asarray(Aj.col_indices),
            np.asarray(Aj.values, jax_dtype), Aj.num_rows,
            Aj.num_cols).init()
    text = f"solver(s)={name}, s:relaxation_factor=0.8" + \
        extra.replace(", ", ", s:")
    js = jx_make_solver(name, jx.Config.from_string(text), "s")
    ps = pt_make_solver(name, pt.Config.from_string(text), "s", "cpu")
    if name == "CF_JACOBI":
        A64 = grid_operator(SHAPE, np.float64, seed=7)[0]
        cf = np.array(jx_pmis(A64, JaxAhat(jx.Config.from_string(
            "strength_threshold=0.25"), "default").strong_mask(A64)))
        js.set_cf_map(cf)
        ps.set_cf_map(torch.from_numpy(cf))
    js.setup(Aj)
    ps.setup(Ap)
    return js, ps, Aj, Ap


def _jax_sweep(js, b, x):
    """One JAX solve_iteration, its host-built solve data as jax arrays
    (as the JAX package's solve loop passes them)."""
    data = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in js.solve_data().items()}
    return np.asarray(js.solve_iteration(data, jnp.asarray(b),
                                         {"x": jnp.asarray(x)})["x"],
                      np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("key", list(SWEEPS))
def test_one_sweep_matches_jax(key, dtype):
    """A float32 ILU(1) is held against the JAX package's float64 sweep
    on the same values: the JAX package's level-1 fill is float64, which
    turns its float32 sweep's state float64 and fails its loop."""
    ref64 = key == "MULTICOLOR_ILU_1" and dtype == np.float32
    js, ps, Aj, Ap = _setup_pair(key, dtype, np.float64 if ref64 else None)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(Ap.num_rows).astype(dtype)
    b = rng.standard_normal(Ap.num_rows).astype(dtype)
    jdt = np.float64 if ref64 else dtype
    want = _jax_sweep(js, b.astype(jdt), x.astype(jdt))
    st = ps.solve_iteration(ps.solve_data(), torch.from_numpy(b),
                            {"x": torch.from_numpy(x)})
    assert st["x"].dtype == torch.from_numpy(x).dtype
    assert rel(st["x"], want) < TOL[dtype]


@pytest.mark.parametrize("key", ["MULTICOLOR_ILU", "MULTICOLOR_ILU_1"])
def test_ilu_factors_match_jax(key):
    js, ps, _, _ = _setup_pair(key, np.float64)
    for mp, mj in ((ps._Lp, js._Lp), (ps._Up, js._Up)):
        assert mp.dia_offsets is None
        assert np.array_equal(mp.row_offsets.numpy(),
                              np.asarray(mj.row_offsets))
        assert np.array_equal(mp.col_indices.numpy(),
                              np.asarray(mj.col_indices))
        assert rel(mp.values, np.asarray(mj.values)) < 1e-12
    assert rel(ps._u_diag, np.asarray(js._u_diag)) < 1e-12


def test_ilu_fill_needs_a_distance2_coloring():
    Aj, Ap = grid_operator(SHAPE, np.float64, seed=7)
    text = "solver(s)=MULTICOLOR_ILU, s:ilu_sparsity_level=1"
    with pytest.raises(JaxBadParameters, match="coloring_level=2"):
        jx_make_solver("MULTICOLOR_ILU", jx.Config.from_string(text),
                       "s").setup(Aj)
    with pytest.raises(BadParametersError, match="coloring_level=2"):
        pt_make_solver("MULTICOLOR_ILU", pt.Config.from_string(text), "s",
                       "cpu").setup(Ap)


def test_gs_plain_twin_matches_jax_row_loop():
    """K6's plain twin against the JAX package's fori_loop sweep on a
    random-valued operator, float64 and float32."""
    for dtype in (np.float64, np.float32):
        js, ps, Aj, Ap = _setup_pair("GS_L1", dtype)
        x = np.random.default_rng(2).standard_normal(Ap.num_rows).astype(
            dtype)
        b = np.ones(Ap.num_rows, dtype)
        d = ps.solve_data()
        got = gs_sweep(Ap.row_offsets, Ap.col_indices, Ap.values,
                       torch.from_numpy(b), d["gs_diag"], d["dinv"],
                       torch.from_numpy(x), 0.8)
        assert rel(got, _jax_sweep(js, b, x)) < TOL[dtype]


def _solve_pair(text, Aj, Ap, b):
    js = jx.create_solver(jx.Config.from_string(text))
    js.setup(Aj)
    rj = js.solve(b)
    ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
    ps.setup(Ap)
    rp = ps.solve(torch.from_numpy(np.asarray(b, np.float64)))
    return rj, rp


@pytest.mark.parametrize("name", ["POLYNOMIAL", "KPZ_POLYNOMIAL",
                                  "CHEBYSHEV_POLY", "KACZMARZ"])
def test_amg_smoother_solves_match_jax(name):
    """tests/test_smoothers_extra.py: the smoother standalone (30
    iterations) and inside AGGREGATION SIZE_2 AMG (2 + 2 sweeps)."""
    Aj = jx.gallery.poisson("5pt", 16, 16).init()
    Ap = pt.gallery.poisson("5pt", 16, 16, device="cpu").init()
    b = np.ones(Aj.num_rows)
    for text in (f"solver={name}, max_iters=30, monitor_residual=1, "
                 "tolerance=1e-12, convergence=RELATIVE_INI_CORE",
                 "solver=AMG, algorithm=AGGREGATION, selector=SIZE_2, "
                 f"smoother={name}, presweeps=2, postsweeps=2, max_iters=60,"
                 " tolerance=1e-8, monitor_residual=1, "
                 "convergence=RELATIVE_INI_CORE"):
        rj, rp = _solve_pair(text, Aj, Ap, b)
        assert rp.status == rj.status
        assert rp.iterations == int(rj.iterations)
        assert rel(rp.x, np.asarray(rj.x)) < 1e-9


def test_kaczmarz_naive_solve_matches_jax():
    Aj = jx.gallery.poisson("5pt", 16, 16).init()
    Ap = pt.gallery.poisson("5pt", 16, 16, device="cpu").init()
    text = ("solver=KACZMARZ, kaczmarz_coloring_needed=0, max_iters=50, "
            "monitor_residual=1, tolerance=1e-12, "
            "convergence=RELATIVE_INI_CORE")
    rj, rp = _solve_pair(text, Aj, Ap, np.ones(Aj.num_rows))
    assert rp.status == rj.status and rp.iterations == int(rj.iterations)
    assert rel(rp.x, np.asarray(rj.x)) < 1e-12


@pytest.mark.parametrize("name", ["MULTICOLOR_ILU", "GS"])
def test_standalone_smoother_solves_match_jax(name):
    """tests/test_multicolor.py:98-115: the smoother alone on the 5-pt
    10^2 Poisson to 1e-8, x_true from a seed."""
    Aj = jx.gallery.poisson("5pt", 10, 10).init()
    Ap = pt.gallery.poisson("5pt", 10, 10, device="cpu").init()
    x_true = np.random.default_rng(0).standard_normal(Aj.num_rows)
    b = np.asarray(jx.ops.spmv(Aj, x_true))
    text = (f"solver={name}, max_iters=500, monitor_residual=1, "
            "tolerance=1e-8, relaxation_factor=0.9")
    rj, rp = _solve_pair(text, Aj, Ap, b)
    assert rp.status == rj.status == "success"
    assert rp.iterations == int(rj.iterations)
    assert rel(rp.x, x_true) < 1e-5


def test_cf_jacobi_under_classical_pcg_matches_jax():
    """tests/test_multicolor.py:249-265: PCG with a classical AMG whose
    smoother is CF_JACOBI (the hierarchy hands it each level's split)."""
    Aj = jx.gallery.poisson("5pt", 24, 24).init()
    Ap = pt.gallery.poisson("5pt", 24, 24, device="cpu").init()
    text = ("solver=PCG, max_iters=60, monitor_residual=1, tolerance=1e-8,"
            " preconditioner(amg)=AMG, amg:algorithm=CLASSICAL,"
            " amg:smoother=CF_JACOBI, amg:max_iters=1, amg:cycle=V,"
            " amg:relaxation_factor=0.9")
    rj, rp = _solve_pair(text, Aj, Ap, np.ones(Aj.num_rows))
    assert rp.status == rj.status == "success"
    assert rp.iterations == int(rj.iterations)
    for lv in rp_levels(text, Ap):
        assert torch.equal(lv.smoother.cf_map, lv.cf_map)


def rp_levels(text, Ap):
    ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
    ps.setup(Ap)
    return ps.preconditioner.amg.levels


@pytest.mark.parametrize("key", ["POLYNOMIAL", "KPZ_POLYNOMIAL", "KACZMARZ",
                                 "GS", "MULTICOLOR_ILU", "CF_JACOBI"])
def test_vcycle_on_the_jax_hierarchy(key):
    name, extra = SWEEPS[key]
    algo = "CLASSICAL" if name == "CF_JACOBI" else \
        "AGGREGATION, amg:selector=SIZE_2"
    cfg = (f"solver(amg)=AMG, amg:algorithm={algo}, amg:smoother={name},"
           " amg:presweeps=1, amg:postsweeps=2, amg:max_iters=1,"
           " amg:max_levels=2, amg:relaxation_factor=0.9,"
           " amg:cycle_fusion=0" + extra.replace(", ", ", amg:"))
    Aj, Ap = grid_operator(SHAPE, np.float64, seed=4)
    js = jx.create_solver(jx.Config.from_string(cfg))
    js.setup(Aj)
    levels, coarse = jax_hierarchy_arrays(js)
    amg = pti.hierarchy_from_numpy(levels, coarse, pt.Config.from_string(cfg),
                                   "amg", device="cpu")
    b = np.random.default_rng(6).standard_normal(Ap.num_rows)
    xj = js.solve(b).x
    xp = amg.cycle(amg.solve_data(), torch.from_numpy(b),
                   torch.zeros(Ap.num_rows, dtype=torch.float64))
    assert rel(xp, np.asarray(xj)) < 1e-12
