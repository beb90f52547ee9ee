"""Classical PMIS/D2 AMG in amgx_tpu_torch against the JAX package, on
the CPU: strength, PMIS, D2 with truncation and the transpose on the
level-0 operators of a 7-pt 16^3 and a 9-pt 20^2 grid; the whole
16^3 hierarchy; the unstructured SpMV / sweep (B8, B9) and the weighted
transfer rows of B3/B4 through their plain twins; `amg_precision=float`;
and bench.py's `_classical_cfg` (PCG f64 around an f32 classical cycle),
also with its cycle in bfloat16. CLASSICAL_REFINEMENT, the slice's
second solve, is in test_torch_classical_refinement.py; the bf16 forms
of B9, B8, B3w and B4w in test_torch_bf16_hierarchies.py.

The JAX side runs as its own tests run it: its default host setup, its
Pallas kernels under the interpreter where a kernel is compared.
"""
import ast
import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.amg.hierarchy import AMG as JaxAMG
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.ops import pallas_swell as psw
from amgx_tpu.ops import smooth as jfused

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch.amg.hierarchy import AMG
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops import cuda_csr, cuda_spmv
from amgx_tpu_torch.ops.smooth import build_csr_transfer_tables

from _torch_util import csr_arrays, jax_hierarchy_arrays, rel
from chip_smoke import CLASSICAL, classical_refinement
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

# bench.py's `_classical_cfg("JACOBI_L1")` and CLASSICAL_REFINEMENT
# (FLAGSHIP's REFINEMENT + FGMRES around its AMG block, without
# amg_precision, set up on the device), defined once in chip_smoke.py
CLASSICAL_REFINEMENT = classical_refinement()
AMG_BLOCK = CLASSICAL[CLASSICAL.index("amg:algorithm"):]
# the AMG block alone, in the default scope
LEVEL_CFG = AMG_BLOCK.replace("amg:", "").replace(
    ", amg_precision=float", "")
GRIDS = {"7pt_16^3": ("7pt", (16, 16, 16)), "9pt_20^2": ("9pt", (20, 20, 1))}
# f64: the same arithmetic; coarse levels add their Galerkin sums in
# another order than numpy's reduceat (ulps)
TOL64 = 1e-12
# f32: one rounding per operation, chains of a few dependent steps
TOL32 = 1e-6
# damped-sweep chains through B3/B4 (two steps, a residual through A)
TOL_CHAIN = 1e-5
# solves: both stop at a 1e-8 residual; the two f32 cycles round
# differently, which the condition number turns into at most ~1e-6 in x
X_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _csr_equal(mj, mp):
    return (np.array_equal(np.asarray(mj.row_offsets),
                           mp.row_offsets.numpy())
            and np.array_equal(np.asarray(mj.col_indices),
                               mp.col_indices.numpy()))


@functools.lru_cache(maxsize=None)
def _hierarchy_pair(grid):
    """The JAX package's and the port's hierarchies of one grid, f64,
    built once per test process (the level tests and the kernel tests
    share the 7-pt 16^3 pair)."""
    pts, shape = GRIDS[grid]
    ja = JaxAMG(JaxConfig.from_string(LEVEL_CFG)).setup(
        jx.gallery.poisson(pts, *shape).init())
    pa = AMG(Config.from_string(LEVEL_CFG)).setup(
        pt.gallery.poisson(pts, *shape, device="cpu"))
    return ja, pa


@pytest.fixture(scope="module", params=sorted(GRIDS))
def hierarchies(request):
    """The JAX package's and the port's hierarchies of one grid, f64."""
    return (request.param,) + _hierarchy_pair(request.param)


def test_level0_strength_split_interpolation(hierarchies):
    """Identical strong mask, CF split, P and R patterns at level 0; P's
    values within 1e-12 (the same D2 arithmetic in the same order)."""
    _, ja, pa = hierarchies
    lj, lp = ja.levels[0], pa.levels[0]
    assert np.array_equal(np.asarray(lj.strong), lp.strong.numpy())
    assert np.array_equal(np.asarray(lj.cf_map), lp.cf_map.numpy())
    assert lj.coarse_size == lp.coarse_size
    for name in ("P", "R"):
        mj, mp = getattr(lj, name), getattr(lp, name)
        assert _csr_equal(mj, mp), name
        assert np.abs(np.asarray(mj.values) - mp.values.numpy()).max() \
            <= TOL64


def test_classical_string_is_the_bench_literal():
    """CLASSICAL is bench.py's `_classical_cfg("JACOBI_L1")`, read from
    bench.py's source (importing bench.py would reconfigure JAX in this
    process)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(node for node in ast.walk(tree)
              if isinstance(node, ast.FunctionDef)
              and node.name == "_classical_cfg")
    call = next(node for node in ast.walk(fn)
                if isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "from_string")
    literal = eval(compile(ast.Expression(call.args[0]), path, "eval"),
                   {"smoother": "JACOBI_L1", "extra": ""})
    assert CLASSICAL == literal


def test_hierarchy_parity(hierarchies):
    """tests/test_setup_device.py's parity contract: the same level row
    counts, CF splits and operator patterns at every level, operators
    within 1e-10."""
    _, ja, pa = hierarchies
    rows_j = [lv.A.num_rows for lv in ja.levels] + [ja.coarsest_A.num_rows]
    assert pa.level_rows() == rows_j
    for lj, lp in zip(ja.levels, pa.levels):
        assert np.array_equal(np.asarray(lj.cf_map), lp.cf_map.numpy())
        assert _csr_equal(lj.P, lp.P)
    for mj, mp in zip([lv.A for lv in ja.levels] + [ja.coarsest_A],
                      [lv.A for lv in pa.levels] + [pa.coarsest_A]):
        assert _csr_equal(mj, mp)
        np.testing.assert_allclose(mp.values.numpy(), np.asarray(mj.values),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("max_row_sum", [0.5, 0.9])
def test_strength_max_row_sum_weakening(max_row_sum):
    """AHAT's max_row_sum weakening on the 9-pt 20^2 operator: at 0.5 its
    corner rows (|row sum| 5 > 0.5 * 8) lose every connection."""
    from amgx_tpu.amg.classical.strength import AhatStrength as JaxAhat
    from amgx_tpu_torch.amg.classical.strength import AhatStrength
    cfg = f"strength_threshold=0.25, max_row_sum={max_row_sum}"
    Aj = jx.gallery.poisson("9pt", 20, 20).init()
    Ap = pt.gallery.poisson("9pt", 20, 20, device="cpu").init()
    sj = np.asarray(JaxAhat(JaxConfig.from_string(cfg), "default")
                    .strong_mask(Aj))
    sp = AhatStrength(Config.from_string(cfg), "default").strong_mask(Ap)
    assert np.array_equal(sj, sp.numpy())
    assert (sp.sum() < (Ap.row_ids() != Ap.col_indices.long()).sum()) \
        == (max_row_sum < 0.625)


@pytest.mark.parametrize("option", ["strength=AFFINITY", "selector=CR"])
def test_unported_classical_options_raise(option):
    """The two options that raised before they were ported: level 0 of
    the 7-pt 8^3 hierarchy takes the JAX package's strength and CF split
    bit for bit."""
    from amgx_tpu.amg.classical import ClassicalAMGLevel as JaxLevel
    from amgx_tpu_torch.amg.classical import ClassicalAMGLevel
    text = LEVEL_CFG + ", " + option
    lp = ClassicalAMGLevel(pt.gallery.poisson("7pt", 8, 8, 8, device="cpu")
                           .init(), Config.from_string(text), "default", 0)
    lj = JaxLevel(jx.gallery.poisson("7pt", 8, 8, 8).init(),
                  JaxConfig.from_string(text), "default", 0)
    lp.create_coarse_vertices()
    lj.create_coarse_vertices()
    assert np.array_equal(lp.strong.numpy(), np.asarray(lj.strong))
    assert np.array_equal(lp.cf_map.numpy(), np.asarray(lj.cf_map))
    assert lp.coarse_size == lj.coarse_size


# ---------------------------------------------------------------------------
# B8 / B9 and B3w / B4w plain twins against the JAX package's kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def h16():
    """The 7-pt 16^3 hierarchy of both packages (f64), for the kernels:
    the level tests' pair."""
    return _hierarchy_pair("7pt_16^3")


def _jax_f32(M):
    return jx.CsrMatrix.from_scipy_like(
        np.asarray(M.row_offsets), np.asarray(M.col_indices),
        np.asarray(M.values, np.float32), M.num_rows, M.num_cols).init()


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("which", ["A1", "P1", "R1"])
def test_b8_csr_spmv_f32(h16, which):
    """B8's plain twin on level 1's operator, P and R against the JAX
    package's SWELL kernel (interpreter)."""
    ja, pa = h16
    mj = {"A1": ja.levels[1].A, "P1": ja.levels[1].P,
          "R1": ja.levels[1].R}[which]
    mp = {"A1": pa.levels[1].A, "P1": pa.levels[1].P,
          "R1": pa.levels[1].R}[which].astype(torch.float32)
    x = _vec(mp.num_cols, 3)
    Aj = _jax_f32(mj)
    assert Aj.swell_vals is not None
    yj = psw.swell_spmv(Aj, jnp.asarray(x), interpret=True)
    yp = cuda_csr.csr_spmv(mp.row_offsets, mp.col_indices, mp.values, _t(x))
    assert rel(yp, yj) < TOL32


@pytest.mark.parametrize("with_dinv", [False, True])
def test_b9_csr_smooth_f32(h16, with_dinv):
    """B9's plain twin (two sweeps) on level 1's operator against the
    JAX package's fused SWELL sweep (interpreter)."""
    ja, pa = h16
    Aj = _jax_f32(ja.levels[1].A)
    Ap = pa.levels[1].A.astype(torch.float32)
    n = Ap.num_rows
    b, x = _vec(n, 4), _vec(n, 5)
    dinv = (1.0 / np.random.default_rng(6).uniform(8, 12, n)).astype(
        np.float32) if with_dinv else None
    taus = np.asarray([0.9, 0.7], np.float32)
    xj = jnp.asarray(x)
    for tau in taus:
        xj = psw.swell_smooth_step(Aj, jnp.asarray(b), xj,
                                   jnp.float32(tau),
                                   None if dinv is None
                                   else jnp.asarray(dinv), interpret=True)
    xp = cuda_csr.csr_smooth(Ap.row_offsets, Ap.col_indices, Ap.values,
                             _t(taus), _t(b), _t(x),
                             None if dinv is None else _t(dinv))
    assert rel(xp, xj) < TOL32


def _level0_f32(h16):
    ja, pa = h16
    lj, lp = ja.levels[0], pa.levels[0]
    Aj = jx.gallery.poisson("7pt", 16, 16, 16, dtype=jnp.float32).init()
    Pj, Rj = (dataclasses.replace(M, values=jnp.asarray(
        np.asarray(M.values, np.float32))) for M in (lj.P, lj.R))
    Ap = lp.A.astype(torch.float32)
    xfer = build_csr_transfer_tables(Ap, lp.P.astype(torch.float32),
                                     lp.R.astype(torch.float32))
    return Aj, Pj, Rj, Ap, xfer


def test_weighted_tables_match_jax_slabs(h16):
    """ctab/cwt and ptab/pwt hold the JAX package's weighted slabs
    without the TPU's lane padding."""
    Aj, Pj, Rj, Ap, xfer = _level0_f32(h16)
    jt = jfused.build_csr_transfer_slabs(Aj, Pj, Rj)
    nc, n = xfer["ctab"].shape[1], Ap.num_rows
    assert (jt.m, jt.mp) == (xfer["ctab"].shape[0], xfer["ptab"].shape[0])
    assert np.array_equal(np.asarray(jt.ctab).reshape(jt.m, -1)[:, :nc],
                          xfer["ctab"].numpy())
    assert np.array_equal(np.asarray(jt.cwt).reshape(jt.m, -1)[:, :nc],
                          xfer["cwt"].numpy())
    aqf = ps.transfer_quota_rows(Aj.dia_offsets, n)[0] * ps.LANES
    assert np.array_equal(
        np.asarray(jt.ptab).reshape(jt.mp, -1)[:, aqf:aqf + n],
        xfer["ptab"].numpy())
    assert np.array_equal(
        np.asarray(jt.pwt).reshape(jt.mp, -1)[:, aqf:aqf + n],
        xfer["pwt"].numpy())


@pytest.mark.parametrize("with_dinv", [False, True])
def test_b3w_weighted_restrict_f32(h16, with_dinv):
    Aj, Pj, Rj, Ap, xfer = _level0_f32(h16)
    n = Ap.num_rows
    b, x = _vec(n, 7), _vec(n, 8)
    dinv = (1.0 / np.random.default_rng(9).uniform(8, 12, n)).astype(
        np.float32) if with_dinv else None
    jd = None if dinv is None else jnp.asarray(dinv)
    taus = np.full(2, 0.9, np.float32)
    with ps.force_pallas_interpret():
        slabs = jfused.build_fused_slabs(Aj, jd)
        jt = jfused.build_csr_transfer_slabs(Aj, Pj, Rj)
        xj, bcj = jfused.fused_smooth_restrict(
            {"A": Aj, "fused": slabs}, jnp.asarray(b), jnp.asarray(x),
            jnp.asarray(taus), jt, dinv=jd)
    xp, bcp = cuda_spmv.dia_smooth_restrict(
        Ap.dia_vals, Ap.dia_offsets, _t(taus), _t(b), _t(x), xfer["ctab"],
        None if dinv is None else _t(dinv), weights=xfer["cwt"])
    assert rel(xp, xj) < TOL_CHAIN
    assert rel(bcp, bcj) < TOL_CHAIN


@pytest.mark.parametrize("with_dinv", [False, True])
def test_b4w_weighted_prolong_f32(h16, with_dinv):
    Aj, Pj, Rj, Ap, xfer = _level0_f32(h16)
    n, nc = Ap.num_rows, xfer["ctab"].shape[1]
    b, x, xc = _vec(n, 10), _vec(n, 11), _vec(nc, 12)
    dinv = (1.0 / np.random.default_rng(13).uniform(8, 12, n)).astype(
        np.float32) if with_dinv else None
    jd = None if dinv is None else jnp.asarray(dinv)
    taus = np.full(2, 0.85, np.float32)
    with ps.force_pallas_interpret():
        slabs = jfused.build_fused_slabs(Aj, jd)
        jt = jfused.build_csr_transfer_slabs(Aj, Pj, Rj)
        xj = jfused.fused_corr_smooth(
            {"A": Aj, "fused": slabs}, jnp.asarray(b), jnp.asarray(x),
            jnp.asarray(xc), jnp.asarray(taus), jt, dinv=jd)
    xp = cuda_spmv.dia_prolong_smooth(
        Ap.dia_vals, Ap.dia_offsets, _t(taus), _t(b), _t(x), _t(xc),
        dinv=None if dinv is None else _t(dinv), ptab=xfer["ptab"],
        pwt=xfer["pwt"])
    assert rel(xp, xj) < TOL_CHAIN


# ---------------------------------------------------------------------------
# amg_precision=float and the solves
# ---------------------------------------------------------------------------


def _precond_amg(slv):
    s = slv
    while not hasattr(s, "amg"):
        s = s.preconditioner
    return s


@pytest.fixture(scope="module")
def classical16():
    """`_classical_cfg` at 16^3 in both packages (set up and solved)."""
    js = jx.create_solver(JaxConfig.from_string(CLASSICAL))
    js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
    rj = js.solve(np.ones(16 ** 3))
    ps_ = pt.create_solver(Config.from_string(CLASSICAL), device="cpu")
    ps_.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    rp = ps_.solve(torch.ones(16 ** 3, dtype=torch.float64))
    return js, rj, ps_, rp


def _true_rel_res(n, x):
    from amgx_tpu_torch.ops.spmv import residual
    A = pt.gallery.poisson("7pt", n, n, n, device="cpu").init()
    b = torch.ones(A.num_rows, dtype=torch.float64)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    return float(torch.linalg.norm(residual(A, x, b)) / torch.linalg.norm(b))


def test_amg_precision_float_solve_data(classical16):
    """Level leaves float32 (operators, P, R, dinv, weighted tables), the
    coarse subtree in the coarse dtype (float32), cast once per setup;
    the cycle declines the dot and returns the caller's dtype."""
    _, _, ps_, _ = classical16
    amg = _precond_amg(ps_).amg
    data = amg.solve_data()
    for ld in data["levels"]:
        for key in ("A", "P", "R"):
            assert ld[key].dtype == torch.float32
        assert ld["smoother"]["dinv"].dtype == torch.float32
        assert ld["smoother"]["A"] is ld["A"]
    assert data["levels"][0]["xfer"]["cwt"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for k, t in data["coarse"].items()
               if torch.is_tensor(t))
    again = amg.solve_data()
    assert again["levels"][0]["A"] is data["levels"][0]["A"]
    b = torch.ones(16 ** 3, dtype=torch.float64)
    x, dot = amg.cycle_dot(data, b, torch.zeros_like(b))
    assert dot is None and x.dtype == torch.float64


def test_one_cycle_matches_jax(classical16):
    """One f32 V-cycle of the port on the JAX package's own hierarchy
    (carried across with interop) against the JAX cycle: the port runs
    B3w/B4w's plain twins at level 0 where the JAX package, off its TPU,
    composes explicit R/P products -- same arithmetic, other rounding."""
    js, _, ps_, _ = classical16
    jamg = _precond_amg(js)
    levels, coarse = jax_hierarchy_arrays(jamg)
    cfg = Config.from_string(CLASSICAL)
    _, scope = cfg.get_solver("preconditioner", cfg.get_solver("solver")[1])
    amg = pti.hierarchy_from_numpy(levels, coarse, cfg, scope, device="cpu")
    assert amg.precision_policy.name == "float"
    b = np.random.default_rng(21).standard_normal(16 ** 3)
    xj = jamg.amg.cycle(jamg.solve_data()["amg"], jnp.asarray(b),
                        jnp.zeros(16 ** 3))
    xp = amg.cycle(amg.solve_data(), _t(b), torch.zeros(16 ** 3,
                                                        dtype=torch.float64))
    assert rel(xp, xj) < TOL_CHAIN


def test_classical_solve_matches_jax(classical16):
    _, rj, ps_, rp = classical16
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    assert _true_rel_res(16, rj.x) <= 1e-8
    assert _true_rel_res(16, rp.x) <= 1e-8
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL
    assert _precond_amg(ps_).amg.level_rows() == [
        lv.A.num_rows for lv in _precond_amg(classical16[0]).amg.levels] + [
        _precond_amg(classical16[0]).amg.coarsest_A.num_rows]


def test_classical_bf16_solve_matches_jax(classical16):
    """CLASSICAL with amg:amg_precision=bfloat16 at 16^3 (PCG in float64
    around a bf16 cycle: bf16 B3w / B4w on level 0, bf16 B9 / B8 on the
    CSR levels, a float32 coarse solve), the JAX package under its
    Pallas route (set up there too: it builds its fused payloads only
    where its kernels run; the setup shares `classical16`'s compiled
    programs): the same status, iterations and level rows, every CSR
    level of the reference in its SWELL layout, and the float64 answer.
    The residual histories are not compared: the reference's interpreted
    kernels are compiled into one program with the XLA ops around them,
    and XLA drops bf16 roundings between fused operations there (its
    excess-precision default), which moves the history by 4-5 % at 16^3
    (0.7 % with `--xla_allow_excess_precision=false`; ROADMAP.md Queue
    C)."""
    cfg = CLASSICAL.replace("amg_precision=float", "amg_precision=bfloat16")
    with ps.force_pallas_interpret():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
        rj = js.solve(np.ones(16 ** 3))
    ps_ = pt.create_solver(Config.from_string(cfg), device="cpu")
    ps_.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    rp = ps_.solve(torch.ones(16 ** 3, dtype=torch.float64))
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    ja, pa = _precond_amg(js).amg, _precond_amg(ps_).amg
    assert pa.level_rows() == [lv.A.num_rows for lv in ja.levels] + [
        ja.coarsest_A.num_rows]
    assert [ja._layout_of(lv.A) for lv in ja.levels] == \
        ["dia"] + ["swell"] * (len(ja.levels) - 1)
    assert _true_rel_res(16, rp.x) <= 1e-8
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL


def test_classical_setup_is_deterministic():
    """Two setups give the same bits (every float sum of the setup has a
    fixed order; on the card chip_smoke.py checks the same)."""
    out = []
    for _ in range(2):
        amg = AMG(Config.from_string(LEVEL_CFG)).setup(
            pt.gallery.poisson("7pt", 12, 12, 12, device="cpu"))
        out.append([(lv.P.values, lv.A.values) for lv in amg.levels])
    for (p0, a0), (p1, a1) in zip(*out):
        assert torch.equal(p0, p1) and torch.equal(a0, a1)


def test_hierarchy_from_numpy_builds_classical_levels(h16):
    _, pa = h16
    lv = pa.levels[0]
    d = {**csr_arrays(lv.A), "coarse_size": lv.coarse_size,
         "cf_map": lv.cf_map.numpy(), "P": csr_arrays(lv.P),
         "R": csr_arrays(lv.R)}
    coarse = {**csr_arrays(pa.coarsest_A),
              "qt": pa.coarse_solver._qt.numpy(),
              "r": pa.coarse_solver._r.numpy()}
    amg = pti.hierarchy_from_numpy([d], coarse,
                                   Config.from_string(LEVEL_CFG),
                                   device="cpu")
    xfer = amg.levels[0]._transfer_tables()
    assert xfer is not None and torch.equal(xfer["ptab"],
                                            lv._transfer_tables()["ptab"])


def _f32_ulps(a, b):
    """Elementwise distance of two float32 arrays in units in the last
    place (the same sign throughout: P's weights here are positive)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - np.asarray(b, np.float32).view(np.int32))


def test_d2_truncation_f32_is_the_device_route():
    """Float32 D2 with GMRES_AMG_D2's truncation (interp_max_elements 4)
    on 7-pt 8^3: the port's level-0 P has the bits of the JAX package's
    device route (`_generate_jnp`, `_truncate`: float32 row sums, what a
    TPU runs). The JAX package's host route (`_truncate_host`, the one a
    CPU setup takes) sums in float64 through np.bincount and rounds once;
    the device route rounds each sum, the quotient and the product, so
    the two routes differ by up to 2 ulp here -- a difference inside the
    reference, which the port does not share."""
    cfg = ("algorithm=CLASSICAL, selector=PMIS, interpolator=D2, "
           "interp_max_elements=4, smoother=JACOBI_L1, max_levels=2, "
           "min_coarse_rows=2, coarse_solver=NOSOLVER")
    lp = AMG(Config.from_string(cfg)).setup(pt.gallery.poisson(
        "7pt", 8, 8, 8, dtype=torch.float32, device="cpu")).levels[0]
    from amgx_tpu.amg.classical import interpolators as jinterp
    from amgx_tpu.matrix import forced_device_setup
    Aj = jx.gallery.poisson("7pt", 8, 8, 8, dtype=jnp.float32).init()
    d2 = jinterp.Distance2Interpolator(
        JaxConfig.from_string(cfg.replace("interp_max_elements=4",
                                          "interp_max_elements=-1")),
        "default")
    with forced_device_setup():
        full = d2._generate_jnp(Aj, jnp.asarray(lp.cf_map.numpy()),
                                jnp.asarray(lp.strong.numpy()))
        dev = jinterp._truncate(full, 1.1, 4)
    host = jinterp._truncate_host(dataclasses.replace(
        full, row_offsets=np.asarray(full.row_offsets),
        col_indices=np.asarray(full.col_indices),
        values=np.asarray(full.values)), 1.1, 4)
    for P in (dev, host):
        assert _csr_equal(P, lp.P)
    vp = lp.P.values.numpy()
    assert np.array_equal(np.asarray(dev.values), vp)
    ulps = _f32_ulps(host.values, vp)
    assert ulps.max() <= 2 and (ulps > 0).any()
