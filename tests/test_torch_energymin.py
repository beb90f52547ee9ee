"""The energymin AMG level of amgx_tpu_torch against the JAX package's, on
the CPU: the same matrices go to both packages.

- `solve_qr` (K7's plain version) against the JAX package's within 1e-12
  in float64 at the patch widths a driven matrix gives, a singular patch
  non-finite in the same entries; K7's launch route (`qr_threads`);
- the CR selector's split equal to the JAX package's on the 5-pt 16^2 /
  24^2 and 7-pt 8^3 / 12^3 Poisson;
- the EM interpolator's P within 1e-12 (float64) on the JAX package's CF
  split and strength;
- the JAX tests' ENERGYMIN solves (tests/test_energymin.py), with a CR and
  a PMIS selector, standalone and under PCG: the same status and
  iterations; a structure-reuse resetup the JAX package's too;
- one V-cycle of the port on the JAX package's ENERGYMIN hierarchy
  (interop.py) within 1e-12.
"""
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu import registry as jreg
from amgx_tpu.amg.classical.selectors import pmis_split as jx_pmis
from amgx_tpu.ops.dense import solve_qr as jx_solve_qr

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch import registry as preg
from amgx_tpu_torch.ops import dense

from _torch_util import jax_hierarchy_arrays, rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

SHAPES = {"5pt_16^2": ("5pt", 16, 16, 1), "5pt_24^2": ("5pt", 24, 24, 1),
          "7pt_8^3": ("7pt", 8, 8, 8), "7pt_12^3": ("7pt", 12, 12, 12)}
SOLVES = {
    "cr": "solver=AMG, algorithm=ENERGYMIN, energymin_selector=CR, "
          "max_iters=60, tolerance=1e-8, monitor_residual=1, "
          "convergence=RELATIVE_INI_CORE",
    "pmis": "solver=AMG, algorithm=ENERGYMIN, energymin_selector=PMIS, "
            "max_iters=60, tolerance=1e-8, monitor_residual=1, "
            "convergence=RELATIVE_INI_CORE",
    "pcg": "solver=PCG, preconditioner=AMG, algorithm=ENERGYMIN, "
           "energymin_selector=PMIS, max_iters=100, tolerance=1e-8, "
           "monitor_residual=1, convergence=RELATIVE_INI_CORE",
}


def _pair(key):
    pts, nx, ny, nz = SHAPES[key]
    return (jx.gallery.poisson(pts, nx, ny, nz).init(),
            pt.gallery.poisson(pts, nx, ny, nz, device="cpu").init())


def _strength(Aj, Ap, text="strength_threshold=0.25"):
    sj = jreg.strength.create("AHAT", jx.Config.from_string(text),
                              "default").strong_mask(Aj)
    sp = preg.strength.create("AHAT", pt.Config.from_string(text),
                              "default").strong_mask(Ap)
    assert np.array_equal(np.asarray(sj), sp.numpy())
    return sj, sp


@pytest.mark.parametrize("k", [1, 3, 6])
def test_solve_qr_matches_jax(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((40, k, k)) + 4 * np.eye(k)
    b = rng.standard_normal((40, k))
    a[3] = 0.0                                   # a singular patch
    a[5, :, 0] = 0.0                             # a zero column
    want = np.asarray(jx_solve_qr(a, b))
    got = dense.solve_qr(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert not fin[3].any() and not fin[5].all()
    assert rel(got[fin], want[fin]) < 1e-12


def test_qr_threads_routes():
    """K7 stages patches in 48 KB with whole warps, up to 128 threads;
    wider patches take the global route (0)."""
    assert dense.qr_threads(6, 8) == 128
    assert dense.qr_threads(6, 4) == 128
    assert dense.qr_threads(13, 8) == 32
    assert dense.qr_threads(14, 8) == 0
    assert dense.qr_threads(19, 4) == 32
    for k in range(1, 80):
        for size in (4, 8):
            t = dense.qr_threads(k, size)
            assert t % 32 == 0 and 0 <= t <= 128
            assert t == 0 or (k * k + k) * size * t <= dense.QR_SMEM


def _segments(rng, lengths, dtype):
    starts = torch.zeros(len(lengths) + 1, dtype=torch.int64)
    torch.cumsum(torch.tensor(lengths), 0, out=starts[1:])
    vals = torch.from_numpy(rng.standard_normal(int(starts[-1])) * 10.0 **
                            rng.integers(-3, 4, int(starts[-1]))).to(dtype)
    return starts, vals


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_ordered_sum_plain_form_adds_in_stored_order(dtype):
    """K8's plain form (the CPU route, and the bits K8 must give): each
    segment summed from 0 left to right in its dtype, empty segments 0;
    the plan's lengths (K8's operand) are the segments' longest first."""
    from amgx_tpu_torch.ops import cuda_spmv, segment
    rng = np.random.default_rng(8)
    lengths = [3, 0, 17, 1, 0, 40, 5, 5, 2]
    starts, vals = _segments(rng, lengths, dtype)
    plan = segment.ordered_sum_plan(starts)
    assert plan[3].tolist() == sorted(lengths, reverse=True)
    assert torch.equal(plan[1], starts[:-1][plan[0]])
    want = []
    for s in range(len(lengths)):
        acc = torch.zeros((), dtype=dtype)
        for v in vals[starts[s]:starts[s + 1]]:
            acc = acc + v
        want.append(acc)
    before = cuda_spmv.LAUNCHES["ordered_sum"]
    got = segment.ordered_sum(vals, plan, len(lengths))
    assert torch.equal(got, torch.stack(want))
    assert torch.equal(segment.ordered_segment_sum(vals, starts), got)
    assert cuda_spmv.LAUNCHES["ordered_sum"] == before


@pytest.mark.parametrize("key", list(SHAPES))
def test_cr_split_matches_jax(key):
    Aj, Ap = _pair(key)
    sj, sp = _strength(Aj, Ap)
    cfg = "strength_threshold=0.25"
    cj = jreg.classical_selectors.create(
        "CR", jx.Config.from_string(cfg), "default"
    ).mark_coarse_fine_points(Aj, sj)
    cp = preg.classical_selectors.create(
        "CR", pt.Config.from_string(cfg), "default"
    ).mark_coarse_fine_points(Ap, sp)
    assert cp.dtype == torch.int32
    assert np.array_equal(cp.numpy(), np.asarray(cj))


@pytest.mark.parametrize("key", ["5pt_16^2", "7pt_8^3"])
def test_em_interpolator_matches_jax(key):
    Aj, Ap = _pair(key)
    sj, sp = _strength(Aj, Ap)
    cf = np.array(jx_pmis(Aj, sj))
    cfg = "strength_threshold=0.25"
    Pj = jreg.energymin_interpolators.create(
        "EM", jx.Config.from_string(cfg), "default").generate(Aj, cf, sj)
    Pp = preg.energymin_interpolators.create(
        "EM", pt.Config.from_string(cfg), "default").generate(
        Ap, torch.from_numpy(cf), sp)
    assert np.array_equal(Pp.row_offsets.numpy(), np.asarray(Pj.row_offsets))
    assert np.array_equal(Pp.col_indices.numpy(), np.asarray(Pj.col_indices))
    assert rel(Pp.values, np.asarray(Pj.values)) < 1e-12


@pytest.mark.parametrize("name", list(SOLVES))
def test_energymin_solves_match_jax(name):
    Aj, Ap = _pair("5pt_16^2")
    js = jx.create_solver(jx.Config.from_string(SOLVES[name]))
    js.setup(Aj)
    rj = js.solve(np.ones(Aj.num_rows))
    ps = pt.create_solver(pt.Config.from_string(SOLVES[name]), device="cpu")
    ps.setup(Ap)
    rp = ps.solve(torch.ones(Ap.num_rows, dtype=torch.float64))
    assert rp.status == rj.status == "success"
    assert rp.iterations == int(rj.iterations)
    assert rel(rp.x, np.asarray(rj.x)) < 1e-9


def test_energymin_resetup_reuses_structure():
    """structure_reuse_levels=-1: the CF split, P and R stay, only the
    Galerkin values see the new coefficients, as in the JAX package."""
    text = SOLVES["pcg"].replace("preconditioner=AMG",
                                 "preconditioner(amg)=AMG") \
        + ", amg:structure_reuse_levels=-1"
    Aj, Ap = _pair("5pt_16^2")
    js = jx.create_solver(jx.Config.from_string(text))
    js.setup(Aj)
    js.resetup(Aj.with_values(np.asarray(Aj.values) * 1.5))
    rj = js.solve(np.ones(Aj.num_rows))
    ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
    ps.setup(Ap)
    lv0 = ps.preconditioner.amg.levels[0]
    cf, P = lv0.cf_map, lv0.P
    ps.resetup(Ap.with_values(Ap.values * 1.5))
    lv0 = ps.preconditioner.amg.levels[0]
    assert lv0.algorithm == "ENERGYMIN" and lv0.cf_map is cf \
        and lv0.P is P
    rp = ps.solve(torch.ones(Ap.num_rows, dtype=torch.float64))
    assert rp.status == rj.status == "success"
    assert rp.iterations == int(rj.iterations)


def test_vcycle_on_the_jax_energymin_hierarchy():
    cfg = ("solver(amg)=AMG, amg:algorithm=ENERGYMIN,"
           " amg:energymin_selector=CR, amg:max_iters=1,"
           " amg:smoother=JACOBI_L1, amg:presweeps=1, amg:postsweeps=1")
    Aj, Ap = _pair("5pt_16^2")
    js = jx.create_solver(jx.Config.from_string(cfg))
    js.setup(Aj)
    levels, coarse = jax_hierarchy_arrays(js)
    amg = pti.hierarchy_from_numpy(levels, coarse, pt.Config.from_string(cfg),
                                   "amg", device="cpu")
    assert [lv.algorithm for lv in amg.levels] == ["ENERGYMIN"] * len(levels)
    b = np.random.default_rng(3).standard_normal(Ap.num_rows)
    xj = js.solve(b).x
    xp = amg.cycle(amg.solve_data(), torch.from_numpy(b),
                   torch.zeros(Ap.num_rows, dtype=torch.float64))
    assert rel(xp, np.asarray(xj)) < 1e-12
