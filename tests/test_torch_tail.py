"""The coarse-tail kernel B5 (amgx_tpu_torch/ops/cuda_tail.py) against the
JAX package's, and the untouched FLAGSHIP, whose cycle runs through it.

A JAX hierarchy is set up with its Pallas kernels under the interpreter
(force_pallas_interpret: the route that builds its transfer slabs and
DENSE_LU's explicit inverse), carried into the port with
amgx_tpu_torch.interop, and one cycle from identical (b, x) is compared:
the port's plain B5 on the CPU against the JAX tail kernel in interpret
mode. The CUDA kernel itself is held against the plain B5 on the card by
chip_smoke.py; here its phase program (the host half of the kernel) is
run op by op and held against the plain recursion.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.amg.cycles import run_cycle_dot
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.presets import FLAGSHIP as JAX_FLAGSHIP

import amgx_tpu_torch as pt
from amgx_tpu_torch.interop import hierarchy_from_numpy
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import cuda_tail as T
from amgx_tpu_torch.presets import FLAGSHIP

from _torch_util import jax_hierarchy_arrays, rel

AMG_CFG = ("solver=AMG, algorithm=AGGREGATION, selector=GEO,"
           " smoother={smoother}, chebyshev_polynomial_order=2,"
           " relaxation_factor=0.75, presweeps=1, postsweeps=2,"
           " max_iters=1, cycle={cycle}, max_levels=10, min_coarse_rows=32"
           "{extra}")
# one cycle in float32 through two implementations of the same
# arithmetic: rounding of a few levels' dependent steps
TOL32 = 1e-5
# the flagship solve: as tests/test_torch_flagship.py
HIST_TOL = 1e-5
X_TOL = 1e-5


def _jax_amg(smoother, cycle, n, extra="", dtype=np.float32):
    cfg = AMG_CFG.format(smoother=smoother, cycle=cycle, extra=extra)
    with ps.force_pallas_interpret():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", n, n, n, dtype=dtype).init())
        levels, coarse = jax_hierarchy_arrays(js)
    amg = hierarchy_from_numpy(levels, coarse, pt.Config.from_string(cfg),
                               device="cpu")
    return js, amg


def _record_tail(monkeypatch):
    seen = []
    real = T.dia_coarse_tail

    def spy(spec, arrs, b, x, with_dot=False):
        seen.append(spec)
        return real(spec, arrs, b, x, with_dot)

    monkeypatch.setattr(T, "dia_coarse_tail", spy)
    return seen


CASES = [  # smoother, cycle, grid, extra config, entry level
    ("CHEBYSHEV_POLY", "V", 16, "", 0),
    ("JACOBI_L1", "V", 16, "", 0),
    ("CHEBYSHEV_POLY", "V", 16, ", cycle_fusion_tail_rows=600", 1),
    ("JACOBI_L1", "V", 16, ", cycle_fusion_tail_rows=600", 1),
    ("CHEBYSHEV_POLY", "W", 12, "", 0),
    ("JACOBI_L1", "W", 12, "", 0),
    ("CHEBYSHEV_POLY", "F", 12, "", 0),
    ("JACOBI_L1", "F", 12, "", 0),
]


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("smoother,cycle,n,extra,entry", CASES)
def test_tail_cycle_matches_jax(monkeypatch, smoother, cycle, n, extra,
                                entry, with_dot):
    js, amg = _jax_amg(smoother, cycle, n, extra)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n ** 3).astype(np.float32)
    x = rng.standard_normal(n ** 3).astype(np.float32)
    with ps.force_pallas_interpret():
        jd = js.solve_data()["amg"]
        js.amg._tail_entry_level = None
        if with_dot:
            xj, dj = run_cycle_dot(js.amg, cycle, jd, jnp.asarray(b),
                                   jnp.asarray(x))
        else:
            xj = js.amg.cycle(jd, jnp.asarray(b), jnp.asarray(x))
    assert js.amg._tail_entry_level == entry
    seen = _record_tail(monkeypatch)
    data = amg.solve_data()
    tb, tx = torch.from_numpy(b), torch.from_numpy(x)
    if with_dot:
        xp, dp = amg.cycle_dot(data, tb, tx)
        assert abs(float(dp) - float(dj)) <= TOL32 * abs(float(dj))
    else:
        xp = amg.cycle(data, tb, tx)
    assert [s.levels[0].n for s in seen] == [amg.levels[entry].A.num_rows]
    assert seen[0].coarse == ("inv", amg.coarsest_A.num_rows)
    assert seen[0].levels[0].has_dinv == (smoother == "JACOBI_L1")
    assert rel(xp, xj) < TOL32


# ---------------------------------------------------------------------------
# the phase program, run op by op on the CPU
# ---------------------------------------------------------------------------


def _run_program(spec, arrs, b, x, with_dot):
    """Execute tail_program's phases as csrc/tail.cu does, one phase
    after another, on CPU tensors."""
    L = len(spec.levels)
    nz = spec.coarse[1]
    out = torch.full_like(x, float("nan"))
    bufs = [{T.S_IN: x, T.S_A: out,
             T.S_B: torch.full_like(x, float("nan"))}]
    bs = [b]
    for ls in spec.levels[1:]:
        bufs.append({T.S_A: torch.full((ls.n,), float("nan")),
                     T.S_B: torch.full((ls.n,), float("nan"))})
        bs.append(torch.full((ls.n,), float("nan")))
    bz, xz = torch.full((nz,), float("nan")), torch.full((nz,), float("nan"))
    dot = None
    for op, l, src, dst, tau, nxt, flags in T.tail_program(spec, with_dot):
        if op == T.OP_COARSE:
            xz.copy_(arrs[-1]["inv"] @ bz if spec.coarse[0] == "inv"
                     else torch.zeros(nz))
            continue
        if op == T.OP_DOT:
            dot = torch.dot(out, b)
            continue
        ls, ar = spec.levels[l], arrs[l]
        x_l = bufs[l][src]
        if op == T.OP_RESTRICT:
            r = bs[l] - K.dia_spmv_plain(ar["vals"], ls.offsets, x_l)
            bn = bz if l + 1 == L else bs[l + 1]
            bn.copy_(K.restrict_plain(ar["ctab"], r))
            if l + 1 < L:
                bufs[l + 1][T.S_A].zero_()
            continue
        assert src != dst and dst != T.S_IN
        if flags & T.F_CORRECTED:
            xc = xz if nxt == T.S_Z else bufs[l + 1][nxt]
            x_l = x_l + xc[ar["agg"].long()]
        if op == T.OP_STEP:
            taus = ar["taus_post"] if flags & T.F_POST else ar["taus_pre"]
            x_l = K.dia_smooth_plain(ar["vals"], ls.offsets,
                                     taus[tau:tau + 1], bs[l], x_l,
                                     ar["dinv"], with_residual=False)
        bufs[l][dst].copy_(x_l)
    return (out, dot) if with_dot else out


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("case", ["V", "W", "F", "V-no-post", "V-no-pre",
                                  "V-nosolver"])
def test_phase_program_matches_plain_recursion(case, with_dot):
    """Every slot the program reads holds what the recursion computes
    there (unwritten slots hold NaN), and the entry level's last write
    lands in the output."""
    cycle = case[0]
    pre, post = {"V-no-post": (2, 0), "V-no-pre": (0, 2)}.get(case, (1, 2))
    js, amg = _jax_amg("JACOBI_L1", cycle, 12,
                       f", presweeps={pre}, postsweeps={post}")
    if case == "V-nosolver":
        amg.coarse_solver = pt.solvers.relaxation.NoSolver(
            amg.cfg, name="NOSOLVER")
        amg.coarse_solver.setup(amg.coarsest_A)
    from amgx_tpu_torch.ops.smooth import _tail_plan
    rng = np.random.default_rng(4)
    b = torch.from_numpy(rng.standard_normal(12 ** 3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(12 ** 3).astype(np.float32))
    spec, arrs = _tail_plan(amg, cycle, amg.solve_data(), 0, x)
    assert spec.coarse[0] == ("none" if case == "V-nosolver" else "inv")
    want = T.dia_coarse_tail_plain(spec, arrs, b, x, with_dot)
    got = _run_program(spec, arrs, b, x, with_dot)
    if with_dot:
        assert torch.equal(got[0], want[0])
        assert abs(float(got[1] - want[1])) <= 1e-6 * abs(float(want[1]))
    else:
        assert torch.equal(got, want)


def test_phase_count_of_the_flagship_tail():
    """The flagship's 128^3 tail (levels of 32768, 4096 and 512 rows, 5
    damping steps a sweep, one sweep each side): 11 phases per level and
    the coarse product -- the dependent chain the kernel's grid barriers
    follow."""
    lv = [T.TailLevelSpec((-n * n, -n, -1, 0, 1, n, n * n), n ** 3, 5, 5,
                          False, (n // 2) ** 3, 8) for n in (32, 16, 8)]
    spec = T.TailSpec("V", tuple(lv), ("inv", 64))
    assert len(T.tail_program(spec)) == 34
    assert len(T.tail_program(spec, with_dot=True)) == 35


# ---------------------------------------------------------------------------
# DENSE_LU's explicit inverse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_dense_lu_inverse_matches_jax(dtype, tol):
    """The port's own setup (not the carried arrays) gives the JAX
    package's d["inv"] = R^-1 Q^T in the factors' dtype."""
    js, _ = _jax_amg("JACOBI_L1", "V", 16, dtype=dtype)
    with ps.force_pallas_interpret():
        jinv = np.asarray(js.solve_data()["amg"]["coarse"]["inv"])
    cfg = AMG_CFG.format(smoother="JACOBI_L1", cycle="V", extra="")
    pslv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    pslv.setup(pt.gallery.poisson("7pt", 16, 16, 16, dtype=getattr(
        torch, np.dtype(dtype).name), device="cpu"))
    pinv = pslv.amg.coarse_solver.solve_data()["inv"]
    assert pinv.dtype == getattr(torch, np.dtype(dtype).name)
    assert rel(pinv, jinv) <= tol


# ---------------------------------------------------------------------------
# the untouched FLAGSHIP: every inner cycle at 16^3 is one tail
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship_tail():
    cfg = FLAGSHIP + ", store_res_history=1"
    with ps.force_pallas_interpret():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
        rj = js.solve(np.ones(16 ** 3))
    ps_ = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    ps_.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    rp = ps_.solve(torch.ones(16 ** 3, dtype=torch.float64))
    return rj, rp


def test_flagship_is_the_jax_preset():
    assert FLAGSHIP == JAX_FLAGSHIP


def test_flagship_status_and_iterations(flagship_tail):
    rj, rp = flagship_tail
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations


def test_flagship_residual_history(flagship_tail):
    rj, rp = flagship_tail
    hj, hp = np.asarray(rj.res_history), np.asarray(rp.res_history)
    assert hp.shape == hj.shape
    assert np.abs(hp - hj).max() <= HIST_TOL * hj[0]


def test_flagship_solution(flagship_tail):
    rj, rp = flagship_tail
    A = pt.gallery.poisson("7pt", 16, 16, 16, device="cpu").init()
    b = torch.ones(16 ** 3, dtype=torch.float64)
    from amgx_tpu_torch.ops.spmv import residual
    true_rel = float(torch.linalg.norm(residual(A, rp.x, b))
                     / torch.linalg.norm(b))
    assert true_rel <= 1e-8
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL
