"""The port's main path end to end on the CPU: the flagship solve
(REFINEMENT f64 around f32 FGMRES + GEO-aggregation AMG) with the coarse
tail off in amgx_tpu_torch against the JAX package, at 16^3 (levels 4096
-> 512 -> 64) and 32^3 (32768 -> 4096 -> 512 -> 64); the inner FGMRES +
AMG solve alone; the tail on against off and where the cycle enters it
(the untouched FLAGSHIP against the JAX package is in test_torch_tail.py);
and the shipped configs parsing in the port's Config."""
import glob
import os

import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.presets import FLAGSHIP as JAX_FLAGSHIP

import amgx_tpu_torch as pt
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF

from _torch_util import rel

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
SIZES = [16, 32]
# The outer defect after an f32 inner solve sits at float32 rounding of
# x, so the two packages' histories agree to rounding of the INITIAL
# residual, not of each (tiny) entry: |h_j - h'_j| <= 1e-5 * h_0.
HIST_TOL = 1e-5
# x: both runs stop at a 1e-8 residual; the condition number of the
# 7-pt operator times that bounds their distance well inside 1e-5.
X_TOL = 1e-5
INNER = ("solver=FGMRES, max_iters=60, monitor_residual=1, tolerance=1e-6,"
         " gmres_n_restart=10, convergence=RELATIVE_INI, norm=L2,"
         " preconditioner(amg)=AMG, amg:algorithm=AGGREGATION,"
         " amg:selector=GEO, amg:smoother=CHEBYSHEV_POLY,"
         " amg:chebyshev_polynomial_order=2, amg:presweeps=1,"
         " amg:postsweeps=1, amg:max_iters=1, amg:cycle=V,"
         " amg:max_levels=50, amg:min_coarse_rows=32,"
         " amg:cycle_fusion_tail_rows=0")


def _true_rel_res(n, x):
    A = pt.gallery.poisson("7pt", n, n, n, device="cpu")
    b = torch.ones(A.num_rows, dtype=torch.float64)
    from amgx_tpu_torch.ops.spmv import residual
    x = torch.tensor(np.asarray(x), dtype=torch.float64)
    return float(torch.linalg.norm(residual(A.init(), x, b))
                 / torch.linalg.norm(b))


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"{n}^3")
def flagship(request):
    n = request.param
    cfg = FLAGSHIP_TAIL_OFF + ", store_res_history=1"
    js = jx.create_solver(JaxConfig.from_string(cfg))
    js.setup(jx.gallery.poisson("7pt", n, n, n).init())
    rj = js.solve(np.ones(n ** 3))
    ps = pt.create_solver(Config.from_string(cfg), device="cpu")
    ps.setup(pt.gallery.poisson("7pt", n, n, n, device="cpu"))
    rp = ps.solve(torch.ones(n ** 3, dtype=torch.float64))
    return n, rj, rp, ps


def test_flagship_preset_is_the_jax_one():
    assert FLAGSHIP == JAX_FLAGSHIP
    assert FLAGSHIP_TAIL_OFF == JAX_FLAGSHIP + \
        ", amg:cycle_fusion_tail_rows=0"


def test_status_and_outer_iterations(flagship):
    _, rj, rp, _ = flagship
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    assert rp.extra_stats["inner_iters"] > 0


def test_residual_history(flagship):
    _, rj, rp, _ = flagship
    hj, hp = np.asarray(rj.res_history), np.asarray(rp.res_history)
    assert hp.shape == hj.shape
    assert hp[0] == pytest.approx(hj[0], rel=1e-12)
    assert np.abs(hp - hj).max() <= HIST_TOL * hj[0]


def test_solution_and_true_residual(flagship):
    n, rj, rp, _ = flagship
    assert _true_rel_res(n, rj.x) <= 1e-8
    assert _true_rel_res(n, rp.x) <= 1e-8
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL


def test_hierarchy_shape(flagship):
    n, _, _, ps = flagship
    rows = ps.preconditioner.preconditioner.amg.level_rows()
    assert rows[0] == n ** 3 and rows[-1] == 64
    assert all(a == 8 * b for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("n", SIZES)
def test_inner_fgmres_iterations(n):
    """JAX reports no inner count by default, so the inner solver runs
    alone in both packages on the same f32 system."""
    js = jx.create_solver(JaxConfig.from_string(INNER))
    js.setup(jx.gallery.poisson("7pt", n, n, n, dtype=np.float32).init())
    rj = js.solve(np.ones(n ** 3, np.float32))
    ps = pt.create_solver(Config.from_string(INNER), device="cpu")
    ps.setup(pt.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                                device="cpu"))
    rp = ps.solve(torch.ones(n ** 3, dtype=torch.float32))
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations


def test_tail_on_matches_tail_off_on_cpu():
    """FLAGSHIP runs every inner cycle at 16^3 as one coarse tail (B5's
    plain twin on the CPU); with the tail off the same cycle composes
    per level. Same arithmetic, other rounding: same outer iterations and
    x within 1e-5."""
    out = []
    for cfg in (FLAGSHIP, FLAGSHIP_TAIL_OFF):
        ps = pt.create_solver(Config.from_string(cfg), device="cpu")
        ps.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
        out.append(ps.solve(torch.ones(16 ** 3, dtype=torch.float64)))
    assert out[0].status == out[1].status == "success"
    assert out[0].iterations == out[1].iterations
    assert rel(out[0].x, out[1].x) <= X_TOL


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR,
                                                        "*.json"))))
def test_config_file_parses(name):
    cfg = Config.from_file(os.path.join(CONFIG_DIR, name))
    ref = JaxConfig.from_file(os.path.join(CONFIG_DIR, name))
    assert cfg.values == ref.values
    assert cfg.param_scopes == ref.param_scopes


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(
        CONFIG_DIR, "eigen_configs", "*"))))
def test_eigen_config_parses(name):
    cfg = Config.from_file(os.path.join(CONFIG_DIR, "eigen_configs", name))
    ref = JaxConfig.from_file(os.path.join(CONFIG_DIR, "eigen_configs",
                                           name))
    assert cfg.values == ref.values


@pytest.mark.parametrize("tail_rows,fusion,entry", [
    (65536, 1, 0), (600, 1, 1), (0, 1, None), (65536, 0, None)])
def test_coarse_tail_entry_level(monkeypatch, tail_rows, fusion, entry):
    """A float32 cycle on the 16^3 hierarchy (4096 -> 512 -> 64 rows)
    enters the coarse tail at the first level of at most
    cycle_fusion_tail_rows rows, on the CPU as on the card; with the
    threshold 0 or cycle_fusion=0 it composes per level."""
    from amgx_tpu_torch.ops import cuda_tail
    entered = []
    real = cuda_tail.dia_coarse_tail

    def spy(spec, arrs, b, x, with_dot=False):
        entered.append(spec.levels[0].n)
        return real(spec, arrs, b, x, with_dot)

    monkeypatch.setattr(cuda_tail, "dia_coarse_tail", spy)
    ps = pt.create_solver(Config.from_string(
        INNER + f", amg:cycle_fusion_tail_rows={tail_rows},"
        f" amg:cycle_fusion={fusion}"), device="cpu")
    ps.setup(pt.gallery.poisson("7pt", 16, 16, 16, dtype=torch.float32,
                                device="cpu"))
    amg = ps.preconditioner.amg
    b = torch.ones(16 ** 3, dtype=torch.float32)
    amg.cycle(amg.solve_data(), b, torch.zeros_like(b))
    rows = amg.level_rows()
    assert entered == ([] if entry is None else [rows[entry]])


@pytest.mark.parametrize("option", ["amg_precision=bfloat16", "cycle=CG"])
def test_unported_hierarchy_options_raise(option):
    from amgx_tpu_torch.amg.hierarchy import AMG
    with pytest.raises(NotImplementedError):
        AMG(Config.from_string(option))
