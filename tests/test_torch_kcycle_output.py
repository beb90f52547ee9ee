"""The K-cycles CG and CGF and the solve output of amgx_tpu_torch against
the JAX package, in float64.

One K-cycle on the same hierarchy (the JAX package's SIZE_4 aggregation
levels carried over by amgx_tpu_torch.interop) from the same b and x;
the stock K-cycle files set up and solved by both packages at 10^3; and
the text both print under print_grid_stats and print_solve_stats,
captured through each package's print callback: the grid table equal
line for line, the solve table equal apart from the measured setup and
solve seconds.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu import output as jx_output
from amgx_tpu.config import Config as JaxConfig

import amgx_tpu_torch as pt
from amgx_tpu_torch import output as pt_output
from amgx_tpu_torch.interop import hierarchy_from_numpy
from amgx_tpu_torch.ops import cuda_tail

from _torch_util import ROOT, jax_hierarchy_arrays, rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12
KCYCLE = ("solver=AMG, algorithm=AGGREGATION, selector=SIZE_4,"
          " smoother=JACOBI_L1, presweeps=0, postsweeps=3, max_iters=1,"
          " max_levels=50, cycle={cycle}, cycle_iters={iters}")
# the stock files whose root is AMG with a K-cycle (classical PMIS + D2,
# and SIZE_4 aggregation)
FILES = ["AMG_CLASSICAL_CG", "AMG_AGGRREGATION_CG"]
TIMINGS = ("    Setup Time:", "    Solve Time:")


@pytest.fixture(scope="module")
def size4():
    """The JAX package's SIZE_4 hierarchy of the 10^3 Poisson, and b, x."""
    js = jx.create_solver(JaxConfig.from_string(
        KCYCLE.format(cycle="CG", iters=2)))
    js.setup(jx.gallery.poisson("7pt", 10, 10, 10).init())
    rng = np.random.default_rng(3)
    n = js.A.num_rows
    return js, rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("cycle", ["CG", "CGF"])
@pytest.mark.parametrize("iters", [1, 2, 3])
def test_kcycle_matches_jax(size4, cycle, iters):
    js, b, x = size4
    cfg = KCYCLE.format(cycle=cycle, iters=iters)
    js.amg.cycle_name, js.amg.cycle_iters = cycle, iters
    levels, coarse = jax_hierarchy_arrays(js)
    amg = hierarchy_from_numpy(levels, coarse, pt.Config.from_string(cfg),
                               device="cpu")
    assert len(amg.levels) >= 2 and amg.cycle_iters == iters
    xj = js.amg.cycle(js.solve_data()["amg"], jnp.asarray(b),
                      jnp.asarray(x))
    xp = amg.cycle(amg.solve_data(), torch.from_numpy(b),
                   torch.from_numpy(x))
    assert rel(xp, xj) < TOL
    # and carries no cycle-borne dot
    xd, dot = amg.cycle_dot(amg.solve_data(), torch.from_numpy(b),
                            torch.from_numpy(x))
    assert dot is None and torch.equal(xd, xp)


@pytest.mark.parametrize("cycle", ["CG", "CGF"])
def test_kcycle_never_enters_the_coarse_tail(monkeypatch, cycle):
    """Where a V-cycle runs its coarse levels as one tail launch (B5),
    a K-cycle recurses level by level, as the reference's does."""
    entered = []
    real = cuda_tail.dia_coarse_tail

    def spy(*a, **k):
        entered.append(1)
        return real(*a, **k)

    monkeypatch.setattr(cuda_tail, "dia_coarse_tail", spy)
    A = pt.gallery.poisson("7pt", 16, 16, 16, dtype=torch.float32,
                           device="cpu")
    b = torch.ones(A.num_rows, dtype=torch.float32)
    counts = {}
    for name in ("V", cycle):
        amg = pt.create_solver(pt.Config.from_string(
            "solver=AMG, algorithm=AGGREGATION, selector=GEO,"
            " smoother=JACOBI_L1, max_iters=1, min_coarse_rows=32,"
            f" cycle={name}, cycle_fusion_tail_rows=600"),
            device="cpu")
        amg.setup(A)
        entered.clear()
        x = amg.amg.cycle(amg.amg.solve_data(), b, torch.zeros_like(b))
        assert bool(torch.isfinite(x).all())
        counts[name] = len(entered)
    assert counts == {"V": 1, cycle: 0}


def _capture(output):
    lines = []
    output.register_print_callback(
        lambda msg, n: lines.extend(msg[:n].splitlines()))
    return lines


@pytest.fixture(scope="module", params=FILES)
def stock(request):
    """One stock K-cycle file set up and solved by both packages at 10^3
    in float64, each package's printed text captured: (name, JAX
    result, port result, JAX lines, port lines)."""
    name = request.param
    path = os.path.join(ROOT, "configs", name + ".json")
    n = 10
    b = np.ones(n ** 3)
    try:
        jlines = _capture(jx_output)
        js = jx.create_solver(JaxConfig.from_file(path))
        js.setup(jx.gallery.poisson("7pt", n, n, n).init())
        rj = js.solve(b)
        plines = _capture(pt_output)
        ps = pt.create_solver(pt.Config.from_file(path), device="cpu")
        ps.setup(pt.gallery.poisson("7pt", n, n, n, device="cpu"))
        rp = ps.solve(torch.from_numpy(b))
    finally:
        jx_output.register_print_callback(None)
        pt_output.register_print_callback(None)
    return name, rj, rp, jlines, plines


def test_kcycle_stock_file_matches_jax(stock):
    name, rj, rp, _, _ = stock
    assert rp.status == str(rj.status) == "success"
    assert rp.iterations == int(rj.iterations)
    assert rel(rp.x, np.asarray(rj.x)) <= TOL


def test_grid_stats_text_equals_jax(stock):
    _, _, _, jl, pl = stock
    m = next(i for i, ln in enumerate(jl)
             if ln.startswith("         Operator Complexity"))
    assert jl.index("AMG Grid:") == 0 == pl.index("AMG Grid:")
    assert pl[:m + 1] == jl[:m + 1]
    assert int(pl[1].split(":")[1]) >= 3       # levels in the table


def test_solve_stats_text_equals_jax(stock):
    """The solve table, totals and status line for line; the two timing
    lines (obtain_timings) are each package's own seconds."""
    _, rj, rp, jl, pl = stock
    start = jl.index("    iter      Mem Usage (GB)       residual"
                     "           rate")
    assert pl.index(jl[start]) == start
    jt = [ln for ln in jl[start:] if not ln.startswith(TIMINGS)]
    ptx = [ln for ln in pl[start:] if not ln.startswith(TIMINGS)]
    assert ptx == jt
    assert len(jt) == rp.iterations + 1 + 7
    assert [ln.split(":")[0] for ln in pl[-2:]] == [t[:-1] for t in TIMINGS]
    assert f"    Solve Status: {rp.status}" in pl


def test_print_callback_receives_every_line(capsys):
    """With a callback registered nothing reaches stdout; without one
    the same text does."""
    A = pt.gallery.poisson("7pt", 6, 6, 6, device="cpu")
    cfg = ("solver=AMG, algorithm=AGGREGATION, selector=SIZE_2,"
           " max_iters=3, monitor_residual=1, print_solve_stats=1,"
           " print_grid_stats=1, obtain_timings=0, cycle=CG")
    b = torch.ones(A.num_rows, dtype=torch.float64)
    got = []
    pt.register_print_callback(lambda msg, n: got.append((msg, n)))
    try:
        slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
        slv.setup(A)
        slv.solve(b)
    finally:
        pt.register_print_callback(None)
    assert capsys.readouterr().out == ""
    assert all(len(msg) == n for msg, n in got)
    text = "".join(msg for msg, _ in got)
    assert text.startswith("AMG Grid:")
    assert "Setup Time" not in text and "    Total Iterations: 3" in text
    slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    slv.setup(A)
    slv.solve(b)
    assert capsys.readouterr().out == text


def test_grid_stats_dict_layouts():
    """`layout` names the port's storage: dia (a banded level 0), csr,
    or dia-mf for a matrix-free level."""
    A = pt.gallery.poisson("7pt", 16, 16, 16, dtype=torch.float32,
                           device="cpu")
    layouts = {}
    for mf in ("0", "1"):
        slv = pt.create_solver(pt.Config.from_string(
            "solver=AMG, algorithm=AGGREGATION, selector=SIZE_2,"
            f" smoother=JACOBI_L1, matrix_free={mf}"), device="cpu")
        slv.setup(A)
        d = slv.amg.grid_stats_dict()
        assert d["num_levels"] == len(slv.amg.level_rows())
        assert d["levels"][0]["nnz"] == A.nnz
        layouts[mf] = [lv["layout"] for lv in d["levels"]]
    assert layouts["0"][0] == "dia" and layouts["1"][0] == "dia-mf"
    assert set(layouts["0"][1:]) == {"csr"} == set(layouts["1"][1:])


@pytest.mark.parametrize("cycle", ["CG", "CGF"])
def test_bf16_kcycle_coarsest_matvec_in_float32(monkeypatch, cycle):
    """Under a bfloat16 cycle the coarsest operator stays float32: the
    K-cycle widens v for its matvec and rounds the product back."""
    from amgx_tpu_torch.amg import cycles
    seen = []
    real = cycles.spmv_coarsest

    def spy(amg, data, v):
        seen.append((v.dtype, data["coarse"]["A"].dtype))
        return real(amg, data, v)

    monkeypatch.setattr(cycles, "spmv_coarsest", spy)
    slv = pt.create_solver(pt.Config.from_string(
        KCYCLE.format(cycle=cycle, iters=2) + ", amg_precision=bfloat16"),
        device="cpu")
    slv.setup(pt.gallery.poisson("7pt", 10, 10, 10, dtype=torch.float32,
                                 device="cpu"))
    b = torch.ones(1000, dtype=torch.float32)
    x = slv.amg.cycle(slv.amg.solve_data(), b, torch.zeros_like(b))
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    assert seen and set(seen) == {(torch.float32, torch.float32)}
