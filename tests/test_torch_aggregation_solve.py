"""AmgX's stock pairwise-aggregation files in amgx_tpu_torch against the
JAX package, on the CPU: configs/PCG_AGGREGATION_JACOBI.json (with a
structure-reuse resetup on D A D, all levels and one),
FGMRES_AGGREGATION_JACOBI.json and AGGREGATION_MULTI_PAIRWISE.json at
12^3 in float32: the same iterations, status, hierarchy (rows,
aggregates) and residual history; and a classical resetup's level rows
with and without structure reuse. The selectors, the relabel plan and the transfer
tables are in test_torch_aggregation.py.

The JAX side runs as its own tests run it: its default host setup.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig

import amgx_tpu_torch as pt
from amgx_tpu_torch.amg.hierarchy import AMG
from amgx_tpu_torch.config import Config

from _torch_util import rel
from chip_smoke import CLASSICAL, ROOT, agg_config, scaled_values
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

# f32: one rounding per addition
TOL32 = 1e-6
# f32 Krylov histories, relative to the initial residual (as
# tests/test_torch_flagship.py)
HIST_TOL = 1e-5
SOLVE_N = 12


def _t(a):
    return torch.from_numpy(np.array(a))


def test_classical_structure_reuse_raises():
    """A classical resetup with structure_reuse_levels -1 (every level's
    structure kept) and 0 (set up anew) on 2 A gives the JAX package's
    level rows (CLASSICAL at 8^3; the strength of 2 A is that of A, so
    the JAX package's fresh setup reuses its compiled shapes)."""
    n = 8
    Aj = jx.gallery.poisson("7pt", n, n, n).init()
    A2j = jx.CsrMatrix.from_scipy_like(
        np.asarray(Aj.row_offsets), np.asarray(Aj.col_indices),
        2 * np.asarray(Aj.values), n ** 3, n ** 3).init()
    A = pt.gallery.poisson("7pt", n, n, n, device="cpu").init()
    for reuse in (-1, 0):
        cfg = CLASSICAL + f", amg:structure_reuse_levels={reuse}"
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(Aj)
        js.resetup(A2j)
        ps = pt.create_solver(Config.from_string(cfg), device="cpu")
        ps.setup(A)
        levels = list(_amg(ps).levels)
        ps.resetup(A.with_values(2 * A.values))
        amg = _amg(ps)
        jamg = _amg(js)
        assert amg.level_rows() == [lv.A.num_rows for lv in jamg.levels] + [
            jamg.coarsest_A.num_rows]
        assert all((a.P is b.P) == (reuse != 0)
                   for a, b in zip(amg.levels, levels))


# -- whole solves --------------------------------------------------------------


def _amg(slv):
    while not hasattr(slv, "amg"):
        slv = slv.preconditioner
    return slv.amg


def _configs(name, reuse=None, **extra):
    cj, cp = (agg_config(C, name, reuse) for C in (JaxConfig, Config))
    for k, v in dict(store_res_history=1, **extra).items():
        cj.set(k, v, scope="main")
        cp.set(k, v, scope="main")
    return cj, cp


def _hierarchy(amg):
    return ([lv.A.num_rows for lv in amg.levels] + [amg.coarsest_A.num_rows],
            [np.asarray(lv.aggregates) for lv in amg.levels])


def _run_both(cj, cp, n, resetup=False):
    """Setup + solve (+ resetup on D A D + solve) in both packages on the
    7-pt n^3 float32 Poisson with b = 1: per package the results and the
    hierarchies after each setup, and the aggregates tensors of the
    first setup."""
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            slv = jx.create_solver(cj)
            A = jx.gallery.poisson("7pt", n, n, n, dtype=np.float32).init()
            b = np.ones(n ** 3, np.float32)
            to_vals = jnp.asarray
        else:
            slv = pt.create_solver(cp, device="cpu")
            A = pt.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                                   device="cpu").init()
            b = torch.ones(n ** 3)
            to_vals = _t
        slv.setup(A)
        runs = [(slv.solve(b), _hierarchy(_amg(slv)))]
        first = [lv.aggregates for lv in _amg(slv).levels]
        values = [np.asarray(lv.A.values) for lv in _amg(slv).levels[1:]]
        if resetup:
            slv.resetup(A.with_values(to_vals(scaled_values(
                A.row_offsets, A.col_indices, A.values))))
            runs.append((slv.solve(b), _hierarchy(_amg(slv))))
            values = [np.asarray(lv.A.values)
                      for lv in _amg(slv).levels[1:]]
        out[pkg] = (runs, first, _amg(slv), values)
    return out


def _assert_same_solve(rj, rp, hj, hp):
    assert rp.status == rj.status
    assert rp.iterations == rj.iterations
    assert hp[0] == hj[0]
    assert len(hp[1]) == len(hj[1]) and all(
        np.array_equal(a, b) for a, b in zip(hp[1], hj[1]))
    hist_j, hist_p = np.asarray(rj.res_history), np.asarray(rp.res_history)
    assert hist_p.shape == hist_j.shape
    assert np.abs(hist_p - hist_j).max() <= HIST_TOL * hist_j[0]


@pytest.fixture(scope="module", params=[-1, 1], ids=["reuse_all",
                                                     "reuse_1"])
def pcg_runs(request):
    return request.param, _run_both(*_configs("agg-pcg", request.param),
                                    SOLVE_N, resetup=True)


def test_pcg_aggregation_matches_jax(pcg_runs):
    """configs/PCG_AGGREGATION_JACOBI.json: the same iterations, status,
    hierarchy (rows, aggregates) and residual history."""
    _, out = pcg_runs
    (rj, hj), (rp, hp) = out["jax"][0][0], out["port"][0][0]
    assert rp.status == "success"
    _assert_same_solve(rj, rp, hj, hp)
    # the relabeled coarse operators take the JAX package's layouts (a
    # pattern's choice): level 1 has more than DIA_MAX_OFFSETS offsets,
    # so CSR with B8/B9's lanes per row
    mp, mj = ([lv.A for lv in out[k][2].levels] for k in ("port", "jax"))
    assert [M.dia_offsets is None for M in mp] == \
        [M.dia_offsets is None for M in mj]
    assert mp[1].dia_offsets is None and mp[1].csr_lanes >= 1


def test_fgmres_aggregation_matches_jax():
    out = _run_both(*_configs("agg-fgmres"), SOLVE_N)
    (rj, hj), (rp, hp) = out["jax"][0][0], out["port"][0][0]
    assert rp.status == "success"
    _assert_same_solve(rj, rp, hj, hp)


def test_multi_pairwise_matches_jax():
    """configs/AGGREGATION_MULTI_PAIRWISE.json (standalone AMG, F-cycle,
    DENSE_LU, Notay weights) capped at 5 iterations."""
    path = os.path.join(ROOT, "configs", "AGGREGATION_MULTI_PAIRWISE.json")
    cj, cp = (C.from_file(path) for C in (JaxConfig, Config))
    for c in (cj, cp):
        c.set("max_iters", 5, scope="main")
        c.set("store_res_history", 1, scope="main")
    out = _run_both(cj, cp, SOLVE_N)
    (rj, hj), (rp, hp) = out["jax"][0][0], out["port"][0][0]
    assert rp.iterations == 5
    _assert_same_solve(rj, rp, hj, hp)


def test_resetup_matches_jax(pcg_runs):
    """resetup(D A D) with structure_reuse_levels -1 / 1: the reused
    levels keep their aggregates tensors (no selector ran), every level's
    aggregates equal the JAX package's, the coarse values agree to f32
    rounding, and the solve takes the same iterations."""
    reuse, out = pcg_runs
    (rj, hj), (rp, hp) = out["jax"][0][1], out["port"][0][1]
    _assert_same_solve(rj, rp, hj, hp)
    _, first, amg, values = out["port"]
    kept = len(amg.levels) if reuse < 0 else reuse
    assert all(a is lv.aggregates
               for a, lv in zip(first[:kept], amg.levels[:kept]))
    for vp, vj in zip(values, out["jax"][3]):
        assert rel(vp, vj) <= TOL32
