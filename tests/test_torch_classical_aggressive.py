"""Classical aggressive coarsening of amgx_tpu_torch against the JAX
package, in float64 on the 7-pt Poisson at 8^3-10^3: the RS first pass
(the host bucket queue) and HMIS, the aggressive selectors' two-hop
graph S S and PMIS split on it, DUMMY_CLASSICAL, the MULTIPASS and D1
interpolators, and the stock files with `aggressive_levels` > 0 set up
and solved by both packages (level rows, CF splits, P and the coarse
operators, then status, iterations and x).

Splits are integer decisions and must be bit-equal; interpolation
weights and coarse operators agree within 1e-12 (every sum of the port
is an ordered sum in the reference's order, so they agree to the bit
where the reference sums in sorted order too).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu import registry as jx_registry
from amgx_tpu.amg.classical import interpolators as jx_interp
from amgx_tpu.amg.classical import selectors as jx_sel
from amgx_tpu.amg.classical.strength import AhatStrength as JaxAhat

import amgx_tpu_torch as pt
from amgx_tpu_torch import registry as pt_registry
from amgx_tpu_torch.amg.classical import interpolators as pt_interp
from amgx_tpu_torch.amg.classical import selectors as pt_sel
from amgx_tpu_torch.amg.classical.strength import AhatStrength
from amgx_tpu_torch.amg.hierarchy import AMG

from _torch_util import ROOT, rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12
STRENGTH = "strength_threshold=0.25, max_row_sum=0.9"
# the stock files whose AMG coarsens aggressively (aggressive_levels 1,
# 1 and 2): PMIS + MULTIPASS, HMIS (the RS pass below level 0), and
# BLOCK_JACOBI under PCG
FILES = ["FGMRES_CLASSICAL_AGGRESSIVE_PMIS",
         "AMG_CLASSICAL_L1_AGGRESSIVE_HMIS", "PCG_CLASSICAL_V_JACOBI"]


@pytest.fixture(scope="module")
def grid():
    """The 10^3 operator and its AHAT strength in both packages (the
    masks bit-equal)."""
    n = 10
    Aj = jx.gallery.poisson("7pt", n, n, n).init()
    Ap = pt.gallery.poisson("7pt", n, n, n, device="cpu").init()
    sj = JaxAhat(jx.Config.from_string(STRENGTH), "default").strong_mask(Aj)
    sp = AhatStrength(pt.Config.from_string(STRENGTH),
                      "default").strong_mask(Ap)
    assert np.array_equal(np.asarray(sj), sp.numpy())
    return Aj, Ap, sj, sp


def test_rs_pass_is_the_reference_queue(grid):
    Aj, Ap, sj, sp = grid
    cj = jx_sel.rs_split_python(Aj.num_rows, np.asarray(Aj.row_offsets),
                                np.asarray(Aj.col_indices), np.asarray(sj))
    cp = pt_sel.rs_split(Ap, sp)
    assert cp.dtype == np.int32 and np.array_equal(cp, np.asarray(cj))
    assert 0 < cp.sum() < Ap.num_rows


@pytest.mark.parametrize("name", ["RS", "HMIS", "DUMMY_CLASSICAL"])
def test_selector_split_bit_equal(grid, name):
    Aj, Ap, sj, sp = grid
    jsel = jx_registry.classical_selectors.create(
        name, jx.Config.from_string(STRENGTH), "default")
    psel = pt_registry.classical_selectors.create(
        name, pt.Config.from_string(STRENGTH), "default")
    cj = np.asarray(jsel.mark_coarse_fine_points(Aj, sj))
    cp = psel.mark_coarse_fine_points(Ap, sp)
    assert cp.dtype == torch.int32
    assert np.array_equal(cp.numpy(), cj)


def test_pmis_keeps_a_seeded_split(grid):
    """PMIS seeded with a full split keeps it; seeded with a partial one
    it decides only the UNDECIDED points, as the reference does."""
    Aj, Ap, sj, sp = grid
    n = Ap.num_rows
    seed = np.full(n, -1, np.int32)
    seed[::7] = 1
    seed[3::11] = 0
    cj = np.asarray(jx_sel.pmis_split(Aj, sj, init=seed))
    cp = pt_sel.pmis_split(Ap, sp, init=torch.from_numpy(seed)).numpy()
    assert np.array_equal(cp, cj)
    decided = seed >= 0
    assert np.array_equal(cp[decided], seed[decided])
    full = pt_sel.rs_split(Ap, sp)
    assert np.array_equal(pt_sel.pmis_split(Ap, sp, init=full).numpy(),
                          full)


@pytest.mark.parametrize("name", ["AGGRESSIVE_PMIS", "AGGRESSIVE_HMIS"])
def test_aggressive_two_hop_graph_and_split(grid, name):
    Aj, Ap, sj, sp = grid
    S2j = jx_sel._two_hop_strength(Aj, sj)
    S2p = pt_sel.two_hop_strength(Ap, sp)
    for key in ("row_offsets", "col_indices", "values"):
        assert np.array_equal(getattr(S2p, key).numpy(),
                              np.asarray(getattr(S2j, key))), key
    jsel = jx_registry.classical_selectors.create(name, None, "default")
    psel = pt_registry.classical_selectors.create(name, None, "default")
    cj = np.asarray(jsel.mark_coarse_fine_points(Aj, sj))
    cp = psel.mark_coarse_fine_points(Ap, sp).numpy()
    assert np.array_equal(cp, cj)
    # two hops coarsen harder than one
    assert cp.sum() < pt_sel.pmis_split(Ap, sp).sum()


@pytest.mark.parametrize("name", ["MULTIPASS", "D1"])
@pytest.mark.parametrize("extra", ["", ", interp_max_elements=2",
                                   ", interp_truncation_factor=0.3"])
def test_interpolator_matches_jax(grid, name, extra):
    """P from the aggressive split (MULTIPASS's case: pass numbers up to
    the two-hop distance), truncated as configured."""
    Aj, Ap, sj, sp = grid
    cf = np.asarray(jx_sel.AggressivePMISSelector(None, None)
                    .mark_coarse_fine_points(Aj, sj))
    jcls = {"MULTIPASS": jx_interp.MultipassInterpolator,
            "D1": jx_interp.Distance1Interpolator}[name]
    pcls = {"MULTIPASS": pt_interp.MultipassInterpolator,
            "D1": pt_interp.Distance1Interpolator}[name]
    Pj = jcls(jx.Config.from_string(STRENGTH + extra), "default").generate(
        Aj, jnp.asarray(cf), sj)
    Pp = pcls(pt.Config.from_string(STRENGTH + extra), "default").generate(
        Ap, torch.from_numpy(cf), sp)
    assert (Pp.num_rows, Pp.num_cols) == (Pj.num_rows, Pj.num_cols)
    assert np.array_equal(Pp.row_offsets.numpy(),
                          np.asarray(Pj.row_offsets))
    assert np.array_equal(Pp.col_indices.numpy(),
                          np.asarray(Pj.col_indices))
    vj = np.asarray(Pj.values)
    assert np.abs(Pp.values.numpy() - vj).max() <= TOL * np.abs(vj).max()
    if "max_elements" in extra:
        assert int(torch.diff(Pp.row_offsets).max()) <= 2


@pytest.mark.parametrize("selector, aggressive, want", [
    ("PMIS", "DEFAULT", "AGGRESSIVE_PMIS"),
    ("HMIS", "DEFAULT", "AGGRESSIVE_HMIS"),
    ("AGGRESSIVE_PMIS", "DEFAULT", "AGGRESSIVE_PMIS"),
    ("PMIS", "NO_SUCH_SELECTOR", "PMIS")])
def test_aggressive_selector_resolution(grid, monkeypatch, selector,
                                        aggressive, want):
    """Level 0 of aggressive_levels=1 takes aggressive_selector (DEFAULT:
    AGGRESSIVE_ + the selector's name; an unknown name: PMIS) and
    aggressive_interpolator; level 1 the plain selector and D2."""
    seen = []
    real = pt_registry.classical_selectors.create

    def spy(name, *a, **k):
        seen.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(pt_registry.classical_selectors, "create", spy)
    amg = AMG(pt.Config.from_string(
        f"algorithm=CLASSICAL, selector={selector}, interpolator=D2,"
        f" aggressive_levels=1, aggressive_selector={aggressive},"
        f" max_levels=3, {STRENGTH}"))
    amg.setup(grid[1])
    assert seen[0] == want
    assert [lv._aggressive for lv in amg.levels] == \
        [True] + [False] * (len(amg.levels) - 1)


def test_selector_device_sweep_is_not_ported(grid):
    """selector_device_sweep=1 (ported since the test's name was given):
    HMIS's first pass is the device-parallel RS sweep, its split the JAX
    package's bit for bit, counted under amg.selector.device_sweep."""
    from amgx_tpu_torch.telemetry import metrics as pm
    text = "selector_device_sweep=1"
    before = pm.snapshot()["amg.selector.device_sweep"]
    sel = pt_registry.classical_selectors.create(
        "HMIS", pt.Config.from_string(text), "default")
    cp = sel.mark_coarse_fine_points(grid[1], grid[3])
    cj = jx_registry.classical_selectors.create(
        "HMIS", jx.Config.from_string(text), "default"
    ).mark_coarse_fine_points(grid[0], grid[2])
    assert np.array_equal(cp.numpy(), np.asarray(cj))
    assert pm.snapshot()["amg.selector.device_sweep"] == \
        before + 1


@pytest.fixture(scope="module", params=FILES)
def stock(request):
    """One stock file set up and solved by both packages at 10^3 in
    float64: (name, JAX result, port result, JAX solver's AMG, port
    solver's AMG)."""
    name = request.param
    path = os.path.join(ROOT, "configs", name + ".json")
    n = 10
    js = jx.create_solver(jx.Config.from_file(path))
    js.setup(jx.gallery.poisson("7pt", n, n, n).init())
    ps = pt.create_solver(pt.Config.from_file(path), device="cpu")
    ps.setup(pt.gallery.poisson("7pt", n, n, n, device="cpu"))
    b = np.ones(n ** 3)
    return (name, js.solve(b), ps.solve(torch.from_numpy(b)), _amg(js),
            _amg(ps))


def _amg(slv):
    while not hasattr(slv, "amg"):
        slv = slv.preconditioner
    return slv.amg


def test_aggressive_hierarchy_matches_jax(stock):
    """Level rows and CF splits equal, P and every coarse operator within
    1e-12; the first aggressive_levels levels are aggressive."""
    name, _, _, aj, ap = stock
    assert ap.level_rows() == [lv.A.num_rows for lv in aj.levels] + [
        aj.coarsest_A.num_rows]
    for lj, lp in zip(aj.levels, ap.levels):
        assert lp._aggressive == lj._aggressive
        assert np.array_equal(lp.cf_map.numpy(), np.asarray(lj.cf_map))
        for Mj, Mp in ((lj.P, lp.P), (lj.A, lp.A)):
            assert np.array_equal(Mp.row_offsets.numpy(),
                                  np.asarray(Mj.row_offsets))
            assert np.array_equal(Mp.col_indices.numpy(),
                                  np.asarray(Mj.col_indices))
            vj = np.asarray(Mj.values)
            assert np.abs(Mp.values.numpy() - vj).max() \
                <= TOL * np.abs(vj).max()
    want = 2 if name == "PCG_CLASSICAL_V_JACOBI" else 1
    assert [lv._aggressive for lv in ap.levels] == \
        [i < want for i in range(len(ap.levels))]


def test_aggressive_stock_file_matches_jax(stock):
    name, rj, rp, _, _ = stock
    assert rp.status == str(rj.status) == "success"
    assert rp.iterations == int(rj.iterations)
    assert rel(rp.x, np.asarray(rj.x)) <= TOL


def test_transfer_route_matches_jax(stock):
    """Each level takes the weighted transfer tables (B3w / B4w) exactly
    where the JAX package builds its weighted slabs: R rows of at most
    32 entries, P rows of at most 16, a DIA fine operator."""
    from amgx_tpu.ops.smooth import build_csr_transfer_slabs
    _, _, _, aj, ap = stock
    routes = []
    for lj, lp in zip(aj.levels, ap.levels):
        jw = build_csr_transfer_slabs(lj.A, lj.P, lj.R) is not None
        pw = lp._transfer_tables() is not None
        assert pw == jw
        routes.append(pw)
    assert routes[0]          # the 10^3 level 0: rows within the caps
