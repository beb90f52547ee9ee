"""The rest of resetup in amgx_tpu_torch against the JAX package, on the
CPU: classical structure reuse (amg/classical), the GEO value-only route
(amg/value_resetup.py), structure snapshots and `adopt_structure`, and
the cross-setup plan caches (ops/spgemm.py, amg/aggregation/galerkin.py).

Sizes are the smallest the existing port tests compile in the JAX
package: CLASSICAL (bench.py's PCG around a PMIS + D2 + JACOBI_L1 cycle)
at 8^3 in float64, FLAGSHIP with matrix_free=1 at 12^3. The JAX package's
classical setup is most of this file's time, so it is built once.
"""
import dataclasses

import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig

import amgx_tpu_torch as pt
from amgx_tpu_torch.amg import value_resetup
from amgx_tpu_torch.amg.aggregation import AggregationAMGLevel
from amgx_tpu_torch.amg.aggregation import galerkin
from amgx_tpu_torch.amg.classical import ClassicalAMGLevel
from amgx_tpu_torch.ops import spgemm
from amgx_tpu_torch.presets import FLAGSHIP

from _torch_util import rel
from chip_smoke import CLASSICAL, agg_config, scaled_values
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

# float64 Galerkin sums in two implementations
TOL64 = 1e-12
# float32 against the float64 reference, and the value route's pieces
TOL32 = 1e-6
N_CLASSICAL = 8
N_FLAGSHIP = 12
FLAGSHIP_MF = FLAGSHIP + ", amg:matrix_free=1, amg:structure_reuse_levels=-1"


def _amg(slv):
    while not hasattr(slv, "amg"):
        slv = slv.preconditioner
    return slv.amg


def _classical_cfg(reuse):
    return CLASSICAL + f", amg:structure_reuse_levels={reuse}"


def _dense(M):
    """A matrix of either package as a float64 numpy array."""
    ro, ci, v = (np.asarray(t.cpu() if torch.is_tensor(t) else t)
                 for t in (M.row_offsets, M.col_indices, M.values))
    out = np.zeros((M.num_rows, M.num_cols))
    np.add.at(out, (np.repeat(np.arange(M.num_rows), np.diff(ro)), ci),
              v.astype(np.float64))
    return out


def _coarse_ops(amg):
    return [lv.A for lv in amg.levels[1:]] + [amg.coarsest_A]


def _port_poisson(n, dtype=torch.float64):
    return pt.gallery.poisson("7pt", n, n, n, dtype=dtype,
                              device="cpu").init()


def _dad(A):
    return A.with_values(torch.from_numpy(scaled_values(
        A.row_offsets, A.col_indices, A.values)).to(A.dtype))


@pytest.fixture(scope="module")
def jax_classical():
    """The JAX package's CLASSICAL at 8^3 in float64: the setup's level-0
    snapshot, then resetup(D A D) with structure_reuse_levels -1 and
    then 1 on the same hierarchy (the first keeps every level, so the
    second starts from the setup's structure), each solved with b = 1."""
    n = N_CLASSICAL
    cfg = JaxConfig.from_string(_classical_cfg(-1))
    A = jx.gallery.poisson("7pt", n, n, n).init()
    A2 = jx.CsrMatrix.from_scipy_like(
        np.asarray(A.row_offsets), np.asarray(A.col_indices),
        scaled_values(A.row_offsets, A.col_indices, A.values).astype(
            np.float64), n ** 3, n ** 3).init()
    slv = jx.create_solver(cfg)
    slv.setup(A)
    out = {"snapshot": _amg(slv).levels[0].structure_snapshot()}
    b = np.ones(n ** 3)
    for reuse in (-1, 1):
        cfg.set("structure_reuse_levels", reuse, scope="amg")
        slv.resetup(A2)
        amg = _amg(slv)
        res = slv.solve(b)
        out[reuse] = {"rows": [lv.A.num_rows for lv in amg.levels]
                      + [amg.coarsest_A.num_rows],
                      "coarse": [_dense(M) for M in _coarse_ops(amg)],
                      "iterations": res.iterations,
                      "status": str(res.status)}
    return out


@pytest.mark.parametrize("reuse", [-1, 1])
def test_classical_resetup_matches_jax(jax_classical, reuse):
    """setup(A), resetup(D A D): the reused levels keep their CF split,
    P and R (the same tensors), the resetup builds no RAP plan there,
    and the coarse operators, level rows, iterations and status equal
    the JAX package's resetup."""
    A = _port_poisson(N_CLASSICAL)
    slv = pt.create_solver(pt.Config.from_string(_classical_cfg(reuse)),
                           device="cpu")
    slv.setup(A)
    kept = [(lv.cf_map, lv.P, lv.R, lv.rap_plan) for lv in _amg(slv).levels]
    pt.reset_kernel_launches()
    slv.resetup(_dad(A))
    amg = _amg(slv)
    reused = len(kept) if reuse < 0 else reuse
    for lv, (cf, P, R, plan) in zip(amg.levels[:reused], kept):
        assert lv.cf_map is cf and lv.P is P and lv.R is R
        assert lv.rap_plan is plan
    if reuse < 0:
        assert pt.plan_counts()["rap_build"] == 0
    want = jax_classical[reuse]
    assert amg.level_rows() == want["rows"]
    for M, D in zip(_coarse_ops(amg), want["coarse"]):
        assert np.abs(_dense(M) - D).max() <= TOL64 * np.abs(D).max()
    res = slv.solve(torch.ones(A.num_rows, dtype=torch.float64))
    assert res.iterations == want["iterations"]
    assert str(res.status) == want["status"]


def test_classical_resetup_f32_matches_jax(jax_classical):
    """The float32 route (B10's plain twin) on a float32 operator: the
    same structure and level rows as the JAX package's float64 resetup,
    coarse values within TOL32 of it."""
    A = _port_poisson(N_CLASSICAL, torch.float32)
    slv = pt.create_solver(pt.Config.from_string(_classical_cfg(-1)),
                           device="cpu")
    slv.setup(A)
    slv.resetup(_dad(A))
    amg = _amg(slv)
    want = jax_classical[-1]
    assert amg.level_rows() == want["rows"]
    for M, D in zip(_coarse_ops(amg), want["coarse"]):
        assert M.dtype == torch.float32
        assert np.abs(_dense(M) - D).max() <= TOL32 * np.abs(D).max()


def test_classical_snapshot_matches_jax(jax_classical):
    """A classical level's snapshot (CF split, P) equals the JAX
    package's for the same input."""
    slv = pt.create_solver(pt.Config.from_string(_classical_cfg(-1)),
                           device="cpu")
    slv.setup(_port_poisson(N_CLASSICAL))
    meta, arrays = _amg(slv).levels[0].structure_snapshot()
    jmeta, jarrays = jax_classical["snapshot"]
    assert meta == jmeta
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        assert np.array_equal(arrays[k], np.asarray(jarrays[k])), k


# -- the value-only route ------------------------------------------------------


def _one_row_scaled(A):
    v = A.values.clone()
    ro = A.row_offsets
    v[int(ro[5]):int(ro[6])] *= 2
    return A.with_values(v)


def _jax_dia(M):
    return np.asarray(M.dia_vals).reshape(len(M.dia_offsets), -1)[
        :, :M.num_rows]


@pytest.fixture(scope="module")
def jax_flagship():
    """The JAX package's FLAGSHIP with matrix_free=1 at 12^3: the
    setup's level snapshots, then resetup(3 A) (values, taus, stencil
    coefficients, coarse QR, whether the value route ran) and
    resetup(one row scaled) (whether it ran)."""
    n = N_FLAGSHIP
    A = jx.gallery.poisson("7pt", n, n, n).init()
    ro, ci = np.asarray(A.row_offsets), np.asarray(A.col_indices)

    def with_values(v):
        return dataclasses.replace(jx.CsrMatrix.from_scipy_like(
            ro, ci, v, n ** 3, n ** 3), grid_shape=(n, n, n)).init()

    slv = jx.create_solver(JaxConfig.from_string(FLAGSHIP_MF))
    slv.setup(A)
    amg = _amg(slv)
    out = {"snapshots": [lv.structure_snapshot() for lv in amg.levels]}
    slv.resetup(with_values(3 * np.asarray(A.values)))
    out["scaled"] = {
        "value_only": amg._last_resetup_value_only,
        "dia": [_jax_dia(lv.A) for lv in amg.levels] + [
            _jax_dia(amg.coarsest_A)],
        "taus": [np.asarray(lv.smoother._taus) for lv in amg.levels],
        "mf": [np.asarray(lv.smoother._mf_stencil.coeffs)
               for lv in amg.levels],
        "qt": np.asarray(amg.coarse_solver._qt),
        "r": np.asarray(amg.coarse_solver._r)}
    v = 3 * np.asarray(A.values)
    v[ro[5]:ro[6]] *= 2
    slv.resetup(with_values(v))
    out["one_row"] = {"value_only": amg._last_resetup_value_only}
    return out


def _flagship(A):
    slv = pt.create_solver(pt.Config.from_string(FLAGSHIP_MF), device="cpu")
    return slv.setup(A)


def test_value_resetup_matches_jax(jax_flagship):
    """resetup(3 A) takes the value route in both packages, gives the
    JAX package's level slabs, taus, stencil coefficients and coarse QR,
    builds no GEO plan, and the solve equals a fresh setup's on 3 A (the
    same iterations, x bit for bit)."""
    A = _port_poisson(N_FLAGSHIP)
    slv = _flagship(A)
    amg = _amg(slv)
    plans = [lv._geo_plan_memo[0] for lv in amg.levels]
    A3 = A.with_values(3 * A.values)
    pt.reset_kernel_launches()
    slv.resetup(A3)
    want = jax_flagship["scaled"]
    assert amg._last_resetup_value_only is want["value_only"] is True
    assert pt.plan_counts()["geo_build"] == 0
    assert [lv._geo_plan_memo[0] for lv in amg.levels] == plans
    got = [lv.A.dia_vals for lv in amg.levels] + [amg.coarsest_A.dia_vals]
    for g, w in zip(got, want["dia"]):
        assert rel(g, w) <= TOL32
    for lv, taus, mf in zip(amg.levels, want["taus"], want["mf"]):
        assert rel(lv.smoother._taus, taus) <= TOL32
        st = lv.smoother._mf_stencil
        assert rel(st.coeffs, mf) <= TOL32
        assert st.host == tuple(st.coeffs.tolist())
    cs = amg.coarse_solver
    assert rel(cs._qt, want["qt"]) <= TOL32 and rel(cs._r, want["r"]) <= TOL32
    b = torch.ones(A.num_rows, dtype=torch.float64)
    res, fresh = slv.solve(b), _flagship(A3).solve(b)
    assert res.status == fresh.status == "success"
    assert res.iterations == fresh.iterations
    assert res.extra_stats == fresh.extra_stats
    assert torch.equal(res.x, fresh.x)


def test_value_resetup_declines_like_jax(jax_flagship):
    """A one-row-scaled A breaks level 0's constant stencil: both
    packages decline the value route; the port's generic loop then drops
    the stencils the values no longer support."""
    A = _port_poisson(N_FLAGSHIP)
    slv = _flagship(A)
    amg = _amg(slv)
    slv.resetup(_one_row_scaled(A.with_values(3 * A.values)))
    assert amg._last_resetup_value_only is \
        jax_flagship["one_row"]["value_only"] is False
    assert amg.levels[0].smoother._mf_stencil is None


def test_value_resetup_tail_cycle_equals_fresh():
    """The splice drops B5's plans and the cast memo: a tail-entered
    cycle (whole 12^3 cycle in B5's plain twin) after resetup(3 A), in
    float32 and in bfloat16, equals a fresh setup's bit for bit."""
    A = _port_poisson(N_FLAGSHIP)
    for extra in ("", ", amg:amg_precision=bfloat16"):
        cfg = pt.Config.from_string(
            "solver=AMG, algorithm=AGGREGATION, selector=GEO,"
            " smoother=CHEBYSHEV_POLY, chebyshev_polynomial_order=2,"
            " max_levels=50, min_coarse_rows=32, matrix_free=1,"
            " structure_reuse_levels=-1" + extra)
        A32 = A.astype(torch.float32)
        slv = pt.create_solver(cfg, device="cpu").setup(A32)
        b = torch.linspace(-1, 1, A.num_rows, dtype=torch.float32)
        amg = _amg(slv)
        amg.cycle(amg.solve_data(), b, torch.zeros_like(b))   # plans made
        A3 = A32.with_values(3 * A32.values)
        slv.resetup(A3)
        assert amg._last_resetup_value_only
        fresh = _amg(pt.create_solver(cfg, device="cpu").setup(A3))
        x = amg.cycle(amg.solve_data(), b, torch.zeros_like(b))
        y = fresh.cycle(fresh.solve_data(), b, torch.zeros_like(b))
        assert any(hit[1] is not None for hit in amg._tail_plans.values())
        assert torch.equal(x, y)


def test_value_resetup_dad_takes_the_generic_route():
    """D A D is not a constant stencil: the generic loop runs, every
    level's stencil is dropped and the hierarchy equals a fresh setup's
    on D A D (the same solve, bit for bit)."""
    A = _port_poisson(N_FLAGSHIP)
    slv = _flagship(A)
    A2 = _dad(A)
    slv.resetup(A2)
    amg = _amg(slv)
    assert not amg._last_resetup_value_only
    assert all(lv.smoother._mf_stencil is None for lv in amg.levels)
    b = torch.ones(A.num_rows, dtype=torch.float64)
    res, fresh = slv.solve(b), _flagship(A2).solve(b)
    assert res.iterations == fresh.iterations
    assert torch.equal(res.x, fresh.x)


# -- snapshots and adopt_structure ---------------------------------------------


def test_aggregation_snapshot_matches_jax(jax_flagship):
    """Every GEO level's snapshot (meta and aggregates) equals the JAX
    package's for the same input."""
    amg = _amg(_flagship(_port_poisson(N_FLAGSHIP)))
    snaps = [lv.structure_snapshot() for lv in amg.levels]
    assert len(snaps) == len(jax_flagship["snapshots"])
    for (meta, arrays), (jmeta, jarrays) in zip(snaps,
                                                jax_flagship["snapshots"]):
        assert meta == jmeta
        assert np.array_equal(arrays["aggregates"],
                              np.asarray(jarrays["aggregates"]))


def _refuse_selectors(monkeypatch):
    from amgx_tpu_torch import registry

    def refuse(*a, **k):
        raise AssertionError("a selector ran")

    for reg in (registry.aggregation_selectors,
                registry.classical_selectors, registry.strength):
        monkeypatch.setattr(reg, "create", refuse)


@pytest.mark.parametrize("kind", ["classical", "aggregation"])
def test_adopt_structure_equals_resetup(monkeypatch, kind):
    """Snapshot -> structure_restore -> adopt_structure -> setup(D A D)
    runs no selector or strength, and gives the hierarchy of a resetup
    on D A D; a row-count mismatch discards the ghosts."""
    if kind == "classical":
        cfg = pt.Config.from_string(_classical_cfg(-1))
        A, cls = _port_poisson(N_CLASSICAL), ClassicalAMGLevel
    else:
        cfg = agg_config(pt.Config, "agg-pcg", -1)
        A, cls = _port_poisson(N_CLASSICAL, torch.float32), \
            AggregationAMGLevel
    slv = pt.create_solver(cfg, device="cpu").setup(A)
    ghosts = [cls.structure_restore(*lv.structure_snapshot())
              for lv in _amg(slv).levels]
    A2 = _dad(A)
    slv.resetup(A2)
    other = pt.create_solver(cfg, device="cpu")
    with monkeypatch.context() as m:
        _refuse_selectors(m)
        _amg(other).adopt_structure(ghosts)
        other.setup(A2)
    a, o = _amg(slv), _amg(other)
    assert o.level_rows() == a.level_rows()
    for M, N in zip([lv.A for lv in a.levels] + [a.coarsest_A],
                    [lv.A for lv in o.levels] + [o.coarsest_A]):
        assert torch.equal(M.values, N.values)
    b = torch.ones(A.num_rows, dtype=A.dtype)
    assert torch.equal(slv.solve(b).x, other.solve(b).x)
    _amg(other).adopt_structure(ghosts)
    small = _port_poisson(N_CLASSICAL - 2, A.dtype)
    assert other.setup(small).solve(
        torch.ones(small.num_rows, dtype=A.dtype)).status == "success"
    assert _amg(other)._ghost_levels is None


# -- the plan caches -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["rap", "agg"])
def test_warm_setup_builds_no_plan(kind):
    """A second solver's setup on new pattern tensors of the same content
    is served every plan from the cache: no build."""
    if kind == "rap":
        cfg, dtype = pt.Config.from_string(CLASSICAL), torch.float64
    else:
        cfg, dtype = agg_config(pt.Config, "agg-pcg"), torch.float32
    first = pt.create_solver(cfg, device="cpu").setup(
        _port_poisson(N_CLASSICAL, dtype))
    pt.reset_kernel_launches()
    second = pt.create_solver(cfg, device="cpu").setup(
        _port_poisson(N_CLASSICAL, dtype))
    counts = pt.plan_counts()
    levels = len(_amg(second).levels)
    assert counts[kind + "_build"] == 0 and counts[kind + "_hit"] == levels
    for a, b in zip(_coarse_ops(_amg(first)), _coarse_ops(_amg(second))):
        assert torch.equal(a.values, b.values)


def test_permuted_pattern_never_served_a_stale_plan():
    """A structure resetup on a symmetric permutation of A (the same
    size and nnz, another pattern): the memo misses, the cache keys on
    content, so the coarse operators equal those of the eager
    composition (spgemm_plan=0) on the same sequence."""
    n = N_CLASSICAL
    A = _port_poisson(n)
    perm = torch.from_numpy(np.random.default_rng(7).permutation(n ** 3))
    rows, cols, vals = A.coo()
    Ap = pt.CsrMatrix.from_coo(perm[rows], perm[cols.long()], vals,
                               n ** 3, n ** 3).init()
    assert Ap.nnz == A.nnz
    out = []
    for extra in ("", ", amg:spgemm_plan=0"):
        slv = pt.create_solver(pt.Config.from_string(
            _classical_cfg(-1) + extra), device="cpu").setup(A)
        slv.resetup(Ap)
        out.append(_coarse_ops(_amg(slv)))
    for M, E in zip(*out):
        D = _dense(E)
        assert np.abs(_dense(M) - D).max() <= TOL64 * np.abs(D).max()


def test_cache_checks_content_behind_the_fingerprint(monkeypatch):
    """With every fingerprint colliding, the kept patterns' comparison
    still refuses another pattern's plan."""
    monkeypatch.setattr(spgemm, "_fingerprint", lambda tensors: ())
    A = _port_poisson(6)
    agg = torch.arange(A.num_rows, dtype=torch.int32) // 2
    B = pt.CsrMatrix.from_coo(*(t.flip(0) if i < 2 else t
                                for i, t in enumerate(A.coo())),
                              A.num_rows, A.num_cols)
    pt.reset_kernel_launches()
    p1 = spgemm.get_agg_plan(A, agg, A.num_rows // 2)
    assert spgemm.get_agg_plan(A, agg, A.num_rows // 2) is p1
    p2 = spgemm.get_agg_plan(B, agg.flip(0).contiguous(), A.num_rows // 2)
    assert p2 is not p1
    assert pt.plan_counts()["agg_build"] == 2
    assert pt.plan_counts()["agg_hit"] == 1


def test_geo_plan_deferred_wrap_check():
    """A GEO level whose values wrap a grid row (a periodic coupling in
    x): the build's one deferred read fails and the level is rebuilt
    with the relabel product (no GEO plan memo), equal to the relabel
    product of the same aggregates."""
    n = N_CLASSICAL
    A = _port_poisson(n, torch.float32)
    rows, cols, vals = A.coo()
    extra = torch.arange(0, n ** 3, n)
    Aw = pt.CsrMatrix.from_coo(
        torch.cat([rows, extra, extra + n - 1]),
        torch.cat([cols.long(), extra + n - 1, extra]),
        torch.cat([vals, torch.full((2 * extra.numel(),), -0.5)]),
        n ** 3, n ** 3)
    Aw = dataclasses.replace(Aw, grid_shape=(n, n, n)).init()
    assert Aw.dia_offsets is not None
    cfg = pt.Config.from_string(
        "solver=AMG, algorithm=AGGREGATION, selector=GEO,"
        " smoother=CHEBYSHEV_POLY, max_levels=2, min_coarse_rows=8")
    amg = _amg(pt.create_solver(cfg, device="cpu").setup(Aw))
    lv = amg.levels[0]
    assert lv._geo_plan_memo is None
    want = spgemm.plan_coarse_matrix(
        spgemm.build_agg_plan(Aw, lv.aggregates, int(lv.coarse_size)), Aw)
    assert torch.equal(amg.coarsest_A.values, want.values)
    plan = galerkin.get_geo_plan(Aw, (n, n, n), lv.geo_axes,
                                 lv.geo_coarse_shape)
    assert plan.wrapped(Aw.dia_vals)
    assert value_resetup.build_plan(amg) is None
