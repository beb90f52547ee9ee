"""The port's telemetry and runtime helpers (amgx_tpu_torch/telemetry/,
profiling.py, determinism.py, thread_manager.py, memory_info.py) against
the JAX package's, on the CPU.

- the metric catalog's names and kinds; `snapshot` and `to_openmetrics`
  after the same recorded sequence; the setup / resetup routing counters
  after the same setup and resetup;
- SolveReport: status, iterations, residuals (1e-12 in float64, 1e-6 in
  float32), the hierarchy's rows / nnz / complexities, `validate_report`
  against the copied schema, strict JSON on a NaN solve;
- the diagnostics block at 10^3 on PCG + AMG and on the FLAGSHIP-shaped
  nested tree: per-level reduction factors within 1e-6, the same
  bottleneck level; the probe on one residual, norm by norm;
- the span names of one setup and solve, the Chrome trace export;
- DeterminismChecker, `setup_async` equal to `setup`;
- BatchedSolveResult.reports against the JAX package's batch reports;
- tools/check_spans.py's rules 1, 3 and 4 on amgx_tpu_torch: every span
  and metric name the port records is declared, every declared name has
  a site or is listed as waiting (`metrics.WAITING`).

The routing columns of a report's levels describe each package's own
kernels (see amgx_tpu_torch/telemetry/report.py); the columns compared
here are those both define by meaning.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import amgx_tpu as jx
import amgx_tpu.batch as jbatch
from amgx_tpu.telemetry import diagnostics as jdiag
from amgx_tpu.telemetry import metrics as jm
from amgx_tpu.telemetry import spans as jspans

import amgx_tpu_torch as pt
from amgx_tpu_torch import determinism, memory_info
from amgx_tpu_torch.batch import BatchedSolver
from amgx_tpu_torch.resilience import faultinject as pfi
from amgx_tpu_torch.telemetry import diagnostics as pdiag
from amgx_tpu_torch.telemetry import metrics as pm
from amgx_tpu_torch.telemetry import spans as pspans
from amgx_tpu_torch.telemetry import validate_report
from _torch_util import ROOT, single_torch_thread  # noqa: F401  (autouse)

jx.initialize()

# tests/test_diagnostics.py's configurations
AMG_PCG = (
    "solver(s)=PCG, s:max_iters=60, s:tolerance=1e-8,"
    " s:convergence=RELATIVE_INI, s:monitor_residual=1,"
    " s:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION,"
    " amg:selector=SIZE_2, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1,"
    " amg:presweeps=1, amg:postsweeps=1, amg:max_iters=1,"
    " amg:coarse_solver=DENSE_LU_SOLVER, amg:min_coarse_rows=16,"
    " amg:max_levels=10")
NESTED = (
    "solver=REFINEMENT, max_iters=15, monitor_residual=1,"
    " tolerance=1e-9, convergence=RELATIVE_INI,"
    " preconditioner(in)=FGMRES, in:max_iters=20,"
    " in:monitor_residual=1, in:tolerance=1e-5, in:gmres_n_restart=10,"
    " in:convergence=RELATIVE_INI, in:preconditioner(amg)=AMG,"
    " amg:algorithm=AGGREGATION, amg:selector=SIZE_2,"
    " amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, amg:presweeps=1,"
    " amg:postsweeps=1, amg:max_iters=1, amg:cycle=V,"
    " amg:min_coarse_rows=16, amg:max_levels=10")
# standalone AMG (tests/test_resilience.py's drill shape, 10^3)
AMG_ALONE = (
    "solver(amg)=AMG, amg:max_iters=30, amg:monitor_residual=1,"
    " amg:tolerance=1e-8, amg:convergence=RELATIVE_INI,"
    " amg:algorithm=AGGREGATION, amg:selector=SIZE_2,"
    " amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, amg:presweeps=1,"
    " amg:postsweeps=1, amg:cycle=V, amg:coarse_solver=DENSE_LU_SOLVER,"
    " amg:min_coarse_rows=16")
ROUTES = ("amg.setup.full", "amg.resetup.value", "amg.resetup.structure",
          "amg.setup.restored")


def _grid(points, shape, dtype=np.float64):
    Aj = jx.gallery.poisson(points, *shape, dtype=dtype).init()
    Ap = pt.gallery.poisson(points, *shape, device="cpu",
                            dtype=getattr(torch, np.dtype(dtype).name))
    return Aj, Ap.init()


def _solve_both(text, Aj, Ap, b=None):
    js = jx.create_solver(jx.Config.from_string(text))
    js.setup(Aj)
    ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
    ps.setup(Ap)
    dt = np.asarray(Aj.values).dtype
    b = np.ones(Ap.num_rows, dt) if b is None else b
    return js, ps, js.solve(b), ps.solve(torch.from_numpy(b))


@pytest.fixture(scope="module", params=["pcg_amg", "amg"])
def diag10(request):
    Aj, Ap = _grid("7pt", (10, 10, 10))
    text = AMG_PCG if request.param == "pcg_amg" else AMG_ALONE
    return _solve_both(text + ", diagnostics=1", Aj, Ap)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_catalog_is_the_jax_packages():
    assert pm.COUNTERS.keys() == jm.COUNTERS.keys()
    assert pm.GAUGES.keys() == jm.GAUGES.keys()
    assert pm.HISTOGRAMS.keys() == jm.HISTOGRAMS.keys()
    assert pm.HISTOGRAM_EDGES == jm.HISTOGRAM_EDGES
    with pytest.raises(KeyError) as ei:
        pm.inc("batch.requets")
    assert "batch.requests" in str(ei.value)


def _record(m):
    m.inc("batch.requests", 3)
    m.inc("resilience.fallback.retry")
    m.set_gauge("batch.bucket_occupancy", 0.625)
    m.max_gauge("memory.setup_peak_bytes", 4096)
    m.max_gauge("memory.setup_peak_bytes", 1024)
    for v, t in ((0.003, "a"), (0.2, "b"), (7.5, "a"), (0.0004, "b")):
        m.observe("serving.solve_latency_s", v, labels={"tenant": t})
    m.observe("autotune.shadow_wall_s", 1.5)


def test_snapshot_and_openmetrics_after_the_same_sequence():
    jm.reset()
    pm.reset()
    _record(jm)
    _record(pm)
    assert pm.snapshot() == jm.snapshot()
    assert pm.to_openmetrics() == jm.to_openmetrics()
    assert pm.quantile("serving.solve_latency_s", 0.5) == \
        jm.quantile("serving.solve_latency_s", 0.5)


@pytest.mark.parametrize("case", ["geo_value", "agg_structure"])
def test_routing_counters_after_setup_and_resetup(case):
    """A GEO / CHEBYSHEV_POLY hierarchy's resetup takes the value route,
    a SIZE_2 one the structure route; both packages count the same."""
    if case == "geo_value":
        text = pt.presets.FLAGSHIP + ", amg:structure_reuse_levels=-1"
        Aj, Ap = _grid("7pt", (10, 10, 10))
    else:
        text = pt.presets.BATCHED_CG
        Aj, Ap = _grid("5pt", (16, 16))
    counts = {}
    for name, pkg, m, A in (("jax", jx, jm, Aj), ("port", pt, pm, Ap)):
        m.reset()
        kw = {} if pkg is jx else {"device": "cpu"}
        slv = pkg.create_solver(pkg.Config.from_string(text), **kw)
        slv.setup(A)
        slv.resetup(A.with_values(A.values * 2.0))
        snap = m.snapshot()
        counts[name] = {k: snap[k] for k in ROUTES}
    assert counts["port"] == counts["jax"]
    want = "amg.resetup.value" if case == "geo_value" \
        else "amg.resetup.structure"
    assert counts["port"]["amg.setup.full"] == 1 and \
        counts["port"][want] == 1


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_report_matches_jax(dtype, tol):
    Aj, Ap = _grid("7pt", (10, 10, 10), dtype)
    _, ps, rj, rp = _solve_both(AMG_PCG, Aj, Ap)
    dj, dp = rj.report.to_dict(), rp.report.to_dict()
    assert validate_report(dp) == [] and validate_report(dj) == []
    for key in ("solver", "status", "status_code", "iterations",
                "converged", "cycle"):
        assert dp[key] == dj[key], key
    np.testing.assert_allclose(dp["residuals"], dj["residuals"],
                               rtol=tol, atol=tol * dj["residuals"][0])
    assert len(dp["residuals"]) == rp.iterations + 1
    for lj, lp in zip(dj["levels"], dp["levels"]):
        assert (lp["level"], lp["rows"], lp["nnz"]) == \
            (lj["level"], lj["rows"], lj["nnz"])
    hj, hp = dj["hierarchy"], dp["hierarchy"]
    assert hp["num_levels"] == hj["num_levels"]
    assert [r["rows"] for r in hp["levels"]] == \
        [r["rows"] for r in hj["levels"]]
    assert hp["operator_complexity"] == pytest.approx(
        hj["operator_complexity"], rel=1e-12)
    # the port's own routes: B3 / B4 on the DIA level 0, B9 + B8 below;
    # float64 levels decline the kernels' dtypes and compose unfused
    if dtype == np.float32:
        assert dp["levels"][0]["kernels"] == ["B3", "B4"]
        assert all(r["kernels"] == ["B9", "B8"]
                   for r in dp["levels"][1:-1])
    else:
        assert all(r["fused_routing"] == "declined_dtype"
                   and r["kernels"] == [] for r in dp["levels"][:-1])
    assert dp["levels"][-1]["coarse_solver"] == "DENSE_LU_SOLVER"


def test_flagship_report_names_the_tail_and_the_tiled_launches():
    """Matrix-free GEO levels report B3-mf / B4-mf with one launch each a
    visit; the levels from the B5 tail's entry down report the tail."""
    A = pt.gallery.poisson("7pt", 16, 16, 16, device="cpu",
                           dtype=torch.float64)
    slv = pt.create_solver(pt.Config.from_string(
        pt.presets.FLAGSHIP + ", amg:matrix_free=1,"
        " amg:cycle_fusion_tail_rows=600"), device="cpu")
    slv.setup(A)
    d = slv.solve(torch.ones(A.num_rows, dtype=torch.float64)
                  ).report.to_dict()
    assert validate_report(d) == []
    assert d["tail_entry_level"] == 1
    top = d["levels"][0]
    assert (top["matrix_free"], top["kernels"], top["kernels_per_visit"]) \
        == (True, ["B3-mf", "B4-mf"], 2)
    assert all(r["kind"] == "coarse_tail" and r["kernels"] == ["B5-mf"]
               for r in d["levels"][1:-1])
    assert d["precision"] is None


def test_report_is_strict_json_on_a_nan_solve():
    _, Ap = _grid("5pt", (16, 16))
    slv = pt.create_solver(pt.Config.from_string(
        "solver=CG, max_iters=50, monitor_residual=1, tolerance=1e-8,"
        " convergence=RELATIVE_INI"), device="cpu")
    slv.setup(Ap)
    with pfi.inject("spmv_nan", iteration=3):
        res = slv.solve(torch.ones(Ap.num_rows, dtype=torch.float64))
    assert res.status == "nan_detected"
    text = res.report.to_json()
    d = json.loads(text)                    # no bare NaN tokens
    assert "NaN" not in text and d["residuals"][-1] is None
    assert d["status"] == "nan_detected" and validate_report(d) == []
    lines = []
    pt.register_print_callback(lambda msg, n: lines.append(msg))
    try:
        res.report.emit(include_counters=True)
    finally:
        pt.register_print_callback(None)
    assert json.loads(lines[0])["amgx_report"]["counters"][
        "solver.retrace.solve"] >= 1


def test_telemetry_off_attaches_no_report_and_launches_the_same():
    _, Ap = _grid("7pt", (10, 10, 10), np.float32)
    out = {}
    for flag in (0, 1):
        slv = pt.create_solver(pt.Config.from_string(
            AMG_PCG + f", telemetry={flag}"), device="cpu")
        slv.setup(Ap)
        out[flag] = slv.solve(torch.ones(Ap.num_rows))
    assert out[0].report is None and out[1].report is not None
    assert torch.equal(out[0].x, out[1].x)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

FACTORS = ("presmooth_reduction", "correction_reduction",
           "postsmooth_reduction", "level_reduction",
           "smoother_effectiveness")


def _same_diagnostics(dj, dp, tol=1e-6):
    assert dp["stages"] == dj["stages"]
    assert dp["bottleneck_level"] == dj["bottleneck_level"] is not None
    assert len(dp["levels"]) == len(dj["levels"])
    for lj, lp in zip(dj["levels"], dp["levels"]):
        for key in FACTORS:
            assert lp[key] == pytest.approx(lj[key], rel=tol), \
                (lj["level"], key)


def test_diagnostics_match_jax_on_amg(diag10):
    _, _, rj, rp = diag10
    assert rp.iterations == int(rj.iterations)
    dj, dp = rj.report.diagnostics, rp.report.diagnostics
    _same_diagnostics(dj, dp)
    assert all(r["level_reduction"] is not None for r in dp["levels"])
    assert validate_report(rp.report.to_dict()) == []
    assert pdiag.suggest_config_deltas(dp) == \
        jdiag.suggest_config_deltas(dj)


def test_probe_norms_match_jax_on_one_residual(diag10):
    """The probe cycle alone, both packages on the same residual: each
    recorded stage norm within 1e-12 (float64)."""
    js, ps, _, _ = diag10
    r = np.random.default_rng(7).standard_normal(ps.A.num_rows)
    ja = getattr(js, "amg", None) or js.preconditioner.amg
    pa = getattr(ps, "amg", None) or ps.preconditioner.amg
    vj = np.asarray(jdiag.probe_cycle(ja, ja.solve_data(),
                                      jx_array(r), np.float64))
    vp = pdiag.probe_cycle(pa, pa.solve_data(), torch.from_numpy(r),
                           torch.float64).numpy()
    np.testing.assert_allclose(vp, vj, rtol=1e-12)


def jx_array(r):
    import jax.numpy as jnp
    return jnp.asarray(r)


def test_diagnostics_match_jax_on_the_nested_tree():
    """The probe reaches the float32 hierarchy two preconditioners deep.
    Each package probes its own final residual, and those part at the
    float32 inner solve's rounding, so the solves' blocks agree on the
    bottleneck level and the probe is held to 1e-6 on one residual."""
    Aj, Ap = _grid("7pt", (10, 10, 10))
    js, ps, rj, rp = _solve_both(NESTED + ", amg:diagnostics=1", Aj, Ap)
    assert rp.converged and (rp.iterations, rp.status) == \
        (int(rj.iterations), rj.status)
    dj, dp = rj.report.diagnostics, rp.report.diagnostics
    assert dp["bottleneck_level"] == dj["bottleneck_level"] is not None
    assert all(r["level_reduction"] is not None for r in dp["levels"])
    for lj, lp in zip(dj["levels"], dp["levels"]):
        for key in FACTORS:
            assert lp[key] == pytest.approx(lj[key], rel=1e-2)
    ja = js.preconditioner.preconditioner.amg
    pa = ps.preconditioner.preconditioner.amg
    assert len(dp["levels"]) == len(pa.levels) == len(ja.levels)
    r = np.random.default_rng(8).standard_normal(Ap.num_rows)
    vj = np.asarray(jdiag.probe_cycle(ja, ja.solve_data(), jx_array(r),
                                      np.float64))
    vp = pdiag.probe_cycle(pa, pa.solve_data(), torch.from_numpy(r),
                           torch.float64).numpy()
    fj = pdiag.derive(vj, len(ja.levels))
    fp = pdiag.derive(vp, len(pa.levels))
    _same_diagnostics(fj, fp)


def test_diagnostics_off_runs_no_probe(monkeypatch):
    calls = []
    real = pdiag.probe_cycle
    monkeypatch.setattr(pdiag, "probe_cycle",
                        lambda *a: calls.append(1) or real(*a))
    _, Ap = _grid("7pt", (10, 10, 10))
    slv = pt.create_solver(pt.Config.from_string(AMG_PCG), device="cpu")
    slv.setup(Ap)
    res = slv.solve(torch.ones(Ap.num_rows, dtype=torch.float64))
    assert calls == [] and res.report.diagnostics is None


# ---------------------------------------------------------------------------
# spans, determinism, async setup, batch reports, memory
# ---------------------------------------------------------------------------


def _roots(records):
    return sorted({r["name"] for r in records if r["depth"] == 0})


def test_span_names_of_one_setup_and_solve(tmp_path):
    Aj, Ap = _grid("5pt", (16, 16))
    jspans.reset()
    pspans.reset()
    _solve_both(pt.presets.BATCHED_CG, Aj, Ap)
    pj, pp = jspans.records(), pspans.records()
    assert _roots(pp) == _roots(pj) == ["PCG.setup", "PCG.solve"]
    names = {r["name"] for r in pp}
    assert all(pspans.is_declared(n) for n in names)
    # the port's setup leaves are the JAX package's names
    assert {"amg.L0.selector", "amg.L0.galerkin",
            "amg.L0.smoother_setup", "amg.coarse_solver_setup"} <= names
    assert all(n in {r["name"] for r in pj} for n in
               ("amg.L0.selector", "amg.L0.smoother_setup",
                "amg.coarse_solver_setup"))
    path = str(tmp_path / "trace.json")
    assert pspans.export_chrome_trace(path) > 0
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert {"PCG.setup", "PCG.solve"} <= {e["name"] for e in evs}


def test_profiling_regions_and_trace_capture(tmp_path):
    """trace_region accumulates the flat timers; start_trace / stop_trace
    capture a torch.profiler trace that loads as Chrome JSON."""
    from amgx_tpu_torch import profiling
    profiling.reset_timers()
    profiling.start_trace(str(tmp_path))
    with profiling.trace_region("amg.coarse_solver_setup"):
        torch.ones(64).sum()
    path = profiling.stop_trace()
    assert profiling.stop_trace() is None
    assert profiling.timers()["amg.coarse_solver_setup"][0] == 1
    assert "amg.coarse_solver_setup" in profiling.format_timers()
    with open(path) as f:
        assert "traceEvents" in json.load(f)


def test_telemetry_sync_is_latched_by_create_solver():
    pt.create_solver(pt.Config.from_string(
        pt.presets.BATCHED_CG + ", telemetry_sync=1"), device="cpu")
    assert pspans.sync_enabled()
    pt.create_solver(pt.Config.from_string(pt.presets.BATCHED_CG),
                     device="cpu")
    assert not pspans.sync_enabled()


def test_determinism_checker_and_fingerprints():
    a = np.arange(12.0).reshape(3, 4)
    assert determinism.fingerprint(torch.from_numpy(a)) == \
        determinism.fingerprint(a)
    from amgx_tpu import determinism as jdet
    assert determinism.fingerprint(a) == jdet.fingerprint(a)
    _, Ap = _grid("7pt", (10, 10, 10))
    chk = determinism.DeterminismChecker()
    for run in range(2):
        if run:
            chk.start_verification()
        slv = pt.create_solver(pt.Config.from_string(AMG_PCG),
                               device="cpu")
        slv.setup(Ap)
        for i, t in enumerate(determinism.tensor_leaves(
                slv.preconditioner.amg.solve_data())):
            chk.observe(f"leaf{i}", t)
        chk.observe("x", slv.solve(torch.ones(Ap.num_rows,
                                              dtype=torch.float64)).x)
    chk.finish()
    with pytest.raises(determinism.DeterminismError):
        chk.start_verification()
        chk.observe("x", torch.zeros(Ap.num_rows, dtype=torch.float64))


def test_setup_async_equals_setup():
    _, Ap = _grid("7pt", (10, 10, 10), np.float32)
    cfg = pt.Config.from_string(pt.presets.FLAGSHIP + ", amg:matrix_free=1")
    sync = pt.create_solver(cfg, device="cpu").setup(Ap)
    slv = pt.create_solver(cfg, device="cpu")
    task = slv.setup_async(Ap)
    assert task.wait() is slv and task.done()
    fa = determinism.tree_fingerprints(slv.solve_data())
    fs = determinism.tree_fingerprints(sync.solve_data())
    assert fa == fs and len(fa) > 10
    b = torch.ones(Ap.num_rows, dtype=torch.float32)
    assert slv.solve(b).extra_stats == sync.solve(b).extra_stats
    # wait() re-raises what the worker's setup raised
    with pytest.raises(AttributeError):
        pt.create_solver(cfg, device="cpu").setup_async(None).wait()


def test_batch_reports_match_jax():
    Aj, Ap = _grid("5pt", (16, 16))
    B = np.random.default_rng(3).standard_normal((3, Ap.num_rows))
    bj = jbatch.BatchedSolver(jx.Config.from_string(pt.presets.BATCHED_CG))
    bj.setup(Aj)
    bp = BatchedSolver(pt.Config.from_string(pt.presets.BATCHED_CG),
                       device="cpu")
    bp.setup(Ap)
    rj, rp = bj.solve_many(B), bp.solve_many(torch.from_numpy(B))
    assert len(rp.reports) == len(rj.reports) == 3
    for j, p, per in zip(rj.reports, rp.reports, rp.per_system()):
        dj, dp = j.to_dict(), p.to_dict()
        assert validate_report(dp) == []
        assert (dp["status"], dp["iterations"]) == \
            (dj["status"], dj["iterations"])
        np.testing.assert_allclose(dp["residuals"], dj["residuals"],
                                   rtol=1e-10)
        assert per.report is p


def test_memory_info_reads_zero_on_the_cpu():
    assert memory_info.peak_bytes([torch.device("cpu")]) == 0
    assert memory_info.update_max_memory_usage([torch.device("cpu")]) == 0
    assert memory_info.sum_device_stats([torch.device("cpu")]) == {}
    assert pt.Resources(platform="cpu").memory_stats() == {}


# ---------------------------------------------------------------------------
# tools/check_spans.py's rules on the port
# ---------------------------------------------------------------------------


def test_check_spans_rules_hold_on_the_port(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import check_spans as cs
    finally:
        sys.path.pop(0)
    pkg = os.path.join(ROOT, "amgx_tpu_torch")
    # the port's recording engine and catalog, exempt as the JAX
    # package's are
    monkeypatch.setattr(cs, "_EXEMPT", (
        os.path.join("amgx_tpu_torch", "profiling.py"),
        os.path.join("amgx_tpu_torch", "telemetry", "spans.py")))
    monkeypatch.setattr(cs, "_METRIC_EXEMPT", (
        os.path.join("amgx_tpu_torch", "telemetry", "metrics.py"),))
    errors = []
    # 1. every span name used is declared
    spans_used = cs.extract_span_literals(pkg)
    assert len(spans_used) >= 8
    for path, line, name in spans_used:
        if name is None or not any(cs._compatible(name, d)
                                   for d in pspans.DECLARED_SPANS):
            errors.append(f"{path}:{line}: span {name!r}")
    # 3. every literal metric name recorded is declared in its catalog
    catalogs = {"counter": pm.COUNTERS, "gauge": pm.GAUGES,
                "histogram": pm.HISTOGRAMS}
    literals, patterns, writes = cs._extract_metric_calls(pkg)
    for path, line, kind, name in literals:
        if name not in catalogs[kind]:
            errors.append(f"{path}:{line}: {kind} {name!r} undeclared")
    # 4. every declared name has a recording site, or waits for a later
    # item (metrics.WAITING)
    constants = cs.extract_string_constants(pkg)
    sites = {(k, n) for k, n in writes}
    for kind, catalog in catalogs.items():
        for name in catalog:
            live = (kind, name) in sites or name in constants or any(
                k == kind and cs.fnmatch.fnmatchcase(name, p)
                for _, _, k, p in patterns)
            if live == (pm.waiting(name) is not None):
                errors.append(f"{kind} {name!r}: site={live}, "
                              f"waiting={pm.waiting(name)!r}")
    assert errors == []
