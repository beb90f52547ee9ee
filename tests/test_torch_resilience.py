"""The port's resilience layer (amgx_tpu_torch/resilience/) against the
JAX package's, on the CPU: the same configs and fault specs through
both packages give the same status, iterations and `fallback_history`.

- spmv_nan on CG (NAN_DETECTED on iteration k + 1, then a clean solve),
  on standalone AMG (BREAKDOWN: the non-finite cycle) and on the
  FLAGSHIP-shaped nested tree (REFINEMENT -> FGMRES -> AMG, the poison at
  inner iteration k of every outer pass);
- a fires-limited spec is spent once per root solve, however many inner
  loops the solve ran; the AMGX_TPU_FAULT_INJECT toggle;
- galerkin_perturb turns a converging AMG into a DIVERGED one;
- the five fallback chains of tests/test_resilience.py: history, the
  adopted solver and the attempt bound; every rebuild on the wrapped
  solver's device;
- the policy grammars' errors and suggestions.

Inputs are the JAX tests' own: the 5-point 16 x 16 Poisson (and its
D A D), the indefinite tridiagonal, the 7-point 10^3 Poisson.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.resilience import faultinject as jfi
import amgx_tpu.resilience.policy as jpol

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch.errors import BadConfigurationError
from amgx_tpu_torch.resilience import faultinject as pfi
from amgx_tpu_torch.resilience import policy as ppol
from amgx_tpu_torch.resilience.policy import ResilientSolver
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

jx.initialize()

CG = ("solver=CG, max_iters={it}, monitor_residual=1, tolerance={tol},"
      " convergence=RELATIVE_INI")
AMG = ("solver(amg)=AMG, amg:max_iters={it}, amg:monitor_residual=1,"
       " amg:tolerance={tol}, amg:convergence=RELATIVE_INI,"
       " amg:algorithm=AGGREGATION, amg:selector=SIZE_2,"
       " amg:smoother(sm)=JACOBI_L1, sm:max_iters=1,"
       " amg:presweeps={sw}, amg:postsweeps={sw}, amg:cycle=V,"
       " amg:coarse_solver=DENSE_LU_SOLVER, amg:min_coarse_rows=8")
STALL = AMG.format(it=40, tol="1e-8", sw=0) + \
    ", amg:stall_detection_window=4"
# tests/test_diagnostics.py's FLAGSHIP_SHAPE
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


def _pair(Asp):
    """(JAX matrix, port matrix) of one scipy matrix."""
    Asp = Asp.tocsr()
    n = Asp.shape[0]
    Aj = jx.CsrMatrix.from_scipy_like(Asp.indptr, Asp.indices, Asp.data,
                                      n, n).init()
    Ap = pti.matrix_from_numpy(Asp.indptr, Asp.indices, Asp.data, n, n,
                               device="cpu")
    return Aj, Ap


def _poisson16():
    A = jx.gallery.poisson("5pt", 16, 16).init()
    n = A.num_rows
    return sp.csr_matrix((np.asarray(A.values), np.asarray(A.col_indices),
                          np.asarray(A.row_offsets)), shape=(n, n))


def _indefinite(n=64):
    d = np.ones(n)
    d[::2] = -1.0
    off = 0.1 * np.ones(n - 1)
    return sp.diags([d, off, off], [0, 1, -1])


def _badly_scaled(seed=0):
    A = _poisson16()
    d = 10.0 ** np.random.default_rng(seed).uniform(-4, 4, A.shape[0])
    return sp.diags(d) @ A @ sp.diags(d)


def _poisson10():
    A = jx.gallery.poisson("7pt", 10, 10, 10).init()
    n = A.num_rows
    return sp.csr_matrix((np.asarray(A.values), np.asarray(A.col_indices),
                          np.asarray(A.row_offsets)), shape=(n, n))


def _solvers(text, Asp):
    Aj, Ap = _pair(Asp)
    js = jx.create_solver(jx.Config.from_string(text))
    js.setup(Aj)
    ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
    ps.setup(Ap)
    return js, ps


def _both(js, ps, n, kind=None, **spec):
    """One solve (b = 1) in each package, under the same armed spec when
    `kind` is given: (JAX result, port result)."""
    b = np.ones(n)
    if kind is None:
        return js.solve(b), ps.solve(torch.from_numpy(b))
    with jfi.inject(kind, **spec):
        rj = js.solve(b)
    with pfi.inject(kind, **spec):
        rp = ps.solve(torch.from_numpy(b))
    return rj, rp


def _same(rj, rp):
    assert (rp.status, rp.iterations) == (rj.status, int(rj.iterations))


# ---------------------------------------------------------------------------
# spmv_nan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iteration", [0, 3])
def test_spmv_nan_on_cg_matches_jax(iteration):
    A = _poisson16()
    js, ps = _solvers(CG.format(it=50, tol="1e-8"), A)
    rj, rp = _both(js, ps, A.shape[0], "spmv_nan", iteration=iteration)
    _same(rj, rp)
    assert rp.status == "nan_detected" and rp.iterations == iteration + 1
    # disarmed: both solve clean again, with the same iterations
    rj, rp = _both(js, ps, A.shape[0])
    _same(rj, rp)
    assert rp.status == "success"


def test_spmv_nan_on_amg_is_breakdown_as_in_jax():
    A = _poisson16()
    js, ps = _solvers(AMG.format(it=30, tol="1e-6", sw=1), A)
    rj, rp = _both(js, ps, A.shape[0], "spmv_nan", iteration=2)
    _same(rj, rp)
    assert (rp.status, rp.iterations) == ("breakdown", 3)


def test_spmv_nan_on_the_nested_tree_matches_jax():
    """REFINEMENT -> FGMRES -> AMG: the inner loop's iteration 3 is
    poisoned; both packages stop the outer loop on the same iteration
    with the same status. The port spends one firing per root solve; the
    JAX package one per traced loop that reached a hook, so its nested
    tree spends two (the inner loop's trace, then the outer's)."""
    A = _poisson10()
    js, ps = _solvers(NESTED, A)
    rj, rp = _both(js, ps, A.shape[0], "spmv_nan", iteration=3, fires=3)
    _same(rj, rp)
    assert rp.status == "nan_detected"
    left = {}
    for name, fi, slv, rhs in (
            ("jax", jfi, js, np.ones(A.shape[0])),
            ("port", pfi, ps, torch.ones(A.shape[0], dtype=torch.float64))):
        with fi.inject("spmv_nan", iteration=3, fires=3):
            slv.solve(rhs)
            left[name] = fi.active("spmv_nan").fires
    assert left == {"jax": 1, "port": 2}
    rj, rp = _both(js, ps, A.shape[0])
    _same(rj, rp)
    assert rp.status == "success"


def test_fires_are_spent_once_per_root_solve():
    """fires=2 poisons two root solves, then the third is clean; a
    spec whose hook no solve reached (halo_corrupt on one device) is
    never spent."""
    A = _poisson16()
    js, ps = _solvers(CG.format(it=100, tol="1e-8"), A)
    b = np.ones(A.shape[0])
    got = {}
    for name, fi, slv, rhs in (("jax", jfi, js, b),
                               ("port", pfi, ps, torch.from_numpy(b))):
        with fi.inject("spmv_nan", iteration=1, fires=2):
            got[name] = [slv.solve(rhs).status for _ in range(3)]
        with fi.inject("halo_corrupt", iteration=0, fires=1):
            assert slv.solve(rhs).status == "success"
            assert fi.active("halo_corrupt") is not None
    assert got["port"] == got["jax"] == ["nan_detected", "nan_detected",
                                         "success"]


def test_environment_toggle_arms_a_spec(monkeypatch):
    A = _poisson16()
    js, ps = _solvers(CG.format(it=200, tol="1e-8"), A)
    monkeypatch.setenv("AMGX_TPU_FAULT_INJECT",
                       "spmv_nan:iteration=2:fires=1")
    out = []
    for fi, slv, rhs in ((jfi, js, np.ones(A.shape[0])),
                         (pfi, ps, torch.ones(A.shape[0],
                                              dtype=torch.float64))):
        monkeypatch.setattr(fi, "_ENV_CHECKED", False)
        monkeypatch.setattr(fi, "_SPEC", None)
        r = slv.solve(rhs)
        out.append((r.status, int(r.iterations)))
        fi.disarm()
    assert out[1] == out[0] == ("nan_detected", 3)


def test_galerkin_perturbation_diverges_as_in_jax():
    A = _poisson16()
    text = AMG.format(it=60, tol="1e-6", sw=2) + \
        ", amg:rel_div_tolerance=1e6"
    js, ps = _solvers(text, A)
    _same(*_both(js, ps, A.shape[0]))
    Aj, Ap = _pair(A)
    with jfi.inject("galerkin_perturb", index=0, scale=-1.0):
        js = jx.create_solver(jx.Config.from_string(text))
        js.setup(Aj)
    with pfi.inject("galerkin_perturb", index=0, scale=-1.0):
        ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
        ps.setup(Ap)
    rj, rp = _both(js, ps, A.shape[0])
    _same(rj, rp)
    assert rp.status == "diverged"


def test_an_index_past_a_level_is_dropped():
    """An index past a coarse level's rows poisons only the levels that
    have it (the JAX package's .at[].set drops the rest): index 200 of
    the 16 x 16 problem reaches level 0 alone."""
    A = _poisson16()
    js, ps = _solvers(AMG.format(it=30, tol="1e-6", sw=1), A)
    rj, rp = _both(js, ps, A.shape[0], "spmv_nan", iteration=2,
                   index=200)
    _same(rj, rp)
    assert pfi._poison(torch.zeros(5), 7, float("nan")).isfinite().all()
    assert pfi._poison(torch.zeros(2, 5), -1, float("nan"))[
        :, -1].isnan().all()


# ---------------------------------------------------------------------------
# fallback chains
# ---------------------------------------------------------------------------

CHAINS = {
    "nan_retry": (CG.format(it=200, tol="1e-8")
                  + ", fallback_policy=NAN_DETECTED>retry,"
                  " max_fallback_attempts=2", _poisson16,
                  ("spmv_nan", {"iteration": 2, "fires": 1})),
    "breakdown_gmres": (CG.format(it=80, tol="1e-8")
                        + ", gmres_n_restart=40,"
                        " fallback_policy=BREAKDOWN>switch_solver=GMRES,"
                        " max_fallback_attempts=1", _indefinite, None),
    "stalled_escalate": (STALL + ", fallback_policy=STALLED>"
                         "escalate_sweeps, max_fallback_attempts=1",
                         _poisson16, None),
    "max_iters_rescale": (CG.format(it=60, tol="1e-6")
                          + ", fallback_policy=MAX_ITERS>rescale_retry,"
                          " max_fallback_attempts=1", _badly_scaled,
                          None),
    "bounded": (CG.format(it=30, tol="1e-8")
                + ", fallback_policy=NAN_DETECTED>retry|NAN_DETECTED>"
                "retry, max_fallback_attempts=2", _poisson16,
                ("spmv_nan", {"iteration": 1, "fires": None})),
}


@pytest.mark.parametrize("case", list(CHAINS))
def test_fallback_chain_matches_jax(case, monkeypatch):
    text, mat, fault = CHAINS[case]
    A = mat()
    js, ps = _solvers(text, A)
    assert isinstance(js, jpol.ResilientSolver)
    assert isinstance(ps, ResilientSolver)
    devices = []
    real = ppol.make_solver

    def spy(name, cfg, scope, device):
        devices.append(device)
        return real(name, cfg, scope, device)

    monkeypatch.setattr(ppol, "make_solver", spy)
    kind, spec = fault if fault else (None, {})
    rj, rp = _both(js, ps, A.shape[0], kind, **spec)
    _same(rj, rp)
    assert rp.fallback_history == rj.fallback_history
    assert ps.solver.name == js.solver.name
    assert len(rp.fallback_history) - 1 <= ps.max_attempts
    # every rebuilt tree was built on the wrapped solver's device, and
    # the adopted tree's tensors live there
    assert all(d == ps.solver.device for d in devices)
    assert ps.solver.A.values.device == ps.solver.device
    if case in ("nan_retry", "breakdown_gmres", "stalled_escalate",
                "max_iters_rescale"):
        assert rp.status == "success"
    if case == "breakdown_gmres":
        assert ps.solver.name == "GMRES"
    if case == "bounded":
        assert len(rp.fallback_history) == 3


def test_every_rebuild_takes_the_wrapped_solvers_device():
    """make_solver has no device default; each rebuilding action passes
    the wrapped solver's device (here a tree re-labelled to a device
    object the spy can tell apart from a default)."""
    with pytest.raises(TypeError):
        pt.solvers.base.make_solver("CG", pt.Config(), "default")
    A = _poisson16()
    _, Ap = _pair(A)
    for action in ("rescale_retry", "switch_solver=GMRES",
                   "escalate_sweeps"):
        rs = pt.create_solver(pt.Config.from_string(
            STALL + f", fallback_policy=ANY>{action},"
            " max_fallback_attempts=1"), device="cpu")
        rs.setup(Ap)
        seen = []
        real = ppol.make_solver
        ppol.make_solver = lambda n, c, s, device: (
            seen.append(device) or real(n, c, s, device))
        try:
            rs.solve(torch.ones(Ap.num_rows, dtype=torch.float64))
        finally:
            ppol.make_solver = real
        assert seen == [torch.device("cpu")], action


def test_policy_parse_errors_match_jax():
    for spec, needle in (("NAN_DETECTD>retry", "NAN_DETECTED"),
                         ("BREAKDOWN>swich_solver=GMRES", "switch_solver"),
                         ("BREAKDOWN>switch_solver", "switch_solver"),
                         ("retry", "expected")):
        with pytest.raises(BadConfigurationError) as ep:
            ppol.parse_fallback_policy(spec)
        with pytest.raises(Exception) as ej:
            jpol.parse_fallback_policy(spec)
        assert str(ep.value) == str(ej.value)
        assert needle in str(ep.value)
    assert ppol.parse_fallback_policy("NAN>retry|ANY>switch_solver=GMRES") \
        == jpol.parse_fallback_policy("NAN>retry|ANY>switch_solver=GMRES")
    for port_fn, jax_fn, bad in (
            (ppol.parse_service_policy, jpol.parse_service_policy,
             "BUILD_FAILD>retry_backoff"),
            (ppol.parse_fleet_policy, jpol.parse_fleet_policy,
             "REPLICA_DEAD>failovr")):
        with pytest.raises(BadConfigurationError) as ep:
            port_fn(bad)
        with pytest.raises(Exception) as ej:
            jax_fn(bad)
        assert str(ep.value) == str(ej.value)
    assert ppol.parse_service_policy("BUILD_FAILED>retry_backoff|WEDGED>"
                                     "reject") == jpol.parse_service_policy(
        "BUILD_FAILED>retry_backoff|WEDGED>reject")


def test_resilient_preset_is_the_jax_packages():
    from amgx_tpu import presets as jpresets
    assert pt.presets.RESILIENT_CG == jpresets.RESILIENT_CG
    rs = pt.create_solver(pt.Config.from_string(pt.presets.RESILIENT_CG),
                          device="cpu")
    assert isinstance(rs, ResilientSolver) and rs.max_attempts == 2
