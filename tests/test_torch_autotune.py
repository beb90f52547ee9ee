"""The port's online config autotuner (amgx_tpu_torch/serving/autotune.py)
and the hierarchy store's tuned-config overlays against the JAX
package's (amgx_tpu/serving/autotune.py, hstore.py) on the CPU.

The mistuned config is the JAX tests' (tests/test_autotune.py):
BATCHED_CG with an overdamped BLOCK_JACOBI smoother, on the 7-point
10^3 Poisson with seeded numpy right-hand sides. The shadow scores come
from `autotune._shadow_clock`, which these tests replace by a clock that
advances one second a reading: every shadow solve then measures one
second, the score is the iteration count, and no decision rests on
measured wall time.

- Candidates: the same deltas for the same probe diagnostics (the
  mapping, and the port's own probe against the JAX package's).
- Promotion: the hot fingerprint's search promotes the relaxation
  re-damp; the next request builds with the overlay and takes the JAX
  package's iterations for the overlaid config, fewer than before.
- Demotion, restart with the overlay (zero full setups), shadow-crash
  absorption, shadow isolation on a saturated service, drain quiesce,
  autotune=0 inertness and the fleet's tuned-config handoff."""
import itertools

import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.presets import BATCHED_CG as JAX_BATCHED_CG
from amgx_tpu.serving.autotune import ConfigAutotuner as JaxTuner
from amgx_tpu.serving.hstore import HierarchyStore as JaxHierarchyStore
from amgx_tpu.telemetry.diagnostics import \
    suggest_config_deltas as jax_suggest

import amgx_tpu_torch as pt
from amgx_tpu_torch.presets import BATCHED_CG
from amgx_tpu_torch.resilience import faultinject
from amgx_tpu_torch.serving import (ConfigAutotuner, FleetRouter,
                                    HierarchyStore, SolveService)
from amgx_tpu_torch.serving import autotune as pt_autotune
from amgx_tpu_torch.telemetry import metrics
from amgx_tpu_torch.telemetry.diagnostics import suggest_config_deltas
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

jx.initialize()

MISTUNED = (", amg:smoother(sm2)=BLOCK_JACOBI, sm2:max_iters=1,"
            " sm2:relaxation_factor=0.15,"
            " serving_bucket_slots=2, serving_chunk_iters=8")
TUNER = (", autotune=1, autotune_hot_requests=4,"
         " autotune_hot_exec_share=0.0")


def _at_cfg(extra=""):
    return pt.Config.from_string(
        BATCHED_CG + MISTUNED + TUNER + (", " + extra if extra else ""))


@pytest.fixture(autouse=True)
def ticking_clock(monkeypatch):
    """Every shadow solve measures exactly one second."""
    ticks = itertools.count()
    monkeypatch.setattr(pt_autotune, "_shadow_clock",
                        lambda device: float(next(ticks)))


@pytest.fixture(scope="module")
def geo10():
    return pt.gallery.poisson("7pt", 10, 10, 10, dtype=torch.float64,
                              device="cpu").init()


def _rhs(A, seed=0):
    return np.random.default_rng(seed).standard_normal(A.num_rows)


def _heat(svc, A, n=5, seed0=0):
    """Submit + drain `n` same-fingerprint requests (drain quiesces the
    tuner, so only the tallies move)."""
    tix = [svc.submit(A, _rhs(A, seed0 + i)) for i in range(n)]
    svc.drain(timeout_s=600)
    assert all(t.done for t in tix)
    return tix


def _search(svc, max_steps=16):
    for _ in range(max_steps):
        svc.step()
        if svc.stats()["autotune"]["promoted"]:
            break


def _jax_matrix(A):
    return jx.gallery.poisson("7pt", *A.grid_shape).init().with_values(
        A.values.numpy())


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


DIAGS = [
    None, {},
    {"levels": [{"level": 0, "smoother_effectiveness": 0.95,
                 "correction_reduction": 1.5}],
     "bottleneck_level": 0, "asymptotic_convergence_factor": 0.9},
    {"levels": [{"level": 1, "smoother_effectiveness": 0.9,
                 "correction_reduction": 1.3}],
     "bottleneck_level": 1, "asymptotic_convergence_factor": 0.95},
    {"levels": [{"level": 0, "smoother_effectiveness": 0.2,
                 "correction_reduction": 0.5}],
     "bottleneck_level": 0, "asymptotic_convergence_factor": 0.2},
    {"levels": [{"level": 0, "smoother_effectiveness": None,
                 "correction_reduction": 1.2}],
     "bottleneck_level": 0, "asymptotic_convergence_factor": 0.5},
]


@pytest.mark.parametrize("i", range(len(DIAGS)))
def test_candidates_match_jax_mapping(i):
    assert suggest_config_deltas(DIAGS[i]) == jax_suggest(DIAGS[i])


def test_probe_candidates_match_jax(geo10):
    """The baseline probe (diagnostics=1 overlaid) on the same system in
    both packages: the same bottleneck, and the same candidate deltas."""
    probe = [{"param": "diagnostics", "value": 1},
             {"param": "store_res_history", "value": 1}]
    b = _rhs(geo10, 3)
    cfg_p = ConfigAutotuner.apply_overlay(
        pt.Config.from_string(BATCHED_CG + MISTUNED), probe)
    cfg_j = JaxTuner.apply_overlay(
        JaxConfig.from_string(JAX_BATCHED_CG + MISTUNED), probe)
    slv = pt.create_solver(cfg_p, device="cpu")
    slv.setup(geo10)
    dp = slv.solve(torch.from_numpy(b)).report.diagnostics
    sj = jx.create_solver(cfg_j)
    sj.setup(_jax_matrix(geo10))
    dj = sj.solve(b).report.diagnostics
    assert dp["bottleneck_level"] == dj["bottleneck_level"]
    cands = suggest_config_deltas(dp)
    assert [c["deltas"] for c in cands] \
        == [c["deltas"] for c in jax_suggest(dj)]
    assert cands and cands[0]["knob"] == "smoother_swap"


def test_apply_overlay_matches_jax():
    deltas = [{"param": "relaxation_factor", "value": 0.9},
              {"param": "smoother", "value": "JACOBI_L1"},
              {"param": "cycle", "value": "W"}]
    p = ConfigAutotuner.apply_overlay(
        pt.Config.from_string(BATCHED_CG + MISTUNED), deltas)
    j = JaxTuner.apply_overlay(
        JaxConfig.from_string(JAX_BATCHED_CG + MISTUNED), deltas)
    for name in ("relaxation_factor", "smoother", "cycle"):
        for scope in ("default", "amg", "sm2"):
            assert str(p.get(name, scope)) == str(j.get(name, scope))


# ---------------------------------------------------------------------------
# promote, restart, demote
# ---------------------------------------------------------------------------


def test_promotion_fixes_mistuned_fingerprint(geo10):
    svc = SolveService(_at_cfg(), device="cpu")
    runs0 = metrics.get("autotune.shadow.runs")
    tix = _heat(svc, geo10)
    pre = tix[0].result.iterations
    assert metrics.get("autotune.shadow.runs") == runs0   # quiesced
    assert not svc._draining and not svc._tuner._quiesced
    _search(svc)
    snap = svc.stats()["autotune"]
    rec = next(iter(snap["fingerprints"].values()))
    assert snap["promoted"] == 1 and rec["phase"] == "promoted"
    assert rec["overlay"] == "relaxation_factor=0.9"
    applied0 = metrics.get("autotune.overlay.applied")
    t = svc.submit(geo10, _rhs(geo10, 90))
    svc.drain(timeout_s=600)
    assert metrics.get("autotune.overlay.applied") == applied0 + 1
    assert t.result.converged and t.result.iterations < pre
    # the JAX package's solve of the overlaid config: the same count
    cfg = JaxTuner.apply_overlay(
        JaxConfig.from_string(JAX_BATCHED_CG + MISTUNED),
        [{"param": "relaxation_factor", "value": 0.9}])
    sj = jx.create_solver(cfg)
    sj.setup(_jax_matrix(geo10))
    assert t.result.iterations == int(sj.solve(_rhs(geo10, 90)).iterations)


def test_tuned_config_survives_restart_zero_full_setups(geo10, tmp_path):
    dirs = (f"serving_hierarchy_dir={tmp_path}/hier,"
            f" serving_journal_dir={tmp_path}/journal")
    svc = SolveService(_at_cfg(dirs), device="cpu")
    _heat(svc, geo10)
    _search(svc)
    assert svc.stats()["autotune"]["promoted"] == 1
    t1 = svc.submit(geo10, _rhs(geo10, 91))
    svc.drain(timeout_s=600)
    assert svc.hstore.load_tuned(t1.fingerprint)["knob"] == "relaxation"
    restored0 = metrics.get("autotune.overlay.restored")
    full0 = metrics.get("amg.setup.full")
    svc2 = SolveService(_at_cfg(dirs), device="cpu")
    t2 = svc2.submit(geo10, _rhs(geo10, 91))
    svc2.drain(timeout_s=600)
    assert t2.result.iterations == t1.result.iterations
    assert torch.equal(t2.result.x, t1.result.x)
    assert metrics.get("autotune.overlay.restored") == restored0 + 1
    assert metrics.get("amg.setup.full") == full0
    assert next(iter(svc2.stats()["autotune"]["fingerprints"].values())
                )["restored"]


def test_demotion_drops_overlay_and_record(geo10, tmp_path):
    svc = SolveService(_at_cfg(f"serving_hierarchy_dir={tmp_path},"
                               " autotune_demote_window=2"), device="cpu")
    _heat(svc, geo10)
    _search(svc)
    fp = next(iter(svc._tuner._fp))
    rec = svc._tuner._fp[fp]
    assert rec["phase"] == "promoted" and svc.hstore.load_tuned(fp)
    rec["pre_exec"] = 0.01              # a regression past the factor
    rec["post"].extend([1.0, 1.0])
    dem0 = metrics.get("autotune.demotions")
    svc.step()
    assert metrics.get("autotune.demotions") == dem0 + 1
    assert rec["phase"] == "demoted" and rec["overlay"] is None
    assert svc.hstore.load_tuned(fp) is None
    assert svc._tuner.overlay_for(fp) is None


def test_no_win_retires_search(geo10, monkeypatch):
    """With every candidate's shadow slower than the baseline the search
    promotes nothing (the hysteresis gate)."""
    ticks = itertools.count()
    walls = iter([1.0] + [5.0] * 8)

    def clock(device):
        k = next(ticks)
        return 0.0 if k % 2 == 0 else next(walls)

    monkeypatch.setattr(pt_autotune, "_shadow_clock", clock)
    svc = SolveService(_at_cfg(), device="cpu")
    _heat(svc, geo10)
    _search(svc)
    rec = next(iter(svc.stats()["autotune"]["fingerprints"].values()))
    assert rec["phase"] == "exhausted" and rec["overlay"] is None


# ---------------------------------------------------------------------------
# isolation, chaos, inertness
# ---------------------------------------------------------------------------


def test_shadow_crash_absorbed_then_retired(geo10):
    svc = SolveService(_at_cfg(), device="cpu")
    tix = _heat(svc, geo10)
    err0 = metrics.get("autotune.shadow.errors")
    with faultinject.inject("shadow_crash", fires=1):
        svc.step()
    assert metrics.get("autotune.shadow.errors") == err0 + 1
    rec = next(iter(svc.stats()["autotune"]["fingerprints"].values()))
    assert rec["errors"] == 1 and rec["phase"] in ("hot", "search")
    assert all(t.result.converged for t in tix)
    t2 = svc.submit(geo10, _rhs(geo10, 50))
    svc.drain(timeout_s=600)
    assert t2.result.converged
    svc2 = SolveService(_at_cfg(), device="cpu")
    _heat(svc2, geo10)
    with faultinject.inject("shadow_crash", fires=None):
        svc2.step()
        svc2._tuner._fp[next(iter(svc2._tuner._fp))]["not_before"] = 0.0
        svc2.step()
    rec = next(iter(svc2.stats()["autotune"]["fingerprints"].values()))
    assert rec["phase"] == "exhausted" and rec["errors"] == 2


def test_saturated_service_runs_no_shadows(geo10):
    svc = SolveService(_at_cfg(), device="cpu")
    runs0 = metrics.get("autotune.shadow.runs")
    tix = [svc.submit(geo10, _rhs(geo10, i)) for i in range(8)]
    busy = 0
    for _ in range(400):
        with svc._lock:
            queued = len(svc._queue)
        svc.step()
        if queued:
            busy += 1
            assert metrics.get("autotune.shadow.runs") == runs0
        if svc.idle:
            break
    assert busy >= 1 and all(t.result.converged for t in tix)


def test_autotune_off_is_inert(geo10):
    base = {k: metrics.get(k) for k in (
        "autotune.hot", "autotune.shadow.runs", "autotune.overlay.applied",
        "autotune.promotions")}
    off = SolveService(pt.Config.from_string(BATCHED_CG + MISTUNED),
                       device="cpu")
    assert off._tuner is None
    tix = _heat(off, geo10)
    for _ in range(4):
        off.step()
    assert {k: metrics.get(k) for k in base} == base
    assert off.stats()["autotune"] == {"enabled": False}
    on = SolveService(_at_cfg("autotune_hot_requests=1000"), device="cpu")
    tix2 = _heat(on, geo10)
    for a, b in zip(tix, tix2):
        assert a.result.iterations == b.result.iterations
        assert torch.equal(a.result.x, b.result.x)


def test_fleet_drain_hands_off_tuned_config(tmp_path):
    fleet = FleetRouter.build(_at_cfg(f"serving_hierarchy_dir={tmp_path}"),
                              2, device="cpu")
    r0, r1 = list(fleet.replicas)
    fp = "handoff-test-fingerprint/float64"
    state = {"deltas": [{"param": "relaxation_factor", "value": 0.9}],
             "knob": "relaxation", "trace": "tr-1"}
    fleet.replicas[r0]._tuner.adopt(fp, state)
    h0 = metrics.get("autotune.handoffs")
    fleet.drain_replica(r0)
    assert metrics.get("autotune.handoffs") == h0 + 1
    assert fleet.replicas[r1]._tuner.overlay_for(fp) == state["deltas"]
    assert fleet.replicas[r1].hstore.load_tuned(fp)["deltas"] \
        == state["deltas"]


# ---------------------------------------------------------------------------
# the hierarchy store's tuned records
# ---------------------------------------------------------------------------


def test_tuned_records_match_jax_store(tmp_path):
    """Both stores write the same file for a fingerprint, read each
    other's records, and drop a malformed one (counted)."""
    hp, hj = HierarchyStore(str(tmp_path)), JaxHierarchyStore(str(tmp_path))
    fp = "fp-tuned/float64"
    assert hp._tuned_path(fp) == hj._tuned_path(fp)
    rec = {"deltas": [{"param": "cycle", "value": "W"}], "knob": "cycle"}
    assert hp.save_tuned(fp, rec)
    assert hj.load_tuned(fp)["deltas"] == rec["deltas"]
    hp.drop_tuned(fp)
    assert hp.load_tuned(fp) is None
    hj.save_tuned(fp, rec)
    assert hp.load_tuned(fp)["fingerprint"] == fp
    with open(hp._tuned_path(fp), "w") as f:
        f.write('{"deltas": "not a list"}')
    err0 = metrics.get("serving.recovery.hstore_error")
    assert hp.load_tuned(fp) is None
    assert metrics.get("serving.recovery.hstore_error") == err0 + 1
    assert hp.load_tuned(fp) is None     # dropped, not re-read
    hp.drop_tuned(fp)                     # absent: a no-op
