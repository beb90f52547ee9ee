"""The port's serving fleet (amgx_tpu_torch/serving/fleet.py, health.py)
against the JAX package's (amgx_tpu/serving/fleet.py, health.py) on the
CPU.

- Routing: both packages' FleetRouter route the same scripted sequence
  of fingerprints (with the same injected queue depths and breaker
  states) to the same replica with the same route class, on the same
  rendezvous scores.
- Tickets: a two-replica port fleet on BATCHED_CG (5-point 16^2 and
  14^2, seeded numpy right-hand sides) gives every ticket the JAX
  package's status and iterations, x within 1e-12 in float64.
- Failover and rolling restart: a replica_kill mid-flight and a
  drain_replica / restore_replica lose no ticket and give x bit-identical
  to an unfaulted port run; the survivor adopts the dead replica's
  journal.
- The breaker: both packages' HealthMonitor, driven by explicit `now`
  values over stub replicas, take the same transitions."""
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.presets import BATCHED_CG as JAX_BATCHED_CG
from amgx_tpu.serving import fleet as jax_fleet
from amgx_tpu.serving import health as jax_health

import amgx_tpu_torch as pt
from amgx_tpu_torch.presets import BATCHED_CG
from amgx_tpu_torch.resilience import faultinject
from amgx_tpu_torch.resilience.status import SolveStatus
from amgx_tpu_torch.serving import FleetRouter, HealthMonitor
from amgx_tpu_torch.serving import fleet as pt_fleet
from amgx_tpu_torch.serving import health as pt_health
from amgx_tpu_torch.telemetry import flightrec
from amgx_tpu_torch.telemetry import metrics
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

jx.initialize()

SHAPES = ((16, 16), (14, 14))
EXTRA = "serving_bucket_slots=2, serving_chunk_iters=4"


def _cfg(extra=""):
    return pt.Config.from_string(
        BATCHED_CG + ", " + EXTRA + (", " + extra if extra else ""))


def _fleet(extra="", n=2):
    return FleetRouter.build(_cfg(extra), n, device="cpu")


@pytest.fixture(scope="module")
def mats():
    return [pt.gallery.poisson("5pt", *s, dtype=torch.float64,
                               device="cpu").init() for s in SHAPES]


def _shift(A, c):
    rows, cols, vals = A.coo()
    return A.with_values(vals + c * (rows == cols.long()).to(vals.dtype))


def _rhs(A, seed):
    return np.random.default_rng(seed).standard_normal(A.num_rows)


def _requests(mats):
    """Six requests alternating the two patterns, each system shifted."""
    return [(_shift(mats[i % 2], 0.05 * i), _rhs(mats[i % 2], i))
            for i in range(6)]


# ---------------------------------------------------------------------------
# routing parity: the same decisions on the same fingerprints
# ---------------------------------------------------------------------------


class _Stub:
    """The replica state the router and the monitor read (no solves)."""

    def __init__(self):
        self._queue, self._exec_recent, self._exec_fp = [], [], {}
        self._faulted, self._keyed, self._builds = {}, {}, {}
        self._cycle, self.completed_total, self.slots = 0, 0, 2
        self._thread, self._thread_error, self._stopping = None, None, False
        self.busy = False
        import threading
        self._lock = threading.RLock()
        self.buckets = type("B", (), {"peek": staticmethod(lambda k: None)})

    def _inflight(self):
        return 0

    @property
    def idle(self):
        return not self.busy

    def _estimate_latency_s(self, fingerprint=None):
        return None


def _router(mod, n=3):
    r = mod.FleetRouter.__new__(mod.FleetRouter)
    reps = {f"r{i}": _Stub() for i in range(n)}
    mod.FleetRouter.__init__(r, reps)
    return r


def test_rendezvous_scores_match_jax():
    fps = [f"fp{i}/float64" for i in range(50)]
    for fp in fps:
        for rid in ("r0", "r1", "r2", "replica-7"):
            assert pt_fleet._rendezvous_score(fp, rid) \
                == jax_fleet._rendezvous_score(fp, rid)


def test_route_sequence_matches_jax():
    """A scripted sequence over three replicas: cold placements, warm
    repeats, overload spills under injected queue depth, and diversions
    around a draining and a DOWN home -- decision for decision."""
    routers = {"jax": _router(jax_fleet), "port": _router(pt_fleet)}
    decisions = {}
    for name, r in routers.items():
        out = []
        fps = [f"fp{i}/float64" for i in range(6)]
        for fp in fps + fps:                       # cold, then warm
            rid, route, _, _ = r._route(fp, "t", None)
            out.append((rid, route))
            r.replicas[rid]._queue.append(object())   # queued load
        for rid in r.replicas:                     # overload everywhere
            r.replicas[rid]._queue.extend([object()] * 4)
        busiest = max(r.replicas, key=lambda k: len(r.replicas[k]._queue))
        r.replicas[busiest]._queue.extend([object()] * 8)
        for fp in fps:
            rid, route, hand, _ = r._route(fp, "t", None)
            out.append((rid, route, None if hand is None else hand[1]))
        r.health.drain("r0")
        r.health.mark_down("r1")
        for fp in fps:
            rid, route, hand, _ = r._route(fp, "t", None)
            out.append((rid, route, None if hand is None else hand[1]))
        out.append(sorted(r._placed.items()))
        decisions[name] = out
    assert decisions["port"] == decisions["jax"]
    routes = {d[1] for d in decisions["port"][:-1]}
    assert routes == {"cold", "warm", "spill"}


# ---------------------------------------------------------------------------
# the breaker: the same transitions under explicit clocks
# ---------------------------------------------------------------------------


def _drive_breaker(mod):
    stub = _Stub()
    mon = mod.HealthMonitor({"r0": stub}, suspect_checks=2,
                            probe_backoff_s=0.5, check_s=1.0, warmup_s=2.0)
    mon._b["r0"].last_hb_t = 0.0
    trail = []

    def tick(now):
        v = mon.check(now=now)
        br = mon.breaker("r0")
        trail.append((now, br.state, br.failures, br.stale, br.down,
                      [x[1:3] for x in v]))

    stub.busy = True                   # busy, cycle counter flat
    for now in (0.5, 1.0, 2.0, 3.0):   # rate-limited: 1.0 s windows
        tick(now)
    for now in (3.2, 3.6):             # OPEN for 0.5 s, then HALF_OPEN
        tick(now)
    trail.append(mon.probe_admit("r0", "fpA"))
    trail.append(mon.probe_admit("r0", "fpB"))
    stub.completed_total += 1          # the probe completed: CLOSED
    stub._cycle += 3
    tick(4.0)
    for now in (5.0, 6.0, 7.0):        # wedged again: the chain's failover
        tick(now)
    mon.mark_down("r0")
    mon.restore("r0", now=8.0)
    br = mon.breaker("r0")
    trail.append((br.state, br.down, br.failures, br.warm_until))
    stub._thread_error = RuntimeError("scheduler died")
    tick(9.0)                          # dead: never rate-limited
    return trail


def test_breaker_transitions_match_jax():
    assert _drive_breaker(pt_health) == _drive_breaker(jax_health)
    trail = _drive_breaker(pt_health)
    states = [t[1] for t in trail if isinstance(t, tuple) and len(t) == 6]
    assert {"open", "half_open", "closed"} <= set(states)
    assert trail[-1][-1] == [("REPLICA_DEAD", "failover")]


# ---------------------------------------------------------------------------
# tickets: the JAX package's statuses, iterations and x
# ---------------------------------------------------------------------------


_JAX = {}


def _jax_solve(A, b):
    """The JAX package's solo BATCHED_CG solve of (A, b) (the fleet's
    buckets solve each system as a solo solve does)."""
    key = A.num_rows
    Aj = jx.CsrMatrix.from_scipy_like(
        A.row_offsets.numpy(), A.col_indices.numpy(), A.values.numpy(),
        A.num_rows, A.num_cols).init()
    slv = _JAX.get(key)
    if slv is None:
        slv = _JAX[key] = jx.create_solver(JaxConfig.from_string(
            JAX_BATCHED_CG))
        slv.setup(Aj)
    else:
        slv.resetup(Aj)
    return slv.solve(np.asarray(b))


def test_fleet_tickets_match_jax(mats):
    fleet = _fleet()
    reqs = _requests(mats)
    ts = [fleet.submit(A, b) for A, b in reqs]
    fleet.drain(timeout_s=300)
    homes = {}
    for t, (A, b) in zip(ts, reqs):
        assert t.done and t.result.converged
        homes.setdefault(t.fingerprint, t.replica)
        assert t.replica == homes[t.fingerprint]       # sticky
        r = _jax_solve(A, b)
        assert t.result.status == str(r.status).lower()
        assert t.result.iterations == int(r.iterations)
        np.testing.assert_allclose(t.result.x.numpy(), np.asarray(r.x),
                                   rtol=0, atol=1e-12)
    assert len(set(homes.values())) == 2
    routes = fleet.stats()["routes"]
    assert sum(c["cold"] for c in routes.values()) == 2
    assert sum(c["warm"] for c in routes.values()) == 4


def test_spill_on_overload_writes_handoff(mats):
    seq0 = flightrec.last_seq()
    fleet = _fleet("fleet_spill_depth=1")
    A = mats[0]
    t1 = fleet.submit(A, _rhs(A, 1))
    t2 = fleet.submit(_shift(A, 0.1), _rhs(A, 2))
    assert t1.route == "cold" and t2.route == "spill"
    assert t2.replica != t1.replica
    ev = flightrec.events(kind="fleet.handoff", since_seq=seq0)
    assert [(e["from_replica"], e["to_replica"], e["reason"]) for e in ev] \
        == [(t1.replica, t2.replica, "overload")]
    assert fleet._placed[t1.fingerprint] == t1.replica
    fleet.drain(timeout_s=300)
    assert t1.result.converged and t2.result.converged


# ---------------------------------------------------------------------------
# failover and rolling restart: zero loss, bit-identical
# ---------------------------------------------------------------------------


KILL = "serving_checkpoint_cycles=1, serving_chunk_iters=1"


@pytest.fixture(scope="module")
def unfaulted(mats, tmp_path_factory):
    """x of every request from a fleet nothing happens to."""
    d = tmp_path_factory.mktemp("ref")
    ref = _fleet(KILL + f", serving_journal_dir={d}")
    ts = [ref.submit(A, b) for A, b in _requests(mats)[:4]]
    ref.drain(timeout_s=300)
    return [t.result.x for t in ts]


def test_kill_failover_zero_loss_bit_identical(mats, unfaulted, tmp_path):
    fleet = _fleet(KILL + f", serving_journal_dir={tmp_path}")
    ts = [fleet.submit(A, b) for A, b in _requests(mats)[:4]]
    victim = ts[0].replica
    traces = [t.trace_id for t in ts]
    for _ in range(3):                 # admit + checkpoint on the victim
        fleet.step()
    adopted0 = metrics.get("fleet.health.adopted")
    requeued0 = metrics.get("fleet.health.requeued")
    with faultinject.inject("replica_kill", fires=1, target=victim):
        fleet.drain(timeout_s=300)
    assert all(t.done and t.result.converged for t in ts)
    for t, x in zip(ts, unfaulted):
        assert torch.equal(t.result.x, x)
    assert [t.trace_id for t in ts] == traces
    assert all(t.replica != victim for t in ts)
    hs = fleet.health_snapshot()
    assert hs[victim]["down"] and hs[victim]["state"] == "open"
    assert fleet.replicas[victim].journal.pending() == []
    assert metrics.get("fleet.health.requeued") - requeued0 == 2
    # the survivor adopted the journal; every pending record was moved
    # with its live ticket, so nothing replays twice
    assert metrics.get("fleet.health.adopted") == adopted0


def test_drain_restore_rolling_restart(mats, unfaulted):
    fleet = _fleet(KILL)
    reqs = _requests(mats)[:4]
    ts = [fleet.submit(A, b) for A, b in reqs[:2]]
    home = ts[0].replica
    fleet.step()
    moved = fleet.drain_replica(home)
    ts += [fleet.submit(A, b) for A, b in reqs[2:]]
    assert all(t.replica != home for t in ts[2:])    # no new placements
    fleet.drain(timeout_s=300)
    assert moved >= 0 and fleet.replicas[home].idle
    for t, x in zip(ts, unfaulted):
        assert t.done and torch.equal(t.result.x, x)
    assert fleet._placed[ts[0].fingerprint] == home  # homes kept
    fleet.restore_replica(home)
    assert fleet.health_snapshot()[home]["state"] == "closed"
    t = fleet.submit(*reqs[0])
    assert t.replica == home and t.route == "warm"
    fleet.drain(timeout_s=300)
    assert torch.equal(t.result.x, unfaulted[0])


def test_failover_adopts_journal_of_queued_records(mats, tmp_path):
    """A replica killed with requests only in its journal (no live
    ticket moved): the least-loaded survivor adopts the journal and
    replays them under their original trace ids."""
    fleet = _fleet(KILL + f", serving_journal_dir={tmp_path}")
    victim = fleet.replicas["r0"]
    A, b = _requests(mats)[0]
    t = victim.submit(A, b)
    with victim._lock:                 # the ticket object is lost ...
        victim._queue.clear()
        victim._keyed.clear()
    adopted0 = metrics.get("fleet.health.adopted")
    with faultinject.inject("replica_kill", fires=1, target="r0"):
        done = fleet.step()            # the idle victim's cycle dies
    assert fleet.health_snapshot()["r0"]["down"]
    done += fleet.drain(timeout_s=300)
    assert metrics.get("fleet.health.adopted") - adopted0 == 1
    # ... and its journal record replays on the survivor
    replayed = [d for d in done if d.journal_id == t.journal_id]
    assert len(replayed) == 1 and replayed[0].trace_id == t.trace_id
    assert replayed[0].result.converged
    assert victim.journal.pending() == []


def test_no_survivor_failover_fails_tickets_terminal(mats):
    fleet = _fleet(n=1)
    A, b = _requests(mats)[0]
    t = fleet.submit(A, b)
    with faultinject.inject("replica_kill", fires=1):
        fleet.drain(timeout_s=60)
    assert t.done and t.result.status_code == int(SolveStatus.BREAKDOWN)
    assert "replica_kill" in str(t.error)


def test_fleet_build_exports_and_knobs(tmp_path):
    cfg = _cfg(f"fleet_replicas=3, serving_journal_dir={tmp_path},"
               " fleet_spill_depth=5, fleet_suspect_checks=7")
    fleet = FleetRouter.build(cfg, device="cpu")
    assert list(fleet.replicas) == ["r0", "r1", "r2"]
    assert {s.journal.directory for s in fleet.replicas.values()} \
        == {str(tmp_path / r) for r in ("r0", "r1", "r2")}
    assert all(s.exec_share == 3.0 for s in fleet.replicas.values())
    assert fleet.spill_depth == 5 and fleet.health.suspect_checks == 7
    assert isinstance(fleet.health, HealthMonitor)
    assert metrics.get("fleet.replicas") == 3
