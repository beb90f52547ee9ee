"""Replica health: heartbeat sampling + per-replica circuit breakers
(the port of amgx_tpu/serving/health.py).

A `SolveService` is crash-safe on its own; the `FleetRouter` in front
of several of them must also know which replica is alive. The router
owns a `HealthMonitor` and ticks it from its submit/step/drain paths,
and the monitor turns three cheap liveness signals into breaker
transitions the router acts on:

- **thread aliveness + exception capture** -- `SolveService.start()`
  wraps its scheduler loop; an escaping exception lands on
  `svc._thread_error` (and the thread exits). Inline-driven fleets get
  the same capture from `FleetRouter.step()`. Either way the monitor
  sees it immediately (not rate-limited) and emits REPLICA_DEAD.
- **scheduler-cycle progress** -- `svc._cycle` increments once per
  scheduler cycle. A replica that is busy (queued or in-flight work)
  whose counter flatlines across `fleet_suspect_checks` consecutive
  rate-limited checks is SUSPECT first, then REPLICA_WEDGED.
- **cycle pace** -- when `fleet_slow_cycle_s` > 0, a busy replica whose
  per-cycle wall between checks exceeds it emits REPLICA_SLOW.

Events feed the per-replica circuit breaker through the
`fleet_fault_policy` chains (`resilience/policy.py` grammar,
`EVENT>action|...`): `ignore` counts only; `probe_backoff` OPENs the
breaker for a bounded exponential backoff (`fleet_probe_backoff_s *
2^failures`, exponent capped) and then HALF_OPENs -- the router admits
exactly ONE trial fingerprint until the replica proves progress (a
completion since the probe began closes the breaker); `failover`
returns a verdict the router turns into the full DOWN path (rehome +
ticket move + journal adoption, serving/fleet.py).

Administrative state rides the same breaker: `draining` (rolling
restart -- no new placements, in-flight finishes) and `warm_until`
(restore grace -- a just-restored cold replica is skipped for COLD
placements so it is not instantly the least-loaded home for every new
fingerprint, while warm traffic may return at once).

Every transition writes a flight-recorder event (`fleet.health`), a
`fleet.health.transition` span mark, and literal `fleet.health.*`
counters, so a cross-replica postmortem reads end to end. The clock is
`time.monotonic()`; `check()` and `restore()` take an explicit `now`
for deterministic drives. The monitor touches no tensor: it reads
host counters only, whatever device the replicas serve on.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..resilience.policy import parse_fleet_policy
from ..telemetry import flightrec as _fr
from ..telemetry import metrics as _tm
from ..telemetry import spans as _spans

# breaker states (the classic circuit-breaker trio; DOWN and draining
# are orthogonal flags on top -- a DOWN breaker stays OPEN until
# restore_replica resets it)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

DEFAULT_FLEET_POLICY = ("REPLICA_DEAD>failover"
                        "|REPLICA_WEDGED>probe_backoff"
                        "|REPLICA_WEDGED>failover"
                        "|REPLICA_SLOW>probe_backoff")

# Verdict the monitor hands the router per transition:
# (replica_id, event, action, captured_error_or_None)
Verdict = Tuple[str, str, str, Optional[BaseException]]


class ReplicaBreaker:
    """Health + breaker state for one replica (mutated only under the
    owning HealthMonitor's lock; hot-path reads are lock-free -- every
    field is a plain scalar)."""

    def __init__(self, rid: str):
        self.rid = rid
        self.state = CLOSED
        self.down = False          # failover ran; restore_replica resets
        self.draining = False      # administrative (rolling restart)
        self.failures = 0          # consecutive health events
        self.not_before = 0.0      # OPEN -> HALF_OPEN gate (monotonic)
        self.probe_fp: Optional[str] = None   # the HALF_OPEN trial
        self.probe_base = 0        # completed_total when probe began
        self.warm_until = 0.0      # restore grace (monotonic)
        self.last_event: Optional[str] = None
        # heartbeat sampling state (rate-limited by check_s)
        self.last_cycle = 0
        self.last_hb_t = 0.0
        self.stale = 0

    @property
    def available(self) -> bool:
        """May this replica take warm/queued traffic right now?
        (HALF_OPEN counts: the probe-admission decision is the
        router's, per fingerprint.)"""
        return not self.down and not self.draining and self.state != OPEN

    def snapshot(self, now: float) -> Dict[str, object]:
        return {
            "state": self.state,
            "down": self.down,
            "draining": self.draining,
            "failures": self.failures,
            "last_event": self.last_event,
            "probe_fingerprint": self.probe_fp,
            "backoff_remaining_s": round(max(0.0, self.not_before - now), 4)
            if self.state == OPEN and not self.down else 0.0,
            "warmup_remaining_s": round(max(0.0, self.warm_until - now), 4),
        }


class HealthMonitor:
    """Fleet-side health tracking over {replica_id: SolveService}.

    `check()` is the single entry point: the router calls it from its
    submit/step/drain paths. Dead-thread detection runs on EVERY call
    (a dead scheduler must not wait out a rate limiter); heartbeat
    counting (wedge/slow) runs at most once per `check_s` per replica,
    so the SUSPECT counter counts real no-progress WINDOWS, not
    back-to-back submits that never gave the scheduler a chance to
    run."""

    def __init__(self, replicas, *, policy: Optional[str] = None,
                 suspect_checks: int = 4, probe_backoff_s: float = 0.05,
                 check_s: float = 0.25, warmup_s: float = 1.0,
                 slow_cycle_s: float = 0.0):
        self.replicas = replicas
        self.policy = parse_fleet_policy(
            DEFAULT_FLEET_POLICY if policy is None else policy)
        self.suspect_checks = max(1, int(suspect_checks))
        self.probe_backoff_s = float(probe_backoff_s)
        self.check_s = float(check_s)
        self.warmup_s = float(warmup_s)
        self.slow_cycle_s = float(slow_cycle_s)
        self._lock = threading.Lock()
        self._b: Dict[str, ReplicaBreaker] = {
            rid: ReplicaBreaker(rid) for rid in replicas}
        now = time.monotonic()
        for rid, br in self._b.items():
            br.last_hb_t = now
            br.last_cycle = replicas[rid]._cycle
        self._publish_available()

    # -- reads -------------------------------------------------------------
    def breaker(self, rid: str) -> ReplicaBreaker:
        return self._b[rid]

    def available(self, rid: str) -> bool:
        return self._b[rid].available

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        now = time.monotonic()
        with self._lock:
            return {rid: br.snapshot(now) for rid, br in self._b.items()}

    def _publish_available(self):
        _tm.set_gauge("fleet.health.available",
                      sum(1 for br in self._b.values() if br.available))

    # -- transitions -------------------------------------------------------
    def _record(self, rid: str, event: str, **fields):
        """One transition: flight event + span mark (the postmortem
        trail AND the Perfetto timeline both carry it)."""
        _fr.record("fleet.health", replica=rid, event=event, **fields)
        _spans.mark("fleet.health.transition",
                    args=dict(replica=rid, event=event, **fields))

    def _apply(self, br: ReplicaBreaker, event: str,
               err: Optional[BaseException], now: float
               ) -> Optional[Verdict]:
        """Run one detected event through the policy chain (lock
        held). Returns a failover verdict for the router, or None when
        the chain handled it breaker-side."""
        chain = self.policy.get(event) or ["failover"]
        action = chain[min(br.failures, len(chain) - 1)]
        n = br.failures
        br.failures += 1
        br.last_event = event
        self._record(br.rid, event, action=action, failures=br.failures,
                     error=None if err is None else str(err)[:120])
        if action == "ignore":
            return None
        if action == "probe_backoff":
            br.state = OPEN
            br.probe_fp = None
            # bounded exponential backoff (exponent capped so a
            # repeat-offender replica re-probes within minutes, not
            # geologic time)
            br.not_before = now + self.probe_backoff_s * (2 ** min(n, 6))
            _tm.inc("fleet.health.breaker_open")
            self._publish_available()
            return None
        return (br.rid, event, "failover", err)

    def note_error(self, rid: str, err: BaseException):
        """Router-side capture: an inline-driven replica's step()
        raised. Stored on the service exactly where the background
        loop would put it, so the next check() sees one code path."""
        svc = self.replicas[rid]
        if getattr(svc, "_thread_error", None) is None:
            svc._thread_error = err

    def mark_down(self, rid: str):
        """Failover ran (router-side): pin the breaker OPEN until
        restore_replica."""
        with self._lock:
            br = self._b[rid]
            br.down = True
            br.state = OPEN
            br.probe_fp = None
            _tm.inc("fleet.health.down")
            self._record(rid, "DOWN")
            self._publish_available()

    def drain(self, rid: str):
        with self._lock:
            br = self._b[rid]
            if br.draining:
                return
            br.draining = True
            _tm.inc("fleet.health.drains")
            self._record(rid, "DRAINING")
            self._publish_available()

    def restore(self, rid: str, now: Optional[float] = None):
        """Re-enter rendezvous: breaker reset to CLOSED with a cold-
        placement warm-up grace (rehomed fingerprints are NOT pulled
        back -- snap-back is by natural eviction only)."""
        now = time.monotonic() if now is None else now
        svc = self.replicas[rid]
        with self._lock:
            br = self._b[rid]
            br.down = False
            br.draining = False
            br.state = CLOSED
            br.failures = 0
            br.stale = 0
            br.probe_fp = None
            br.warm_until = now + self.warmup_s
            br.last_cycle = svc._cycle
            br.last_hb_t = now
            svc._thread_error = None
            _tm.inc("fleet.health.restores")
            self._record(rid, "RESTORED",
                         warmup_s=round(self.warmup_s, 3))
            self._publish_available()

    def probe_admit(self, rid: str, fp: str) -> bool:
        """HALF_OPEN admission control: exactly one trial fingerprint
        passes; everything else diverts until the breaker closes."""
        with self._lock:
            br = self._b[rid]
            if br.state != HALF_OPEN:
                return br.available
            if br.probe_fp is None:
                br.probe_fp = fp
                br.probe_base = self.replicas[rid].completed_total
                _tm.inc("fleet.health.probe_trials")
                self._record(rid, "PROBE", fingerprint=fp[:24])
                return True
            return br.probe_fp == fp

    # -- the periodic check ------------------------------------------------
    def check(self, now: Optional[float] = None) -> List[Verdict]:
        """Sample every replica once; returns the failover verdicts
        the router must act on. Cheap enough for the submit path: a
        few attribute reads per replica, heartbeat bookkeeping rate-
        limited to one sample per `check_s`."""
        now = time.monotonic() if now is None else now
        verdicts: List[Verdict] = []
        with self._lock:
            for rid, svc in self.replicas.items():
                br = self._b[rid]
                if br.down:
                    continue
                # OPEN -> HALF_OPEN once the backoff elapsed
                if br.state == OPEN and now >= br.not_before:
                    br.state = HALF_OPEN
                    br.probe_fp = None
                    br.probe_base = svc.completed_total
                    _tm.inc("fleet.health.breaker_half_open")
                    self._record(rid, "HALF_OPEN")
                    self._publish_available()
                # dead scheduler: captured exception, or a started
                # thread that is no longer alive without stop() -- runs
                # on EVERY check (never rate-limited)
                err = getattr(svc, "_thread_error", None)
                th = svc._thread
                dead = err is not None or (
                    th is not None and not th.is_alive()
                    and not svc._stopping)
                if dead:
                    _tm.inc("fleet.health.dead")
                    v = self._apply(br, "REPLICA_DEAD", err, now)
                    if v is not None:
                        verdicts.append(v)
                    continue
                # HALF_OPEN probe success: any completion since the
                # probe began is proof of end-to-end progress
                if br.state == HALF_OPEN \
                        and svc.completed_total > br.probe_base:
                    br.state = CLOSED
                    br.failures = 0
                    br.stale = 0
                    br.probe_fp = None
                    _tm.inc("fleet.health.breaker_closed")
                    self._record(rid, "CLOSED")
                    self._publish_available()
                # heartbeat window (rate-limited)
                if now - br.last_hb_t < self.check_s:
                    continue
                cycle = svc._cycle
                dt, dc = now - br.last_hb_t, cycle - br.last_cycle
                br.last_hb_t = now
                br.last_cycle = cycle
                busy = not svc.idle
                # An active builder thread is progress even when the
                # scheduler cycle counter flatlines: long AMG setups
                # (full resetup, bucket compile) must not read as a
                # wedged scheduler.  The chaos wedge drill stalls the
                # scheduler itself, with no build in flight.
                if busy and dc == 0 and not svc._builds:
                    br.stale += 1
                    if br.stale == 1:
                        _tm.inc("fleet.health.suspect")
                        self._record(rid, "SUSPECT", cycle=cycle)
                    if br.stale >= self.suspect_checks:
                        br.stale = 0
                        _tm.inc("fleet.health.wedged")
                        v = self._apply(br, "REPLICA_WEDGED", None, now)
                        if v is not None:
                            verdicts.append(v)
                    continue
                br.stale = 0
                if busy and dc > 0 and self.slow_cycle_s > 0 \
                        and dt / dc > self.slow_cycle_s:
                    _tm.inc("fleet.health.slow")
                    v = self._apply(br, "REPLICA_SLOW", None, now)
                    if v is not None:
                        verdicts.append(v)
        return verdicts
