"""Fleet serving: a fingerprint-affine router over SolveService
replicas (the port of amgx_tpu/serving/fleet.py).

One `SolveService` is crash-safe and overload-safe on its own; a
`FleetRouter` fronts N of them behind the same submit/step/drain/ticket
API, so a caller talks to one serving endpoint while requests land on
the replica most likely to serve them cheaply.

Why affinity keys on the PATTERN FINGERPRINT: everything expensive a
replica holds -- its hierarchy cache buckets, persisted structures,
warm-start bundles, even its retry/backoff fault state -- is
fingerprint-keyed. A replica warm for a fingerprint serves it with a
value-only resetup; a cold one pays a full coarsening. Placement is
therefore the dominant fleet-level lever, and it must be STICKY:
rendezvous (highest-random-weight) hashing gives every fingerprint a
stable candidate order over the replica set, so adding or removing a
replica reshuffles only the fingerprints that hashed to it. The scores
are the JAX package's (`_rendezvous_score`), so both packages send a
fingerprint to the same replica.

Routing classes (counted per decision, `fleet.route.*`):

- `cold` -- first sighting of a fingerprint: placed on the
  least-loaded replica (live queue depth x recent exec estimate, ties
  broken by rendezvous order) which becomes its home;
- `warm` -- the home replica takes it (the steady state);
- `spill` -- the home is overloaded (queue depth past
  `fleet_spill_depth` AND a strictly less-loaded candidate exists),
  quarantine-looping on this fingerprint (its fault/backoff state is
  live), or deadline-infeasible while another replica's estimate says
  feasible: the request diverts to the next rendezvous candidate and
  the flight recorder gets a `fleet.handoff` note. Quarantine spills
  REHOME the fingerprint (the sick replica stays its rendezvous
  candidate, but the warm state now grows elsewhere); load spills
  don't.

Shed decisions consult the FLEET-WIDE aggregate: per-replica
feasibility estimates plus the merged per-tenant latency histograms
(`metrics.merge_snapshots` over the replica-labeled series, read via
`metrics.quantile_where`). When every replica judges a deadline
unmeetable the router routes home anyway -- the home replica's shed
policy completes the request honestly OVERLOADED -- and counts
`fleet.shed.infeasible` with the estimates it decided on in the
flight recorder.

Trace attribution: every routed ticket gains `.replica`/`.route`
attributes and, when tracing is on, a `fleet.route` instant event on
its flow chain.

**Fault tolerance.** The router owns a `HealthMonitor`
(serving/health.py) and ticks it from submit/step/drain. Routing is
availability-aware: DOWN, draining and breaker-OPEN replicas take no
traffic, a HALF_OPEN replica admits exactly one probe fingerprint,
and a just-restored replica sits out COLD placements for a warm-up
grace. When the monitor's `fleet_fault_policy` chain says `failover`,
`_failover()` runs the zero-loss DOWN path: the dead replica's queued
AND in-flight tickets move to survivors (in-flight resume from their
last journal checkpoint, deadlines re-anchored as remaining budget),
its fingerprints rehome along rendezvous order, and the least-loaded
survivor ADOPTS its journal -- pending records replay cross-replica
under their original trace ids, completions settle back into the
adopted journal so nothing double-replays. With no survivor left the
outstanding tickets complete BREAKDOWN with the captured error
(`ticket.error`) instead of wedging drain. `drain_replica()` /
`restore_replica()` give rolling restarts the same guarantees
administratively.

**One card, several replicas.** In-process replicas share the
service's device and its default stream: each replica's builder and
scheduler threads launch onto the same card, and `exec_share` scales
every replica's feasibility estimate by the fleet size. The router
itself reads host counters only and launches nothing.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..batch.queue import pattern_fingerprint
from ..config import Config
from ..errors import BadParametersError
from ..matrix import CsrMatrix
from ..telemetry import flightrec as _fr
from ..telemetry import metrics as _tm
from ..telemetry import spans as _spans
from .health import CLOSED, HALF_OPEN, HealthMonitor
from .service import (ServiceTicket, SolveService, _dtype_name, _now,
                      _vector)


def _rendezvous_score(fingerprint: str, rid: str) -> int:
    """Highest-random-weight score of (fingerprint, replica): stable
    across processes and python hash seeds (the journal may hand a
    restarted fleet the same fingerprints)."""
    h = hashlib.blake2b(f"{fingerprint}@{rid}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


class FleetRouter:
    """N `SolveService` replicas behind one submit/step/drain/ticket
    surface. Accepts a dict {replica_id: service} or a list of
    services; entries without an identity (no dict key, no
    pre-assigned `.replica` attribute) get distinct derived ids
    `r0..rN-1` -- two unlabeled replicas in one process must never
    scrape identically (their latency series would silently merge)."""

    def __init__(self, replicas, *, spill_depth: int = 0,
                 fault_policy: Optional[str] = None,
                 suspect_checks: int = 4,
                 probe_backoff_s: float = 0.05,
                 health_check_s: float = 0.25,
                 warmup_s: float = 1.0,
                 slow_cycle_s: float = 0.0):
        if isinstance(replicas, dict):
            items = list(replicas.items())
        else:
            items = [(None, svc) for svc in replicas]
        if not items:
            raise BadParametersError(
                "FleetRouter: at least one replica required")
        self.replicas: Dict[str, SolveService] = {}
        taken = {rid for rid, svc in items
                 if rid or getattr(svc, "replica", "")}
        auto = 0
        for rid, svc in items:
            rid = str(rid or getattr(svc, "replica", "") or "")
            if not rid:
                while f"r{auto}" in taken:
                    auto += 1
                rid = f"r{auto}"
                taken.add(rid)
            if rid in self.replicas:
                raise BadParametersError(
                    f"FleetRouter: duplicate replica id {rid!r}")
            svc.replica = rid      # labels this replica's metric series
            self.replicas[rid] = svc
        for svc in self.replicas.values():
            # in-process replicas share ONE execution device: each
            # one's exec window undercounts wall latency by the number
            # of co-residents competing for the core, so feasibility
            # estimates (shed decisions, spill reads, fleet consults)
            # scale by the fleet size
            svc.exec_share = float(len(self.replicas))
        self.spill_depth = int(spill_depth)
        self._lock = threading.Lock()
        # fingerprint -> home replica id (sticky placement)
        self._placed: Dict[str, str] = {}
        # request_key -> replica id: a retried idempotent submit must
        # land on the replica holding (or journaling) the original
        self._keyed: Dict[str, str] = {}
        self.route_counts: Dict[str, Dict[str, int]] = {
            rid: {"warm": 0, "cold": 0, "spill": 0}
            for rid in self.replicas}
        self.health = HealthMonitor(
            self.replicas, policy=fault_policy,
            suspect_checks=suspect_checks,
            probe_backoff_s=probe_backoff_s, check_s=health_check_s,
            warmup_s=warmup_s, slow_cycle_s=slow_cycle_s)
        # the poll cadence start() last used: restore_replica restarts
        # a restored replica's scheduler iff the fleet runs background
        self._bg_poll: Optional[float] = None
        _tm.set_gauge("fleet.replicas", len(self.replicas))

    @classmethod
    def build(cls, cfg: Config, n_replicas: Optional[int] = None,
              scope: str = "default", device=None) -> "FleetRouter":
        """N replicas from ONE config (default `fleet_replicas`).
        Each gets a derived replica id; a configured
        `serving_journal_dir` gains a per-replica subdirectory -- a
        journal's replay owns its records, two replicas must not
        replay each other's -- while the AOT and hierarchy stores stay
        shared (fingerprint-keyed: one replica's export warms every
        replica's restart). Every replica serves on `device` (the card
        unless device="cpu")."""
        n = int(cfg.get("fleet_replicas", scope)
                if n_replicas is None else n_replicas)
        if n < 1:
            raise BadParametersError(
                f"FleetRouter.build: need >= 1 replica, got {n}")
        jdir = str(cfg.get("serving_journal_dir", scope)).strip()
        base_id = str(cfg.get("serving_replica_id", scope)).strip()
        replicas: Dict[str, SolveService] = {}
        for i in range(n):
            rid = f"{base_id}{i}" if base_id else f"r{i}"
            c = cfg.clone()
            # the id is assigned as the service ATTRIBUTE below (via
            # __init__), not through serving_replica_id -- the knob
            # also sets the process-global scrape label, and N
            # in-process replicas must not fight over it
            if jdir:
                c.set("serving_journal_dir",
                      os.path.join(jdir, rid), scope)
            svc = SolveService(c, scope=scope, device=device)
            svc.replica = rid
            replicas[rid] = svc
        return cls(replicas,
                   spill_depth=int(cfg.get("fleet_spill_depth",
                                           scope)),
                   fault_policy=str(cfg.get("fleet_fault_policy",
                                            scope)),
                   suspect_checks=int(cfg.get("fleet_suspect_checks",
                                              scope)),
                   probe_backoff_s=float(
                       cfg.get("fleet_probe_backoff_s", scope)),
                   health_check_s=float(
                       cfg.get("fleet_health_check_s", scope)),
                   warmup_s=float(cfg.get("fleet_warmup_s", scope)),
                   slow_cycle_s=float(
                       cfg.get("fleet_slow_cycle_s", scope)))

    # -- load/feasibility reads -------------------------------------------
    def _queue_depth(self, svc: SolveService) -> int:
        with svc._lock:
            return len(svc._queue)

    def _load(self, svc: SolveService) -> float:
        """Live load: (queue depth + in-flight) x the replica's recent
        exec estimate (1.0 while untrained, so cold placement on an
        empty fleet degenerates to fewest-requests)."""
        with svc._lock:
            depth = len(svc._queue) + svc._inflight()
            if len(svc._exec_recent) >= 1:
                window = sorted(svc._exec_recent)
                est = float(window[len(window) // 2])
            else:
                est = 1.0
        return depth * max(est, 1e-9) + 1e-12 * depth

    def _estimate(self, svc: SolveService) -> Optional[float]:
        with svc._lock:
            return svc._estimate_latency_s()

    def _spill_limit(self, svc: SolveService) -> int:
        return self.spill_depth or max(2 * svc.slots, 2)

    # -- routing -----------------------------------------------------------
    def _healthy(self, rid: str, now: float,
                 cold: bool = False) -> bool:
        """May `rid` take regular (non-probe) traffic? CLOSED breaker,
        not down, not draining -- and for COLD placements, past its
        restore warm-up grace (a just-restored empty replica would
        otherwise instantly be the least-loaded home for every new
        fingerprint). Lock-free: breaker fields are plain scalars."""
        br = self.health.breaker(rid)
        if br.down or br.draining or br.state != CLOSED:
            return False
        if cold and now < br.warm_until:
            return False
        return True

    def _route(self, fp: str, tenant: str,
               deadline_s: Optional[float]):
        """(replica id, route class, handoff, consult): the whole
        decision under the router lock -- placement map reads/writes
        must not interleave across concurrent submits."""
        now_m = time.monotonic()
        with self._lock:
            order = sorted(
                self.replicas,
                key=lambda r: _rendezvous_score(fp, r), reverse=True)
            home = self._placed.get(fp)
            if home is None or home not in self.replicas:
                # cold placement: healthy-and-warmed-up first, then
                # healthy, then anything not down -- an all-down fleet
                # still routes (the ticket waits for a restore; a
                # refusal would lose it outright)
                cands = [r for r in order
                         if self._healthy(r, now_m, cold=True)] \
                    or [r for r in order if self._healthy(r, now_m)] \
                    or [r for r in order
                        if not self.health.breaker(r).down] \
                    or order
                loads = {rid: self._load(self.replicas[rid])
                         for rid in cands}
                rid = min(cands,
                          key=lambda r: (loads[r], order.index(r)))
                self._placed[fp] = rid
                return rid, "cold", None, None
            home_svc = self.replicas[home]
            br_home = self.health.breaker(home)
            if br_home.down or br_home.draining \
                    or br_home.state != CLOSED:
                # the home can't take regular traffic. HALF_OPEN
                # admits exactly ONE trial fingerprint (the breaker
                # probe); everything else diverts to the next healthy
                # rendezvous candidate
                if br_home.state == HALF_OPEN and not br_home.down \
                        and not br_home.draining \
                        and self.health.probe_admit(home, fp):
                    return home, "warm", None, None
                reason = ("draining" if br_home.draining
                          else "down" if br_home.down else "breaker")
                target = next(
                    (r for r in order
                     if r != home and self._healthy(r, now_m)), None)
                if target is None:
                    # no healthy alternative: degraded beats refused
                    return home, "warm", None, None
                if br_home.down:
                    # failover rehomes placements, but a submit can
                    # race it -- make the diversion sticky so the warm
                    # state grows in ONE place
                    self._placed[fp] = target
                return target, "spill", \
                    (home, reason, self._queue_depth(home_svc)), None
            cands = [r for r in order
                     if r != home and self._healthy(r, now_m)]
            # 1. quarantine-looping home: its fault/backoff state for
            # this fingerprint is live -- rebuild-crash loops there
            # while a healthy replica could just serve. Rehome.
            fl = home_svc._faulted.get(fp)
            if fl is not None and cands:
                target = next(
                    (r for r in cands
                     if fp not in self.replicas[r]._faulted),
                    cands[0])
                self._placed[fp] = target
                return target, "spill", \
                    (home, "quarantine", self._queue_depth(home_svc)), \
                    None
            # 2. overloaded home: spill only toward a STRICTLY less
            # loaded candidate -- a uniformly saturated fleet keeps
            # affinity (and sheds) instead of ping-ponging cold builds
            depth = self._queue_depth(home_svc)
            if cands and depth >= self._spill_limit(home_svc):
                home_load = self._load(home_svc)
                target = next(
                    (r for r in cands
                     if self._load(self.replicas[r]) < home_load
                     and self._queue_depth(self.replicas[r]) < depth),
                    None)
                if target is not None:
                    return target, "spill", \
                        (home, "overload", depth), None
            # 3. fleet-wide deadline feasibility consult. A
            # deadline-driven spill is only eligible toward a replica
            # already holding this fingerprint's bucket WARM: moving a
            # warm fingerprint to a cold replica trades a sub-second
            # value-resetup for a multi-second setup -- the one hop
            # guaranteed to bust the very deadline being rescued
            if deadline_s is not None:
                est_home = self._estimate(home_svc)
                if est_home is not None \
                        and est_home > float(deadline_s):
                    ests = {rid: self._estimate(self.replicas[rid])
                            for rid in order}
                    feas = [r for r in cands
                            if (ests[r] is None
                                or ests[r] <= float(deadline_s))
                            and self.replicas[r].buckets.peek(fp)
                            is not None]
                    if feas:
                        return feas[0], "spill", \
                            (home, "deadline", depth), None
                    # infeasible everywhere: route home for the
                    # honest per-replica OVERLOADED shed, and record
                    # the fleet-wide evidence the verdict rests on
                    consult = {
                        "deadline_s": round(float(deadline_s), 6),
                        "estimates_s": {
                            rid: None if e is None
                            else round(float(e), 6)
                            for rid, e in ests.items()},
                        "tenant_p50_s": _tm.quantile_where(
                            "serving.solve_latency_s", 0.50,
                            {"tenant": tenant}),
                        "tenant_p99_s": _tm.quantile_where(
                            "serving.solve_latency_s", 0.99,
                            {"tenant": tenant}),
                    }
                    return home, "warm", None, consult
            return home, "warm", None, None

    # -- the serving surface ----------------------------------------------
    def submit(self, A: CsrMatrix, b, x0=None,
               tenant: str = "default",
               deadline_s: Optional[float] = None,
               request_key: Optional[str] = None) -> ServiceTicket:
        """Route one request to a replica and submit it there. The
        returned ticket is the replica's own (same wait/result API),
        plus `.replica` and `.route` attribution."""
        self._health_tick()
        fp = f"{pattern_fingerprint(A)}/{_dtype_name(_vector(b).dtype)}"
        if request_key:
            with self._lock:
                prior = self._keyed.get(request_key)
            if prior is not None and prior in self.replicas \
                    and not self.health.breaker(prior).down:
                # idempotent retry: the original's replica holds the
                # live ticket (or its journal holds the result) --
                # routing elsewhere would re-solve it
                t = self.replicas[prior].submit(
                    A, b, x0=x0, tenant=tenant,
                    deadline_s=deadline_s, request_key=request_key)
                t.replica = prior
                t.route = "warm"
                return t
        rid, route, handoff, consult = self._route(
            fp, str(tenant), deadline_s)
        svc = self.replicas[rid]
        t = svc.submit(A, b, x0=x0, tenant=tenant,
                       deadline_s=deadline_s,
                       request_key=request_key)
        t.replica = rid
        t.route = route
        # literal route-class counters (the check_spans dead-metric
        # lint wants write sites it can see)
        if route == "warm":
            _tm.inc("fleet.route.warm")
        elif route == "spill":
            _tm.inc("fleet.route.spill")
        else:
            _tm.inc("fleet.route.cold")
        with self._lock:
            self.route_counts[rid][route] += 1
            if request_key:
                self._keyed[request_key] = rid
        if t.trace_id:
            # replica attribution on the request's flow chain
            _spans.mark("fleet.route", args={
                "trace": t.trace_id, "replica": rid, "route": route})
        if handoff is not None:
            from_rid, reason, home_depth = handoff
            _fr.record("fleet.handoff", trace=t.trace_id,
                       fingerprint=fp[:24], from_replica=from_rid,
                       to_replica=rid, reason=reason,
                       home_queue_depth=home_depth)
        if consult is not None:
            _tm.inc("fleet.shed.infeasible")
            _fr.record("fleet.shed", trace=t.trace_id,
                       tenant=str(tenant), verdict="infeasible",
                       **consult)
        return t

    def step(self) -> List[ServiceTicket]:
        """One scheduler cycle on every LIVE replica (round-robin
        inline driving -- the single-process analog of N schedulers);
        returns the tickets completed across the fleet. A step() that
        raises (chaos replica_kill, a real scheduler bug) is captured
        for the health monitor exactly where a background loop would
        put it, then the health tick runs the policy chain."""
        done: List[ServiceTicket] = []
        for rid, svc in self.replicas.items():
            if self.health.breaker(rid).down:
                continue
            try:
                done.extend(svc.step())
            except Exception as e:
                self.health.note_error(rid, e)
        done.extend(self._health_tick())
        return done

    @property
    def idle(self) -> bool:
        """DOWN replicas are excluded: their outstanding work was
        moved or failed terminal by _failover, and a racing builder
        thread repopulating their install map must not wedge drain."""
        return all(svc.idle for rid, svc in self.replicas.items()
                   if not self.health.breaker(rid).down)

    @property
    def completed_total(self) -> int:
        return sum(svc.completed_total
                   for svc in self.replicas.values())

    def drain(self, timeout_s: Optional[float] = None
              ) -> List[ServiceTicket]:
        """Step until every live replica is idle (or timeout).
        Replicas running their own background scheduler are waited on;
        inline-driven ones are stepped. The health monitor ticks every
        loop, so a replica whose scheduler thread died mid-drain is
        failed over (tickets move to survivors, or complete BREAKDOWN
        with the captured error when none remain) instead of spinning
        this loop to its timeout."""
        t0 = time.monotonic()
        done: List[ServiceTicket] = []
        done.extend(self._health_tick())
        while not self.idle:
            if timeout_s is not None \
                    and time.monotonic() - t0 > timeout_s:
                break
            stepped = False
            for rid, svc in self.replicas.items():
                if self.health.breaker(rid).down:
                    continue
                if svc._thread is None:
                    try:
                        done.extend(svc.step())
                    except Exception as e:
                        self.health.note_error(rid, e)
                    stepped = True
            done.extend(self._health_tick())
            if not stepped:
                time.sleep(0.001)
        return done

    def start(self, poll_s: float = 0.0005):
        self._bg_poll = poll_s
        for rid, svc in self.replicas.items():
            if not self.health.breaker(rid).down:
                svc.start(poll_s=poll_s)

    def stop(self):
        self._bg_poll = None
        for svc in self.replicas.values():
            svc.stop()

    # -- fault tolerance ---------------------------------------------------
    def _health_tick(self) -> List[ServiceTicket]:
        """One health check + the actions its verdicts demand. Called
        from submit/step/drain -- cheap when nothing is wrong (a few
        scalar reads per replica). Returns tickets a no-survivor
        failover completed BREAKDOWN, so drain loops can report
        them."""
        done: List[ServiceTicket] = []
        for rid, _event, _action, err in self.health.check():
            done.extend(self._failover(rid, err, _event))
        # straggler rescue: a submit that raced a failover may have
        # queued onto a replica marked down in between -- move it
        for rid, svc in self.replicas.items():
            if self.health.breaker(rid).down and svc._queue:
                self._rescue_queue(rid)
        return done

    def _failover(self, rid: str, err: Optional[BaseException],
                  event: str = "REPLICA_DEAD") -> List[ServiceTicket]:
        """The DOWN path: mark `rid` down, extract its queued AND
        in-flight tickets, rehome its fingerprints along rendezvous
        order, re-submit the tickets to survivors at the FRONT of
        their queues (in-flight ones resume from their last journal
        checkpoint with deadlines re-anchored as remaining budget),
        and have the least-loaded survivor adopt the dead replica's
        journal so its other pending records replay exactly once.
        With no survivor, everything outstanding completes BREAKDOWN
        with the captured error -- terminal honesty over a wedged
        drain. Returns the tickets completed here (empty on the
        survivor path: moved work completes later, on its adopter)."""
        t0 = time.monotonic()
        svc = self.replicas[rid]
        self.health.mark_down(rid)
        svc._stopping = True       # a still-breathing loop exits
        # a DEAD scheduler's cycle lock is free; a truly WEDGED one
        # may never release it -- bounded acquire keeps failover from
        # hanging on the very replica it is rescuing
        got = svc._sched_lock.acquire(timeout=0.1)
        try:
            with svc._lock:
                queued = list(svc._queue)
                svc._queue = []
                svc._builds.clear()
                svc._built.clear()
                svc._build_failed.clear()
                engines = [svc.buckets.peek(k)
                           for k in svc.buckets.keys()]
            inflight: List[ServiceTicket] = []
            for eng in engines:
                if eng is None:
                    continue
                for j in range(eng.slots):
                    t = eng.occupant[j]
                    if t is None:
                        continue
                    try:
                        eng.release(j)
                    except Exception:
                        eng.occupant[j] = None
                    if not t.done:
                        inflight.append(t)
            with svc._lock:
                for t in queued + inflight:
                    if t.request_key:
                        svc._keyed.pop(t.request_key, None)
        finally:
            if got:
                svc._sched_lock.release()
        jr = svc.journal
        now = _now()
        for t in inflight:
            # resume from the last DURABLE checkpoint (what a
            # cross-process adoption would see); the journal's
            # remaining deadline budget re-anchors against the
            # adopter's service_now() -- same contract as recover().
            # Without a journal the live absolute deadline stands
            # (in-process replicas share one skew-hookable clock)
            state = remaining = None
            if jr is not None and t.journal_id is not None:
                try:
                    state, remaining = jr.load_checkpoint(t.journal_id)
                except Exception:
                    state = remaining = None
            if state is not None:
                t.resume_state = state
            if remaining is not None:
                t.deadline_t = now + float(remaining)
            t.admit_t = None
        victims = queued + inflight
        for t in victims:
            if jr is not None and t.journal_id is not None:
                # completions settle the DEAD replica's records --
                # the adopted journal must never replay moved work
                t.journal_ref = jr
        now_m = time.monotonic()
        surv = [r for r in self.replicas
                if r != rid and self._healthy(r, now_m)]
        survset = set(surv)
        rehomed = 0
        with self._lock:
            for fp, h in list(self._placed.items()):
                if h != rid:
                    continue
                order = sorted(
                    self.replicas,
                    key=lambda r: _rendezvous_score(fp, r),
                    reverse=True)
                target = next((r for r in order if r in survset),
                              None)
                if target is None:
                    self._placed.pop(fp)
                else:
                    self._placed[fp] = target
                    rehomed += 1
        if rehomed:
            _tm.inc("fleet.health.rehomed", rehomed)
        if not surv:
            e = err if isinstance(err, Exception) else RuntimeError(
                f"replica {rid} {event.lower()}"
                + ("" if err is None else f": {err}"))
            with svc._lock:
                for t in victims:
                    if not t.done:
                        svc._fail_ticket(t, e)
            svc._flush_flightrec()
            svc._flush_journal_done()
            _fr.record("fleet.failover", replica=rid, event=event,
                       survivors=0, failed=len(victims),
                       error=None if err is None else str(err)[:120])
            _spans.mark("fleet.failover", args={
                "replica": rid, "event": event, "survivors": 0,
                "failed": len(victims)})
            return [t for t in victims if t.done]
        per: Dict[str, List[ServiceTicket]] = {}
        with self._lock:
            for t in victims:
                target = self._placed.get(t.fingerprint)
                if target not in survset:
                    order = sorted(
                        self.replicas,
                        key=lambda r: _rendezvous_score(
                            t.fingerprint, r), reverse=True)
                    target = next(
                        (r for r in order if r in survset), surv[0])
                per.setdefault(target, []).append(t)
                if t.request_key:
                    self._keyed[t.request_key] = target
        for trid, ts in per.items():
            tsvc = self.replicas[trid]
            with tsvc._lock:
                # FRONT of the queue: moved work was submitted before
                # anything already waiting here
                tsvc._queue[0:0] = ts
                for t in ts:
                    if t.request_key:
                        tsvc._keyed[t.request_key] = t
                _tm.set_gauge("serving.queue_depth",
                              len(tsvc._queue))
            for t in ts:
                t.replica = trid
        if victims:
            _tm.inc("fleet.health.requeued", len(victims))
        adopter = None
        adopted = 0
        if jr is not None:
            adopter = min(surv,
                          key=lambda r: self._load(self.replicas[r]))
            skipids = frozenset(t.journal_id for t in victims
                                if t.journal_id is not None)
            adopted = self.replicas[adopter].adopt_journal(
                jr, skip=skipids)
            if adopted:
                _tm.inc("fleet.health.adopted", adopted)
            _fr.record("fleet.adopt", from_replica=rid,
                       to_replica=adopter, replayed=adopted,
                       skipped=len(skipids))
        # the victim's tuned-config overlays ride along with the
        # journal: the fingerprints rehome to survivors, and a
        # survivor rebuilding one must rebuild it TUNED
        self._handoff_tuned(rid, surv)
        wall_ms = round((time.monotonic() - t0) * 1e3, 3)
        _fr.record("fleet.failover", replica=rid, event=event,
                   survivors=len(surv), queued=len(queued),
                   inflight=len(inflight), rehomed=rehomed,
                   adopter=adopter, adopted=adopted,
                   wall_ms=wall_ms,
                   error=None if err is None else str(err)[:120])
        _spans.mark("fleet.failover", args={
            "replica": rid, "event": event,
            "survivors": len(surv), "requeued": len(victims),
            "rehomed": rehomed, "adopter": adopter,
            "adopted": adopted, "wall_ms": wall_ms})
        return []

    def _rescue_queue(self, rid: str) -> List[ServiceTicket]:
        """Move a draining/down replica's QUEUED tickets to healthy
        survivors. In-flight work is NOT touched: a draining replica
        finishes its slots in place (rolling restart), and a down
        one's slots were already extracted by _failover. The source
        journal rides along on journal_ref so completions settle the
        original records. Placements are NOT rehomed -- a drained
        replica keeps its homes and takes them back on restore."""
        svc = self.replicas[rid]
        now_m = time.monotonic()
        surv = [r for r in self.replicas
                if r != rid and self._healthy(r, now_m)]
        if not surv:
            return []
        survset = set(surv)
        with svc._lock:
            moved = list(svc._queue)
            svc._queue = []
            for t in moved:
                if t.request_key:
                    svc._keyed.pop(t.request_key, None)
        if not moved:
            return []
        jr = svc.journal
        per: Dict[str, List[ServiceTicket]] = {}
        for t in moved:
            if jr is not None and t.journal_id is not None:
                t.journal_ref = jr
            order = sorted(
                self.replicas,
                key=lambda r: _rendezvous_score(t.fingerprint, r),
                reverse=True)
            target = next((r for r in order if r in survset),
                          surv[0])
            per.setdefault(target, []).append(t)
        for trid, ts in per.items():
            tsvc = self.replicas[trid]
            with tsvc._lock:
                tsvc._queue[0:0] = ts
                for t in ts:
                    if t.request_key:
                        tsvc._keyed[t.request_key] = t
                _tm.set_gauge("serving.queue_depth",
                              len(tsvc._queue))
            for t in ts:
                t.replica = trid
        with self._lock:
            for trid, ts in per.items():
                for t in ts:
                    if t.request_key:
                        self._keyed[t.request_key] = trid
        _tm.inc("fleet.health.requeued", len(moved))
        _fr.record("fleet.rehome", from_replica=rid,
                   moved=len(moved),
                   targets={trid: len(ts)
                            for trid, ts in per.items()})
        return moved

    def _handoff_tuned(self, rid: str, surv: List[str]) -> int:
        """Hand the victim replica's promoted tuned-config overlays to
        the survivors its fingerprints rehome to (rendezvous order --
        the same replica the next request for that fingerprint routes
        to). Adoption installs the overlay live AND persists it in the
        adopter's own hstore, so the tuned config survives the
        adopter's restarts too. Best-effort: a replica without a tuner
        (autotune=0) exports/adopts nothing."""
        tuner = self.replicas[rid]._tuner
        if tuner is None or not surv:
            return 0
        survset = set(surv)
        handed = 0
        for fp, state in tuner.export_promoted().items():
            order = sorted(
                self.replicas,
                key=lambda r: _rendezvous_score(fp, r), reverse=True)
            target = next((r for r in order if r in survset), surv[0])
            tsvc = self.replicas[target]
            if tsvc._tuner is None:
                continue
            tsvc._tuner.adopt(fp, state)
            handed += 1
            _tm.inc("autotune.handoffs")
            _fr.record("fleet.tuned_handoff", from_replica=rid,
                       to_replica=target, fingerprint=fp[:24],
                       knob=state.get("knob"))
        return handed

    def drain_replica(self, rid: str) -> int:
        """Rolling-restart entry: stop NEW placements on `rid`, hand
        its queued tickets to survivors, let in-flight work finish in
        place (or hand off via the journal if the process is killed
        anyway -- the DOWN path covers that). The replica's promoted
        tuned-config overlays hand off with the queue, so a rehomed
        fingerprint rebuilds TUNED on its adopter. Returns the number
        of queued tickets handed off. The replica keeps serving its
        slots; wait for `replicas[rid].idle` (or fleet drain) before
        actually restarting it."""
        if rid not in self.replicas:
            raise BadParametersError(
                f"drain_replica: unknown replica {rid!r}")
        self.health.drain(rid)
        moved = len(self._rescue_queue(rid))
        now_m = time.monotonic()
        surv = [r for r in self.replicas
                if r != rid and self._healthy(r, now_m)]
        self._handoff_tuned(rid, surv)
        return moved

    def restore_replica(self, rid: str):
        """Re-enter `rid` into the rendezvous: breaker reset, error
        cleared, warm-up grace started (no COLD placements until it
        elapses; warm traffic returns at once). Rehomed fingerprints
        are NOT pulled back -- they stay with their adopter until
        natural eviction, so a restore never thunders the herd. A
        dead scheduler thread's corpse is cleared and, when the fleet
        runs background, a fresh one started."""
        if rid not in self.replicas:
            raise BadParametersError(
                f"restore_replica: unknown replica {rid!r}")
        svc = self.replicas[rid]
        th = svc._thread
        if th is not None and not th.is_alive():
            svc._thread = None
        svc._stopping = False
        self.health.restore(rid)
        if self._bg_poll is not None and svc._thread is None:
            svc.start(poll_s=self._bg_poll)
        _fr.record("fleet.restore", replica=rid,
                   background=self._bg_poll is not None)

    def health_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The monitor's per-replica breaker view plus live scheduler
        facts (cycle counter, thread aliveness, captured error, queue
        depth)."""
        snap = self.health.snapshot()
        for rid, svc in self.replicas.items():
            th = svc._thread
            snap[rid].update({
                "cycle": svc._cycle,
                "thread_alive": bool(th is not None
                                     and th.is_alive()),
                "error": None if svc._thread_error is None
                else str(svc._thread_error)[:160],
                "queue_depth": self._queue_depth(svc),
            })
        return snap

    # -- fleet observability ----------------------------------------------
    def snapshots(self) -> Dict[str, Dict[str, Any]]:
        """One metrics view per replica: the labeled histogram series
        its observations carry (replica="<id>"). Counters/gauges are
        process-wide and excluded here -- in a one-process-per-replica
        deployment each process's full snapshot() goes straight into
        merge_snapshots instead."""
        full = _tm.snapshot()
        views: Dict[str, Dict[str, Any]] = {
            rid: {} for rid in self.replicas}
        for key, val in full.items():
            if not (isinstance(val, dict) and "counts" in val):
                continue
            _name, pairs = _tm._parse_entry_key(key)
            rid = dict(pairs).get("replica")
            if rid in views:
                views[rid][key] = val
        return views

    def fleet_snapshot(self) -> Dict[str, Any]:
        """The merged fleet-wide view (metrics.merge_snapshots over
        the per-replica views): per-tenant-per-replica series side by
        side plus recomputed fleet aggregates."""
        return _tm.merge_snapshots(self.snapshots())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            routes = {rid: dict(c)
                      for rid, c in self.route_counts.items()}
            placed = len(self._placed)
        return {
            "replicas": {rid: svc.stats()
                         for rid, svc in self.replicas.items()},
            "routes": routes,
            "placed_fingerprints": placed,
        }
