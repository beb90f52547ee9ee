"""The multi-tenant solve service (the port of
amgx_tpu/serving/service.py, without the autotuner).

`SolveService` is the front end of the serving layer: a stream of
(matrix, rhs, tenant, deadline) requests goes in; batched, cached,
deadline-aware solves come out. It composes the pieces this package
provides:

- requests are bucketed by (pattern fingerprint, dtype) and served by
  `BucketEngine`s -- continuous batching: a converged slot is refilled
  at the next cycle boundary, never waiting for the whole batch;
- the engines live in a bytes-budgeted `HierarchyCache`: a repeat
  fingerprint is a cache hit and admission routes through the
  value-resetup path instead of a full AMG setup; idle LRU buckets are
  evicted past the byte budget;
- with `serving_aot_dir` set, each bucket's warm-start bundle (its
  solve-data split and CUDA libraries) round-trips through the
  `AotStore`, and with `serving_hierarchy_dir` set the hierarchy
  STRUCTURES persist too (`HierarchyStore`): a restarted service
  rebuilds each bucket via load + structure-reuse + the warm-start
  bundle -- zero full setups, zero probes (`serving.retrace`);
- with `serving_journal_dir` set every request is journaled
  (`SolveJournal`) and in-flight solve states are checkpointed every
  `serving_checkpoint_cycles` cycles: a crashed process's successor
  replays the journal and RESUMES mid-flight solves from their
  checkpoints (bit-identical iterates -- the chunked solve entry is
  resumable by construction);
- every request may carry a deadline: expiry completes the ticket
  with `DEADLINE_EXCEEDED` (its current iterate under the default
  'partial' action, the initial iterate under 'reject') at the next
  cycle boundary -- a late request can never stall its bucket;
- admission is a SHED policy, not just a bound: beyond the hard
  `serving_max_queue` cap, `serving_shed_policy=deadline` rejects
  requests whose deadline the live execution-time estimate (median
  of recent in-bucket execs scaled by queue-depth waves, 25% margin)
  says is unmeetable, and `serving_tenant_quota` bounds any one
  tenant's live footprint -- all shed completions carry status
  `OVERLOADED`;
- failures are supervised: bucket builds and device-step cycles that
  raise (or wedge -- the per-cycle progress heartbeat flatlines) are
  routed through the `serving_fault_policy` grammar (BUILD_FAILED /
  STEP_FAILED / WEDGED > retry_backoff / requeue / reject): the
  bucket is quarantined, salvageable slots finalize with their
  current iterate, the rest requeue (resuming from live state), and
  rebuilds back off exponentially up to `serving_retry_max_attempts`.

The scheduler lock is SPLIT from the device work: all hierarchy
builds, admission resetups, engine chunk-stepping and finalize reads
run OUTSIDE the service lock, so a concurrent `submit()` contends only
with bookkeeping -- never with a cycle of device work.

Drive it synchronously (`step()` / `drain()`: deterministic, what the
tests use) or start the background scheduler thread (`start()`), in
which case `submit()` is all a caller ever touches and tickets
complete asynchronously (`ticket.wait()`).

Device: the service runs on the card unless built with device="cpu"
(`resolve_device`); every bucket is built on that device, in a builder
thread too. A request's matrix and rhs may live anywhere; results
(`ticket.result.x`) are tensors on the service's device. The online
autotuner (`autotune=1`) is not ported (ROADMAP.md Queue A item 11);
`adopt_journal` and `_fail_outstanding` serve the fleet, which is not
ported yet either, and have no caller in this package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..batch.queue import pattern_fingerprint
from ..config import Config
from ..device import resolve_device
from ..errors import BadParametersError
from ..matrix import CsrMatrix
from ..resilience import faultinject as _fi
from ..resilience.status import SolveStatus
from ..solvers.base import SolveResult
from ..telemetry import flightrec as _fr
from ..telemetry import metrics as _tm
from ..telemetry import spans as _spans
from .aot import AotStore
from .cache import HierarchyCache, solve_data_bytes
from .engine import BucketEngine
from .hstore import HierarchyStore
from .journal import SolveJournal
from .ladder import choose_slots, parse_ladder


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _vector(v) -> torch.Tensor:
    """A request vector as a tensor (numpy arrays are wrapped, tensors
    kept where they live)."""
    return v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))


def _now() -> float:
    # every deadline computation reads the clock through the chaos
    # hook so clock-skew drills are deterministic (faultinject)
    return _fi.service_now()


@dataclasses.dataclass(eq=False)
class ServiceTicket:
    """One submitted request; completes with a SolveResult. Identity
    semantics (eq=False): tickets are unique live objects -- a
    field-wise __eq__ over numpy members would be both meaningless
    and ambiguous."""

    A: CsrMatrix
    b: torch.Tensor
    x0: Optional[torch.Tensor]
    tenant: str
    fingerprint: str
    submit_t: float
    deadline_t: Optional[float]          # absolute service_now() time
    result: Optional[SolveResult] = None
    complete_t: Optional[float] = None
    # process-CPU completion stamp (time.process_time at _complete):
    # on shared-core deployments the wall stamps also count neighbor
    # steal -- paired latency comparisons (bench, SLO forensics) read
    # this ruler to see only what the service itself executed
    complete_cpu_t: Optional[float] = None
    # has this request's cache routing (hit/miss) been counted yet?
    # (once per request, at its build/admission -- never per poll)
    cache_counted: bool = False
    # the bucket-build exception when this request was rejected
    # because its bucket could not be built (status BREAKDOWN)
    error: Optional[Exception] = None
    # client idempotency key (submit(request_key=...)): a retried
    # submit with the same key dedupes against the live ticket or the
    # journal instead of double-enqueueing
    request_key: Optional[str] = None
    # journal linkage + crash/quarantine resume state (a checkpointed
    # solve-state row; admission then resumes instead of initializing)
    journal_id: Optional[str] = None
    resume_state: Optional[Dict[str, np.ndarray]] = None
    # fleet failover: the journal holding this ticket's pending record
    # when that is NOT the serving replica's own (a survivor adopting a
    # dead replica's work writes checkpoints/completions back to the
    # ADOPTED journal, so its records settle instead of replaying twice)
    journal_ref: Optional[SolveJournal] = None
    admit_t: Optional[float] = None
    # request trace id (telemetry/spans.py): every lifecycle span of
    # this request is tagged with it, so the Perfetto export connects
    # them into one flow chain; persisted in the journal so a
    # crash-recovered resume keeps the ORIGINAL id
    trace_id: Optional[str] = None
    # submit wall in spans' perf_counter epoch (the retroactive
    # serving.queue span's start; service_now() is skew-hookable and
    # lives in a different epoch)
    _perf_submit: float = 0.0
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def latency_s(self) -> Optional[float]:
        if self.complete_t is None:
            return None
        return self.complete_t - self.submit_t

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def _complete(self, result: SolveResult):
        self.result = result
        self.complete_t = _now()
        self.complete_cpu_t = time.process_time()
        self._event.set()


class SolveService:
    """Async multi-tenant solve service (see module docs). One Config
    serves every bucket; knobs are the `serving_*` parameters."""

    def __init__(self, cfg: Config, scope: str = "default", device=None):
        if int(cfg.get("autotune", scope)):
            raise BadParametersError(
                "serving: autotune=1 needs the online config autotuner, "
                "which is not ported yet (ROADMAP.md Queue A item 11: the "
                "autotuner)")
        self.cfg = cfg
        self.scope = scope
        # every bucket is built here (the card unless device="cpu")
        self.device = resolve_device(device)
        self.chunk = int(cfg.get("serving_chunk_iters", scope))
        self.slots = int(cfg.get("serving_bucket_slots", scope))
        self.max_queue = int(cfg.get("serving_max_queue", scope))
        self.deadline_action = str(
            cfg.get("serving_deadline_action", scope))
        self.shed_policy = str(cfg.get("serving_shed_policy", scope))
        self.tenant_quota = int(cfg.get("serving_tenant_quota", scope))
        self.ckpt_cycles = int(
            cfg.get("serving_checkpoint_cycles", scope))
        self.supervisor_cycles = int(
            cfg.get("serving_supervisor_cycles", scope))
        self.retry_backoff_s = float(
            cfg.get("serving_retry_backoff_s", scope))
        self.retry_max = int(cfg.get("serving_retry_max_attempts",
                                     scope))
        from ..resilience.policy import parse_service_policy
        self._svc_policy = parse_service_policy(
            cfg.get("serving_fault_policy", scope))
        # mixed bucket-width ladder: () = fixed self.slots width
        self.ladder = parse_ladder(
            cfg.get("serving_bucket_ladder", scope))
        # request-path tracing + fleet observability knobs
        self.tracing = bool(int(cfg.get("serving_tracing", scope)))
        replica = str(cfg.get("serving_replica_id", scope)).strip()
        if replica:
            _tm.set_replica_label(replica)
        # per-SERVICE replica identity for in-process fleets: when
        # non-empty, this service's latency observations carry a
        # replica=<id> label so two replicas' per-tenant series stay
        # distinct in the shared registry. Assigned by the FleetRouter
        # (or explicitly on the attribute), NEVER from the knob above:
        # serving_replica_id sets the process-global scrape label,
        # which stamps samples at EXPOSITION time and stays clearable
        # via set_replica_label(None) -- baking it into stored label
        # sets would survive the clear and break that contract.
        self.replica = ""
        frdir = str(cfg.get("flightrec_dir", scope)).strip()
        if frdir:
            _fr.configure(frdir)
        aot_dir = str(cfg.get("serving_aot_dir", scope)).strip()
        self.aot: Optional[AotStore] = \
            AotStore(aot_dir) if aot_dir else None
        hier_dir = str(cfg.get("serving_hierarchy_dir", scope)).strip()
        self.hstore: Optional[HierarchyStore] = \
            HierarchyStore(hier_dir) if hier_dir else None
        jdir = str(cfg.get("serving_journal_dir", scope)).strip()
        self.journal: Optional[SolveJournal] = \
            SolveJournal(jdir) if jdir else None
        # hit/miss is counted PER REQUEST at its build/admission (in
        # step()), not via the cache's own lookup counters -- a queued
        # ticket polling a full bucket every cycle must not inflate
        # the hit rate
        self.buckets = HierarchyCache(
            budget_bytes=int(cfg.get("serving_cache_bytes", scope)),
            max_entries=int(cfg.get("serving_cache_entries", scope)),
            counters={"evict": "serving.cache.evictions",
                      "bytes": "serving.cache.bytes",
                      "entries": "serving.live_buckets"},
            can_evict=lambda eng: eng.idle)
        self._queue: List[ServiceTicket] = []
        self._lock = threading.RLock()
        # serializes whole scheduler cycles (one step() at a time);
        # NEVER held while the bookkeeping lock is wanted by submit()
        self._sched_lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        # the exception that killed the background scheduler loop (or
        # an inline step(), captured by the FleetRouter): the fleet
        # health monitor's REPLICA_DEAD signal. None while healthy.
        self._thread_error: Optional[BaseException] = None
        # async bucket builds (background-scheduler mode): fingerprint
        # -> builder thread / finished engine / failure
        self._builds: Dict[str, threading.Thread] = {}
        self._built: Dict[str, BucketEngine] = {}
        self._build_failed: Dict[str, Exception] = {}
        # service-level fault bookkeeping (serving_fault_policy):
        # fingerprint -> {"attempts", "not_before"} retry/backoff state
        self._faulted: Dict[str, Dict[str, float]] = {}
        # fingerprint -> (iters_heartbeat, stale_cycles) wedge detector
        self._progress: Dict[str, Tuple[int, int]] = {}
        self._completed_total = 0
        self._cycle = 0
        # live request_key -> ticket (idempotent submit dedupe)
        self._keyed: Dict[str, ServiceTicket] = {}
        # recent in-bucket execution times (shed estimator window)
        import collections
        self._exec_recent = collections.deque(maxlen=64)
        # ... and the same window PER FINGERPRINT: mixed-size traffic
        # must not shed the small tenant on the big tenant's median --
        # a fingerprint with its own trained window is estimated from
        # its own history, the global window is only the cold fallback
        self._exec_fp: Dict[str, Any] = {}
        # execution-device share factor for the feasibility estimate:
        # an in-process fleet (FleetRouter) runs N replicas on ONE
        # device, so each replica's observed exec window undercounts
        # wall latency by the number of co-resident replicas competing
        # for it; the router sets this to N. Standalone services (and
        # one-replica-per-host fleets) keep 1.0
        self.exec_share = 1.0
        # completed journaled tickets awaiting their record_done write
        # (flushed outside the lock each cycle)
        self._journal_doneq: List[ServiceTicket] = []
        # flight-recorder events minted under the service lock queue
        # here and flush outside it (disk write + flush per event --
        # the PR-11 lock-split discipline applies to the recorder
        # exactly as it does to the journal); a deferred BREAKDOWN
        # dump rides along (it prints through the user's output
        # callback, which must never run lock-held)
        self._fr_q: List[Tuple[str, Optional[str], Dict[str, Any]]] = []
        self._fr_dump_reason: Optional[str] = None
        # per-tenant tallies for stats()
        self._tenants: Dict[str, Dict[str, int]] = {}
        if self.journal is not None and \
                int(cfg.get("serving_recover", scope)):
            self.recover()

    # -- request-path tracing ----------------------------------------------
    # (the _raw aliases keep tools/check_spans.py honest: _tspan/_tmark
    # call sites carry the literal names the lint checks, while these
    # forwarding bodies -- generic `name` parameters like the spans
    # engine itself -- stay off its span-call surface)
    _raw_span = staticmethod(_spans.span)
    _raw_mark = staticmethod(_spans.mark)

    def _tspan(self, name: str, **args):
        """A lifecycle span tagged with request-trace args, or a
        no-op when serving_tracing=0 (the pre-tracing span set)."""
        if not self.tracing:
            return contextlib.nullcontext()
        return self._raw_span(name, annotate=False, args=args)

    def _tmark(self, name: str, **args):
        if self.tracing:
            self._raw_mark(name, args=args)

    def _fr_enqueue(self, kind: str, trace: Optional[str] = None,
                    **fields):
        """Queue a flight event minted while the service lock is held
        (callers: shed / build-failure / quarantine bookkeeping). The
        crash-survival window widens by at most one cycle -- the same
        accepted-durable-once-returned model the journal documents."""
        self._fr_q.append((kind, trace, fields))

    def _flush_flightrec(self):
        """Write queued flight events + any deferred BREAKDOWN dump.
        File IO and output-callback work -- callers must NOT hold the
        service lock."""
        with self._lock:
            q, self._fr_q = self._fr_q, []
            reason, self._fr_dump_reason = self._fr_dump_reason, None
        for kind, trace, fields in q:
            _fr.record(kind, trace=trace, **fields)
        if reason is not None:
            _fr.dump_recent(reason=reason)

    def _trace_list(self, tickets) -> Optional[List[str]]:
        """trace ids of `tickets` (None entries skipped), or None when
        tracing is off / nothing is tagged -- batched stages (step /
        checkpoint / finalize) tag the whole set they touched."""
        if not self.tracing:
            return None
        ids = [t.trace_id for t in tickets
               if t is not None and t.trace_id]
        return ids or None

    def _hlabels(self, tenant: str) -> Dict[str, str]:
        """Labels for this service's histogram observations: tenant
        always, replica only when this service has an identity (so a
        plain single service keeps its historical label shape)."""
        if self.replica:
            return {"tenant": tenant, "replica": self.replica}
        return {"tenant": tenant}

    # -- submission --------------------------------------------------------
    def _tenant(self, name: str) -> Dict[str, int]:
        return self._tenants.setdefault(
            name, {"submitted": 0, "completed": 0, "deadline_miss": 0,
                   "rejected": 0, "shed": 0})

    def submit(self, A: CsrMatrix, b, x0=None, tenant: str = "default",
               deadline_s: Optional[float] = None,
               request_key: Optional[str] = None) -> ServiceTicket:
        """Enqueue one system. `deadline_s` is a relative budget from
        now; expiry completes the ticket with DEADLINE_EXCEEDED rather
        than ever blocking the bucket. `request_key` makes the submit
        idempotent: a retry with the same key returns the live ticket
        (or a fresh ticket completed from the journaled result) instead
        of enqueueing twice. Thread-safe; issues no device work of its
        own and never waits on one -- the scheduler's device cycles run
        outside the bookkeeping lock."""
        b = _vector(b)
        if b.dim() != 1:
            raise BadParametersError(
                f"service.submit: b must be one system's rhs, got "
                f"shape {tuple(b.shape)}")
        if b.numel() != A.num_rows:
            # caller bug surfaced at the submit site, not as a
            # scheduler-cycle admission failure later
            raise BadParametersError(
                f"service.submit: rhs length {b.numel()} does not match "
                f"the matrix ({A.num_rows} unknowns)")
        if request_key:
            dedup = self._dedupe(request_key)
            if dedup is not None:
                return dedup
        now = _now()
        ticket = ServiceTicket(
            A=A, b=b, x0=None if x0 is None else _vector(x0),
            tenant=str(tenant),
            fingerprint=f"{pattern_fingerprint(A)}/{_dtype_name(b.dtype)}",
            submit_t=now,
            deadline_t=None if deadline_s is None
            else now + float(deadline_s),
            request_key=request_key or None,
            trace_id=_spans.new_trace_id() if self.tracing else None,
            _perf_submit=time.perf_counter())
        _tm.inc("serving.requests")
        # ONE lock section for dedupe-recheck + shed decision + key
        # registration + enqueue: splitting these would let concurrent
        # submits breach the queue bound / tenant quota (check-then-act)
        # or double-enqueue one request_key
        shed_early = False
        with self._tspan("serving.submit", trace=ticket.trace_id,
                         tenant=ticket.tenant), self._lock:
            if request_key:
                live = self._keyed.get(request_key)
                if live is not None:      # lost the race to a twin
                    _tm.inc("serving.dedupe")
                    return live
            self._tenant(ticket.tenant)["submitted"] += 1
            shed = self._shed_reason(ticket, deadline_s)
            if shed is not None:
                reason, est = shed
                self._shed(ticket, reason, est, deadline_s)
                shed_early = True
            else:
                if request_key:
                    self._keyed[request_key] = ticket
                self._queue.append(ticket)
                _tm.set_gauge("serving.queue_depth", len(self._queue))
        # queue-wait epoch starts where the submit span ends: the
        # retroactive serving.queue span then follows serving.submit
        # on the flow chain instead of overlapping it
        ticket._perf_submit = time.perf_counter()
        if shed_early:
            # the shed's flight event (file IO) writes off the lock
            self._flush_flightrec()
            return ticket
        # journal outside the lock (file IO must not block other
        # submitters or the scheduler). The request only counts as
        # accepted-durable once submit() RETURNS -- a crash inside this
        # window is indistinguishable from one before the submit. The
        # background scheduler may complete the ticket while we write;
        # the done-check below closes that window so the journal never
        # keeps a pending record for a finished request (which would
        # re-solve it at replay).
        if self.journal is not None:
            try:
                ticket.journal_id = self.journal.record_submit(
                    fingerprint=ticket.fingerprint, tenant=ticket.tenant,
                    A=A, b=b, x0=ticket.x0,
                    deadline_remaining_s=None if deadline_s is None
                    else float(deadline_s),
                    request_key=request_key or None,
                    trace_id=ticket.trace_id)
                if ticket.done:
                    self._journal_done(ticket, ticket.result)
            except Exception:
                # durability degraded, service continues: the request
                # is live in memory, only crash replay is lost for it
                _tm.inc("serving.recovery.journal_corrupt")
        return ticket

    def _dedupe(self, request_key: str) -> Optional[ServiceTicket]:
        """Idempotent-submit lookup: the live ticket with this key, or
        a fresh ticket completed from the journaled result of an
        already-finished request. None = genuinely new."""
        with self._lock:
            live = self._keyed.get(request_key)
        if live is not None:
            _tm.inc("serving.dedupe")
            return live
        if self.journal is None:
            return None
        rec = self.journal.lookup_key(request_key)
        if rec is None or rec.get("status") != "done":
            return None
        res = self.journal.load_result(rec["id"])
        if res is None:
            return None
        x, status_code, iterations = res
        _tm.inc("serving.dedupe")
        now = _now()
        x = torch.from_numpy(np.asarray(x))
        t = ServiceTicket(
            A=None, b=x, x0=None,
            tenant=rec.get("tenant", "default"),
            fingerprint=rec.get("fingerprint", ""), submit_t=now,
            deadline_t=None, request_key=request_key,
            # same knob gate as recover(): a serving_tracing=0
            # incarnation hands out no trace ids, journaled or not
            trace_id=rec.get("trace") if self.tracing else None)
        t._complete(SolveResult(
            x=x, iterations=int(iterations),
            converged=status_code == int(SolveStatus.CONVERGED),
            res_norm=np.asarray(np.nan), norm0=np.asarray(np.nan),
            status_code=int(status_code)))
        return t

    # -- load shedding -----------------------------------------------------
    def _shed_reason(self, t: ServiceTicket,
                     deadline_s: Optional[float]
                     ) -> Optional[Tuple[str, Optional[float]]]:
        """Admission control (lock held): None = admit, else (shed
        class, feasibility estimate): 'overload' queue bound / 'quota'
        tenant fairness / 'deadline' unmeetable-by-estimate -- the
        estimate rides along so the shed decision is auditable (the
        flight recorder logs it with the decision)."""
        if self.max_queue and len(self._queue) >= self.max_queue:
            return "overload", None
        if self.tenant_quota:
            live = sum(1 for q in self._queue if q.tenant == t.tenant)
            for key in self.buckets.keys():
                eng = self.buckets.peek(key)
                if eng is None:
                    continue
                live += sum(1 for o in eng.occupant
                            if o is not None and getattr(o, "tenant", None)
                            == t.tenant)
            if live >= self.tenant_quota:
                return "quota", None
        if self.shed_policy == "deadline" and deadline_s is not None:
            est = self._estimate_latency_s(t.fingerprint)
            if est is not None and float(deadline_s) < est:
                return "deadline", est
        return None

    def _estimate_latency_s(self, fingerprint: Optional[str] = None
                            ) -> Optional[float]:
        """Deadline-feasibility estimate: the MEDIAN of the request's
        OWN fingerprint's recent in-bucket execution times when that
        window is trained (mixed-size traffic: the small tenant's
        tight deadline is judged on the small tenant's history, not a
        global median a co-resident 256^3 tenant drags up), falling
        back to the service-wide window (a bounded deque, so one
        cold-bucket trace outlier washes out and a restarted service
        retrains within a few requests; the process-wide
        serving.exec_s histogram p50 is the fallback before the window
        fills) scaled by how many queue 'waves' are ahead (queue
        depth over slot capacity), plus a 25% safety margin so
        admitted work keeps its deadline promise. None while fully
        untrained -- an untrained estimator must never shed."""
        fpw = self._exec_fp.get(fingerprint) \
            if fingerprint is not None else None
        if fpw is not None and len(fpw) >= 3:
            window = sorted(fpw)
            est = window[len(window) // 2]
        elif len(self._exec_recent) >= 3:
            window = sorted(self._exec_recent)
            est = window[len(window) // 2]
        elif self.replica:
            # in-process fleet: train from THIS replica's labeled
            # series, not the registry-wide aggregate a co-resident
            # replica also feeds
            est = _tm.quantile_where("serving.exec_s", 0.50,
                                     {"replica": self.replica})
        else:
            est = _tm.quantile("serving.exec_s", 0.50)
        if est is None or est <= 0:
            return None
        cap = 0
        for key in self.buckets.keys():
            eng = self.buckets.peek(key)
            if eng is not None:
                cap += eng.slots
        cap = max(cap, self.slots, 1)
        return 1.25 * (1.0 + len(self._queue) / cap) * float(est) \
            * self.exec_share

    _SHED_COUNTERS = {"overload": "serving.shed.overload",
                      "quota": "serving.shed.quota",
                      "deadline": "serving.shed.deadline"}

    def _shed(self, t: ServiceTicket, reason: str,
              estimate_s: Optional[float] = None,
              deadline_s: Optional[float] = None):
        """Complete without solving: OVERLOADED + the initial iterate
        (the early honest rejection -- admitted work keeps its deadline
        promise, unserviceable work finds out immediately). The
        decision is auditable: an instant span on the request's flow
        chain and a flight-recorder event carrying the feasibility
        estimate it was made on."""
        x = t.x0 if t.x0 is not None else torch.zeros_like(t.b)
        _tm.inc("serving.rejected")
        _tm.inc(self._SHED_COUNTERS[reason])
        self._tmark("serving.shed", trace=t.trace_id, reason=reason,
                    estimate_s=estimate_s)
        self._fr_enqueue("shed", trace=t.trace_id, reason=reason,
                         tenant=t.tenant,
                         estimate_s=None if estimate_s is None
                         else round(float(estimate_s), 6),
                         deadline_s=None if deadline_s is None
                         else round(float(deadline_s), 6),
                         queue_depth=len(self._queue))
        tt = self._tenant(t.tenant)
        tt["rejected"] += 1
        tt["shed"] += 1
        self._finish(t, SolveResult(
            x=x, iterations=0, converged=False,
            res_norm=np.asarray(np.inf), norm0=np.asarray(np.inf),
            status_code=int(SolveStatus.OVERLOADED)))

    def _reject(self, t: ServiceTicket):
        """Complete without solving: the initial iterate and a
        DEADLINE_EXCEEDED status (queued expiry, or the
        reject-on-deadline action)."""
        x = t.x0 if t.x0 is not None else torch.zeros_like(t.b)
        _tm.inc("serving.rejected")
        _tm.inc("serving.deadline_miss")
        _tm.inc("serving.deadline_action.reject")
        self._fr_enqueue("deadline.miss", trace=t.trace_id,
                         tenant=t.tenant, where="queued")
        tt = self._tenant(t.tenant)
        tt["rejected"] += 1
        tt["deadline_miss"] += 1
        self._finish(t, SolveResult(
            x=x, iterations=0, converged=False,
            res_norm=np.asarray(np.inf), norm0=np.asarray(np.inf),
            status_code=int(SolveStatus.DEADLINE_EXCEEDED)))

    def _finish(self, t: ServiceTicket, result: SolveResult):
        _tm.inc("serving.completed")
        self._tenant(t.tenant)["completed"] += 1
        self._completed_total += 1
        t._complete(result)
        # the flow chain's terminal anchor: finalize/complete, tagged
        # with the trace id minted at submit (or restored from the
        # journal -- linking both incarnations' spans)
        self._tmark("serving.complete", trace=t.trace_id,
                    status=getattr(result, "status", None),
                    iterations=int(result.iterations))
        if t.request_key:
            self._keyed.pop(t.request_key, None)
        # per-tenant solve-latency distribution: recorded for EVERY
        # terminal status (a deadline miss is latency the caller saw
        # too) so the p50/p99 the scrape reports are honest
        _tm.observe("serving.solve_latency_s",
                    t.complete_t - t.submit_t,
                    labels=self._hlabels(t.tenant))
        if t.admit_t is not None:
            # the in-bucket half: what the shed estimator reads
            exec_s = t.complete_t - t.admit_t
            _tm.observe("serving.exec_s", exec_s,
                        labels=self._hlabels(t.tenant))
            self._exec_recent.append(exec_s)
            fpw = self._exec_fp.get(t.fingerprint)
            if fpw is None:
                import collections
                fpw = collections.deque(maxlen=64)
                self._exec_fp[t.fingerprint] = fpw
            fpw.append(exec_s)
        if t.journal_id is not None \
                and self._journal_for(t) is not None:
            # queued, not written: _finish runs under the service lock
            # and journal completion is file IO (the whole solution
            # vector) -- the scheduler flushes the queue outside the
            # lock at the end of the cycle (lock-split contract)
            self._journal_doneq.append(t)

    def _fail_ticket(self, t: ServiceTicket, err: Exception):
        """Complete a ticket whose bucket build or admission raised:
        BREAKDOWN status + the exception on ticket.error -- never a
        wedged queue or a scheduler-killing raise. The flight
        recorder's last-N events dump through the output callback:
        a BREAKDOWN is exactly the moment the event trail leading up
        to it is worth reading."""
        t.error = err
        _tm.inc("serving.rejected")
        self._tenant(t.tenant)["rejected"] += 1
        self._fr_enqueue("ticket.breakdown", trace=t.trace_id,
                         tenant=t.tenant, error=str(err)[:160])
        self._finish(t, SolveResult(
            x=torch.zeros_like(t.b), iterations=0, converged=False,
            res_norm=np.asarray(np.inf), norm0=np.asarray(np.inf),
            status_code=int(SolveStatus.BREAKDOWN)))
        if self._fr_dump_reason is None:   # first failure names the dump
            self._fr_dump_reason = f"BREAKDOWN: {str(err)[:80]}"

    # -- crash recovery ----------------------------------------------------
    def recover(self) -> int:
        """Replay the journal (called automatically at construction
        when `serving_recover=1` and a journal is configured): every
        pending record re-enters the queue -- resuming from its last
        checkpoint when one exists -- with its remaining deadline
        budget re-anchored to the current clock. Corrupt records are
        dropped and counted; they can never wedge the replay."""
        if self.journal is None:
            return 0
        n = 0
        for meta in self.journal.pending():
            loaded = self.journal.load_request(meta)
            if loaded is None:
                self.journal.forget(meta["id"])
                continue
            A, b, x0, state, remaining = loaded
            now = _now()
            t = ServiceTicket(
                A=A, b=_vector(b),
                x0=None if x0 is None else _vector(x0),
                tenant=meta.get("tenant", "default"),
                fingerprint=meta["fingerprint"], submit_t=now,
                deadline_t=None if remaining is None
                else now + float(remaining),
                request_key=meta.get("key"),
                # the ORIGINAL trace id, persisted at submit: this
                # incarnation's spans join the dead process's flow
                # chain instead of starting an orphan one. Gated on
                # THIS incarnation's knob: a serving_tracing=0
                # successor must keep its pre-tracing span set even
                # for requests a tracing predecessor journaled
                trace_id=(meta.get("trace") or _spans.new_trace_id())
                if self.tracing else None,
                _perf_submit=time.perf_counter())
            t.journal_id = meta["id"]
            t.resume_state = state
            _tm.inc("serving.recovery.replayed")
            self._tmark("serving.resume", trace=t.trace_id,
                        journal_id=t.journal_id,
                        checkpointed=state is not None)
            t._perf_submit = time.perf_counter()
            with self._lock:
                self._tenant(t.tenant)["submitted"] += 1
                if t.request_key:
                    self._keyed[t.request_key] = t
                self._queue.append(t)
            n += 1
        with self._lock:
            _tm.set_gauge("serving.queue_depth", len(self._queue))
        self.journal.prune()       # bound the done-record history
        return n

    def adopt_journal(self, journal: SolveJournal,
                      skip=frozenset()) -> int:
        """Cross-replica recover(): replay ANOTHER replica's journal
        into this service's queue (fleet failover -- the survivor
        adopting a dead replica's journal dir). Same machinery as
        recover(), with the failover deltas: tickets carry
        `journal_ref` pointing at the ADOPTED journal (checkpoints and
        completions settle the dead replica's records, never this
        service's), deadlines re-anchor as REMAINING budget against
        this adopter's service_now(), trace ids stay the originals,
        and `skip` excludes records whose live ticket the router
        already moved over (nothing double-solves). request_key dedupe
        guards the rest: a key already live here means the record's
        work is present, so its replay is skipped too."""
        n = 0
        for meta in journal.pending():
            if meta["id"] in skip:
                continue
            key = meta.get("key")
            if key:
                with self._lock:
                    if key in self._keyed:
                        continue
            loaded = journal.load_request(meta)
            if loaded is None:
                journal.forget(meta["id"])
                continue
            A, b, x0, state, remaining = loaded
            now = _now()
            t = ServiceTicket(
                A=A, b=_vector(b),
                x0=None if x0 is None else _vector(x0),
                tenant=meta.get("tenant", "default"),
                fingerprint=meta["fingerprint"], submit_t=now,
                deadline_t=None if remaining is None
                else now + float(remaining),
                request_key=key,
                trace_id=(meta.get("trace") or _spans.new_trace_id())
                if self.tracing else None,
                _perf_submit=time.perf_counter())
            t.journal_id = meta["id"]
            t.journal_ref = journal
            t.resume_state = state
            # (the fleet counts fleet.health.adopted where it calls this)
            _tm.inc("serving.recovery.replayed")
            self._tmark("serving.resume", trace=t.trace_id,
                        journal_id=t.journal_id,
                        checkpointed=state is not None)
            with self._lock:
                self._tenant(t.tenant)["submitted"] += 1
                if t.request_key:
                    self._keyed[t.request_key] = t
                self._queue.append(t)
            n += 1
        with self._lock:
            _tm.set_gauge("serving.queue_depth", len(self._queue))
        return n

    def _journal_for(self, t: ServiceTicket) -> Optional[SolveJournal]:
        """The journal holding this ticket's pending record: its
        adopted journal_ref when a fleet failover moved it here, else
        this service's own."""
        return t.journal_ref if t.journal_ref is not None \
            else self.journal

    def _journal_done(self, t: ServiceTicket, result: SolveResult):
        """Persist one completed ticket's journal result. File IO --
        callers must NOT hold the service lock."""
        try:
            self._journal_for(t).record_done(
                t.journal_id, result.x,
                int(result.status_code), int(result.iterations))
        except Exception:
            _tm.inc("serving.recovery.journal_corrupt")

    def _flush_journal_done(self):
        with self._lock:
            flush, self._journal_doneq = self._journal_doneq, []
        for t in flush:
            self._journal_done(t, t.result)

    def _checkpoint(self):
        """Journal the solve state of every journaled in-flight slot
        (serving_checkpoint_cycles cadence). Device pulls + file IO,
        all outside the service lock."""
        from ..profiling import trace_region
        with self._lock:
            busy = [self.buckets.peek(k) for k in self.buckets.keys()]
        ck_tickets = [
            eng.occupant[j]
            for eng in busy if eng is not None and not eng.idle
            for j in range(eng.slots)
            if eng.occupant[j] is not None
            and getattr(eng.occupant[j], "journal_id", None) is not None]
        ck_traces = self._trace_list(ck_tickets)
        with trace_region("serving.checkpoint",
                          args={"traces": ck_traces}
                          if ck_traces else None):
            for eng in busy:
                if eng is None or eng.idle:
                    continue
                slots = [j for j in range(eng.slots)
                         if eng.occupant[j] is not None
                         and getattr(eng.occupant[j], "journal_id",
                                     None) is not None]
                if not slots:
                    continue
                try:
                    rows = eng.state_rows(slots)
                except Exception:
                    continue          # device trouble: supervisor's job
                now = _now()
                for j in slots:
                    t = eng.occupant[j]
                    if t is None or t.done:
                        continue      # settled while we pulled
                    remaining = None if t.deadline_t is None \
                        else max(0.0, t.deadline_t - now)
                    try:
                        self._journal_for(t).record_checkpoint(
                            t.journal_id, rows[j], remaining)
                    except Exception:
                        _tm.inc("serving.recovery.journal_corrupt")

    # -- service-level fault policy ---------------------------------------
    def _fault_action(self, fp: str, event: str) -> str:
        """Next action for this fingerprint's failure chain (lock
        held): consults serving_fault_policy, bounded by
        serving_retry_max_attempts (beyond which: reject)."""
        fl = self._faulted.setdefault(
            fp, {"attempts": 0, "not_before": 0.0})
        n = int(fl["attempts"])
        fl["attempts"] = n + 1
        chain = self._svc_policy.get(event) or ["reject"]
        if n >= self.retry_max:
            return "reject"
        action = chain[min(n, len(chain) - 1)]
        if action == "retry_backoff":
            fl["not_before"] = _now() + \
                self.retry_backoff_s * (2.0 ** n)
        return action

    def _handle_build_failure(self, fp: str, err: Exception,
                              completed: List[ServiceTicket]):
        """Build failed (lock held): reject the fingerprint's queued
        tickets, or leave them queued behind a bounded backoff."""
        action = self._fault_action(fp, "BUILD_FAILED")
        self._fr_enqueue("bucket.build_failed", fingerprint=fp[:24],
                         action=action, error=str(err)[:160])
        if action == "reject":
            self._faulted.pop(fp, None)
            still = []
            for t in self._queue:
                if t.fingerprint == fp:
                    self._fail_ticket(t, err)
                    completed.append(t)
                else:
                    still.append(t)
            self._queue = still
        else:
            _tm.inc("serving.recovery.build_retries")
            self._fr_enqueue("bucket.build_retry", fingerprint=fp[:24],
                             attempts=int(self._faulted.get(
                                 fp, {}).get("attempts", 0)))

    def _quarantine(self, key: str, eng: BucketEngine, err, event: str,
                    completed: List[ServiceTicket]):
        """Remove a failed/wedged bucket from service (lock held):
        finalize the slots whose state already carries a terminal
        done-flag (salvageable -- their iterate is complete), requeue
        the rest with their live solve state as the resume point, and
        route the rebuild through the fault policy.

        The salvage pulls here are device work under the lock -- a
        deliberate exception to the lock split: quarantine is the rare
        failure path, and dismantling a bucket must be atomic with the
        admission bookkeeping (a concurrent submit must never observe
        a half-quarantined engine as admittable)."""
        from ..profiling import trace_region
        _tm.inc("serving.recovery.quarantined")
        self._fr_enqueue("bucket.quarantine", fingerprint=key[:24],
                         event=event, error=None if err is None
                         else str(err)[:160],
                         inflight=sum(1 for o in eng.occupant
                                      if o is not None))
        with trace_region("serving.quarantine"):
            occupied = [j for j in range(eng.slots)
                        if eng.occupant[j] is not None]
            try:
                rows = eng.state_rows(occupied)
            except Exception:
                rows = None
            salvage = [] if rows is None else \
                [j for j in occupied if bool(rows[j].get("done", False))]
            results = {}
            if salvage:
                try:
                    results = eng.finalize(salvage)
                except Exception:
                    results = {}
            requeue_tickets = []
            for j in occupied:
                t = eng.occupant[j]
                eng.occupant[j] = None
                if j in results:
                    _tm.inc("serving.recovery.salvaged")
                    self._fr_enqueue("slot.salvage", trace=t.trace_id,
                                     fingerprint=key[:24], slot=j)
                    self._finish(t, results[j])
                    completed.append(t)
                    continue
                if rows is not None:
                    t.resume_state = rows[j]
                t.admit_t = None
                _tm.inc("serving.recovery.requeued")
                self._fr_enqueue("slot.requeue", trace=t.trace_id,
                                 fingerprint=key[:24], slot=j,
                                 has_state=rows is not None)
                requeue_tickets.append(t)
            self.buckets.pop(key)
            self._progress.pop(key, None)
            error = err if err is not None else \
                RuntimeError(f"serving: bucket {event.lower()}")
            action = self._fault_action(key, event)
            if action == "reject":
                self._faulted.pop(key, None)
                for t in requeue_tickets:
                    self._fail_ticket(t, error)
                    completed.append(t)
            else:
                # front of the queue: they were in flight already
                self._queue = requeue_tickets + self._queue

    # -- scheduling --------------------------------------------------------
    def _slots_for(self, t: ServiceTicket) -> int:
        """Bucket width for the build `t` triggers: the ladder rung
        fitting the queued same-fingerprint demand at build time (the
        queue composition -- `t` itself is still queued), or the fixed
        serving_bucket_slots width when no ladder is configured."""
        if not self.ladder:
            return self.slots
        with self._lock:
            pending = sum(1 for q in self._queue
                          if q.fingerprint == t.fingerprint)
        return choose_slots(self.ladder, pending, self.slots)

    def _build_engine(self, t: ServiceTicket) -> BucketEngine:
        """One bucket build, wrapped in a serving.build span tagged
        with the TRIGGERING ticket's trace (the build serves every
        same-fingerprint ticket, but the oldest unserved one caused
        it) and logged on the flight recorder."""
        slots = self._slots_for(t)
        with self._tspan("serving.build", trace=t.trace_id,
                         fingerprint=t.fingerprint[:24], slots=slots):
            eng = BucketEngine(
                self.cfg, self.scope, t.A, slots=slots,
                chunk=self.chunk, fingerprint=t.fingerprint, aot=self.aot,
                hstore=self.hstore, device=self.device)
        _fr.record("bucket.build", trace=t.trace_id,
                   fingerprint=t.fingerprint[:24],
                   slots=eng.slots,
                   wall_s=round(eng.build_time, 4),
                   aot_warm=eng.aot_warm,
                   hier_restored=eng.hier_restored)
        return eng

    def _builder(self, t: ServiceTicket):
        """Builder-thread body: one bucket build off the scheduler
        cycle, so in-flight buckets keep advancing during the seconds
        a cold fingerprint's setup + traces take."""
        try:
            if self.device.type == "cuda":
                # the thread's current device is its own: enter the
                # service's
                with torch.cuda.device(self.device):
                    eng = self._build_engine(t)
            else:
                eng = self._build_engine(t)
        except Exception as e:            # surfaced by the next step()
            with self._lock:
                self._build_failed[t.fingerprint] = e
                self._builds.pop(t.fingerprint, None)
            return
        with self._lock:
            self._built[t.fingerprint] = eng
            self._builds.pop(t.fingerprint, None)

    def step(self) -> List[ServiceTicket]:
        """One scheduler cycle: expire, build/install missing buckets,
        admit, advance, finalize, checkpoint. Returns the tickets
        completed this cycle. ALL device work -- bucket builds,
        admission resetups, chunk stepping, finalize pulls -- runs
        outside the service lock, so a concurrent
        submit() only ever contends with bookkeeping. Cycles
        themselves are serialized (one step() at a time). Driven
        synchronously (no start()), builds run inline -- one per cycle,
        for the oldest unserved ticket -- which keeps step()
        deterministic for tests."""
        with self._sched_lock:
            return self._step_impl()

    def _step_impl(self) -> List[ServiceTicket]:
        completed: List[ServiceTicket] = []
        self._cycle += 1
        cand = None
        with self._lock:
            now = _now()
            # 1. queued expiry: a request that died waiting never
            # touches a slot
            still = []
            for t in self._queue:
                if t.deadline_t is not None and now >= t.deadline_t:
                    self._reject(t)
                    completed.append(t)
                else:
                    still.append(t)
            self._queue = still
            # 2a. install builder-thread results; route failed builds
            # through the fault policy (reject / bounded retry)
            for fp in list(self._built):
                eng = self._built.pop(fp)
                if self.buckets.peek(fp) is None:
                    self.buckets.put(fp, eng,
                                     nbytes=solve_data_bytes(eng))
                # NOTE: the fault-attempt counter is NOT reset here --
                # a successful build proves nothing about stepping (a
                # deterministically crashing bucket rebuilds fine
                # every time); only a terminal completion (settle
                # phase) clears it, so serving_retry_max_attempts
                # actually bounds STEP_FAILED/WEDGED loops too
                fl = self._faulted.get(fp)
                if fl is not None:
                    fl["not_before"] = 0.0
            if self._build_failed:
                failed = dict(self._build_failed)
                self._build_failed.clear()
                for fp, err in failed.items():
                    self._handle_build_failure(fp, err, completed)
            # 2b. pick at most ONE new build per cycle, for the OLDEST
            # unserved ticket (building every missing bucket up front
            # would serialize all setups ahead of all progress);
            # fingerprints inside a retry backoff window are skipped
            for t in self._queue:
                fp = t.fingerprint
                if self.buckets.peek(fp) is not None \
                        or fp in self._builds:
                    continue
                fl = self._faulted.get(fp)
                if fl is not None and fl["not_before"] > now:
                    continue
                cand = t
                break
            if cand is not None:
                if not cand.cache_counted:
                    _tm.inc("serving.cache.miss")
                    cand.cache_counted = True
                if self._thread is not None:
                    th = threading.Thread(
                        target=self._builder, args=(cand,),
                        daemon=True, name="amgx-serving-build")
                    self._builds[cand.fingerprint] = th
                    th.start()
                    cand = None           # admission catches up later
        # 3. synchronous-mode build: inline, outside the lock; a build
        # failure routes through the fault policy exactly like the
        # threaded path (never a raise out of step(), never an
        # unbounded retry)
        if cand is not None:
            try:
                eng = self._build_engine(cand)
            except Exception as e:
                with self._lock:
                    self._handle_build_failure(cand.fingerprint, e,
                                               completed)
                eng = None
            if eng is not None:
                with self._lock:
                    if self.buckets.peek(cand.fingerprint) is None:
                        self.buckets.put(cand.fingerprint, eng,
                                         nbytes=solve_data_bytes(eng))
                    fl = self._faulted.get(cand.fingerprint)
                    if fl is not None:      # see step 2a note
                        fl["not_before"] = 0.0
        # 4. admission DECISIONS under the lock (slot reservations --
        # strictly oldest-first across ALL buckets, the fairness
        # contract), device splices outside it
        admissions: List[Tuple[BucketEngine, int, ServiceTicket]] = []
        with self._lock:
            blocked = set()
            remaining = []
            for t in self._queue:
                if t.fingerprint in blocked:
                    remaining.append(t)
                    continue
                eng = self.buckets.get(t.fingerprint)   # LRU touch
                if eng is None:
                    # not built yet / evicted under a tiny byte budget
                    # or raced an eviction: retry next cycle
                    blocked.add(t.fingerprint)
                    remaining.append(t)
                    continue
                slot = eng.free_slot()
                if slot is None:
                    blocked.add(t.fingerprint)
                    remaining.append(t)
                    continue
                if not t.cache_counted:
                    _tm.inc("serving.cache.hit")
                    t.cache_counted = True
                t.admit_t = _now()
                _tm.observe("serving.queue_wait_s",
                            t.admit_t - t.submit_t,
                            labels=self._hlabels(t.tenant))
                if self.tracing and t.trace_id:
                    # the queue wait, recorded retroactively now that
                    # it is known -- the flow chain's submit->admit gap
                    # becomes a visible slice instead of dead air. On
                    # a synthetic per-request lane: on this scheduler
                    # thread's real track it would partially overlap
                    # the open cycle slices (same-track slices must
                    # nest in the Chrome trace format)
                    pnow = time.perf_counter()
                    _spans.record_span(
                        "serving.queue", t._perf_submit,
                        max(0.0, pnow - t._perf_submit),
                        args={"trace": t.trace_id,
                              "tenant": t.tenant},
                        tid=_spans.trace_track(t.trace_id))
                eng.occupant[slot] = t      # reservation
                admissions.append((eng, slot, t))
            self._queue = remaining
        # 5. the admission device work (value-resetup splice + state
        # init/restore) -- outside the lock
        admit_failed: List[Tuple[ServiceTicket, Exception]] = []
        for eng, slot, t in admissions:
            try:
                if t.resume_state is not None:
                    try:
                        eng.admit_resume(slot, t.A, t.b,
                                         t.resume_state, occupant=t)
                        _tm.inc("serving.recovery.resumed")
                    except BadParametersError:
                        # layout drifted (config change across the
                        # restart): restart the solve clean
                        _tm.inc("serving.recovery.restart_fresh")
                        t.resume_state = None
                        eng.admit(slot, t.A, t.b, x0=t.x0, occupant=t)
                else:
                    eng.admit(slot, t.A, t.b, x0=t.x0, occupant=t)
            except Exception as e:
                # bad request (rhs length, structure drift): complete
                # THIS ticket with the error -- an admission raise must
                # never wedge the queue or kill the scheduler
                eng.release(slot)
                admit_failed.append((t, e))
        # 6. advance every busy bucket one cycle -- the device work the
        # lock split exists for -- then the finalize pulls, all outside
        # the lock (engines are only ever touched by the scheduler)
        with self._lock:
            busy = [(k, self.buckets.peek(k))
                    for k in self.buckets.keys()]
        outcomes = []   # (key, eng, terminal, expired, results, err)
        for key, eng in busy:
            if eng is None or eng.idle:
                continue
            try:
                terminal = set(eng.step())
            except Exception as e:
                outcomes.append((key, eng, set(), [], {}, e))
                continue
            now = _now()
            expired = [
                j for j in range(eng.slots)
                if eng.occupant[j] is not None
                and j not in terminal
                and getattr(eng.occupant[j], "deadline_t", None)
                is not None
                and now >= eng.occupant[j].deadline_t]
            try:
                results = eng.finalize(sorted(terminal) + expired)
            except Exception as e:
                outcomes.append((key, eng, set(), [], {}, e))
                continue
            outcomes.append((key, eng, terminal, expired, results,
                             None))
        # 7. settle under the lock: complete tickets, wedge heartbeat,
        # quarantine, eviction, gauges
        with self._lock:
            for t, e in admit_failed:
                self._fail_ticket(t, e)
                completed.append(t)
            for key, eng, terminal, expired, results, err in outcomes:
                if err is not None:
                    self._quarantine(key, eng, err, "STEP_FAILED",
                                     completed)
                    continue
                # progress heartbeat: a busy bucket that neither
                # finished a slot nor advanced an iteration counter is
                # wedging; `supervisor_cycles` consecutive flatlines
                # quarantine it
                if self.supervisor_cycles and not terminal \
                        and not expired and not eng.idle:
                    beat = -1 if eng.iters_snapshot is None \
                        else int(np.sum(eng.iters_snapshot))
                    last, stale = self._progress.get(key, (None, 0))
                    stale = stale + 1 if beat == last else 0
                    self._progress[key] = (beat, stale)
                    if stale >= self.supervisor_cycles:
                        self._quarantine(key, eng, None, "WEDGED",
                                         completed)
                        continue
                else:
                    self._progress.pop(key, None)
                if terminal:
                    # proven healthy: the bucket ran a solve to a
                    # terminal status -- THIS clears the fault-attempt
                    # counter (not a mere successful rebuild)
                    self._faulted.pop(key, None)
                for j in sorted(terminal):
                    t = eng.occupant[j]
                    eng.release(j)
                    self._finish(t, results[j])
                    completed.append(t)
                for j in expired:
                    t = eng.occupant[j]
                    eng.release(j)
                    res = results[j]
                    _tm.inc("serving.deadline_miss")
                    self._fr_enqueue(
                        "deadline.miss", trace=t.trace_id,
                        tenant=t.tenant, where="inflight",
                        action=self.deadline_action)
                    self._tenant(t.tenant)["deadline_miss"] += 1
                    res.converged = False
                    res.status_code = int(
                        SolveStatus.DEADLINE_EXCEEDED)
                    if self.deadline_action == "reject":
                        _tm.inc("serving.deadline_action.reject")
                        res.x = torch.zeros_like(t.b) if t.x0 is None \
                            else t.x0
                    else:
                        _tm.inc("serving.deadline_action.partial")
                    self._finish(t, res)
                    completed.append(t)
                self.buckets.set_bytes(key, solve_data_bytes(eng))
            self.buckets.evict_to_budget()
            _tm.set_gauge("serving.queue_depth", len(self._queue))
            _tm.set_gauge("serving.inflight", self._inflight())
        # 8. journal completions + flight events + checkpoint cadence
        # + periodic prune (device pulls + file IO, all outside the
        # lock)
        self._flush_flightrec()
        self._flush_journal_done()
        if self.journal is not None and self.ckpt_cycles > 0 \
                and self._cycle % self.ckpt_cycles == 0:
            self._checkpoint()
        if self.journal is not None and self._cycle % 512 == 0:
            self.journal.prune()
        return completed

    def _inflight(self) -> int:
        # tolerant of concurrent eviction (called lock-free from the
        # scheduler loop's pacing check)
        engines = (self.buckets.peek(k) for k in self.buckets.keys())
        return sum(e.inflight for e in engines if e is not None)

    @property
    def idle(self) -> bool:
        with self._lock:
            return (not self._queue and self._inflight() == 0
                    and not self._builds and not self._built)

    @property
    def completed_total(self) -> int:
        """Requests completed over the service lifetime (any terminal
        status) -- the mode-independent progress counter the C API's
        drain reports deltas of."""
        return self._completed_total

    def drain(self, timeout_s: Optional[float] = None
              ) -> List[ServiceTicket]:
        """Step until every queued and in-flight request completed (or
        the timeout elapsed). Driven inline (no background thread) the
        return value lists the tickets completed during this call;
        with the background scheduler running it only WAITS and
        returns [] -- use `completed_total` deltas (or the tickets you
        hold) for counts in that mode."""
        t0 = time.monotonic()
        done: List[ServiceTicket] = []
        while not self.idle:
            if timeout_s is not None \
                    and time.monotonic() - t0 > timeout_s:
                break
            if self._thread is not None:
                if self._thread_error is not None \
                        and not self._thread.is_alive():
                    # the background scheduler died: nothing will
                    # ever step this work -- surface the captured
                    # exception on the outstanding tickets
                    # (BREAKDOWN + ticket.error) instead of
                    # spinning to timeout
                    done.extend(
                        self._fail_outstanding(self._thread_error))
                    break
                time.sleep(0.001)
            else:
                done.extend(self.step())
        return done

    def _fail_outstanding(self, err: BaseException
                          ) -> List[ServiceTicket]:
        """Complete every queued and in-flight ticket BREAKDOWN with
        `err` on ticket.error -- the dead-scheduler terminal path (a
        drain must never wait on work nothing will ever step). Slots
        are released so the service reads idle afterwards. Shared by
        the standalone drain above and the FleetRouter's no-survivor
        failover."""
        with self._lock:
            victims = list(self._queue)
            self._queue = []
            self._builds.clear()
            self._built.clear()
            self._build_failed.clear()
            engines = [self.buckets.peek(k)
                       for k in self.buckets.keys()]
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
                    victims.append(t)
        with self._lock:
            for t in victims:
                self._fail_ticket(t, err)
        self._flush_flightrec()
        self._flush_journal_done()
        return victims

    # -- background scheduler ---------------------------------------------
    def start(self, poll_s: float = 0.0005):
        """Run the scheduler on a daemon thread: submit() from any
        thread, await tickets with ticket.wait()."""
        if self._thread is not None:
            return
        self._stopping = False
        self._thread_error = None

        def loop():
            while not self._stopping:
                try:
                    if self.idle:
                        time.sleep(poll_s)
                        continue
                    done = self.step()
                    if not done and self._inflight() == 0:
                        # nothing advanced: only waiting on builder
                        # threads or a retry backoff window -- don't
                        # spin the scheduler hot
                        time.sleep(poll_s)
                except Exception as e:
                    # the scheduler thread must never die SILENTLY: a
                    # captured exception is the fleet health monitor's
                    # REPLICA_DEAD signal (and a standalone service's
                    # drain surfaces it instead of spinning forever)
                    self._thread_error = e
                    _fr.record("scheduler.died",
                               replica=self.replica or None,
                               error=str(e)[:160])
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="amgx-serving")
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stopping = True
        self._thread.join()
        self._thread = None

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "inflight": self._inflight(),
                "live_buckets": len(self.buckets),
                "cache_bytes": self.buckets.total_bytes,
                "evictions": self.buckets.evictions,
                # live latency quantiles from the process-wide
                # histograms (all tenants aggregated; per-tenant
                # series live in metrics.snapshot()/OpenMetrics)
                "solve_latency_p50_s":
                    _tm.quantile("serving.solve_latency_s", 0.50),
                "solve_latency_p99_s":
                    _tm.quantile("serving.solve_latency_s", 0.99),
                "queue_wait_p50_s":
                    _tm.quantile("serving.queue_wait_s", 0.50),
                "queue_wait_p99_s":
                    _tm.quantile("serving.queue_wait_s", 0.99),
                "exec_p99_s": _tm.quantile("serving.exec_s", 0.99),
                "journal_pending":
                    0 if self.journal is None
                    else len(self.journal.pending()),
                "quarantined_fingerprints": len(self._faulted),
                "replica": self.replica,
                "bucket_ladder": list(self.ladder),
                "tenants": {k: dict(v)
                            for k, v in self._tenants.items()},
                "autotune": {"enabled": False},
            }
