"""Hierarchical host spans with Perfetto export (a copy of
amgx_tpu/telemetry/spans.py: the same span names, records and Chrome
trace export; the fence and the profiler annotation are PyTorch's).

The reference's AMGX_timer tree (src/amgx_timer.cu) keeps parent/child
timing relationships; the port's original `profiling.py` flattened them
into a name->total dict. This module restores the tree: every
`span(name)` records a (name, start, duration, depth, parent, thread)
event into a bounded process-wide buffer, alongside the flat
(calls, total) accumulator the existing `profiling.timers()` /
`timers_total()` API keeps reading — the accounted-fraction contract
(`timers_total("amg.") / wall`) is unchanged because the amg.*
setup regions remain DISJOINT LEAF spans by construction (the span
REGISTRY below is statically linted for that by tools/check_spans.py).

Spans measure HOST wall clock. Under CUDA's asynchronous launches that
means "time until the region's Python body returned", not device
occupancy -- the honest default for orchestration spans. Set
`telemetry_sync=1` (config) or AMGX_TPU_TELEMETRY_SYNC=1 (env) to fence
device work at every span boundary (`torch.cuda.synchronize` on the
span's device; nothing on the CPU) so host spans bound device
occupancy; this drains the launch queue at every boundary, so it is a
debugging mode, not a production default.

`export_chrome_trace(path)` writes the recorded spans as Chrome
trace-event JSON ("X" complete events, microseconds), loadable by
Perfetto / chrome://tracing — the host-side timeline that sits next to
the device timeline `profiling.start_trace` captures via torch.profiler
(each span is also a `torch.profiler.record_function` range, so it
shows in a captured profile, tools/torch_profile.py's included).

REQUEST TRACING: spans (and instant `mark()` events) accept an `args`
dict; an args entry `trace=<id>` (or `traces=[ids]` for batched
stages touching several requests) tags the event with a request trace
id (`new_trace_id()`; serving mints one per ServiceTicket). The
export turns each trace id's tagged events into a Perfetto FLOW — a
connected s→t→…→f arrow chain through the tagged slices — so one
request's submit→queue→build→admit→chunk-cycles→checkpoint→finalize
path reads as a single arrow chain in the trace viewer, across
threads and (because the serving journal persists trace ids) across
service incarnations when a crash-recovered resume re-tags the
original id. `record_span()` records a span retroactively with
explicit timing (queue waits measured between submit and admission;
per-shard synthetic tracks use its `tid` override).
"""
from __future__ import annotations

import contextlib
import fnmatch
import hashlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# span-name registry
# ---------------------------------------------------------------------------

# Every span/trace_region name used in the package must match one of
# these fnmatch patterns (tools/check_spans.py enforces it statically).
# Patterns under ACCOUNTED_PREFIX are additionally checked to be
# pairwise non-nesting: the setup_accounted_fraction >= 0.9 contract
# sums them, so no amg.* span may ever double-count a child.
DECLARED_SPANS: Tuple[str, ...] = (
    # amg.* accounted setup leaves (disjoint by contract)
    "amg.l0_layout",
    "amg.host_pull",
    "amg.value_resetup",
    "amg.L*.selector",
    "amg.L*.strength",
    "amg.L*.cfsplit",
    "amg.L*.interp",
    "amg.L*.layoutP",
    "amg.L*.transposeR",
    "amg.L*.xfer_slabs",
    # classical device-parallel RS/HMIS first pass: runs INSIDE the
    # amg.L*.cfsplit leaf on the main thread, so it is declared
    # OUTSIDE the amg.* accounted prefix (summing both would
    # double-count the selector wall)
    "selector.device_sweep",
    "amg.L*.rap",
    # plan-split RAP (ops/spgemm.py): structure-phase plan build/lookup
    # and the fused value phase — disjoint siblings of amg.L*.rap (the
    # eager route's span), never nested inside it
    "amg.L*.rap_plan",
    "amg.L*.rap_values",
    "amg.L*.mf_detect",
    "amg.L*.galerkin",
    "amg.L*.layout",
    "amg.L*.smoother_setup",
    "amg.coarse_solver_setup",
    "amg.ship_resolve",
    "amg.device_sync",
    # overlapped ship worker (reports on its own thread; NOT summed
    # into the amg.* accounted fraction)
    "ship.cast_put",
    "ship.resolve_stragglers",
    # serving subsystem (amgx_tpu/serving/): the scheduler's cycle
    # phases + the AOT store round-trips
    "serving.step",
    "serving.admit",
    "serving.finalize",
    "serving.bucket_build",
    "serving.aot_export",
    "serving.aot_load",
    # serving fault tolerance: checkpoint/journal writes, restart
    # replay, hierarchy-structure persistence, bucket quarantine
    "serving.checkpoint",
    "serving.recover",
    "serving.quarantine",
    "serving.hstore_save",
    "serving.hstore_load",
    # request-path tracing (serving_tracing knob): per-ticket
    # lifecycle stages tagged with the ticket's trace id — submit
    # bookkeeping, shed decisions (instant), the retroactive queue
    # wait, the build the candidate ticket triggered, journal-replay
    # resume, and the terminal completion (instant; the flow chain's
    # last anchor)
    "serving.submit",
    "serving.shed",
    "serving.queue",
    "serving.build",
    "serving.resume",
    "serving.complete",
    # fleet router (serving/fleet.py): the per-request routing
    # decision — an instant event on the ticket's flow chain carrying
    # the serving replica id and route class (warm|cold|spill), the
    # cross-replica postmortem's attribution anchor
    "fleet.route",
    # fleet health (serving/health.py): every breaker/liveness
    # transition (SUSPECT, WEDGED, DEAD, OPEN/HALF_OPEN/CLOSED, DOWN,
    # DRAINING, RESTORED, PROBE) as an instant event — the Perfetto
    # view of an incident timeline
    "fleet.health.transition",
    # fleet failover (serving/fleet.py): one instant event per DOWN
    # path with its whole outcome (survivors, tickets requeued,
    # fingerprints rehomed, journal adopter + replay count, wall)
    "fleet.failover",
    # online config autotuner (serving/autotune.py): each shadow
    # solve as a real span (the idle-capacity cost is visible on the
    # timeline next to production work), each promote/demote/retire
    # verdict as an instant event — both tagged with the search's
    # trace id so the whole watch->shadow->promote chain reconstructs
    "autotune.shadow",
    "autotune.decision",
    # distributed comms/shard telemetry: one synthetic track per
    # shard in the Perfetto export (record_span with a per-shard tid)
    "shard.solve",
    # solver-tree entry points (dynamic solver names: CG.solve, ...).
    # NO catch-all patterns belong here: a `<anything>.*` entry would
    # let any typo'd two-segment name pass the static registry check
    # (telemetry's own engine spans live in the checker-exempt
    # spans.py and need no declaration)
    "*.setup",
    "*.resetup",
    "*.solve",
)

ACCOUNTED_PREFIX = "amg."


def is_declared(name: str) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in DECLARED_SPANS)


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_tls = threading.local()
_records: List[dict] = []
_MAX_RECORDS = 100_000      # oldest half dropped past this
_flat: Dict[str, Tuple[int, float]] = {}
_t0 = time.perf_counter()   # trace epoch (ts offsets in the export)

def env_sync() -> bool:
    """The AMGX_TPU_TELEMETRY_SYNC environment toggle (read at call
    time). The root-construction latch ORs this in, so the env var
    keeps fencing on even when configs leave telemetry_sync=0."""
    return os.environ.get("AMGX_TPU_TELEMETRY_SYNC", "0") not in (
        "", "0", "false", "False")


_sync = env_sync()


def set_sync(on: bool):
    """Enable/disable device fencing at span boundaries (the
    telemetry_sync knob)."""
    global _sync
    _sync = bool(on)


def sync_enabled() -> bool:
    return _sync


def _fence():
    """Device fence so a host span bounds device occupancy:
    `torch.cuda.synchronize` on the current CUDA device when one is
    initialized; nothing on the CPU (the span then measures the
    computation itself, which the CPU runs synchronously)."""
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize(torch.cuda.current_device())
    except Exception:
        pass


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextlib.contextmanager
def span(name: str, annotate: bool = True,
         args: Optional[Dict[str, Any]] = None):
    """Record one hierarchical span (and accumulate the flat timer).
    With annotate=True the region is also a
    torch.profiler.record_function range, so it shows up in captured
    device profiles -- the nvtxRange analog `profiling.trace_region` has
    always been.
    `args` attaches extra key/values to the exported event; a
    `trace`/`traces` entry additionally enrolls the span in that
    request's Perfetto flow chain (module docs)."""
    if _sync:
        _fence()
    stack = _stack()
    parent = stack[-1] if stack else None
    stack.append(name)
    t_start = time.perf_counter()
    ctx = contextlib.nullcontext()
    if annotate:
        try:
            import torch
            ctx = torch.profiler.record_function(name)
        except Exception:
            pass
    try:
        with ctx:
            yield
    finally:
        if _sync:
            _fence()
        t_end = time.perf_counter()
        stack.pop()
        dt = t_end - t_start
        rec = {"name": name, "ts": t_start - _t0, "dur": dt,
               "depth": len(stack), "parent": parent,
               "tid": threading.get_ident()}
        if args:
            rec["args"] = dict(args)
        _commit(rec, name, dt)


def _commit(rec: dict, name: str, dt: float):
    with _lock:
        _records.append(rec)
        if len(_records) > _MAX_RECORDS:
            del _records[: _MAX_RECORDS // 2]
        calls, tot = _flat.get(name, (0, 0.0))
        _flat[name] = (calls + 1, tot + dt)


def mark(name: str, args: Optional[Dict[str, Any]] = None):
    """Record one INSTANT event (zero-duration; exported as a Chrome
    'i' event) — lifecycle points like a shed decision or a request's
    terminal completion, where a span would be noise. Shares the span
    registry (check_spans lints mark names too) and the flow-chain
    tagging via args."""
    stack = _stack()
    rec = {"name": name, "ts": time.perf_counter() - _t0, "dur": 0.0,
           "depth": len(stack), "parent": stack[-1] if stack else None,
           "tid": threading.get_ident(), "ph": "i"}
    if args:
        rec["args"] = dict(args)
    _commit(rec, name, 0.0)


def record_span(name: str, t_start: float, dur: float,
                args: Optional[Dict[str, Any]] = None,
                tid: Optional[int] = None):
    """Record a span RETROACTIVELY with explicit timing: `t_start` in
    time.perf_counter() units, `dur` in seconds. Used for intervals
    only known after the fact (a ticket's queue wait, measured when it
    is admitted) and — via the `tid` override — for synthetic tracks
    (one Perfetto track per shard: the per-shard tallies of a
    distributed solve). Flat-timer accounting matches span()."""
    rec = {"name": name, "ts": t_start - _t0, "dur": float(dur),
           "depth": 0, "parent": None,
           "tid": int(tid) if tid is not None else threading.get_ident()}
    if args:
        rec["args"] = dict(args)
    _commit(rec, name, float(dur))


# ---------------------------------------------------------------------------
# request trace ids
# ---------------------------------------------------------------------------

_trace_seq = itertools.count(1)


def new_trace_id() -> str:
    """Mint a process-unique request trace id (pid + monotone counter
    + a coarse time suffix so ids stay distinct across process
    restarts — the successor of a crashed service mints fresh ids for
    new work while journal-replayed requests keep their ORIGINAL id,
    which is what links their spans across incarnations)."""
    return (f"{os.getpid():x}-{next(_trace_seq):x}-"
            f"{int(time.time() * 1e3) & 0xFFFFFF:x}")


def records() -> List[dict]:
    """Copy of the recorded span events (oldest first)."""
    with _lock:
        return [dict(r) for r in _records]


def flat_timers() -> Dict[str, Tuple[int, float]]:
    """The flat (calls, total_seconds) view per span name — the
    accumulator `profiling.timers()` has always returned."""
    with _lock:
        return dict(_flat)


def timers_total(prefix: str) -> float:
    """Total wall seconds under span names starting with `prefix`. The
    amg.* setup regions are maintained as DISJOINT leaf spans (enforced
    by the registry above + tools/check_spans.py) precisely so
    `timers_total("amg.") / wall` is an honest accounted fraction."""
    with _lock:
        return sum(tot for name, (_c, tot) in _flat.items()
                   if name.startswith(prefix))


def reset():
    """Drop recorded spans and flat accumulations (open spans on any
    thread keep recording into the fresh buffers when they close)."""
    with _lock:
        _records.clear()
        _flat.clear()


# ---------------------------------------------------------------------------
# Perfetto / chrome://tracing export
# ---------------------------------------------------------------------------


def _flow_id(trace: str) -> int:
    """Stable positive int flow id for a request trace id (Chrome
    flow events bind on (cat, name, id); the id must survive export
    across processes, so it is a digest, not an enumeration)."""
    return int.from_bytes(
        hashlib.blake2b(str(trace).encode(), digest_size=6).digest(),
        "big")


def trace_track(trace: str, base: int = 2_000_000) -> int:
    """Synthetic per-request track id for RETROACTIVE request-lane
    spans (the serving.queue wait): recorded on the admitting
    scheduler thread's real tid they would partially overlap its open
    cycle slices, which the Chrome trace format forbids (same-track
    slices must nest). One derived track per trace id keeps every
    request's lane self-consistent; a digest collision between two
    concurrent requests costs only a cosmetic overlap on a synthetic
    lane, never a corrupt scheduler track."""
    return base + _flow_id(str(trace)) % 1_000_000


def chrome_trace_events() -> List[dict]:
    """The recorded spans as Chrome trace-event events — 'X' complete
    slices (instant marks as 'i') with ts/dur in microseconds from the
    trace epoch, one track per host thread. Nesting is positional
    (Perfetto stacks overlapping events on a track), so parent linkage
    needs no explicit ids.

    Events whose args carry a request trace id (`trace=<id>` /
    `traces=[ids]`) additionally yield Perfetto FLOW events: per trace
    id, the tagged events sorted by start time become one s→t→…→f
    chain, each flow anchor emitted at its slice's start on the same
    pid/tid so it binds to that slice — the single connected arrow
    chain per request the serving layer's tracing promises. Flow
    anchors only bind to SLICES, so a trace-tagged instant mark (a
    shed decision, the terminal serving.complete) exports as a
    1-microsecond 'X' slice instead of an unbindable 'i' event —
    untagged marks stay true instants."""
    evs = []
    flows: Dict[str, List[Tuple[float, int, int]]] = {}
    for r in records():
        args = {"depth": r["depth"], "parent": r["parent"]}
        extra = r.get("args") or {}
        args.update(extra)
        ph = r.get("ph", "X")
        tr = extra.get("trace")
        tagged = ([tr] if tr else []) + [
            t for t in (extra.get("traces") or ()) if t]
        if ph == "i" and tagged:
            ph = "X"                 # bindable micro-slice (see docs)
        ev = {
            "name": r["name"],
            "cat": (ACCOUNTED_PREFIX.rstrip(".")
                    if r["name"].startswith(ACCOUNTED_PREFIX)
                    else r["name"].split(".", 1)[0]),
            "ph": ph,
            "ts": round(r["ts"] * 1e6, 3),
            "dur": max(round(r["dur"] * 1e6, 3),
                       1.0 if tagged else 0.0),
            "pid": os.getpid(),
            "tid": r["tid"],
            "args": args,
        }
        if ph == "i":
            ev["s"] = "t"            # thread-scoped instant
            del ev["dur"]
        evs.append(ev)
        for t in tagged:
            flows.setdefault(str(t), []).append(
                (ev["ts"], ev["pid"], ev["tid"]))
    for trace, anchors in flows.items():
        if len(anchors) < 2:
            continue                 # nothing to connect
        anchors.sort()
        fid = _flow_id(trace)
        last = len(anchors) - 1
        for i, (ts, pid, tid) in enumerate(anchors):
            fe = {
                "name": "request",
                "cat": "trace.flow",
                "ph": "s" if i == 0 else ("f" if i == last else "t"),
                "id": fid,
                "ts": ts,
                "pid": pid,
                "tid": tid,
                "args": {"trace": trace},
            }
            if fe["ph"] == "f":
                fe["bp"] = "e"       # bind to the ENCLOSING slice
            evs.append(fe)
    return evs


def export_chrome_trace(path: str) -> int:
    """Write the recorded spans as a Perfetto-loadable trace-event JSON
    file; returns the number of events written."""
    evs = chrome_trace_events()
    payload = {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "otherData": {"source": "amgx_tpu_torch.telemetry.spans"},
    }
    with span("telemetry.export", annotate=False):
        with open(path, "w") as f:
            json.dump(payload, f)
            f.write("\n")
    return len(evs)
