"""Crash-surviving flight recorder: bounded structured event log (a
copy of amgx_tpu/telemetry/flightrec.py; the port records the fallback
hops, the setup / resetup routing and the chaos injections, and the
serving events come with the serving layer, ROADMAP.md Queue A item 11).

A crashed service leaves a data journal (serving/journal.py) that says
WHAT was in flight, but nothing that says WHY the process died — the
shed decisions, build failures, quarantines, fallback hops and chaos
injections leading up to the crash are gone with the process. The
flight recorder is that missing event history: a bounded, append-and-
rotate structured log of STATE TRANSITIONS, kept in a process-local
ring always and mirrored to disk per event when a directory is
configured (the `flightrec_dir` config knob / `AMGX_TPU_FLIGHTREC_DIR`
env), so a postmortem can read the last seconds of a dead process.

Recorded event classes (each stamped with the request trace id when
one is in scope, linking the event to the Perfetto flow chain and the
journal record of the request that caused it):

- serving: bucket builds / build failures + retries, quarantines,
  slot salvage/requeue, shed decisions WITH their feasibility
  estimate, deadline misses (serving/service.py);
- resilience: fallback-chain hops (resilience/policy.py) and armed /
  fired chaos injections (resilience/faultinject.py);
- AMG: setup routing — full build vs value/structure resetup vs
  restored-from-snapshot (amg/hierarchy.py).

Durability discipline mirrors the journal's: one `write()` of one
JSON line per event + flush (a torn final line is the crash itself),
rotation via atomic `os.replace` (the previous generation survives as
`flight.log.1`), and corruption-tolerant reads that DROP unparseable
lines (counted, `flightrec.dropped`) instead of wedging the
postmortem. On a BREAKDOWN completion the serving layer dumps the
last-N events through output.py's print callback; `tools/flightrec.py`
pretty-prints a log directory and correlates it with a solve journal.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_LOG_NAME = "flight.log"


def format_event(e: Dict[str, Any]) -> str:
    """One aligned human line per event (shared by the BREAKDOWN dump,
    tools/flightrec.py and examples/chaos_demo.py)."""
    t = e.get("t")
    clock = time.strftime("%H:%M:%S", time.localtime(t)) \
        if isinstance(t, (int, float)) else "--:--:--"
    trace = e.get("trace") or "-"
    extras = " ".join(
        f"{k}={v}" for k, v in sorted(e.items())
        if k not in ("seq", "t", "kind", "trace") and v is not None)
    return (f"[{e.get('seq', '?'):>6}] {clock} "
            f"{str(e.get('kind', '?')):<22} trace={trace} {extras}")


class FlightRecorder:
    """Bounded event recorder (see module docs). Thread-safe; the
    in-memory ring always records, the file mirror is optional."""

    def __init__(self, directory: Optional[str] = None,
                 max_events: int = 4096, rotate_events: int = 2048):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=int(max_events))
        self._seq = 0
        self.rotate_events = int(rotate_events)
        self._dir: Optional[str] = None
        self._fh = None
        self._lines = 0
        if directory:
            self.open(directory)

    # -- file backing ------------------------------------------------------
    @property
    def directory(self) -> Optional[str]:
        return self._dir

    def open(self, directory: str):
        """Attach (or switch) the disk mirror; the in-memory ring is
        kept. Appends to an existing log so a restarted process keeps
        extending the same history (sequence numbers restart per
        process; the wall-clock stamp orders across incarnations)."""
        with self._lock:
            self._close_locked()
            self._dir = str(directory)
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(self._dir, _LOG_NAME)
            self._lines = 0
            if os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        self._lines = sum(1 for _ in f)
                except OSError:
                    pass
            self._fh = open(path, "a")

    def close(self):
        with self._lock:
            self._close_locked()
            self._dir = None

    def _close_locked(self):
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _rotate_locked(self):
        """Atomic generation swap: flight.log -> flight.log.1 (the
        previous .1 is dropped), fresh flight.log. Bounds the on-disk
        history to <= 2 * rotate_events events while always keeping at
        least rotate_events of lookback."""
        path = os.path.join(self._dir, _LOG_NAME)
        self._close_locked()
        try:
            os.replace(path, path + ".1")
        except OSError:
            pass
        self._fh = open(path, "a")
        self._lines = 0

    # -- write path --------------------------------------------------------
    def record(self, kind: str, trace: Optional[str] = None,
               **fields) -> Dict[str, Any]:
        """Append one event: {'seq', 't' (epoch seconds), 'kind',
        'trace', **fields}. One line-write + flush when a directory is
        attached — the crash-surviving part; a torn final line is
        dropped (and counted) by the reader."""
        from . import metrics as _tm
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "t": time.time(),
                  "kind": str(kind), "trace": trace}
            for k, v in fields.items():
                if v is not None:
                    ev[k] = v
            self._ring.append(ev)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(ev, allow_nan=False,
                                              default=str) + "\n")
                    self._fh.flush()
                    self._lines += 1
                    if self._lines >= self.rotate_events:
                        self._rotate_locked()
                except (OSError, ValueError):
                    pass             # degraded durability, never a raise
        _tm.inc("flightrec.events")
        return ev

    # -- read path ---------------------------------------------------------
    def events(self, last: Optional[int] = None,
               kind: Optional[str] = None,
               trace: Optional[str] = None,
               since_seq: int = 0) -> List[Dict[str, Any]]:
        """This process's in-memory ring (oldest first), optionally
        filtered by kind prefix / trace id / minimum sequence."""
        with self._lock:
            evs = list(self._ring)
        if since_seq:
            evs = [e for e in evs if e.get("seq", 0) > since_seq]
        if kind is not None:
            evs = [e for e in evs
                   if str(e.get("kind", "")).startswith(kind)]
        if trace is not None:
            evs = [e for e in evs if e.get("trace") == trace]
        if last is not None:
            evs = evs[-int(last):]
        return evs

    @property
    def last_seq(self) -> int:
        return self._seq

    def reset(self):
        with self._lock:
            self._ring.clear()

    @staticmethod
    def load(directory: str) -> List[Dict[str, Any]]:
        """Read a flight-recorder directory back (rotated generation
        first, then the live log), DROPPING corrupt lines — a torn
        final write or bit-flipped record costs one event, never the
        postmortem. Drops are counted (`flightrec.dropped`)."""
        from . import metrics as _tm
        out: List[Dict[str, Any]] = []
        dropped = 0
        for name in (_LOG_NAME + ".1", _LOG_NAME):
            path = os.path.join(str(directory), name)
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                    if not isinstance(ev, dict):
                        raise ValueError("not an object")
                except ValueError:
                    dropped += 1
                    continue
                out.append(ev)
        if dropped:
            _tm.inc("flightrec.dropped", dropped)
        return out

    # -- postmortem dump ---------------------------------------------------
    def dump_recent(self, n: int = 16, reason: str = ""):
        """Print the last `n` events through output.py's callback —
        the on-BREAKDOWN postmortem trail. Silent when nothing has
        been recorded."""
        evs = self.events(last=n)
        if not evs:
            return
        from ..output import amgx_output
        head = f"flight recorder (last {len(evs)} events"
        if reason:
            head += f"; {reason}"
        amgx_output(head + "):\n")
        for e in evs:
            amgx_output("  " + format_event(e) + "\n")


# ---------------------------------------------------------------------------
# the process-wide recorder
# ---------------------------------------------------------------------------

_REC = FlightRecorder()
_ENV_CHECKED = False


def _check_env():
    """Attach the disk mirror from AMGX_TPU_FLIGHTREC_DIR on first
    use (the config-free path; SolveService also configures from the
    `flightrec_dir` knob)."""
    global _ENV_CHECKED
    if _ENV_CHECKED:
        return
    _ENV_CHECKED = True
    d = os.environ.get("AMGX_TPU_FLIGHTREC_DIR", "").strip()
    if d and _REC.directory is None:
        try:
            _REC.open(d)
        except OSError:
            pass


def configure(directory: Optional[str]):
    """Attach/detach the process recorder's disk mirror."""
    global _ENV_CHECKED
    _ENV_CHECKED = True
    if directory:
        _REC.open(directory)
    else:
        _REC.close()


def recorder() -> FlightRecorder:
    return _REC


def record(kind: str, trace: Optional[str] = None, **fields):
    _check_env()
    return _REC.record(kind, trace=trace, **fields)


def events(**kw) -> List[Dict[str, Any]]:
    return _REC.events(**kw)


def last_seq() -> int:
    return _REC.last_seq


def reset():
    _REC.reset()


def dump_recent(n: int = 16, reason: str = ""):
    _REC.dump_recent(n=n, reason=reason)


def load(directory: str) -> List[Dict[str, Any]]:
    return FlightRecorder.load(directory)
