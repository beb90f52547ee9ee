"""Process-wide counter/gauge/histogram registry (a copy of
amgx_tpu/telemetry/metrics.py: the same catalog, the same snapshot and
OpenMetrics text, so a scrape of either package reads the same names).

Design rules (the JAX package's):

- every metric is DECLARED up front (name + kind + doc) so the registry
  doubles as the documentation of what the library measures; an
  undeclared name raises with a did-you-mean suggestion instead of
  silently forking a typo'd time series;
- counters are monotonic within a process (`inc`); gauges are
  last-value (`set_gauge`) or high-water (`max_gauge`); histograms are
  fixed-bucket-edge distributions (`observe`) with optional labels and
  bucket-interpolated quantiles (`quantile`);
- recording is a dict update under one lock -- cheap enough to stay
  unconditional (the `telemetry` config knob gates report construction
  and span fencing, not counter arithmetic);
- `snapshot()` returns a plain dict (JSON-ready) of every metric that
  has been touched, plus zeros for declared-but-untouched counters and
  empty histograms so a dump always has a stable key set;
- `to_openmetrics()` renders the whole registry as an OpenMetrics text
  exposition (`# EOF`-terminated, Prometheus-compatible).

Recording sites in the port: the setup / resetup routing
(amg/hierarchy.py), the Galerkin plan caches (ops/spgemm.py,
amg/aggregation/galerkin.py), the Krylov shell's routing (ops/spmv.py),
the fused-smoother dtype decline (ops/smooth.py), the RequestBatcher
(batch/queue.py), the fallback engine (resilience/policy.py), the
flight recorder, the memory watermarks (solvers/base.py) and the
`solver.retrace.*` counters (solvers/base.py, batch/core.py).

`solver.retrace.solve` / `solver.retrace.solve_batched` keep the JAX
package's names, but the port compiles no solve program: here each
counts the solves whose key -- (right-hand side shape, dtype, fault
injection epoch), the JAX package's jit cache key -- a solver (or a
batched solver) had not seen before, i.e. the solves at which the JAX
package would trace. Nothing is compiled or cached at those points.

Names declared for parts the port has not reached yet stay in the
catalog with no recording site; `WAITING` lists them with the ROADMAP
item that brings their site.
"""
from __future__ import annotations

import bisect
import os
import re
import threading
from typing import Dict, Optional, Tuple, Union

_lock = threading.Lock()
# fleet identity: a replica/shard label stamped on EVERY OpenMetrics
# sample so multi-replica scrapes don't collide. Sources, later wins: AMGX_REPLICA_ID env (read once,
# lazily) then the serving_replica_id config knob (SolveService
# construction calls set_replica_label)
_replica: Optional[str] = None
_replica_env_checked = False
_counters: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
# (name, sorted-label-items tuple) -> {"counts": [..], "sum": ., "count": .}
_hists: Dict[Tuple[str, tuple], dict] = {}

# name -> doc; the declaration IS the catalog
COUNTERS: Dict[str, str] = {}
GAUGES: Dict[str, str] = {}
HISTOGRAMS: Dict[str, str] = {}
HISTOGRAM_EDGES: Dict[str, tuple] = {}


def declare_counter(name: str, doc: str):
    COUNTERS[name] = doc


def declare_gauge(name: str, doc: str):
    GAUGES[name] = doc


def declare_histogram(name: str, doc: str, edges):
    """Declare a histogram with FIXED bucket upper bounds (`le`
    semantics: bucket i counts samples <= edges[i]; one implicit
    overflow bucket past the last edge). Edges are part of the
    declaration — every process observes into the same buckets, so
    snapshots merge across runs."""
    edges = tuple(float(e) for e in edges)
    if not edges or list(edges) != sorted(set(edges)):
        raise ValueError(
            f"histogram {name!r}: edges must be strictly increasing, "
            f"got {edges}")
    HISTOGRAMS[name] = doc
    HISTOGRAM_EDGES[name] = edges


def _unknown(name: str, catalog: Dict[str, str], kind: str):
    from ..errors import did_you_mean
    raise KeyError(f"undeclared telemetry {kind} {name!r}"
                   f"{did_you_mean(name, catalog)}")


def inc(name: str, n: int = 1):
    """Increment a declared counter."""
    if name not in COUNTERS:
        _unknown(name, COUNTERS, "counter")
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def set_gauge(name: str, value: Union[int, float]):
    """Set a declared gauge to its latest value."""
    if name not in GAUGES:
        _unknown(name, GAUGES, "gauge")
    with _lock:
        _gauges[name] = value


def max_gauge(name: str, value: Union[int, float]):
    """Fold a sample into a declared high-water-mark gauge."""
    if name not in GAUGES:
        _unknown(name, GAUGES, "gauge")
    with _lock:
        _gauges[name] = max(_gauges.get(name, value), value)


def _label_key(labels: Optional[Dict[str, str]]) -> tuple:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def observe(name: str, value: Union[int, float],
            labels: Optional[Dict[str, str]] = None):
    """Fold one sample into a declared histogram. `labels` splits the
    series (e.g. {"tenant": ...} for per-tenant latency); each label
    set keeps its own buckets, and quantile()/snapshot() can aggregate
    across them."""
    if name not in HISTOGRAMS:
        _unknown(name, HISTOGRAMS, "histogram")
    edges = HISTOGRAM_EDGES[name]
    v = float(value)
    idx = bisect.bisect_left(edges, v)    # first edge >= v (le bucket)
    key = (name, _label_key(labels))
    with _lock:
        h = _hists.get(key)
        if h is None:
            h = _hists[key] = {"counts": [0] * (len(edges) + 1),
                               "sum": 0.0, "count": 0}
        h["counts"][idx] += 1
        h["sum"] += v
        h["count"] += 1


def _merged_hist(name: str):
    """Aggregate one histogram's label variants (caller holds _lock)."""
    edges = HISTOGRAM_EDGES[name]
    counts = [0] * (len(edges) + 1)
    total, n = 0.0, 0
    for (nm, _lk), h in _hists.items():
        if nm != name:
            continue
        for i, c in enumerate(h["counts"]):
            counts[i] += c
        total += h["sum"]
        n += h["count"]
    return counts, total, n


def _quantile_from_counts(edges, counts, q: float) -> Optional[float]:
    """Bucket-interpolated quantile: find the bucket holding the q-th
    sample, linearly interpolate within its [lower, upper] edge span
    (lower = 0 for the first bucket; the overflow bucket reports the
    last edge — the estimate saturates at the declared range)."""
    n = sum(counts)
    if n == 0:
        return None
    target = q * n
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            if i >= len(edges):
                return float(edges[-1])
            lo = 0.0 if i == 0 else edges[i - 1]
            hi = edges[i]
            frac = (target - (cum - c)) / max(c, 1)
            return float(lo + (hi - lo) * frac)
    return float(edges[-1])


def quantile(name: str, q: float,
             labels: Optional[Dict[str, str]] = None
             ) -> Optional[float]:
    """Estimated q-quantile of a declared histogram (None = no
    samples). labels=None aggregates every label variant; a labels dict
    reads that one series."""
    if name not in HISTOGRAMS:
        _unknown(name, HISTOGRAMS, "histogram")
    edges = HISTOGRAM_EDGES[name]
    with _lock:
        if labels is None:
            counts, _tot, _n = _merged_hist(name)
        else:
            h = _hists.get((name, _label_key(labels)))
            counts = h["counts"] if h else [0] * (len(edges) + 1)
    return _quantile_from_counts(edges, counts, q)


def get(name: str) -> Union[int, float, dict]:
    """Current value (0 for a declared counter/gauge never touched; a
    histogram returns its merged-across-labels snapshot entry)."""
    if name in COUNTERS:
        with _lock:
            return _counters.get(name, 0)
    if name in GAUGES:
        with _lock:
            return _gauges.get(name, 0)
    if name in HISTOGRAMS:
        edges = HISTOGRAM_EDGES[name]
        with _lock:
            counts, total, n = _merged_hist(name)
        return _hist_snapshot_entry(name, edges, counts, total, n)
    _unknown(name, {**COUNTERS, **GAUGES, **HISTOGRAMS}, "metric")


def _hist_snapshot_entry(name, edges, counts, total, n):
    return {
        "count": n,
        "sum": total,
        "edges": list(edges),
        "counts": list(counts),
        "p50": _quantile_from_counts(edges, counts, 0.50),
        "p90": _quantile_from_counts(edges, counts, 0.90),
        "p99": _quantile_from_counts(edges, counts, 0.99),
    }


def snapshot() -> Dict[str, Union[int, float, dict]]:
    """JSON-ready dump: every declared counter (zeros included, so the
    key set is stable run to run), every gauge that has a sample, and
    every declared histogram (aggregated across labels under its bare
    name — empty ones included — plus one `name{k="v",...}` entry per
    touched label set, each with counts/sum/edges and estimated
    p50/p90/p99)."""
    with _lock:
        out: Dict[str, Union[int, float, dict]] = {
            name: _counters.get(name, 0) for name in COUNTERS}
        out.update(_gauges)
        for name in HISTOGRAMS:
            edges = HISTOGRAM_EDGES[name]
            counts, total, n = _merged_hist(name)
            out[name] = _hist_snapshot_entry(name, edges, counts,
                                             total, n)
        for (name, lk), h in _hists.items():
            if not lk:
                continue     # the unlabeled series IS the merged entry
            disp = name + "{" + ",".join(
                f'{k}="{_om_label_escape(v)}"' for k, v in lk) + "}"
            out[disp] = _hist_snapshot_entry(
                name, HISTOGRAM_EDGES[name], h["counts"], h["sum"],
                h["count"])
        return out


def quantile_where(name: str, q: float,
                   labels: Dict[str, str]) -> Optional[float]:
    """Estimated q-quantile aggregated across every label variant of
    `name` whose label set CONTAINS the given pairs (subset match,
    vs. quantile()'s exact match). This is the fleet-level read:
    ``quantile_where("serving.solve_latency_s", 0.99, {"tenant":
    "a"})`` folds tenant `a`'s series across every replica label into
    one distribution. None = no matching samples."""
    if name not in HISTOGRAMS:
        _unknown(name, HISTOGRAMS, "histogram")
    want = {(str(k), str(v)) for k, v in (labels or {}).items()}
    edges = HISTOGRAM_EDGES[name]
    counts = [0] * (len(edges) + 1)
    with _lock:
        for (nm, lk), h in _hists.items():
            if nm != name or not want.issubset(set(lk)):
                continue
            for i, c in enumerate(h["counts"]):
                counts[i] += c
    return _quantile_from_counts(edges, counts, q)


def reset():
    """Zero every counter and drop every gauge/histogram sample
    (declarations stay — a reset registry still documents its
    catalog)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()


# ---------------------------------------------------------------------------
# fleet snapshot merging (serving/fleet.py + cross-process aggregation)
# ---------------------------------------------------------------------------

_ENTRY_KEY_RE = re.compile(r'^([^{]+)\{(.*)\}$')
_LABEL_PAIR_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _label_unescape(s: str) -> str:
    return re.sub(r'\\(.)',
                  lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), s)


def _parse_entry_key(key: str) -> Tuple[str, tuple]:
    """Snapshot-entry key -> (name, ((k, v), ...)): the inverse of the
    `name{k="v",...}` rendering snapshot() uses for labeled histogram
    series; a bare name parses to (key, ())."""
    m = _ENTRY_KEY_RE.match(key)
    if not m:
        return key, ()
    pairs = tuple((k, _label_unescape(v))
                  for k, v in _LABEL_PAIR_RE.findall(m.group(2)))
    return m.group(1), pairs


def merge_snapshots(snaps: Dict[str, dict]
                    ) -> Dict[str, Union[int, float, dict]]:
    """Fleet-wide aggregate of per-replica snapshot() dumps, keyed by
    replica id: ``merge_snapshots({"r0": snap0, "r1": snap1})``.

    Scalars (counters and gauges) SUM — both are live totals that add
    across a fleet (completed requests, queue depths, cache bytes).
    Histogram entries merge bucket-wise; edges are part of the
    declaration, so a mismatch across snapshots raises instead of
    producing a silently wrong distribution, and p50/p90/p99 are
    recomputed from the merged counts (never averaged). A LABELED
    entry missing a ``replica`` label gains one from its snapshot's
    key, so two replicas' same-named per-tenant series never collide
    in the merge — the in-process analog of the `serving_replica_id`
    scrape label. For every histogram with labeled entries but no
    bare aggregate in the inputs (per-replica filtered views), the
    fleet-wide bare aggregate is synthesized from the labeled
    series."""
    scalars: Dict[str, Union[int, float]] = {}
    # (name, sorted label pairs) -> [counts, sum, count, edges]
    hists: Dict[Tuple[str, tuple], list] = {}
    bare_seen = set()

    def _fold(hk, val):
        cur = hists.get(hk)
        edges = tuple(val["edges"])
        counts = val["counts"]
        if cur is None:
            hists[hk] = [list(counts), float(val["sum"]),
                         int(val["count"]), edges]
            return
        if edges != cur[3] or len(counts) != len(cur[0]):
            raise ValueError(
                f"merge_snapshots: histogram {hk[0]!r} bucket edges "
                f"differ across snapshots — edges are part of the "
                f"declaration and must match to merge")
        for i, c in enumerate(counts):
            cur[0][i] += c
        cur[1] += float(val["sum"])
        cur[2] += int(val["count"])

    for rid, snap in snaps.items():
        for key, val in (snap or {}).items():
            if isinstance(val, dict) and "counts" in val \
                    and "edges" in val:
                name, pairs = _parse_entry_key(key)
                if not pairs:
                    bare_seen.add(name)
                elif not any(k == "replica" for k, _v in pairs):
                    pairs = pairs + (("replica", str(rid)),)
                _fold((name, tuple(sorted(pairs))), val)
            elif isinstance(val, (int, float)) \
                    and not isinstance(val, bool):
                scalars[key] = scalars.get(key, 0) + val
    # synthesize the fleet-wide bare aggregate where the inputs only
    # carried labeled series (per-replica views)
    for (name, pairs), (counts, total, n, edges) in list(hists.items()):
        if not pairs or name in bare_seen:
            continue
        _fold((name, ()), {"counts": counts, "sum": total,
                           "count": n, "edges": edges})
    out: Dict[str, Union[int, float, dict]] = dict(scalars)
    for (name, pairs), (counts, total, n, edges) in sorted(
            hists.items()):
        disp = name if not pairs else name + "{" + ",".join(
            f'{k}="{_om_label_escape(v)}"' for k, v in pairs) + "}"
        out[disp] = _hist_snapshot_entry(name, edges, counts, total, n)
    return out


# ---------------------------------------------------------------------------
# OpenMetrics text exposition
# ---------------------------------------------------------------------------


def _om_name(name: str) -> str:
    """Registry name -> OpenMetrics metric name: dots become
    underscores under an `amgx_` namespace ('serving.cache.hit' ->
    'amgx_serving_cache_hit')."""
    return "amgx_" + name.replace(".", "_").replace("-", "_")


def _om_escape(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _om_label_escape(s: str) -> str:
    """Label-value escaping: the OpenMetrics grammar additionally
    escapes double quotes inside label values — a caller-provided
    tenant id containing a quote must not break the whole scrape."""
    return _om_escape(s).replace('"', r'\"')


def _om_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def set_replica_label(replica: Optional[str]):
    """Set (or clear, with None/'') the replica label every
    OpenMetrics sample carries as `replica="..."`. Process-wide, like
    the registry itself: one serving replica = one process."""
    global _replica, _replica_env_checked
    _replica_env_checked = True
    _replica = str(replica) if replica else None


def replica_label() -> Optional[str]:
    """The active replica label (AMGX_REPLICA_ID env read lazily once;
    an explicit set_replica_label overrides either way)."""
    global _replica, _replica_env_checked
    if not _replica_env_checked:
        _replica_env_checked = True
        env = os.environ.get("AMGX_REPLICA_ID", "").strip()
        if env:
            _replica = env
    return _replica


def _om_labels(items) -> str:
    rep = replica_label()
    if rep is not None and not any(k == "replica" for k, _v in items):
        items = (("replica", rep),) + tuple(items)
    if not items:
        return ""
    return "{" + ",".join(
        f'{k}="{_om_label_escape(v)}"' for k, v in items) + "}"


def to_openmetrics() -> str:
    """The whole registry as an OpenMetrics text exposition (the
    /metrics scrape payload): HELP/TYPE metadata per family, `_total`
    samples for counters, plain samples for gauges, cumulative
    `_bucket{le=...}` + `_sum`/`_count` per histogram label set, and
    the mandatory `# EOF` terminator. Declared-but-untouched counters
    and histograms expose zeros (stable scrape shape); unsampled
    gauges are omitted (a gauge has no meaningful zero). When a
    replica label is configured (`AMGX_REPLICA_ID` env or the
    serving_replica_id knob via set_replica_label), EVERY sample
    carries `replica="..."` so multi-replica scrapes never collide."""
    lines = []
    with _lock:
        for name in sorted(COUNTERS):
            om = _om_name(name)
            lines.append(f"# HELP {om} {_om_escape(COUNTERS[name])}")
            lines.append(f"# TYPE {om} counter")
            lines.append(f"{om}_total{_om_labels(())} "
                         f"{_om_num(_counters.get(name, 0))}")
        for name in sorted(GAUGES):
            if name not in _gauges:
                continue
            om = _om_name(name)
            lines.append(f"# HELP {om} {_om_escape(GAUGES[name])}")
            lines.append(f"# TYPE {om} gauge")
            lines.append(f"{om}{_om_labels(())} {_om_num(_gauges[name])}")
        for name in sorted(HISTOGRAMS):
            om = _om_name(name)
            edges = HISTOGRAM_EDGES[name]
            lines.append(f"# HELP {om} {_om_escape(HISTOGRAMS[name])}")
            lines.append(f"# TYPE {om} histogram")
            series = sorted(
                (lk, h) for (nm, lk), h in _hists.items() if nm == name)
            if not series:
                series = [((), {"counts": [0] * (len(edges) + 1),
                                "sum": 0.0, "count": 0})]
            for lk, h in series:
                cum = 0
                for i, edge in enumerate(edges):
                    cum += h["counts"][i]
                    lab = _om_labels(lk + (("le", _om_num(edge)),))
                    lines.append(f"{om}_bucket{lab} {cum}")
                lab = _om_labels(lk + (("le", "+Inf"),))
                lines.append(f"{om}_bucket{lab} {h['count']}")
                base = _om_labels(lk)
                lines.append(f"{om}_sum{base} {_om_num(h['sum'])}")
                lines.append(f"{om}_count{base} {h['count']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

# AMG setup routing (amg/hierarchy.py): how coefficient updates reach
# the hierarchy -- a full build, a value-only resetup, a structure-reuse
# resetup, or a setup from adopted structure snapshots
declare_counter("amg.setup.full",
                "full hierarchy builds (structure re-coarsened)")
declare_counter("amg.resetup.value",
                "fused value-only resetups (structure + traces kept)")
declare_counter("amg.resetup.structure",
                "structure-reuse resetups (kept levels re-valued, "
                "deeper levels rebuilt)")
declare_counter("amg.setup.restored",
                "setups served from a persisted structure snapshot "
                "(serving/hstore.py: load + structure-reuse rebuild — "
                "the crash-recovery path that replaces a full setup)")
declare_counter("amg.selector.device_sweep",
                "RS/HMIS first passes taken by the device-parallel "
                "independent-set sweep instead of the host-serial "
                "bucket queue (selector_device_sweep routing)")

# fused-kernel routing (ops/smooth.py): a fused smoother's level whose
# dtype the smoother kernels do not take composes unfused; the port
# counts each declined call, and SolveReport's level table records the
# per-level routing and effective dtype
declare_counter("fusion.declined_dtype",
                "fused-kernel dispatches declined because the operand "
                "dtype is off the kernel whitelist (ops/pallas_spmv.py "
                "SMOOTH_DTYPES) — the config fell back to the unfused "
                "composition; see SolveReport levels[].fused_routing")

# Krylov shell fusion routing (ops/spmv.py spmv_pdot / spmv_ddot,
# ops/blas.py cg_update): the route each call of the shell took in the
# port (B6 / B7, or the unfused compose: a CSR or float64 operator, or
# an iteration an armed SpMV fault targets)
declare_counter("krylov.fused_dispatch",
                "Krylov shell dispatches routed to the single-pass "
                "Pallas kernels (SpMV+dot, CG update) at trace time")
declare_counter("krylov.fused_declined",
                "Krylov shell dispatches that fell back to the "
                "unfused-expression XLA compose (non-DIA/block "
                "operator, off-whitelist dtype, or VMEM gate) — same "
                "results, more HBM passes per iteration")

# GEO Galerkin CSR-structure cache (amg/aggregation/galerkin.py): in the
# port the GEO plan carries the coarse structure, so a GEO plan-cache
# lookup counts here and under amg.spgemm.plan_*
declare_counter("amg.geo_struct_cache.hit",
                "GEO coarse CSR-structure device-cache hits")
declare_counter("amg.geo_struct_cache.miss",
                "GEO coarse CSR-structure device-cache misses "
                "(host build + device upload paid)")

# plan-split Galerkin RAP (ops/spgemm.py, amg/aggregation/galerkin.py):
# a warm setup or resetup of a known pattern hits (no symbolic work);
# builds are the once-per-pattern structure phase
declare_counter("amg.spgemm.plan_build",
                "RAP structure-phase plan builds (once per sparsity "
                "pattern: expansion gathers + coalesce order + output "
                "CSR, host numpy)")
declare_counter("amg.spgemm.plan_hit",
                "RAP plan-cache hits (warm setup / resetup of a known "
                "pattern: value phase only, zero symbolic work)")

# RequestBatcher (batch/queue.py)
declare_counter("batch.requests", "solve requests submitted")
declare_counter("batch.dispatches", "batched dispatches issued")
declare_counter("batch.bucket_evictions",
                "pattern buckets evicted from the RequestBatcher's "
                "bounded solver store (count or bytes budget exceeded)")
declare_counter("batch.padded_systems",
                "pad-waste systems dispatched (ladder rung minus real "
                "requests, summed over dispatches)")
declare_gauge("batch.bucket_occupancy",
              "real/padded ratio of the last dispatch (1.0 = no waste)")
declare_gauge("batch.live_buckets",
              "live pattern buckets (each holds a hierarchy + compiled "
              "programs)")

# resilience fallback engine (resilience/policy.py)
declare_counter("resilience.fallback_attempts",
                "total fallback-chain steps executed")
declare_counter("resilience.fallback.retry", "plain retry actions run")
declare_counter("resilience.fallback.rescale_retry",
                "rescale_retry actions run")
declare_counter("resilience.fallback.switch_solver",
                "switch_solver actions run")
declare_counter("resilience.fallback.escalate_sweeps",
                "escalate_sweeps actions run")
declare_counter("resilience.config_fallback",
                "known-fault configurations rerouted at validation "
                "time (e.g. MULTICOLOR_DILU at >96^3 rows on a TPU "
                "-> the documented JACOBI_L1 fallback) instead of "
                "failing at solve time")

# jit retraces per solver entry point in the JAX package; in the port,
# the solves at which it would trace (module docs)
declare_counter("solver.retrace.solve",
                "single-solve jit cache misses (Solver.solve)")
declare_counter("solver.retrace.solve_batched",
                "batched-solve jit cache misses "
                "(BatchedSolver.solve_many)")
declare_counter("solver.retrace.distributed",
                "distributed-solve shard_map rebuilds "
                "(DistributedSolver.solve)")

# serving subsystem (serving/): continuous batching, hierarchy cache
# routing, warm starts and per-tenant deadlines all report here
declare_counter("serving.requests",
                "solve requests submitted to the service")
declare_counter("serving.completed",
                "requests completed (any terminal status)")
declare_counter("serving.rejected",
                "requests rejected without solving (admission control "
                "queue bound, or reject-on-deadline action)")
declare_counter("serving.deadline_miss",
                "requests whose deadline expired before convergence "
                "(completed with DEADLINE_EXCEEDED, queued or in-flight)")
declare_counter("serving.cache.hit",
                "hierarchy-cache hits: request fingerprint matched a "
                "live bucket, so admission routes through value-resetup "
                "instead of a full AMG setup")
declare_counter("serving.cache.miss",
                "hierarchy-cache misses (full setup paid to build a "
                "new bucket)")
declare_counter("serving.cache.evictions",
                "idle buckets evicted to fit the cache byte budget")
declare_counter("serving.retrace",
                "serving-engine python traces (init/step/finish); zero "
                "in steady state and zero from the first request when "
                "the AOT store warmed the bucket")
declare_counter("serving.aot.export",
                "bucket executables exported + persisted via jax.export")
declare_counter("serving.aot.load",
                "bucket executables loaded from the AOT store (trace "
                "latency skipped)")
declare_counter("serving.aot.error",
                "AOT export/load failures degraded to plain tracing")
declare_counter("serving.deadline_action.partial",
                "expired in-flight requests completed with their "
                "current iterate")
declare_counter("serving.deadline_action.reject",
                "expired requests completed with the zero/initial "
                "iterate (reject action)")
# serving latency distributions (serving/service.py): fixed log-spaced
# bucket edges covering sub-ms admission waits through multi-minute
# cold-setup outliers; labeled by tenant so per-tenant p50/p99 are live
# service state (service.stats(), the OpenMetrics scrape) rather than
# bench-only aggregates
_LATENCY_EDGES_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                    120.0)
declare_histogram("serving.solve_latency_s",
                  "submit-to-complete latency per request (seconds), "
                  "labeled tenant=<id>; every terminal status counts "
                  "(a deadline miss is latency the caller saw too)",
                  _LATENCY_EDGES_S)
declare_histogram("serving.queue_wait_s",
                  "submit-to-slot-admission wait per request "
                  "(seconds), labeled tenant=<id>; the queueing half "
                  "of solve latency — what admission control and "
                  "bucket sizing tune",
                  _LATENCY_EDGES_S)
declare_gauge("serving.queue_depth",
              "requests waiting for a bucket slot")
declare_gauge("serving.inflight",
              "requests currently occupying bucket slots")
declare_gauge("serving.live_buckets",
              "live serving buckets (each: hierarchy + engine traces)")
declare_gauge("serving.cache.bytes",
              "estimated device bytes held by live serving buckets")

# serving fault tolerance (serving/{journal,hstore}.py + the
# service-level recovery/shed machinery in serving/service.py)
declare_counter("serving.recovery.checkpoints",
                "in-flight solve states journaled at cycle boundaries "
                "(serving_checkpoint_cycles cadence)")
declare_counter("serving.recovery.replayed",
                "journaled requests re-admitted by a restarted service")
declare_counter("serving.recovery.resumed",
                "replayed requests that resumed from a checkpointed "
                "iterate instead of iteration 0")
declare_counter("serving.recovery.restart_fresh",
                "replayed requests whose checkpoint was unusable "
                "(missing/corrupt/layout drift) and restarted clean")
declare_counter("serving.recovery.journal_corrupt",
                "journal records dropped as corrupt during recovery "
                "(torn writes; the rest of the journal still replays)")
declare_counter("serving.recovery.quarantined",
                "buckets quarantined by the supervisor (device-step "
                "exception or flatlined progress heartbeat)")
declare_counter("serving.recovery.salvaged",
                "slots of a quarantined bucket finalized with their "
                "current terminal iterate")
declare_counter("serving.recovery.requeued",
                "slots of a quarantined bucket requeued for a rebuilt "
                "bucket (resuming from their live/checkpointed state)")
declare_counter("serving.recovery.build_retries",
                "bucket builds retried under the serving_fault_policy "
                "backoff chain")
declare_counter("serving.recovery.hstore_save",
                "hierarchy structure snapshots persisted")
declare_counter("serving.recovery.hstore_load",
                "hierarchy structure snapshots restored (the restart "
                "setup became a structure-reuse rebuild)")
declare_counter("serving.recovery.hstore_skip",
                "hierarchy snapshots skipped (a level class without "
                "persistence support)")
declare_counter("serving.recovery.hstore_error",
                "hierarchy store save/load failures degraded to a "
                "full setup")
declare_counter("serving.dedupe",
                "submits deduplicated against a live ticket or the "
                "journal via the client request key")
declare_counter("serving.shed.overload",
                "requests shed OVERLOADED at the admission queue bound")
declare_counter("serving.shed.deadline",
                "requests shed OVERLOADED because the live latency "
                "estimate said the deadline was unmeetable")
declare_counter("serving.shed.quota",
                "requests shed OVERLOADED by the per-tenant fairness "
                "quota")
declare_histogram("serving.exec_s",
                  "slot-admission-to-complete execution time per "
                  "request (seconds), labeled tenant=<id>; the "
                  "in-bucket half of solve latency — what the shed "
                  "policy's deadline-feasibility estimate reads",
                  _LATENCY_EDGES_S)
declare_gauge("serving.bucket_width",
              "slot width of the most recently built serving bucket — "
              "the mixed-width ladder's live choice "
              "(serving_bucket_ladder; fixed-width services report "
              "serving_bucket_slots)")

# fleet router (serving/fleet.py): fingerprint-affine routing over N
# SolveService replicas — every routing decision lands in exactly one
# of the three route classes
declare_counter("fleet.route.warm",
                "requests routed to their fingerprint's home replica "
                "(rendezvous-hash affinity): warm hierarchy cache, "
                "hstore and AOT paths")
declare_counter("fleet.route.cold",
                "first-seen fingerprints placed on the least-loaded "
                "replica (live queue depth x recent exec estimate), "
                "becoming its home")
declare_counter("fleet.route.spill",
                "requests diverted off an overloaded, "
                "quarantine-looping or deadline-infeasible home "
                "replica to the next rendezvous candidate (each spill "
                "writes a fleet.handoff flight-recorder note)")
declare_counter("fleet.shed.infeasible",
                "submits whose deadline the FLEET-WIDE feasibility "
                "aggregate (per-replica estimates + merged per-tenant "
                "latency) judged unmeetable on every replica — routed "
                "home anyway so the replica's shed policy completes "
                "them honestly OVERLOADED")
declare_gauge("fleet.replicas",
              "replicas fronted by the live FleetRouter")

# fleet health + failover (serving/health.py + fleet.py): the
# breaker/liveness layer's literal transition counters — one per
# detector/transition so a scrape alone reconstructs the incident
declare_counter("fleet.health.suspect",
                "busy replicas whose scheduler-cycle counter first "
                "flatlined across a heartbeat window (the wedge "
                "detector's first strike)")
declare_counter("fleet.health.wedged",
                "REPLICA_WEDGED events: a busy replica's cycle "
                "counter flatlined fleet_suspect_checks consecutive "
                "heartbeat windows")
declare_counter("fleet.health.slow",
                "REPLICA_SLOW events: per-cycle wall between health "
                "checks exceeded fleet_slow_cycle_s")
declare_counter("fleet.health.dead",
                "REPLICA_DEAD detections: a captured scheduler "
                "exception, or a started thread no longer alive "
                "without stop()")
declare_counter("fleet.health.down",
                "replicas marked DOWN (failover ran; only "
                "restore_replica resets)")
declare_counter("fleet.health.breaker_open",
                "breaker OPEN transitions (probe_backoff policy "
                "action: no traffic until the bounded backoff "
                "elapses)")
declare_counter("fleet.health.breaker_half_open",
                "breaker HALF_OPEN transitions (backoff elapsed: one "
                "trial fingerprint may probe)")
declare_counter("fleet.health.breaker_closed",
                "breakers closed by a successful probe (a completion "
                "since the probe began)")
declare_counter("fleet.health.probe_trials",
                "HALF_OPEN probe admissions (exactly one fingerprint "
                "per probe window)")
declare_counter("fleet.health.rehomed",
                "fingerprint placements moved off a DOWN replica "
                "along rendezvous order during failover")
declare_counter("fleet.health.requeued",
                "tickets (queued + in-flight) moved off a down or "
                "draining replica into survivor queues")
declare_counter("fleet.health.adopted",
                "pending journal records a survivor replayed from a "
                "dead replica's adopted journal (cross-replica "
                "recover)")
declare_counter("fleet.health.drains",
                "administrative drain_replica calls (rolling "
                "restarts)")
declare_counter("fleet.health.restores",
                "restore_replica calls re-entering a replica into "
                "the rendezvous")
declare_gauge("fleet.health.available",
              "replicas currently able to take traffic (not down, "
              "not draining, breaker not OPEN)")

# online config autotuner (serving/autotune.py, autotune=1): the
# watch -> generate -> shadow -> promote/demote lifecycle, each
# transition counted where it happens — with autotune=0 every series
# below stays at zero (the bitwise-inert contract's observable half)
declare_counter("autotune.hot",
                "fingerprints crossing both hot thresholds "
                "(autotune_hot_requests AND autotune_hot_exec_share) "
                "— searches opened")
declare_counter("autotune.candidates",
                "candidate configs generated from shadow-baseline "
                "diagnostics (suggest_config_deltas output, summed "
                "over searches)")
declare_counter("autotune.shadow.runs",
                "completed shadow solves (baseline probes + "
                "candidates), run only on idle capacity")
declare_counter("autotune.shadow.errors",
                "shadow solves that raised (absorbed: counted, backed "
                "off, never a failed ticket)")
declare_counter("autotune.promotions",
                "candidate configs promoted to a fingerprint's "
                "serving overlay (won iterations AND wall past the "
                "autotune_min_improvement gate)")
declare_counter("autotune.demotions",
                "promoted overlays dropped by the live regression "
                "watch (post-promotion exec median regressed past "
                "autotune_demote_factor)")
declare_counter("autotune.overlay.applied",
                "bucket builds that applied a tuned-config overlay "
                "(promoted or restored fingerprints)")
declare_counter("autotune.overlay.restored",
                "tuned-config overlays restored from the hstore's "
                "persisted record (restart durability: resolved "
                "before the fingerprint's first build)")
declare_counter("autotune.handoffs",
                "promoted overlays handed to a survivor replica "
                "during fleet drain/failover (adopted live + "
                "persisted in the adopter's hstore)")
declare_gauge("autotune.tuned_fingerprints",
              "fingerprints currently serving a promoted tuned-config "
              "overlay")
declare_histogram("autotune.shadow_wall_s",
                  "wall seconds per shadow solve (setup + cold + "
                  "measured warm pass — the idle-capacity cost of "
                  "the search)", edges=_LATENCY_EDGES_S)

# distributed comms/shard telemetry (distributed/comms.py records at
# TRACE time — collectives are emitted by the traced program, so the
# honest countable event is the traced exchange SITE; bytes are the
# MODELED per-direction window sizes of that site, exact by
# construction from the partition metadata, not measured wire traffic)
declare_counter("dist.exchange.calls",
                "halo/edge exchange sites traced (all modes; one per "
                "exchange site per traced program, NOT per executed "
                "iteration)")
declare_counter("dist.exchange.ring",
                "ring-mode halo exchange sites traced (two ppermutes "
                "per site)")
declare_counter("dist.exchange.a2a",
                "all-to-all-mode halo exchange sites traced")
declare_counter("dist.exchange.gather",
                "all-gather-mode halo exchange sites traced (the "
                "dense-boundary fallback)")
declare_counter("dist.exchange.edge_fused",
                "packed edge-window exchange sites traced by the "
                "halo-folded fused path (distributed/fused.py: one "
                "collective per fused smoother call)")
declare_counter("dist.comms.bytes_fwd",
                "modeled bytes shipped FORWARD (toward rank+1) per "
                "traced exchange site, summed over the whole mesh "
                "(per-hop window elements x itemsize x sending ranks)")
declare_counter("dist.comms.bytes_bwd",
                "modeled bytes shipped BACKWARD (toward rank-1) per "
                "traced exchange site, summed over the whole mesh")
declare_gauge("dist.shard.rows_imbalance",
              "per-shard row imbalance of the live partition "
              "(max rows over mean rows; 1.0 = perfectly balanced)")
declare_gauge("dist.shard.nnz_imbalance",
              "per-shard nonzero imbalance of the live partition "
              "(max nnz over mean nnz) — the load-balance number the "
              "per-chip-throughput gate attribution needs")

# flight recorder (telemetry/flightrec.py)
declare_counter("flightrec.events",
                "flight-recorder events recorded (state transitions: "
                "builds, quarantines, sheds, fallback hops, resetup "
                "routing, chaos injections)")
declare_counter("flightrec.dropped",
                "corrupt flight-recorder lines dropped at read "
                "(torn-write tolerance; the postmortem never wedges)")

# device-memory watermarks per phase (memory_info.py: the CUDA caching
# allocator's own peak, so transient in-phase maxima -- Galerkin
# temporaries freed before the boundary -- are captured; read without a
# device synchronization; zero on the CPU)
declare_gauge("memory.setup_peak_bytes",
              "device-allocator high-water mark (bytes) sampled at "
              "setup/resetup completion")
declare_gauge("memory.solve_peak_bytes",
              "device-allocator high-water mark (bytes) sampled at "
              "solve completion")


# declared names whose recording site comes with a later part of the
# port (fnmatch patterns -> where it comes from); tests hold every other
# declared name to a site in the package
WAITING: Dict[str, str] = {
    "dist.*": "ROADMAP.md Queue A item 13 (distributed solves)",
    "solver.retrace.distributed":
        "ROADMAP.md Queue A item 13 (distributed solves)",
    "resilience.config_fallback":
        "none: the JAX package's MULTICOLOR_DILU reroute guards a TPU "
        "runtime fault; the card runs MULTICOLOR_DILU at every size",
}


def waiting(name: str) -> Optional[str]:
    """Why a declared name has no recording site yet, or None."""
    import fnmatch
    for pat, why in WAITING.items():
        if fnmatch.fnmatchcase(name, pat):
            return why
    return None
