"""Tracing / profiling (the port of amgx_tpu/profiling.py).

Named trace regions that show up in a captured device profile, plus
wall-clock accumulation for setup/solve stage breakdowns (the
reference's AMGX_timer tree). The recording engine is
`telemetry/spans.py`: every region is a node in a parent/child span
tree (exportable as Chrome/Perfetto trace-event JSON via
`telemetry.spans.export_chrome_trace`), and this module is the thin API
over it:

- `trace_region(name)`: context manager that records a hierarchical
  span, accumulates host wall-clock per name and marks the region as a
  `torch.profiler.record_function` range (visible in a profile that
  tools/torch_profile.py or `start_trace` captures).
- `start_trace(logdir)` / `stop_trace()`: capture a device profile of
  the enclosed region with torch.profiler (CPU and, where present, CUDA
  activity) and write it as Chrome trace JSON under `logdir`.
- `timers()` / `reset_timers()`: the accumulated (calls, seconds) per
  region.

Regions measure the host-observed span; under CUDA's asynchronous
launches that is "time until the region's Python body returned", not
device occupancy -- use start_trace for device timelines, or set
`telemetry_sync=1` to fence device work at span boundaries.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

from .telemetry import spans as _spans

_profiler = None
_logdir = None

# the recording engine: hierarchical span + flat accumulator + optional
# device fencing (telemetry/spans.py)
trace_region = _spans.span


def annotate(name: str):
    """Decorator form of trace_region."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with trace_region(name):
                return fn(*a, **k)
        return wrapper
    return deco


def start_trace(logdir: str):
    """Begin a device profile capture (torch.profiler); `stop_trace`
    writes it to `logdir`/trace.json."""
    global _profiler, _logdir
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=acts)
    _profiler.__enter__()
    _logdir = logdir


def stop_trace():
    """End the capture `start_trace` began; returns the trace file's
    path (None when no capture was running)."""
    global _profiler, _logdir
    if _profiler is None:
        return None
    prof, logdir = _profiler, _logdir
    _profiler = _logdir = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def timers() -> Dict[str, Tuple[int, float]]:
    return _spans.flat_timers()


def reset_timers():
    _spans.reset()


def timers_total(prefix: str) -> float:
    """Total wall seconds accumulated under regions starting with
    `prefix` (the amg.* setup regions are disjoint leaf spans, so
    `timers_total("amg.") / wall` is an accounted fraction)."""
    return _spans.timers_total(prefix)


def format_timers() -> str:
    """AMGX_timer-style report: regions sorted by total time, aligned
    columns, calls / mean / share-of-recorded columns."""
    rows = sorted(timers().items(), key=lambda kv: -kv[1][1])
    if not rows:
        return "no trace regions recorded\n"
    grand = sum(tot for _, (_c, tot) in rows) or 1e-30
    w = max(len("region"), max(len(k) for k, _ in rows))
    header = (f"{'region':<{w}}  {'calls':>6}  {'total_s':>9}  "
              f"{'mean_ms':>9}  {'share':>6}")
    out = [header, "-" * len(header)]
    for name, (calls, tot) in rows:
        out.append(f"{name:<{w}}  {calls:6d}  {tot:9.3f}  "
                   f"{tot / calls * 1e3:9.3f}  {tot / grand:6.1%}")
    return "\n".join(out) + "\n"
