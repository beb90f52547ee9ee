"""Telemetry (the port of amgx_tpu/telemetry/):

- `telemetry.metrics` -- the process-wide counter/gauge/histogram
  registry (the JAX package's catalog), `snapshot()` and the OpenMetrics
  text `to_openmetrics()`;
- `telemetry.spans` -- hierarchical host spans behind
  `profiling.trace_region`, exported as Chrome/Perfetto trace-event
  JSON (`spans.export_chrome_trace`); `telemetry_sync=1` fences the card
  at span boundaries;
- `telemetry.report` -- `SolveReport`, built on the host from what a
  solve already read, attached to `SolveResult.report` when the
  `telemetry` knob is on (the default), and validated against the JAX
  package's schema (`report_schema.json`);
- `telemetry.diagnostics` -- the opt-in (`diagnostics=1`) probe cycle and
  its host derivation on `SolveReport.diagnostics`;
- `telemetry.flightrec` -- the bounded, crash-surviving event log
  (fallback hops, setup routing, chaos injections).
"""
from __future__ import annotations

from . import diagnostics, flightrec, metrics, spans  # noqa: F401
from .report import SolveReport, build_report, validate_report  # noqa: F401
