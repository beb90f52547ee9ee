"""Structured solve reports (the port of amgx_tpu/telemetry/report.py).

`SolveReport` is everything a solve already measured -- per-iteration
residual norms, the final `SolveStatus`, per-level kernel routing, wall
times -- assembled on the HOST from values the solve loop already read
(the monitored norms) plus static hierarchy metadata. Building a report
adds no device->host transfer and launches nothing.

The report keeps the JAX package's schema (`report_schema.json`, a copy
of amgx_tpu/telemetry/report_schema.json). The columns both packages
define by meaning -- rows, nnz, layout, dtype, cycle, hierarchy,
residuals, status, diagnostics -- mean the same; the routing columns
describe the PORT's kernels:

- `fused_smoother` / `fused_transfers`: the level's smoother has the
  fused kernels / the level carries transfer tables;
- `fused_routing`: "fused" when the smoother kernels take the level's
  dtype, "declined_dtype" when a fused smoother's level is off their
  dtypes (float64), else "unfused";
- `kernels`: the kernels a cycle visit launches on the level -- B3-mf /
  B4-mf (matrix-free), B3 / B4 (slab), B3w / B4w (weighted classical
  tables), B2 (fused smoothing, composed transfers), B9 + B8 (a CSR
  level), B5 / B5-mf for the levels inside the coarse tail;
- `kernels_per_visit`: the launches of a visit where the route fixes
  them -- a tiled matrix-free level: one B3-mf launch (+ one restriction
  epilogue when the restriction does not ride the tile: SIZE_2) and one
  B4-mf launch; None elsewhere (a slab call splits by its schedule,
  `ops/tiling.py` `plan_calls`; the per-step routes launch a step each);
- `tail_entry_level`: the first level the B5 tail absorbed (None: no
  tail ran);
- `matrix_free`: the level runs from stencil coefficients (the schema's
  layout stays "dia", as the JAX package's matrix-free levels report).

Sinks: `SolveReport.emit()` routes one strict-JSON line through
output.py's print callback; `to_dict()` / `to_json()` for programmatic
consumers; `validate_report()` checks a report dict against the schema
with a dependency-free validator.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np


def _json_finite(obj):
    """Map non-finite floats to None so emitted reports are STRICT
    JSON: a NAN_DETECTED solve carries NaN residuals, and bare `NaN`
    tokens break non-Python consumers. The status/status_code fields
    still say WHY the values are null."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_finite(v) for v in obj]
    return obj


@dataclasses.dataclass
class SolveReport:
    """Machine-readable record of one solve (see module docs)."""

    solver: str                      # root solver name
    status: str                      # SolveStatus string
    status_code: int
    iterations: int
    converged: bool
    norm0: Any                       # float, or list for block norms
    res_norm: Any
    residuals: List[Any]             # per-iteration monitored norms
    #                                  (iterations+1 entries incl. initial)
    setup_time_s: float
    solve_time_s: float
    cycle: Optional[str] = None      # AMG cycle shape when an AMG member
    #                                  is in the tree
    levels: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    tail_entry_level: Optional[int] = None   # first level the B5 tail
    #                                  absorbed (None: no tail ran)
    distributed: Optional[Dict[str, Any]] = None
    counters: Optional[Dict[str, Any]] = None
    # grid statistics (AMG.grid_stats_dict(): per-level rows/nnz/layout,
    # grid + operator complexity) when an AMG hierarchy is in the tree
    hierarchy: Optional[Dict[str, Any]] = None
    # convergence diagnostics (telemetry/diagnostics.py, diagnostics=1)
    diagnostics: Optional[Dict[str, Any]] = None
    # per-precision accounting (solve_precision knob set: the cycle dtype
    # and outer/inner iteration counts; None when unset)
    precision: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        """Strict-JSON serialization: non-finite floats become null."""
        kw.setdefault("allow_nan", False)
        return json.dumps(_json_finite(self.to_dict()), **kw)

    def emit(self, include_counters: bool = False):
        """Route the report through the registered print callback as
        one strict-JSON line tagged `amgx_report`."""
        from ..output import amgx_output
        d = self.to_dict()
        if include_counters and d.get("counters") is None:
            from . import metrics
            d["counters"] = metrics.snapshot()
        amgx_output(json.dumps({"amgx_report": _json_finite(d)},
                               allow_nan=False) + "\n")


# ---------------------------------------------------------------------------
# report construction
# ---------------------------------------------------------------------------


def _amg_of(solver):
    """Walk the (possibly wrapped) solver tree to the AMG hierarchy
    owner."""
    s = getattr(solver, "solver", solver)     # a ResilientSolver's tree
    for _ in range(6):
        if s is None:
            return None
        amg = getattr(s, "amg", None)
        if amg is not None:
            return amg
        s = getattr(s, "preconditioner", None)
    return None


def _dtype_name(dt) -> Optional[str]:
    return None if dt is None else str(dt).replace("torch.", "")


def _tail_entry(amg) -> Optional[int]:
    """The first level a B5 plan was built for (`coarse_tail_cycle`'s
    cache; None: no tail ran since the hierarchy was built)."""
    entries = [key[1] for key, hit in getattr(amg, "_tail_plans",
                                              {}).items()
               if hit[1] is not None]
    return min(entries) if entries else None


def _mf_launches(level, smd, amg) -> Optional[int]:
    """Launches of a cycle visit on a matrix-free level when the tiled
    kernel takes its stencil and both schedules (`tiling.star_fits`): one
    B3-mf launch, one restriction epilogue launch unless the restriction
    rides the tile (GEO's aggregates; SIZE_2's do not), one B4-mf
    launch."""
    from ..ops import tiling
    st = smd["stencil"]
    per_sweep = int(smd["taus"].shape[0]) if "taus" in smd else 1
    steps = [per_sweep * amg._sweeps(level.level_index, pre=p)
             for p in (True, False)]
    if not (tiling.star_fits(st.shifts, st.shape, steps[0] + 1)
            and tiling.star_fits(st.shifts, st.shape, steps[1])):
        return None
    in_tile = getattr(level, "geo_axes", None) is not None
    return 2 if in_tile else 3


def _level_row(amg, level, ld) -> Dict[str, Any]:
    from ..precision import SMOOTH_DTYPES
    A = level.A
    smd = ld.get("smoother") if isinstance(ld, dict) else None
    xfer = ld.get("xfer") if isinstance(ld, dict) else None
    mf = isinstance(smd, dict) and smd.get("stencil") is not None
    cast = amg.precision_policy.cast_dtype
    dt = cast if cast is not None else A.dtype
    sm = level.smoother
    fused_sm = bool(getattr(sm, "fused_smoother", False)) and hasattr(
        sm, "smooth_restrict")
    row: Dict[str, Any] = {
        "level": level.level_index,
        "rows": int(A.num_rows),
        "nnz": int(A.values.shape[-1]),
        "layout": "dia" if A.dia_offsets is not None or mf else "csr",
        "matrix_free": mf,
        "fused_smoother": fused_sm,
        "fused_transfers": xfer is not None,
        "dtype": _dtype_name(dt),
    }
    ok = dt in SMOOTH_DTYPES
    row["fused_routing"] = ("fused" if ok else "declined_dtype") \
        if fused_sm else "unfused"
    kernels: List[str] = []
    per_visit = None
    if fused_sm and ok:
        if row["layout"] == "csr":
            kernels = ["B9", "B8"]
        elif xfer is None:
            kernels = ["B2"]
        elif "cwt" in xfer:
            kernels = ["B3w", "B4w"]
        elif mf:
            kernels = ["B3-mf", "B4-mf"]
            per_visit = _mf_launches(level, smd, amg)
        else:
            kernels = ["B3", "B4"]
    row["kernels"] = kernels
    row["kernels_per_visit"] = per_visit
    return row


def _level_table(amg):
    """Per-level static routing table (see the module docs) and the tail
    entry level. Reads object metadata and the solve data the hierarchy
    already holds: no device work. Memoized on the hierarchy per level
    list and tail entry."""
    levels = getattr(amg, "levels", None) or []
    tail0 = _tail_entry(amg)
    key = (id(levels), len(levels), tail0,
           tuple(id(lv.A) for lv in levels))
    cached = getattr(amg, "_telemetry_level_cache", None)
    if cached is not None and cached[0] == key:
        return [dict(r) for r in cached[1]], tail0
    data = amg.solve_data()["levels"]
    rows = [_level_row(amg, lv, ld) for lv, ld in zip(levels, data)]
    coarsest = getattr(amg, "coarsest_A", None)
    if coarsest is not None and levels:
        rows.append({
            "level": len(levels),
            "rows": int(coarsest.num_rows),
            "nnz": int(coarsest.values.shape[-1]),
            "layout": "dia" if coarsest.dia_offsets is not None else "csr",
            "fused_smoother": False,
            "fused_transfers": False,
            "kernels": [],
            "kernels_per_visit": None,
            "coarse_solver": getattr(amg.coarse_solver, "name", None),
        })
    if tail0 is not None:
        for row in rows:
            if row["level"] >= tail0:
                row["kind"] = "coarse_tail"
                row["kernels"] = ["B5-mf" if row.get("matrix_free")
                                  else "B5"]
                row["kernels_per_visit"] = None
    amg._telemetry_level_cache = (key, rows)
    return [dict(r) for r in rows], tail0


def _hierarchy(amg) -> Optional[Dict[str, Any]]:
    """`grid_stats_dict()` with the schema's layouts: a matrix-free
    level ("dia-mf" in the grid table) reports layout "dia" and
    matrix_free true."""
    try:
        d = amg.grid_stats_dict()
    except Exception:
        return None               # a partially built hierarchy
    for row in d["levels"]:
        row["matrix_free"] = row["layout"] == "dia-mf"
        if row["matrix_free"]:
            row["layout"] = "dia"
    return d


def _scalar(v):
    a = np.asarray(v)
    return a.tolist() if a.ndim else float(a)


def build_report(solver, result, hist=None,
                 distributed: Optional[Dict[str, Any]] = None,
                 diagnostics: Optional[Dict[str, Any]] = None,
                 precision: Optional[Dict[str, Any]] = None
                 ) -> SolveReport:
    """Assemble a SolveReport from a finished SolveResult-shaped record
    and the solver tree's static metadata. `hist` overrides the
    result's stored residual history (the solve passes the history it
    holds even when store_res_history=0). `diagnostics` is the derived
    block when the probe ran (telemetry/diagnostics.py). Reads host
    values and tensor shapes only."""
    hist = result.res_history if hist is None else hist
    residuals = [] if hist is None else np.asarray(hist).tolist()
    amg = _amg_of(solver)
    levels: List[Dict[str, Any]] = []
    tail = None
    cycle = None
    hierarchy = None
    if amg is not None:
        levels, tail = _level_table(amg)
        cycle = getattr(amg, "cycle_name", None)
        hierarchy = _hierarchy(amg)
    return SolveReport(
        solver=str(getattr(solver, "name", type(solver).__name__)),
        status=str(result.status),
        status_code=int(result.status_code),
        iterations=int(result.iterations),
        converged=bool(result.converged),
        norm0=_scalar(result.norm0),
        res_norm=_scalar(result.res_norm),
        residuals=residuals,
        setup_time_s=float(getattr(result, "setup_time", 0.0)),
        solve_time_s=float(getattr(result, "solve_time", 0.0)),
        cycle=cycle,
        levels=levels,
        tail_entry_level=tail,
        distributed=distributed,
        hierarchy=hierarchy,
        diagnostics=diagnostics,
        precision=precision,
    )


# ---------------------------------------------------------------------------
# schema validation (dependency-free subset validator)
# ---------------------------------------------------------------------------

_SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "report_schema.json")


def load_schema() -> Dict[str, Any]:
    with open(_SCHEMA_PATH) as f:
        return json.load(f)


_TYPES = {
    "object": dict, "array": list, "string": str, "boolean": bool,
    "integer": int, "null": type(None),
}


def _type_ok(value, tname: str) -> bool:
    if tname == "number":
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)
    if tname == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, _TYPES[tname])


def _validate(value, schema: Dict[str, Any], path: str,
              errors: List[str]):
    t = schema.get("type")
    if t is not None:
        names = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, n) for n in names):
            errors.append(f"{path}: expected {names}, got "
                          f"{type(value).__name__}")
            return
    if "enum" in schema and value not in schema["enum"]:
        errors.append(f"{path}: {value!r} not in enum {schema['enum']}")
    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                errors.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in value:
                _validate(value[key], sub, f"{path}.{key}", errors)
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            _validate(item, schema["items"], f"{path}[{i}]", errors)


def validate_report(d: Dict[str, Any],
                    schema: Optional[Dict[str, Any]] = None) -> List[str]:
    """Validate a report dict against the checked-in schema; returns
    the list of violations (empty = valid). Implements the subset of
    JSON Schema the schema uses (type unions, required,
    properties, items, enum) so validation needs no extra dependency."""
    errors: List[str] = []
    _validate(d, schema if schema is not None else load_schema(),
              "report", errors)
    return errors
