"""Shared precision policy: one resolver for every precision knob.

The port of amgx_tpu/precision.py. Three knobs name the precision of the
inner multigrid cycle:

- ``solve_precision`` (default unset ``""``): the user-facing knob;
- ``amg_precision``: the hierarchy-level spelling of the same quantity;
- ``tpu_dtype``: legacy alias (``float64`` -> ``double``, ``float32`` ->
  ``float``), kept so the reference's config strings still parse.

Two explicitly-set knobs that disagree are rejected at configuration
time.
"""
from __future__ import annotations

import dataclasses

from .errors import BadConfigurationError

_TPU_DTYPE_ALIASES = {"float64": "double", "float32": "float",
                      "bfloat16": "bfloat16"}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Resolved precision decision for one solver/hierarchy scope."""

    name: str               # effective precision: double|float|bfloat16
    source: str             # the knob that decided, or "default"
    solve_precision: str    # the raw solve_precision knob ("" = unset)


def _explicit(cfg, name: str, scope: str):
    for s in (scope, "default"):
        if (s, name) in cfg.values:
            return cfg.values[(s, name)]
    return None


def resolve_precision(cfg, scope: str = "default") -> PrecisionPolicy:
    """Resolve the three precision knobs into one PrecisionPolicy;
    raises BadConfigurationError when two explicit knobs disagree."""
    sp = str(cfg.get("solve_precision", scope))
    td_raw = _explicit(cfg, "tpu_dtype", scope)
    ap_raw = _explicit(cfg, "amg_precision", scope)
    claims = []
    if sp:
        claims.append(("solve_precision", sp))
    if td_raw:
        claims.append(("tpu_dtype", _TPU_DTYPE_ALIASES[str(td_raw)]))
    if ap_raw is not None:
        claims.append(("amg_precision", str(ap_raw)))
    if len({c[1] for c in claims}) > 1:
        detail = ", ".join(f"{k}={v!r}" for k, v in claims)
        raise BadConfigurationError(
            f"contradictory precision knobs: {detail}; set "
            f"solve_precision alone or make the knobs agree")
    if claims:
        source, name = claims[0]
    else:
        source, name = "default", str(cfg.get("amg_precision", scope))
    return PrecisionPolicy(name=name, source=source, solve_precision=sp)
