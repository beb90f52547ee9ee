"""Convergence diagnostics: per-level cycle-stage residual norms (the
port of amgx_tpu/telemetry/diagnostics.py).

An opt-in `diagnostics=1` mode records the residual norm at the stages
of every level's cycle visit --

    entry            ||b_l - A_l x_in||   (what the level was handed)
    post_presmooth   ||b_l - A_l x'||     (after the presmoother)
    post_correction  ||b_l - A_l (x'+P xc)||  (after the coarse-grid
                                               correction)
    post_postsmooth  ||b_l - A_l x''||    (the level's exit residual)

-- and host-side derivation turns them into per-level reduction
factors, smoother effectiveness, a coarse-correction quality column, a
"bottleneck level" attribution, and an asymptotic convergence-factor
estimate from the residual-history tail. Everything lands on
`SolveReport.diagnostics`.

Execution model: after a ROOT solve's loop (solvers/base.py
`Solver.solve`), ONE instrumented multigrid cycle -- the "probe" -- runs
on the residual equation `A d = r_final`, and its 4 x levels norms come
to the host in one transfer. So:

- the probe runs once per solve, never per iteration; the solve's own
  iterations keep their kernels and their one host read each;
- the probe sees the asymptotic regime (the final residual);
- it works at any preconditioner nesting depth (the flagship's
  REFINEMENT -> FGMRES -> AMG chain included): the root walks its tree
  to the AMG hierarchy's data;
- `diagnostics=0` (the default) runs nothing of this module.

Cost when on: one composed cycle (amg/cycles.py `_cycle` takes no B5
tail and runs the correction and the postsmooth apart while a recorder
is active, so each stage exists to measure) plus one residual SpMV and
one reduction per recorded stage (a matrix-free level's operator rebuilt
from its stencil for them, ops/stencil.py `level_operator`).

The tape is thread-local and active only inside `capturing()`: a cycle
outside it pays one attribute read per level visit.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional

import numpy as np

# stage order inside each level's 4-slot group (the packed layout is
# [level][stage], levels outermost)
STAGES = ("entry", "post_presmooth", "post_correction", "post_postsmooth")
SLOTS_PER_LEVEL = len(STAGES)

_tls = threading.local()


def current():
    """The active Recorder while a probe cycle runs, else None (the gate
    amg/cycles.py consults)."""
    return getattr(_tls, "rec", None)


class Recorder:
    """Tape of (level, stage) -> residual-norm tensors. A level visited
    more than once per cycle (W/F shapes) overwrites its slots, so the
    packed vector reports the LAST visit -- the one whose exit residual
    the cycle returns."""

    def __init__(self, num_levels: int):
        self.num_levels = int(num_levels)
        self.slots: Dict[tuple, Any] = {}

    def record(self, lvl: int, stage: int, A, x, b):
        import torch

        from ..ops.spmv import residual
        r = residual(A, x, b)
        self.slots[(int(lvl), int(stage))] = torch.sqrt(torch.sum(r * r))

    def pack(self, dtype, device):
        """The tape as one (4 * num_levels,) tensor of `dtype` on
        `device`; never-recorded slots pack as NaN so the host derivation
        can tell 'missing' from 'zero residual'."""
        import torch
        nan = torch.full((), float("nan"), dtype=dtype, device=device)
        vals = []
        for lvl in range(self.num_levels):
            for st in range(SLOTS_PER_LEVEL):
                v = self.slots.get((lvl, st))
                vals.append(nan if v is None else v.to(dtype))
        if not vals:
            return torch.zeros((0,), dtype=dtype, device=device)
        return torch.stack(vals)


@contextlib.contextmanager
def capturing(rec: Recorder):
    prev = getattr(_tls, "rec", None)
    _tls.rec = rec
    try:
        yield rec
    finally:
        _tls.rec = prev


def slots_len(amg) -> int:
    """Packed probe length for a hierarchy (0 = no smoothed levels,
    probe skipped)."""
    return SLOTS_PER_LEVEL * len(getattr(amg, "levels", ()))


def probe_cycle(amg, amg_data, r, dtype):
    """Run ONE instrumented multigrid cycle on the residual equation
    `A d = r` (zero initial guess) and return the packed stage-norm
    tensor (on r's device; the caller reads it in one transfer). `r` is
    the root system's final residual in the root's dtype; it is cast to
    the hierarchy's stored dtype (the flagship's AMG is float32 under a
    float64 outer loop) and `amg.cycle` applies any `amg_precision` cast
    on top, exactly like a real cycle."""
    import torch
    lv0 = amg.levels[0].A
    pb = r.to(lv0.dtype)
    rec = Recorder(len(amg.levels))
    with capturing(rec):
        amg.cycle(amg_data, pb, torch.zeros_like(pb))
    return rec.pack(dtype, r.device)


# ---------------------------------------------------------------------------
# host-side derivation
# ---------------------------------------------------------------------------


def _finite(v) -> Optional[float]:
    v = float(v)
    return v if np.isfinite(v) else None


def _ratio(num, den) -> Optional[float]:
    if num is None or den is None or den <= 0.0:
        return None
    r = num / den
    return r if np.isfinite(r) else None


def asymptotic_convergence_factor(res_hist, tail_window: int = 8
                                  ) -> Optional[float]:
    """Geometric mean of the residual-reduction ratios over the tail of
    the (already host-side) residual history — the standard asymptotic
    convergence-factor estimate. Block norms collapse to their max
    component (the monitored quantity). None when the history is too
    short or degenerate to estimate from."""
    if res_hist is None:
        return None
    h = np.asarray(res_hist, dtype=float)
    if h.ndim > 1:
        h = h.max(axis=tuple(range(1, h.ndim)))
    h = h[np.isfinite(h) & (h > 0.0)]
    if h.size < 3:
        return None
    tail = h[-min(tail_window + 1, h.size):]
    ratios = tail[1:] / tail[:-1]
    ratios = ratios[np.isfinite(ratios) & (ratios > 0.0)]
    if ratios.size == 0:
        return None
    return float(np.exp(np.mean(np.log(ratios))))


def derive(diag_vec, num_levels: int, res_hist=None,
           tail_window: int = 8) -> Dict[str, Any]:
    """Turn the packed probe vector into the structured diagnostics
    block `SolveReport.diagnostics` carries:

    - per-level stage norms and reduction factors
      (`presmooth_reduction`, `correction_reduction`,
      `postsmooth_reduction`, `level_reduction` = the whole visit);
    - `smoother_effectiveness` per level: geometric mean of the pre-
      and postsmoother reductions (1.0 = the smoother does nothing);
    - `bottleneck_level`: the level whose visit reduces its own
      residual LEAST (largest `level_reduction`) — where to aim a
      smoother/strength-threshold fix first;
    - `cycle_reduction`: the finest level's whole-visit factor (= one
      cycle's total effect on the probe residual);
    - `asymptotic_convergence_factor` from the residual-history tail.
    """
    diag = np.asarray(diag_vec, dtype=float).reshape(
        num_levels, SLOTS_PER_LEVEL)
    levels: List[Dict[str, Any]] = []
    bottleneck = None
    for lvl in range(num_levels):
        e, pp, pc, ps = (_finite(v) for v in diag[lvl])
        row: Dict[str, Any] = {
            "level": lvl,
            "entry_norm": e,
            "post_presmooth_norm": pp,
            "post_correction_norm": pc,
            "post_postsmooth_norm": ps,
            "presmooth_reduction": _ratio(pp, e),
            "correction_reduction": _ratio(pc, pp),
            "postsmooth_reduction": _ratio(ps, pc),
            "level_reduction": _ratio(ps, e),
        }
        sm = [r for r in (row["presmooth_reduction"],
                          row["postsmooth_reduction"]) if r is not None]
        row["smoother_effectiveness"] = (
            float(np.exp(np.mean(np.log(np.maximum(sm, 1e-300)))))
            if sm else None)
        levels.append(row)
        lr = row["level_reduction"]
        if lr is not None and (bottleneck is None or lr > bottleneck[1]):
            bottleneck = (lvl, lr)
    return {
        "stages": list(STAGES),
        "levels": levels,
        "bottleneck_level": None if bottleneck is None else bottleneck[0],
        "bottleneck_reduction":
            None if bottleneck is None else bottleneck[1],
        "cycle_reduction":
            levels[0]["level_reduction"] if levels else None,
        "asymptotic_convergence_factor":
            asymptotic_convergence_factor(res_hist, tail_window),
    }


# ---------------------------------------------------------------------------
# diagnostics -> concrete config deltas
# ---------------------------------------------------------------------------

# the doctor's hint sentences (the JAX package's convergence doctor
# prints them verbatim; several candidates may share one hint, so the doctor
# dedups in order — its output predates this mapping and must not move)
HINT_SMOOTHER = ("the smoother barely reduces the residual "
                 "there — raise sweeps/relaxation_factor or "
                 "switch smoother")
HINT_CORRECTION = ("the coarse-grid correction INCREASES the "
                   "residual — interpolation quality: lower "
                   "strength_threshold or use D2/multipass")


def suggest_config_deltas(diag: Optional[Dict[str, Any]]
                          ) -> List[Dict[str, Any]]:
    """Map a `derive()` diagnostics block to concrete config-delta
    candidates — the single source both consumers read: the
    convergence doctor prints each suggestion's `hint` (None for the
    tuner-only candidates, so its output stays the historical two
    sentences), and the serving autotuner shadow-solves each
    suggestion's `deltas`.

    Each suggestion:

        {"knob": <short tag>, "hint": <doctor sentence or None>,
         "level": <bottleneck level or None>,
         "deltas": [{"param": <registry name>, "value": ...}, ...]}

    `deltas` name registered config parameters WITHOUT scopes — the
    applier overrides the parameter wherever the live config sets it
    (else at the default scope, which every scope falls back to), so
    one mapping serves any solver-tree shape. Rules:

    - ineffective smoother at the bottleneck (effectiveness > 0.8):
      swap to JACOBI_L1 (resetting relaxation_factor — an overdamped
      factor must not ride along), or just re-damp the current one;
    - coarse-grid correction AMPLIFYING the residual (> 1.1):
      stock strength threshold, or D2 interpolation with row
      truncation (interpolation-quality levers);
    - cycle barely biting overall (asymptotic factor > 0.85): W-cycle
      (more coarse visits per fine sweep);
    - comfortable convergence (asymptotic factor < 0.35): trade slack
      for bandwidth with solve_precision=float (wall lever — shadow
      measurement decides whether the extra iterations pay for the
      halved slab bytes).
    """
    out: List[Dict[str, Any]] = []
    if not diag:
        return out
    levels = diag.get("levels") or []
    bl = diag.get("bottleneck_level")
    row = next((r for r in levels if r.get("level") == bl), None) \
        if bl is not None else None
    if row is not None:
        if (row["smoother_effectiveness"] or 0) > 0.8:
            out.append({"knob": "smoother_swap", "hint": HINT_SMOOTHER,
                        "level": bl, "deltas": [
                            {"param": "smoother", "value": "JACOBI_L1"},
                            {"param": "relaxation_factor", "value": 0.9},
                        ]})
            out.append({"knob": "relaxation", "hint": HINT_SMOOTHER,
                        "level": bl, "deltas": [
                            {"param": "relaxation_factor", "value": 0.9},
                        ]})
        if (row["correction_reduction"] or 0) > 1.1:
            out.append({"knob": "strength", "hint": HINT_CORRECTION,
                        "level": bl, "deltas": [
                            {"param": "strength_threshold",
                             "value": 0.25},
                        ]})
            out.append({"knob": "interp", "hint": HINT_CORRECTION,
                        "level": bl, "deltas": [
                            {"param": "interpolator", "value": "D2"},
                            {"param": "interp_max_elements", "value": 4},
                        ]})
    acf = diag.get("asymptotic_convergence_factor")
    if acf is not None and acf > 0.85:
        out.append({"knob": "cycle", "hint": None, "level": bl,
                    "deltas": [{"param": "cycle", "value": "W"}]})
    if acf is not None and acf < 0.35:
        out.append({"knob": "precision", "hint": None, "level": bl,
                    "deltas": [{"param": "solve_precision",
                                "value": "float"}]})
    return out
