"""Structured solve statuses.

The reference returns AMGX_SOLVE_SUCCESS / FAILED / DIVERGED /
NOT_CONVERGED from every solve (include/amgx_c.h AMGX_SOLVE_STATUS);
the port's original single `converged` bool collapsed a NaN storm, an
indefinite-matrix CG breakdown, and an honest max-iters exit into one
indistinguishable failure string. `SolveStatus` restores the
distinction — and refines it with the breakdown/stall classes the
fallback engine (resilience/policy.py) keys its chains on.

The integer codes are ordered by SEVERITY so that a worst-case `max`
over several solves picks the worst outcome. A copy of
amgx_tpu/resilience/status.py: the port's solve loop (solvers/base.py)
classifies into the same codes.
"""
from __future__ import annotations

import enum

# in-trace sentinel: the loop is still running / no terminal status has
# been assigned yet. Never escapes unpack_stats (a loop that exhausts
# max_iters is reported as MAX_ITERS).
RUNNING = -1


class SolveStatus(enum.IntEnum):
    """Terminal status of one solve, ordered by severity."""

    CONVERGED = 0      # residual met the convergence criterion
    MAX_ITERS = 1      # honest iteration-budget exit, residual finite
    STALLED = 2        # residual stopped improving over the stall window
    DIVERGED = 3       # residual grew past rel_div_tolerance * norm0
    BREAKDOWN = 4      # Krylov recurrence degenerated (p.Ap <= 0, rho/
    #                    omega underflow, Givens degeneracy, ...)
    NAN_DETECTED = 5   # non-finite residual norm reached the monitor
    DEADLINE_EXCEEDED = 6  # serving-layer deadline expired before the
    #                    solve reached a terminal status (the request
    #                    completes with its current iterate or a
    #                    rejection, never a hung bucket; serving/)
    OVERLOADED = 7     # serving-layer load shed: admission control
    #                    judged the request unserviceable (queue bound,
    #                    tenant quota, or a deadline the live latency
    #                    estimate says is unmeetable) and completed it
    #                    immediately with the initial iterate — the
    #                    honest early rejection, distinct from a
    #                    DEADLINE_EXCEEDED surprise after queueing


# AMGX_SOLVE_STATUS codes (include/amgx_c.h) for the C-API surface.
AMGX_SOLVE_SUCCESS = 0
AMGX_SOLVE_FAILED = 1
AMGX_SOLVE_DIVERGED = 2
AMGX_SOLVE_NOT_CONVERGED = 3

_TO_AMGX = {
    SolveStatus.CONVERGED: AMGX_SOLVE_SUCCESS,
    SolveStatus.MAX_ITERS: AMGX_SOLVE_NOT_CONVERGED,
    SolveStatus.STALLED: AMGX_SOLVE_NOT_CONVERGED,
    SolveStatus.DIVERGED: AMGX_SOLVE_DIVERGED,
    SolveStatus.BREAKDOWN: AMGX_SOLVE_FAILED,
    SolveStatus.NAN_DETECTED: AMGX_SOLVE_FAILED,
    SolveStatus.DEADLINE_EXCEEDED: AMGX_SOLVE_NOT_CONVERGED,
    SolveStatus.OVERLOADED: AMGX_SOLVE_NOT_CONVERGED,
}

_STRINGS = {
    SolveStatus.CONVERGED: "success",
    SolveStatus.MAX_ITERS: "max_iters",
    SolveStatus.STALLED: "stalled",
    SolveStatus.DIVERGED: "diverged",
    SolveStatus.BREAKDOWN: "breakdown",
    SolveStatus.NAN_DETECTED: "nan_detected",
    SolveStatus.DEADLINE_EXCEEDED: "deadline_exceeded",
    SolveStatus.OVERLOADED: "overloaded",
}


def coerce(code) -> SolveStatus:
    """Clamp an int-ish code (packed stats travel as floats) to a
    SolveStatus; unknown/sentinel values degrade to MAX_ITERS rather
    than raising inside result plumbing."""
    try:
        return SolveStatus(int(code))
    except ValueError:
        return SolveStatus.MAX_ITERS


def status_string(code) -> str:
    return _STRINGS[coerce(code)]


def to_amgx_status(code) -> int:
    """SolveStatus -> AMGX_SOLVE_* (the C API's coarser vocabulary)."""
    return _TO_AMGX[coerce(code)]
