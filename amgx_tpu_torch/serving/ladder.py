"""Mixed bucket-width padded ladder (a copy of amgx_tpu/serving/ladder.py).

A fixed `serving_bucket_slots` pads every bucket to one batch width,
which is wrong at both ends of a size-diverse workload: a singleton
fingerprint occupies (and pays the padded FLOPs of) a wide bucket,
while a burst queues behind a narrow one in `slots`-sized waves. The
ladder replaces the fixed width with a declared rung set
(`serving_bucket_ladder`, e.g. ``1|4|16``): each bucket BUILD draws
its width from the queue composition at build time -- the smallest
rung that seats every queued same-fingerprint request, capped at the
top rung.

The choice is per-build, not per-cycle: a bucket keeps the width it
was born with until it is evicted (rebuilding mid-life would throw
away its stacked solve data and its in-flight state). A burst that arrives after
a narrow build therefore drains in narrow waves until the LRU churn
gives the fingerprint a fresh, wider build -- the same settling
behaviour the fixed-width engine has, with a better steady state.

Width changes never cross-serve a warm start: `slots` is part of the
engine's warm-start key (`BucketEngine._aot_key`), so every rung keeps
its own store entry and a ladder service warm-starts each width
independently.
"""
from __future__ import annotations

from typing import Tuple

from ..errors import BadParametersError


def parse_ladder(spec: str) -> Tuple[int, ...]:
    """``'1|4|16'`` -> ``(1, 4, 16)``; ``''`` -> ``()`` (ladder off --
    the fixed `serving_bucket_slots` width applies). Rungs must be
    positive, strictly increasing integers; ``,`` separators are
    accepted as well (config strings already use ``,`` between
    parameters, so ``|`` is the documented spelling)."""
    s = str(spec or "").strip()
    if not s:
        return ()
    parts = [p.strip() for p in s.replace(",", "|").split("|")
             if p.strip()]
    try:
        rungs = tuple(int(p) for p in parts)
    except ValueError:
        raise BadParametersError(
            f"serving_bucket_ladder: rungs must be integers, "
            f"got {spec!r}")
    if not rungs or any(r < 1 for r in rungs) \
            or list(rungs) != sorted(set(rungs)):
        raise BadParametersError(
            f"serving_bucket_ladder: rungs must be positive and "
            f"strictly increasing, got {spec!r}")
    return rungs


def choose_slots(rungs: Tuple[int, ...], pending: int,
                 default: int) -> int:
    """Bucket width for a build that will serve `pending` queued
    same-fingerprint requests: the smallest rung seating all of them,
    else the top rung (a burst larger than the ladder drains in
    top-width waves). An empty ladder defers to `default`
    (= serving_bucket_slots, the fixed-width engine)."""
    if not rungs:
        return max(int(default), 1)
    pending = max(int(pending), 1)
    for r in rungs:
        if r >= pending:
            return r
    return rungs[-1]
