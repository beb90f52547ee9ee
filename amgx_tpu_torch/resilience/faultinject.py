"""Deterministic fault injection for resilience testing (the port of
amgx_tpu/resilience/faultinject.py: the same kinds, specs, arming,
environment toggle and hooks).

Proves every `SolveStatus` code and every fallback edge actually fires
(tests/test_torch_resilience.py) by corrupting the numerics at the
seams the port has:

- **SpMV output** (`corrupt_spmv`, hooked in ops/spmv.py `spmv`,
  `spmv_pdot` and `spmv_ddot`, and on each level's restricted residual
  in amg/cycles.py): poison one element of y = A x with a non-finite
  value at a configured solve iteration -- the NaN then storms through
  the Krylov state and must be caught by the solve loop's health guards.
  An index past a vector's length is dropped, as the JAX package's
  `.at[].set` drops it.
- **Galerkin values** (`perturb_galerkin`, hooked in amg/hierarchy.py):
  scale one level's coarse operator during the hierarchy build,
  wrecking the AMG preconditioner without touching the fine system.
- **Halo exchange** (`corrupt_halo`): the hook is here; its call site
  comes with the distributed layer (ROADMAP.md Queue A item 13).

The JAX package injects at TRACE time: an armed spec is baked into the
next traced solve program, and the solve consumes one firing per trace.
The port runs its loops in Python, so the same contract is kept at run
time: while a spec is armed, every hook reached inside a solve loop
(`iteration_scope`, set by solvers/base.py around `solve_iteration`)
poisons its output when the innermost loop's iteration equals the
spec's, and the ROOT solve (the outermost loop, `solve_scope`) consumes
one firing of each kind whose hook it reached -- once, however many
times a nested loop ran (REFINEMENT -> FGMRES poisons inner iteration
k of every outer pass, as the JAX package's once-traced inner loop
does). `epoch()` moves on every arm / consume / disarm, as the JAX
package's jit cache keys need; the port keys its `solver.retrace.*`
counters on it.

The in-loop hooks fire only while an iteration scope is active, so
setup-phase SpMVs are never corrupted by a loop-targeted spec. With
nothing armed each hook is two attribute reads and returns its input.

Arm programmatically::

    with faultinject.inject("spmv_nan", iteration=3):
        res = slv.solve(b)          # status == NAN_DETECTED

or via the environment::

    AMGX_TPU_FAULT_INJECT="spmv_nan:iteration=3:fires=1"

**Service-level and fleet-level chaos** (build_crash, step_crash,
step_wedge, shadow_crash, journal_corrupt, aot_corrupt, clock_skew;
replica_kill, replica_wedge, replica_slow) arm through the same
machinery and keep the JAX package's host-side hooks below; their call
sites come with the serving layer (ROADMAP.md Queue A item 11).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Optional

KINDS = ("spmv_nan", "halo_corrupt", "galerkin_perturb",
         # service-level (host-side) chaos kinds — serving/
         "build_crash", "step_crash", "step_wedge",
         "shadow_crash",
         "journal_corrupt", "aot_corrupt", "clock_skew",
         # fleet-level chaos kinds (whole-replica faults) — serving/
         # fleet.py + serving/health.py failover drills
         "replica_kill", "replica_wedge", "replica_slow")


class ChaosInjected(RuntimeError):
    """Raised by service_crash hooks: a scripted service-level fault
    (never produced by real code paths — tests and the chaos bench
    assert the service survives it, not that it happened)."""

_ENV_VAR = "AMGX_TPU_FAULT_INJECT"


@dataclasses.dataclass
class FaultSpec:
    kind: str              # one of KINDS
    iteration: int = 0     # 0-based solve iteration the fault fires at
    index: int = 0         # flat element (spmv/halo) or level (galerkin)
    value: float = math.nan  # poison value for spmv/halo corruption
    scale: float = 100.0   # multiplicative perturbation for galerkin
    fires: Optional[int] = 1  # armed traces/applications left; None = always
    target: str = ""       # replica id for replica_* kinds ("" = any)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"faultinject: unknown kind {self.kind!r} "
                f"(choose from {KINDS})")


_SPEC: Optional[FaultSpec] = None
_EPOCH = 0
_ENV_CHECKED = False
# iteration of the innermost solve loop running (None outside a loop
# body -- setup-phase hooks then stay inert)
_ITER = None
# nesting depth of the solve loops running (the outermost is the root
# solve, which consumes the firings)
_DEPTH = 0


def epoch() -> int:
    """Monotone counter bumped on every arm/consume/disarm (the JAX
    package folds it into its jit cache keys; the port into the
    `solver.retrace.*` keys)."""
    _check_env()
    return _EPOCH


def evict_stale_epochs(cache: dict, current_epoch: int):
    """Drop cache entries keyed under older injection epochs (the epoch
    is the LAST element of every participating cache key). They are
    unreachable — the epoch only moves forward — and may be
    deliberately poisoned traces; periodic fault drills must not grow
    the caches without bound. Owned here so every epoch-keyed cache
    (solvers/base.py, batch/core.py) evicts by the same rule."""
    for k in [k for k in cache if k[-1] != current_epoch]:
        del cache[k]


def _bump():
    global _EPOCH
    _EPOCH += 1


def _check_env():
    """Arm a spec from AMGX_TPU_FAULT_INJECT on first use:
    `kind[:key=value[:key=value...]]` with keys iteration/index/value/
    scale/fires (fires=none for an always-on fault)."""
    global _ENV_CHECKED, _SPEC
    if _ENV_CHECKED:
        return
    _ENV_CHECKED = True
    raw = os.environ.get(_ENV_VAR, "").strip()
    if not raw or _SPEC is not None:
        return
    parts = raw.split(":")
    kw = {}
    for item in parts[1:]:
        k, _, v = item.partition("=")
        k = k.strip()
        if k == "fires":
            kw[k] = None if v.strip().lower() in ("none", "inf") else int(v)
        elif k in ("iteration", "index"):
            kw[k] = int(v)
        elif k in ("value", "scale"):
            kw[k] = float(v)
        elif k == "target":
            kw[k] = v.strip()
    _SPEC = FaultSpec(parts[0].strip(), **kw)
    _bump()
    # the env path is how a LIVE process gets a drill — its arming
    # must hit the postmortem trail exactly like a programmatic arm()
    _flightrec(_SPEC.kind, armed=True, fires=_SPEC.fires)


def _flightrec(kind: str, **fields):
    """Record a chaos event on the flight recorder — the postmortem
    trail must name the injected cause (lazy import: telemetry must
    stay importable without resilience and vice versa)."""
    try:
        from ..telemetry import flightrec
        flightrec.record("chaos", fault=kind, **fields)
    except Exception:
        pass


def arm(spec: FaultSpec):
    """Install `spec` as the active fault (replacing any previous)."""
    global _SPEC, _ENV_CHECKED
    _ENV_CHECKED = True          # explicit arming overrides the env
    _SPEC = spec
    _bump()
    # the arming itself is a state transition worth a postmortem line
    # (an always-on fault like clock_skew never "fires" countably)
    _flightrec(spec.kind, armed=True, fires=spec.fires)


def disarm():
    global _SPEC
    if _SPEC is not None:
        _SPEC = None
        _bump()


@contextlib.contextmanager
def inject(kind: str, **kw):
    """Arm a fault for the duration of the block (disarmed on exit even
    if already consumed)."""
    arm(FaultSpec(kind, **kw))
    try:
        yield
    finally:
        disarm()


def active(kind: str) -> Optional[FaultSpec]:
    """The armed spec for `kind`, if it has fires left."""
    _check_env()
    s = _SPEC
    if s is None or s.kind != kind:
        return None
    if s.fires is not None and s.fires <= 0:
        return None
    return s


def consume(kind: str):
    """Record one firing (one poisoned root solve, or one applied
    galerkin perturbation). Called by the hooks' owners."""
    s = active(kind)
    if s is None:
        return
    _flightrec(kind, fired=True)
    if s.fires is not None:
        s.fires -= 1
        _bump()


# kinds whose corruption hooks were actually reached during the current
# root solve -- a fires-limited fault must only be spent by a solve that
# really reached its injection site (an armed halo fault must survive
# unrelated single-device solves untouched)
_HOOK_HITS = set()


def any_loop_fault_armed() -> bool:
    """Is an in-loop fault (spmv/halo) armed?"""
    return active("spmv_nan") is not None or \
        active("halo_corrupt") is not None


def consume_loop_faults():
    """Spend one firing for each in-loop kind whose hook was reached
    during the root solve that just ended."""
    for kind in ("spmv_nan", "halo_corrupt"):
        if kind in _HOOK_HITS:
            consume(kind)
    _HOOK_HITS.clear()


# -- solve and iteration scopes (link the loops to the deep hooks) ------


class solve_scope:
    """One solve loop (solvers/base.py `run_loop`, `run_loop_batched`).
    When the outermost one -- the root solve -- ends, one firing of each
    in-loop kind whose hook it reached is consumed."""

    __slots__ = ()

    def __enter__(self):
        global _DEPTH
        _DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _DEPTH
        _DEPTH -= 1
        if _DEPTH == 0 and _HOOK_HITS:
            consume_loop_faults()
        return False


class iteration_scope:
    """Declare the running loop's iteration while `solve_iteration`
    runs, so hooks buried under spmv can gate on it (the innermost loop
    wins; the enclosing loop's iteration comes back on exit)."""

    __slots__ = ("it", "prev")

    def __init__(self, it: int):
        self.it = it

    def __enter__(self):
        global _ITER
        self.prev, _ITER = _ITER, self.it
        return self

    def __exit__(self, *exc):
        global _ITER
        _ITER = self.prev
        return False


def loop_fault_hit(kind: str = "spmv_nan") -> Optional[FaultSpec]:
    """The armed spec of an in-loop `kind` when the running iteration is
    its target, else None. Records the hook as reached whenever the spec
    is armed inside a loop (the consumption rule above). Callers with a
    fused route use it to compose the poisoned iteration unfused."""
    spec = active(kind)
    if spec is None or _ITER is None:
        return None
    _HOOK_HITS.add(kind)
    return spec if _ITER == spec.iteration else None


def _poison(y, index: int, value: float):
    """y with its element `index` (on the last axis: each system of a
    batch) set to `value`; an index out of range is dropped."""
    n = y.shape[-1]
    if not -n <= index < n:
        return y
    y = y.clone()
    y[..., index] = value
    return y


# -- hooks (no-ops when nothing is armed) -------------------------------


def corrupt_spmv(y):
    """Poison y[index] with `value` at the configured iteration. Inert
    outside a solve loop (no iteration scope)."""
    spec = loop_fault_hit("spmv_nan")
    return y if spec is None else _poison(y, spec.index, spec.value)


def corrupt_halo(halo):
    """Poison one received halo entry at the configured iteration (the
    index clamped to the halo, as the JAX package's)."""
    if halo.shape[-1] == 0:
        return halo
    spec = loop_fault_hit("halo_corrupt")
    if spec is None:
        return halo
    return _poison(halo, min(spec.index, halo.shape[-1] - 1), spec.value)


# -- service-level hooks (host-side; serving/) --------------------------


def service_crash(point: str):
    """Raise ChaosInjected when the `point` kind ('build_crash' /
    'step_crash') is armed — one consumed firing per raise. Inert (and
    free) when nothing is armed."""
    spec = active(point)
    if spec is None:
        return
    consume(point)
    raise ChaosInjected(f"chaos: injected {point}")


def step_wedged() -> bool:
    """True while a 'step_wedge' fault is armed: the engine cycle makes
    no progress this cycle (consumes one firing per wedged cycle)."""
    spec = active("step_wedge")
    if spec is None:
        return False
    consume("step_wedge")
    return True


def corrupt_blob(kind: str, blob: bytes) -> bytes:
    """Torn-write model for 'journal_corrupt' / 'aot_corrupt': when
    armed, the blob about to be persisted is truncated and bit-flipped
    (one firing per corrupted write). The read path must detect the
    damage and degrade — skip the record / retrace — never hang."""
    spec = active(kind)
    if spec is None:
        return blob
    consume(kind)
    half = bytes(b ^ 0xFF for b in blob[:max(1, len(blob) // 2)])
    return half


def service_now() -> float:
    """time.monotonic(), shifted by `value` seconds while a
    'clock_skew' fault is armed (arm with fires=None for a persistent
    skew). Every serving-layer deadline computation reads the clock
    through this hook so skew drills are deterministic."""
    spec = active("clock_skew")
    now = time.monotonic()
    if spec is None:
        return now
    return now + float(spec.value)


# -- fleet-level hooks (whole-replica faults; serving/fleet.py) ---------


def _replica_spec(kind: str, replica: str) -> Optional[FaultSpec]:
    """The armed replica-fault spec for `kind` when it targets THIS
    replica (spec.target empty = any replica's scheduler may trip it)."""
    spec = active(kind)
    if spec is None:
        return None
    if spec.target and spec.target != str(replica):
        return None
    return spec


def replica_crash(replica: str):
    """Raise ChaosInjected at the top of the targeted replica's
    scheduler cycle while 'replica_kill' is armed — the whole-replica
    analog of service_crash (one consumed firing per raise)."""
    spec = _replica_spec("replica_kill", replica)
    if spec is None:
        return
    consume("replica_kill")
    raise ChaosInjected(
        f"chaos: injected replica_kill on {replica or 'replica'}")


def replica_wedged(replica: str) -> bool:
    """True while 'replica_wedge' targets this replica: the scheduler
    cycle returns without running AND without advancing the cycle
    counter — the replica-level heartbeat flatline (one firing per
    wedged cycle)."""
    spec = _replica_spec("replica_wedge", replica)
    if spec is None:
        return False
    consume("replica_wedge")
    return True


def replica_delay(replica: str) -> float:
    """Seconds to stall the targeted replica's cycle while
    'replica_slow' is armed (spec.value; one firing per slowed
    cycle), else 0.0."""
    spec = _replica_spec("replica_slow", replica)
    if spec is None:
        return 0.0
    consume("replica_slow")
    v = float(spec.value)
    return v if math.isfinite(v) and v > 0.0 else 0.0


def perturb_galerkin(Ac, level: int):
    """Scale a coarse-level operator's values during the hierarchy
    build (spec.index selects the level). Consumes one firing per
    applied perturbation."""
    spec = active("galerkin_perturb")
    if spec is None or level != spec.index:
        return Ac
    consume("galerkin_perturb")
    return Ac.with_values(Ac.values * spec.scale)
