"""Declarative fallback/retry chains (the resilience policy engine; the
port of amgx_tpu/resilience/policy.py with the same grammars, error
messages and suggestions).

AMGCL-style composable solver fallbacks (PAPERS.md) on top of the
structured `SolveStatus` the in-trace health guards produce: when a
solve ends in a failure status, a host-orchestrated, BOUNDED chain of
recovery actions runs — each action either retries the same solver
(reusing the AMG hierarchy and cached traces when the matrix is
unchanged) or rebuilds a stronger/alternative configuration and
re-solves.

Grammar (`fallback_policy` config parameter)::

    STATUS>action[=arg] | STATUS>action[=arg] | ...

- STATUS: a SolveStatus name (NAN_DETECTED / BREAKDOWN / DIVERGED /
  STALLED / MAX_ITERS / DEADLINE_EXCEEDED; NAN and DEADLINE are
  accepted as aliases), or ANY. DEADLINE_EXCEEDED is produced by the
  serving layer when a request's deadline expires mid-flight; a chain
  keyed on it lets a sync re-solve of the expired system run a recovery
  action like any other failure class.

A rebuilt tree (rescale_retry, switch_solver, escalate_sweeps) is built
on the wrapped solver's device, so a recovered solve stays on the card.
- actions:
  * ``retry``            — re-solve with the SAME solver from a zero
    guess (no setup cost: the hierarchy is reused; a consumed transient
    fault is spent, so the retry runs clean);
  * ``rescale_retry``    — rebuild with DIAGONAL_SYMMETRIC equation
    scaling and re-solve (the NaN/ill-scaling recovery);
  * ``switch_solver=X``  — rebuild the tree with solver X in the same
    scope (e.g. BREAKDOWN on CG -> rerun as GMRES);
  * ``escalate_sweeps``  — double (min 1) every configured presweeps/
    postsweeps and re-solve (the STALLED recovery: more smoothing).

Multiple steps for the SAME status form a chain tried in order across
attempts; `max_fallback_attempts` bounds the total. The `|` separator
keeps the spec safe inside flat config strings (which split on commas).

Example::

    fallback_policy=NAN_DETECTED>retry|BREAKDOWN>switch_solver=GMRES,
    max_fallback_attempts=2
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..config import Config
from ..errors import BadConfigurationError, BadParametersError, did_you_mean
from ..solvers.base import Solver, SolveResult, make_solver
from .status import SolveStatus

ACTIONS = ("retry", "rescale_retry", "switch_solver", "escalate_sweeps")

# service-level grammar (serving_fault_policy; its consumer comes with
# the serving layer, ROADMAP.md Queue A item 11): the
# same 'EVENT>action|...' spec shape, keyed on service events instead
# of solve statuses. Multiple steps for one event form a chain tried in
# order across that fingerprint's consecutive failures (bounded by
# serving_retry_max_attempts, after which the tickets reject).
SERVICE_EVENTS = ("BUILD_FAILED", "STEP_FAILED", "WEDGED")
SERVICE_ACTIONS = ("retry_backoff", "requeue", "reject")

# fleet-level grammar (fleet_fault_policy; consumer with item 11): the same
# 'EVENT>action|...' shape one level up — keyed on REPLICA health
# events instead of per-fingerprint service events. Multiple steps for
# one event form a chain tried in order across that replica's
# consecutive verdicts (the last step repeats once the chain is
# exhausted, so a 'probe_backoff|failover' wedge chain probes once and
# then fails over for good).
FLEET_EVENTS = ("REPLICA_DEAD", "REPLICA_WEDGED", "REPLICA_SLOW")
FLEET_ACTIONS = ("failover", "probe_backoff", "ignore")

ANY = "ANY"

_STATUS_ALIASES = {"NAN": "NAN_DETECTED", "DEADLINE": "DEADLINE_EXCEEDED"}

Chain = List[Tuple[str, str]]


def parse_fallback_policy(spec: str) -> Dict[object, Chain]:
    """Parse the policy grammar into {status_code_or_ANY: [(action,
    arg), ...]}. Raises BadConfigurationError (with a did-you-mean
    suggestion) on unknown statuses or actions."""
    policy: Dict[object, Chain] = {}
    for step in str(spec or "").split("|"):
        step = step.strip()
        if not step:
            continue
        if ">" not in step:
            raise BadConfigurationError(
                f"fallback_policy step {step!r}: expected "
                f"'STATUS>action[=arg]'")
        sname, action = (p.strip() for p in step.split(">", 1))
        sname = _STATUS_ALIASES.get(sname.upper(), sname.upper())
        if sname == ANY:
            key: object = ANY
        else:
            try:
                key = int(SolveStatus[sname])
            except KeyError:
                names = [s.name for s in SolveStatus] + \
                    [ANY] + list(_STATUS_ALIASES)
                raise BadConfigurationError(
                    f"fallback_policy: unknown status {sname!r}"
                    f"{did_you_mean(sname, names)}") from None
        act, _, arg = action.partition("=")
        act = act.strip().lower()
        arg = arg.strip()
        if act not in ACTIONS:
            raise BadConfigurationError(
                f"fallback_policy: unknown action {act!r}"
                f"{did_you_mean(act, ACTIONS)}")
        if act == "switch_solver" and not arg:
            raise BadConfigurationError(
                "fallback_policy: switch_solver needs '=SOLVER_NAME'")
        policy.setdefault(key, []).append((act, arg))
    return policy


def parse_service_policy(spec: str) -> Dict[str, List[str]]:
    """Parse the service-level grammar into {event: [action, ...]}.
    Events: BUILD_FAILED (a bucket's hierarchy build / engine trace
    raised), STEP_FAILED (a device-step cycle raised mid-flight),
    WEDGED (the supervisor's progress heartbeat flatlined). Actions:

    * ``retry_backoff`` — keep the tickets queued and retry the build
      after a bounded exponential backoff (serving_retry_backoff_s *
      2^attempt, capped at serving_retry_max_attempts total);
    * ``requeue``       — retry immediately (same attempt bound);
    * ``reject``        — complete the affected tickets with BREAKDOWN
      + the error on ticket.error.

    Raises BadConfigurationError (with a did-you-mean) on unknown
    events or actions, mirroring parse_fallback_policy."""
    policy: Dict[str, List[str]] = {}
    for step in str(spec or "").split("|"):
        step = step.strip()
        if not step:
            continue
        if ">" not in step:
            raise BadConfigurationError(
                f"serving_fault_policy step {step!r}: expected "
                f"'EVENT>action'")
        ev, action = (p.strip() for p in step.split(">", 1))
        ev = ev.upper()
        if ev not in SERVICE_EVENTS:
            raise BadConfigurationError(
                f"serving_fault_policy: unknown event {ev!r}"
                f"{did_you_mean(ev, SERVICE_EVENTS)}")
        action = action.strip().lower()
        if action not in SERVICE_ACTIONS:
            raise BadConfigurationError(
                f"serving_fault_policy: unknown action {action!r}"
                f"{did_you_mean(action, SERVICE_ACTIONS)}")
        policy.setdefault(ev, []).append(action)
    return policy


def parse_fleet_policy(spec: str) -> Dict[str, List[str]]:
    """Parse the fleet-level grammar into {event: [action, ...]}.
    Events: REPLICA_DEAD (the replica's scheduler thread died with a
    captured exception, or an inline step() raised), REPLICA_WEDGED
    (the replica is busy but its cycle counter flatlined across
    consecutive health checks), REPLICA_SLOW (cycles advance, but
    slower than `fleet_slow_cycle_s` per cycle). Actions:

    * ``failover``      — declare the replica DOWN: rehome its
      fingerprints along rendezvous order, move its queued/in-flight
      tickets to survivors, adopt its journal;
    * ``probe_backoff`` — open the circuit breaker (no new placements)
      for a bounded exponential backoff (fleet_probe_backoff_s *
      2^failures), then HALF_OPEN: exactly one trial fingerprint is
      admitted until the replica proves progress;
    * ``ignore``        — count the event, change nothing.

    Raises BadConfigurationError (with a did-you-mean) on unknown
    events or actions, mirroring parse_service_policy."""
    policy: Dict[str, List[str]] = {}
    for step in str(spec or "").split("|"):
        step = step.strip()
        if not step:
            continue
        if ">" not in step:
            raise BadConfigurationError(
                f"fleet_fault_policy step {step!r}: expected "
                f"'EVENT>action'")
        ev, action = (p.strip() for p in step.split(">", 1))
        ev = ev.upper()
        if ev not in FLEET_EVENTS:
            raise BadConfigurationError(
                f"fleet_fault_policy: unknown event {ev!r}"
                f"{did_you_mean(ev, FLEET_EVENTS)}")
        action = action.strip().lower()
        if action not in FLEET_ACTIONS:
            raise BadConfigurationError(
                f"fleet_fault_policy: unknown action {action!r}"
                f"{did_you_mean(action, FLEET_ACTIONS)}")
        policy.setdefault(ev, []).append(action)
    return policy


class ResilientSolver:
    """Wrap a solver tree with the configured fallback chains.

    Duck-types the `Solver` surface (setup / resetup / solve /
    solve_many and attribute reads delegate to the wrapped tree), so it
    drops into every call site `create_solver` feeds. A successful
    fallback that rebuilt the tree ADOPTS the rebuilt solver, so
    subsequent solves keep the recovered configuration (and its
    hierarchy) instead of re-failing first. Every rebuilt tree is built
    on the wrapped solver's device.
    """

    def __init__(self, cfg: Config, scope: str = "default",
                 solver: Optional[Solver] = None, device=None):
        if solver is None:
            from ..device import resolve_device
            name, child_scope = cfg.get_solver("solver", scope)
            solver = make_solver(name, cfg, child_scope,
                                 resolve_device(device))
        self.solver = solver
        self.cfg = cfg
        self.policy = parse_fallback_policy(
            cfg.get("fallback_policy", solver.scope))
        self.max_attempts = int(cfg.get("max_fallback_attempts",
                                        solver.scope))
        self._A = None

    # -- Solver surface ---------------------------------------------------
    def setup(self, A):
        self._A = A
        self.solver.setup(A)
        return self

    def resetup(self, A):
        self._A = A
        self.solver.resetup(A)
        return self

    def __getattr__(self, name):
        # everything else (A, max_iters, solve_many, solve_data, ...)
        # reads through to the wrapped tree
        return getattr(self.solver, name)

    # -- the attempt loop -------------------------------------------------
    def _chain_for(self, code: int, used: Dict[object, int]):
        for key in (int(code), ANY):
            chain = self.policy.get(key, [])
            i = used.get(key, 0)
            if i < len(chain):
                used[key] = i + 1
                return chain[i]
        return None

    def solve(self, b, x0=None, zero_initial_guess: bool = False
              ) -> SolveResult:
        res = self.solver.solve(b, x0=x0,
                                zero_initial_guess=zero_initial_guess)
        history = [("initial", res.status)]
        used: Dict[object, int] = {}
        attempts = 0
        while (res.status_code != int(SolveStatus.CONVERGED)
               and attempts < self.max_attempts):
            step = self._chain_for(res.status_code, used)
            if step is None:
                break
            action, arg = step
            attempts += 1
            from ..telemetry import flightrec
            flightrec.record(
                "fallback.hop", action=action, arg=arg or None,
                attempt=attempts,
                from_status=SolveStatus(res.status_code).name)
            res = self._run_action(action, arg, b, x0,
                                   zero_initial_guess)
            history.append(
                (f"{action}={arg}" if arg else action, res.status))
        # attach the audit trail (which chain steps ran, and how each
        # attempt ended) without widening the SolveResult contract
        res.fallback_history = history
        return res

    def _run_action(self, action: str, arg: str, b, x0,
                    zero_initial_guess: bool) -> SolveResult:
        from ..telemetry import metrics as _tm
        _tm.inc("resilience.fallback_attempts")
        _tm.inc(f"resilience.fallback.{action}")
        if action == "retry":
            # same tree, zero guess: the hierarchy is reused (the
            # matrix is unchanged); a consumed injected fault is spent,
            # so the retry runs clean
            return self.solver.solve(b, zero_initial_guess=True)
        if self._A is None:
            raise BadParametersError(
                f"fallback action {action!r} needs the matrix from "
                "setup(); this solver was set up through a path that "
                "bypassed ResilientSolver.setup")
        scope = self.solver.scope
        name = self.solver.name
        cfg2 = self.cfg.clone()
        if action == "rescale_retry":
            cfg2.set("scaling", "DIAGONAL_SYMMETRIC", scope=scope)
        elif action == "switch_solver":
            name = arg
            if not self._cfg_names_preconditioner(scope):
                # don't let the registered default ("AMG") silently
                # bolt a multigrid preconditioner onto the substitute
                cfg2.set("preconditioner", "NOSOLVER", scope=scope)
        elif action == "escalate_sweeps":
            self._escalate_sweeps(cfg2)
        # on the wrapped solver's device: a recovered solve stays there
        new = make_solver(name, cfg2, scope, self.solver.device)
        new.setup(self._A)
        res = new.solve(b, x0=x0, zero_initial_guess=zero_initial_guess)
        self.solver = new          # adopt the recovered configuration
        return res

    def _cfg_names_preconditioner(self, scope: str) -> bool:
        vals = self.cfg.values
        return (scope, "preconditioner") in vals or \
            ("default", "preconditioner") in vals

    def _escalate_sweeps(self, cfg2: Config):
        """Double every configured presweeps/postsweeps (min 1); when a
        config never set them, install 2 sweeps in the default scope so
        every AMG member smooths harder."""
        hit = False
        for (s, n), v in list(cfg2.values.items()):
            if n in ("presweeps", "postsweeps"):
                cfg2.set(n, max(1, 2 * int(v)), scope=s)
                hit = True
        if not hit:
            cfg2.set("presweeps", 2)
            cfg2.set("postsweeps", 2)
