"""Solver resilience (the port of amgx_tpu/resilience/):

- `status`: the `SolveStatus` vocabulary the solve loop classifies into
  (solvers/base.py), at no extra device->host reads;
- `policy`: the declarative, bounded fallback/retry engine
  (`ResilientSolver`), configured by the `fallback_policy` parameter;
- `faultinject`: the deterministic fault harness (SpMV NaNs, Galerkin
  perturbation; the halo, service and fleet kinds arm the same way and
  get their call sites with ROADMAP.md Queue A items 11 and 13).

`policy` is imported lazily: it pulls in the solver tree, while `status`
and `faultinject` are dependency-free and imported by low layers
(ops/spmv.py, solvers/base.py).
"""
from __future__ import annotations

from . import faultinject  # noqa: F401
from .status import SolveStatus, status_string  # noqa: F401


def __getattr__(name):
    if name in ("policy", "ResilientSolver", "parse_fallback_policy",
                "parse_service_policy", "parse_fleet_policy"):
        # import_module, not `from . import policy`: the latter asks this
        # hook for `policy` again before the submodule is bound
        import importlib
        policy = importlib.import_module(__name__ + ".policy")
        if name == "policy":
            return policy
        return getattr(policy, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
