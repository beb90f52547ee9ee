"""Factory registries (from amgx_tpu/registry.py).

The reference's backbone is a set of static string-keyed factories
(SolverFactory, CycleFactory, selectors, ... registered in
src/core.cu:546-691): one generic `Factory` class plus a registry for
each pluggable kind the port has so far. Components self-register at
import time via decorators.
"""
from __future__ import annotations

from typing import Callable, Dict

from .errors import BadParametersError, did_you_mean


class Factory:
    """A named registry of constructors for one component kind."""

    def __init__(self, kind: str):
        self.kind = kind
        self._ctors: Dict[str, Callable] = {}

    def register(self, name: str):
        """Class decorator: `@factory.register("NAME")`."""
        def deco(c):
            self._ctors[name.upper()] = c
            return c
        return deco

    def get(self, name: str) -> Callable:
        try:
            return self._ctors[name.upper()]
        except KeyError:
            raise BadParametersError(
                f"{self.kind} factory: unknown name {name!r}"
                f"{did_you_mean(name.upper(), self._ctors)}; "
                f"registered: {sorted(self._ctors)}") from None

    def has(self, name: str) -> bool:
        return name.upper() in self._ctors

    def create(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)


solvers = Factory("Solver")
amg_levels = Factory("AMG_Level")
aggregation_selectors = Factory("AggregationSelector")
convergence = Factory("Convergence")
strength = Factory("Strength")
classical_selectors = Factory("ClassicalSelector")
interpolators = Factory("Interpolator")
