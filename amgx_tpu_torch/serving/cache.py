"""Bytes-budgeted LRU for hierarchy-holding entries (the port of
amgx_tpu/serving/cache.py).

A long-running solve service keyed on pattern fingerprints accumulates
one AMG hierarchy (plus its stacked solve data) per distinct sparsity
pattern it has ever seen. Each of those is worth keeping -- a cache hit
routes a repeat-pattern request through the value-resetup path instead
of a full setup -- but the store must be bounded in the unit that
actually runs out: device bytes, not entry count. This LRU tracks an
estimated byte footprint per entry (``solve_data_bytes``: the
solve-data tree's unique tensor storages), evicts least-recently-used
entries past the budget, and never evicts an entry its owner marks
busy (a serving bucket with in-flight systems).

Used by the serving layer's bucket store (serving/service.py).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import torch


def _tensors(node):
    """Every tensor in a solve-data tree (dicts, lists, tuples,
    dataclasses such as CsrMatrix and StencilOperator, tensors)."""
    if torch.is_tensor(node):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _tensors(getattr(node, f.name))


def solve_data_bytes(obj: Any) -> int:
    """Estimated device footprint of a solver/engine: the bytes of the
    UNIQUE tensor storages in its solve-data tree. A storage counts
    once however many leaves view it (a stacked leaf and its rows, an
    operator every level view refers to, shared structure). `obj` may be
    a solver tree (anything with solve_data()), an already-built tree,
    or an object exposing `footprint_tree()`."""
    tree = obj
    if hasattr(obj, "footprint_tree"):
        tree = obj.footprint_tree()
    elif hasattr(obj, "solve_data"):
        tree = obj.solve_data()
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        key = (t.device, st.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        total += int(st.nbytes())
    return total


class HierarchyCache:
    """LRU of fingerprint -> entry with a byte budget (see module docs).

    `budget_bytes=0` and/or `max_entries=0` disable that bound. The
    optional `counters` dict maps the events 'hit'/'miss'/'evict' to
    declared telemetry counter names and 'bytes'/'entries' to gauges;
    unset events are simply not reported (the class stays importable
    without the telemetry catalog)."""

    def __init__(self, budget_bytes: int = 0, max_entries: int = 0,
                 counters: Optional[Dict[str, str]] = None,
                 can_evict: Optional[Callable[[Any], bool]] = None,
                 on_evict: Optional[Callable[[str, Any], None]] = None):
        self.budget_bytes = int(budget_bytes)
        self.max_entries = int(max_entries)
        self.counters = dict(counters or {})
        self.can_evict = can_evict
        self.on_evict = on_evict
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._bytes: Dict[str, int] = {}
        self.evictions = 0

    def _report(self, event: str, value=1):
        name = self.counters.get(event)
        if not name:
            return
        from ..telemetry import metrics as _tm
        if event in ("bytes", "entries"):
            _tm.set_gauge(name, value)
        else:
            _tm.inc(name, value)

    def _gauges(self):
        self._report("bytes", self.total_bytes)
        self._report("entries", len(self._entries))

    # -- mapping surface --------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries)

    @property
    def total_bytes(self) -> int:
        return sum(self._bytes.values())

    def get(self, key: str):
        """LRU-touching lookup; counts a hit or a miss."""
        entry = self._entries.get(key)
        if entry is None:
            self._report("miss")
            return None
        self._entries.move_to_end(key)
        self._report("hit")
        return entry

    def peek(self, key: str):
        """Lookup without touching LRU order or hit/miss counters."""
        return self._entries.get(key)

    def put(self, key: str, entry: Any, nbytes: int = 0):
        """Insert/replace, then evict LRU entries past the budgets."""
        self._entries[key] = entry
        self._entries.move_to_end(key)
        self._bytes[key] = int(nbytes)
        self.evict_to_budget()
        self._gauges()

    def set_bytes(self, key: str, nbytes: int):
        if key in self._entries:
            self._bytes[key] = int(nbytes)
            self._gauges()

    def pop(self, key: str):
        entry = self._entries.pop(key, None)
        self._bytes.pop(key, None)
        self._gauges()
        return entry

    def evict_to_budget(self):
        """Evict least-recently-used evictable entries until both
        budgets hold. Two classes of entry are never evicted: busy
        ones (can_evict -> False -- a bucket with in-flight systems
        must never vanish under the scheduler) and the most recently
        used one (evicting the entry a caller just inserted or touched
        would thrash: one oversized hierarchy must still be servable
        under any byte budget). A cache reduced to protected entries
        may legitimately exceed the budget until they drain."""
        def over():
            return ((self.budget_bytes > 0
                     and self.total_bytes > self.budget_bytes)
                    or (self.max_entries > 0
                        and len(self._entries) > self.max_entries))

        while over() and len(self._entries) > 1:
            victim = None
            newest = next(reversed(self._entries))
            for key, entry in self._entries.items():   # oldest first
                if key == newest:
                    continue
                if self.can_evict is None or self.can_evict(entry):
                    victim = key
                    break
            if victim is None:
                break
            entry = self._entries.pop(victim)
            self._bytes.pop(victim, None)
            self.evictions += 1
            self._report("evict")
            if self.on_evict is not None:
                self.on_evict(victim, entry)
        self._gauges()
