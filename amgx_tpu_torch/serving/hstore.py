"""Persistent hierarchy structures (the crash-recovery setup store; the
port of amgx_tpu/serving/hstore.py on the port's `structure_snapshot` /
`structure_restore`).

A killed serving process loses every live AMG hierarchy, and a restart
pays the full setup per pattern before the first byte of useful work.
But the hierarchy STRUCTURE -- aggregates maps, CF splits, transfer
operators, grid pairings -- is deterministic from the sparsity pattern,
so it can live on disk next to the warm-start store: `HierarchyStore` persists
each level's `structure_snapshot()` keyed on (pattern fingerprint,
solver-config signature), and a restarted service restores it as
'ghost' levels that `AMG.adopt_structure` routes through the
structure-reuse rebuild -- Galerkin values + smoother setups only, no
coarsening selection -- turning the restart setup into a load +
value-resetup (amg.setup.restored, never amg.setup.full).

Failure model matches the warm-start store: saves are atomic (tmp + rename),
a missing/corrupt/mismatched snapshot loads as None and the caller
does a full setup -- the store can only ever make a restart cheaper,
never wrong (restored hierarchies still recompute every value from the
actual matrix).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, List, Optional

import numpy as np

from ..profiling import trace_region


def _amg_nodes(root) -> List[Any]:
    """The AMG hierarchy objects inside a solver tree, in deterministic
    construction order: unwraps ResilientSolver-style `.solver`
    wrappers and descends `.preconditioner` children. Reads instance
    __dict__ directly so `__getattr__`-delegating wrappers cannot
    surface the same node twice."""
    out: List[Any] = []

    def walk(s):
        if s is None:
            return
        d = getattr(s, "__dict__", None)
        if d is None:
            return
        wrapped = d.get("solver")
        if wrapped is not None:
            walk(wrapped)
        amg = d.get("amg")
        if amg is not None and hasattr(amg, "levels"):
            out.append(amg)
        walk(d.get("preconditioner"))

    walk(root)
    return out


class HierarchyStore:
    """Directory-backed store of per-pattern hierarchy structure
    snapshots (see module docs)."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def key(self, fingerprint: str, cfg) -> str:
        # the config signature is part of the key: selector, strength,
        # max_levels, ... all shape the structure, so a config edit +
        # restart must MISS the store and re-coarsen. serving_* and
        # autotune* knobs are excluded -- they are consumed by the
        # service layer only (queue bounds, store paths, checkpoint
        # cadence, tuner thresholds) and can never influence
        # coarsening, so relocating a journal dir or retuning the shed
        # policy must NOT invalidate every persisted hierarchy (the JAX
        # package's key, so both packages key a pattern alike)
        h = hashlib.blake2b(digest_size=16)
        vals = tuple(sorted((k, v) for k, v in cfg.values.items()
                            if not k[1].startswith(("serving_",
                                                    "autotune"))))
        h.update(repr((str(fingerprint), vals,
                       tuple(sorted(cfg.param_scopes.items())))).encode())
        return h.hexdigest()

    def _paths(self, key: str):
        base = os.path.join(self.directory, key)
        return base + ".hier.json", base + ".hier.npz"

    # -- save -------------------------------------------------------------
    def save(self, key: str, solver_root) -> bool:
        """Snapshot every AMG node's level structures under `key`.
        Skipped (False, serving.recovery.hstore_skip) when any level
        class declines persistence; failures degrade to not-saved."""
        from ..resilience import faultinject as _fi
        from ..telemetry import metrics as _tm
        nodes = _amg_nodes(solver_root)
        if not nodes:
            return False
        metas, arrays = [], {}
        for ni, amg in enumerate(nodes):
            lvls = []
            if not amg.levels:
                _tm.inc("serving.recovery.hstore_skip")
                return False
            for li, level in enumerate(amg.levels):
                snap = level.structure_snapshot()
                if snap is None:
                    _tm.inc("serving.recovery.hstore_skip")
                    return False
                meta, arrs = snap
                meta = dict(meta)
                meta["algorithm"] = type(level).algorithm
                lvls.append(meta)
                for name, arr in arrs.items():
                    arrays[f"n{ni}.L{li}.{name}"] = np.asarray(arr)
            metas.append(lvls)
        jpath, npath = self._paths(key)
        try:
            with trace_region("serving.hstore_save"):
                buf = io.BytesIO()
                np.savez(buf, **arrays)
                blob = _fi.corrupt_blob("aot_corrupt", buf.getvalue())
                with open(npath + ".tmp", "wb") as f:
                    f.write(blob)
                os.replace(npath + ".tmp", npath)
                with open(jpath + ".tmp", "w") as f:
                    json.dump({"nodes": metas}, f)
                os.replace(jpath + ".tmp", jpath)
            _tm.inc("serving.recovery.hstore_save")
            return True
        except Exception:
            _tm.inc("serving.recovery.hstore_error")
            for p in (jpath, npath):
                try:
                    os.remove(p)
                except OSError:
                    pass
            return False

    # -- load -------------------------------------------------------------
    def load(self, key: str) -> Optional[List[List[Any]]]:
        """Ghost-level lists (one per AMG node, construction order) for
        a complete snapshot, or None (missing/corrupt/unknown level
        class -- the caller then runs a full setup)."""
        from .. import registry
        from ..telemetry import metrics as _tm
        jpath, npath = self._paths(key)
        if not os.path.exists(jpath) or not os.path.exists(npath):
            return None
        try:
            with trace_region("serving.hstore_load"):
                with open(jpath) as f:
                    metas = json.load(f)["nodes"]
                with open(npath, "rb") as f:
                    data = np.load(io.BytesIO(f.read()))
                out = []
                for ni, lvls in enumerate(metas):
                    ghosts = []
                    for li, meta in enumerate(lvls):
                        cls = registry.amg_levels.get(meta["algorithm"])
                        prefix = f"n{ni}.L{li}."
                        arrs = {k[len(prefix):]: data[k] for k in data.files
                                if k.startswith(prefix)}
                        ghosts.append(cls.structure_restore(meta, arrs))
                    out.append(ghosts)
            _tm.inc("serving.recovery.hstore_load")
            return out
        except Exception:
            _tm.inc("serving.recovery.hstore_error")
            return None

    def restore_into(self, key: str, solver_root) -> bool:
        """Load `key` and adopt the ghost levels into the tree's AMG
        nodes (their next setup() becomes a structure-reuse rebuild).
        False when the snapshot is absent/corrupt or the node count
        drifted -- the tree is left untouched and sets up fully."""
        ghosts = self.load(key)
        if ghosts is None:
            return False
        nodes = _amg_nodes(solver_root)
        if len(nodes) != len(ghosts):
            return False
        for amg, g in zip(nodes, ghosts):
            amg.adopt_structure(g)
        return True
