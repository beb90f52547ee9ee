"""The serving warm-start store (the port's counterpart of
amgx_tpu/serving/aot.py, under the same API: `key`, `save_bundle`,
`load_meta`, `load_bundle`).

The JAX package exports each bucket's traced engine functions with
`jax.export` so a restarted service skips the first request's trace.
The port traces and compiles no solve program: a bucket's functions are
the solver's own Python over tensors. What a restarted bucket build
would otherwise redo is persisted instead:

- the per-slot / shared split of the solve-data leaves, which a cold
  build discovers with a probe value resetup (`BucketEngine._split_data`):
  one flag a leaf, with the leaf count, shapes and dtypes to check the
  restored tree against;
- the bucket's widths, dtype and history length;
- the CUDA libraries the bucket launched (ops/cuda_build.py `LOADED`),
  which the restarted build loads before it admits, so no first request
  waits on building or loading a kernel library.

No code is pickled and nothing is compiled: a bundle is one JSON
document behind a digest of its bytes. Keys digest the parts the engine
passes (pattern fingerprint, bucket geometry, solver config) with the
torch version and the bucket's device type, so a bundle of another
installation misses. A missing, corrupt or mismatched bundle loads as
None and the engine builds cold (probe resetup, `serving.retrace`); a
failed save is counted in `serving.aot.error` and never fails a build.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from ..profiling import trace_region


def _digest(parts) -> str:
    import torch
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((tuple(parts), torch.__version__)).encode())
    return h.hexdigest()


class AotStore:
    """Directory-backed store of bucket warm-start bundles."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.bundle")

    def key(self, parts: Sequence[Any]) -> str:
        return _digest(parts)

    # -- save -------------------------------------------------------------
    def save_bundle(self, key: str, fns: Dict[str, Any],
                    meta: Dict[str, Any]) -> bool:
        """Persist one bucket's bundle: `fns` maps section names to JSON
        values (the leaf split, the libraries), `meta` the geometry.
        Atomic (tmp + rename); a failure removes the partial file and
        reports False (`serving.aot.error`)."""
        from ..resilience import faultinject as _fi
        from ..telemetry import metrics as _tm
        path = self._path(key)
        try:
            with trace_region("serving.aot_export"):
                body = json.dumps({"meta": meta, "fns": fns},
                                  sort_keys=True).encode()
                blob = hashlib.blake2b(body, digest_size=16).hexdigest() \
                    .encode() + b"\n" + body
                # chaos torn-write drill: damage lands on disk, the load
                # path must detect it and build cold
                blob = _fi.corrupt_blob("aot_corrupt", blob)
                with open(path + ".tmp", "wb") as f:
                    f.write(blob)
                os.replace(path + ".tmp", path)
            _tm.inc("serving.aot.export")
            return True
        except Exception:
            _tm.inc("serving.aot.error")
            for p in (path, path + ".tmp"):
                try:
                    os.remove(p)
                except OSError:
                    pass
            return False

    # -- load -------------------------------------------------------------
    def _read(self, key: str) -> Optional[Dict[str, Any]]:
        """The bundle's document, or None (missing); raises on a digest
        mismatch or an unreadable body."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            blob = f.read()
        head, _, body = blob.partition(b"\n")
        if hashlib.blake2b(body, digest_size=16).hexdigest().encode() \
                != head:
            raise ValueError("warm-start bundle digest mismatch")
        doc = json.loads(body.decode())
        if not isinstance(doc.get("meta"), dict) \
                or not isinstance(doc.get("fns"), dict):
            raise ValueError("malformed warm-start bundle")
        return doc

    def load_meta(self, key: str) -> Optional[Dict[str, Any]]:
        try:
            doc = self._read(key)
        except Exception:
            return None
        return None if doc is None else doc["meta"]

    def load_bundle(self, key: str, names: List[str]):
        """`{name: section, ..., "meta": meta}` for a complete bundle, or
        None (missing / corrupt / without one of `names`: the engine then
        builds cold). A corrupt bundle counts `serving.aot.error`."""
        from ..telemetry import metrics as _tm
        try:
            with trace_region("serving.aot_load"):
                doc = self._read(key)
                if doc is None:
                    return None
                out = {name: doc["fns"][name] for name in names}
        except Exception:
            _tm.inc("serving.aot.error")
            return None
        _tm.inc("serving.aot.load")
        out["meta"] = doc["meta"]
        return out
