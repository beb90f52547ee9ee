"""Durable solve journal: request records + solve checkpoints (a copy of
amgx_tpu/serving/journal.py on the port's matrices).

A killed serving process must not lose in-flight work. The journal is
the service's write-ahead record of every submitted request (matrix
values + rhs + tenant/deadline metadata, with the sparsity pattern
deduplicated per fingerprint) plus periodic CHECKPOINTS of the chunked
solve state (serving/engine.py carries it as a flat dict of tensors;
a per-slot row is written from `.cpu().numpy()` and restored bit for
bit). A restarted service
replays the journal: pending requests are re-admitted, and one that
was checkpointed resumes from its saved iterate -- the resumed solve
visits bit-identical iterates to an uninterrupted run, because the
chunked entry (`Solver._build_chunk_fns`) is resumable across host
boundaries by construction.

Completed requests keep their result in the journal (bounded by
`prune`) so a client retrying a submit after a dropped response -- the
`request_key` idempotency contract -- gets the recorded result back
instead of a second solve.

Failure model: every record write is atomic (tmp + rename) and every
read is corruption-tolerant -- a torn/corrupt record is dropped (and
counted, serving.recovery.journal_corrupt), never replayed wrong and
never allowed to wedge recovery of the records around it.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..matrix import CsrMatrix
from ..profiling import trace_region

_CKPT_PREFIX = "state."


def _host(t) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    import torch
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _pattern(A: CsrMatrix) -> Dict[str, np.ndarray]:
    """The pattern record of a matrix: its index arrays and shape."""
    pat = {"row_offsets": _host(A.row_offsets),
           "col_indices": _host(A.col_indices),
           "shape_meta": np.asarray([A.num_rows, A.num_cols], np.int64)}
    if A.grid_shape is not None:
        pat["grid_shape"] = np.asarray(A.grid_shape, np.int64)
    return pat


def _matrix(pat: Dict[str, np.ndarray], values: np.ndarray) -> CsrMatrix:
    """A host CsrMatrix rebuilt from a pattern record and its values."""
    import torch
    nr, nc = (int(v) for v in pat["shape_meta"][:2])
    gs = pat.get("grid_shape")
    return CsrMatrix(
        row_offsets=torch.from_numpy(np.asarray(pat["row_offsets"])),
        col_indices=torch.from_numpy(np.asarray(pat["col_indices"])),
        values=torch.from_numpy(np.asarray(values)),
        num_rows=nr, num_cols=nc,
        grid_shape=None if gs is None else tuple(int(v) for v in gs)
    ).init()


def _fp_digest(fingerprint: str) -> str:
    return hashlib.blake2b(str(fingerprint).encode(),
                           digest_size=12).hexdigest()


class SolveJournal:
    """Directory-backed request journal (see module docs)."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        # guards _seq allocation and the _index/_keys maps: submit()
        # journals from caller threads while the scheduler records
        # completions -- an unsynchronized _seq would mint duplicate
        # ids and silently overwrite one request's record with
        # another's
        self._lock = threading.Lock()
        # meta index built once per open: id -> record dict; corrupt
        # json records are dropped (counted at replay, where it is an
        # actual loss, not here at bookkeeping time)
        self._index: Dict[str, Dict[str, Any]] = {}
        self._keys: Dict[str, str] = {}
        seqs = [0]
        for name in sorted(os.listdir(self.directory)):
            if not (name.startswith("req-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    meta = json.load(f)
                jid = meta["id"]
            except Exception:
                continue
            self._index[jid] = meta
            if meta.get("key"):
                self._keys[meta["key"]] = jid
            seqs.append(int(meta.get("seq", 0)))
        self._seq = max(seqs) + 1

    # -- paths ------------------------------------------------------------
    def _jpath(self, jid: str, ext: str) -> str:
        return os.path.join(self.directory, f"req-{jid}.{ext}")

    def _ppath(self, fingerprint: str) -> str:
        return os.path.join(self.directory,
                            f"pattern-{_fp_digest(fingerprint)}.npz")

    def _wpath(self, fingerprint: str) -> str:
        return os.path.join(self.directory,
                            f"workload-{_fp_digest(fingerprint)}.npz")

    def _write_npz(self, path: str, arrays: Dict[str, np.ndarray]):
        """Atomic npz write, through the chaos corruption hook (the
        torn-write drill: damage lands on disk, detection is the
        reader's job)."""
        from ..resilience import faultinject as _fi
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = _fi.corrupt_blob("journal_corrupt", buf.getvalue())
        with open(path + ".tmp", "wb") as f:
            f.write(blob)
        os.replace(path + ".tmp", path)

    def _write_json(self, path: str, obj: Dict[str, Any]):
        with open(path + ".tmp", "w") as f:
            json.dump(obj, f)
        os.replace(path + ".tmp", path)

    @staticmethod
    def _read_npz(path: str) -> Optional[Dict[str, np.ndarray]]:
        try:
            with open(path, "rb") as f:
                data = np.load(io.BytesIO(f.read()), allow_pickle=False)
            return {k: data[k] for k in data.files}
        except Exception:
            return None

    # -- write path --------------------------------------------------------
    def record_submit(self, *, fingerprint: str, tenant: str,
                      A: CsrMatrix, b: np.ndarray,
                      x0: Optional[np.ndarray],
                      deadline_remaining_s: Optional[float],
                      request_key: Optional[str],
                      trace_id: Optional[str] = None) -> str:
        """Persist one request; returns its journal id. The pattern
        (index arrays + shape metadata) is written once per
        fingerprint, the per-request record holds only values/rhs.
        `trace_id` is the request's span-flow trace id: persisting it
        is what lets a crash-recovered resume tag its spans with the
        ORIGINAL trace (one connected Perfetto chain across both
        service incarnations) and lets tools/flightrec.py join the
        flight-recorder trail to journal records."""
        with self._lock:
            seq, self._seq = self._seq, self._seq + 1
        jid = f"{seq:08d}"
        ppath = self._ppath(fingerprint)
        if not os.path.exists(ppath):
            self._write_npz(ppath, _pattern(A))
        arrays = {"values": _host(A.values), "b": _host(b)}
        if x0 is not None:
            arrays["x0"] = np.asarray(x0)
        self._write_npz(self._jpath(jid, "npz"), arrays)
        meta = {"id": jid, "seq": seq, "key": request_key or None,
                "tenant": str(tenant), "fingerprint": str(fingerprint),
                "deadline_remaining_s": deadline_remaining_s,
                "trace": trace_id or None,
                "status": "pending"}
        self._write_json(self._jpath(jid, "json"), meta)
        with self._lock:
            self._index[jid] = meta
            if request_key:
                self._keys[request_key] = jid
        return jid

    def record_checkpoint(self, jid: str,
                          state_row: Dict[str, np.ndarray],
                          deadline_remaining_s: Optional[float]):
        """Snapshot one in-flight slot's solve state at a cycle
        boundary (the resumable chunk state: iterate, residual, norms,
        history, iteration counter -- whatever the solver carries)."""
        from ..telemetry import metrics as _tm
        arrays = {_CKPT_PREFIX + k: _host(v)
                  for k, v in state_row.items()}
        if deadline_remaining_s is not None:
            arrays["deadline_remaining_s"] = np.asarray(
                float(deadline_remaining_s))
        self._write_npz(self._jpath(jid, "ckpt.npz"), arrays)
        _tm.inc("serving.recovery.checkpoints")

    def record_done(self, jid: str, x: np.ndarray, status_code: int,
                    iterations: int):
        """Mark a request terminal and keep its result for request_key
        dedupe of retried submits."""
        with self._lock:
            meta = self._index.get(jid)
        if meta is None:
            return
        self._write_npz(self._jpath(jid, "done.npz"),
                        {"x": _host(x),
                         "status_code": np.asarray(int(status_code)),
                         "iterations": np.asarray(int(iterations))})
        meta = dict(meta)
        meta["status"] = "done"
        self._write_json(self._jpath(jid, "json"), meta)
        with self._lock:
            self._index[jid] = meta
        for ext in ("npz", "ckpt.npz"):
            try:
                os.remove(self._jpath(jid, ext))
            except OSError:
                pass

    def save_workload(self, fingerprint: str, A: CsrMatrix,
                      b: np.ndarray):
        """Retain ONE (values, rhs) sample per fingerprint -- the
        autotuner's shadow-solve input. Per-request records are
        deleted at record_done (the journal is a crash log, not an
        archive), so the tuner's workload persists separately: one
        bounded file per fingerprint, overwritten by newer samples,
        riding the pattern file record_submit already deduplicates.
        Best-effort: a failed write only costs the tuner its
        restart-surviving workload, never the journal's guarantees."""
        try:
            ppath = self._ppath(fingerprint)
            if not os.path.exists(ppath):
                self._write_npz(ppath, _pattern(A))
            self._write_npz(self._wpath(fingerprint),
                            {"values": _host(A.values), "b": _host(b)})
        except Exception:
            pass

    def load_workload(self, fingerprint: str
                      ) -> Optional[Tuple[CsrMatrix, np.ndarray]]:
        """The retained (A, b) workload sample for a fingerprint, or
        None (never saved / corrupt -- corruption-tolerant like every
        journal read)."""
        pat = self._read_npz(self._ppath(fingerprint))
        wl = self._read_npz(self._wpath(fingerprint))
        if pat is None or wl is None or "row_offsets" not in pat \
                or "values" not in wl or "b" not in wl:
            return None
        try:
            A = _matrix(pat, wl["values"])
        except Exception:
            return None
        return A, wl["b"]

    # -- read path ---------------------------------------------------------
    def lookup_key(self, request_key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            jid = self._keys.get(request_key)
            return self._index.get(jid) if jid else None

    def load_result(self, jid: str):
        """(x, status_code, iterations) of a done record, or None."""
        data = self._read_npz(self._jpath(jid, "done.npz"))
        if data is None or "x" not in data:
            return None
        return (data["x"], int(data["status_code"]),
                int(data["iterations"]))

    def pending(self) -> List[Dict[str, Any]]:
        """Pending records in submit order (the replay list)."""
        with self._lock:
            recs = [m for m in self._index.values()
                    if m.get("status") == "pending"]
        return sorted(recs, key=lambda m: int(m.get("seq", 0)))

    def load_request(self, meta: Dict[str, Any]
                     ) -> Optional[Tuple[CsrMatrix, np.ndarray,
                                         Optional[np.ndarray],
                                         Optional[Dict[str, np.ndarray]],
                                         Optional[float]]]:
        """Rebuild one journaled request: (A, b, x0, checkpoint_state,
        deadline_remaining_s). None when the pattern or request record
        is corrupt (counted; the caller skips it). A corrupt CHECKPOINT
        only loses the resume point -- the request restarts clean."""
        from ..telemetry import metrics as _tm
        with trace_region("serving.recover"):
            ppath = self._ppath(meta["fingerprint"])
            pat = self._read_npz(ppath)
            req = self._read_npz(self._jpath(meta["id"], "npz"))
            if pat is None or "row_offsets" not in pat:
                # SELF-HEAL: a corrupt pattern file would otherwise
                # poison every future record of this fingerprint
                # (record_submit skips existing pattern files) -- drop
                # it so the next submit rewrites a clean one
                try:
                    os.remove(ppath)
                except OSError:
                    pass
                pat = None
            if pat is None or req is None \
                    or "values" not in req or "b" not in req:
                _tm.inc("serving.recovery.journal_corrupt")
                return None
            try:
                A = _matrix(pat, req["values"])
            except Exception:
                _tm.inc("serving.recovery.journal_corrupt")
                return None
            ckpt = self._read_npz(self._jpath(meta["id"], "ckpt.npz"))
            remaining = meta.get("deadline_remaining_s")
            state = None
            if ckpt is not None:
                state = {k[len(_CKPT_PREFIX):]: v
                         for k, v in ckpt.items()
                         if k.startswith(_CKPT_PREFIX)}
                if not state:
                    state = None
                if "deadline_remaining_s" in ckpt:
                    remaining = float(ckpt["deadline_remaining_s"])
            return (A, req["b"], req.get("x0"), state,
                    None if remaining is None else float(remaining))

    def load_checkpoint(self, jid: str
                        ) -> Tuple[Optional[Dict[str, np.ndarray]],
                                   Optional[float]]:
        """(checkpoint_state, deadline_remaining_s) for one pending
        record -- the fleet-failover path: a survivor adopting a dead
        replica's LIVE in-flight ticket needs only the resume point
        (it already holds A/b/x0 on the ticket object), not the full
        load_request rebuild. A missing/corrupt checkpoint returns
        (None, submit-time remaining): the solve restarts clean with
        its original budget."""
        with self._lock:
            meta = self._index.get(jid)
        remaining = None if meta is None \
            else meta.get("deadline_remaining_s")
        ckpt = self._read_npz(self._jpath(jid, "ckpt.npz"))
        state = None
        if ckpt is not None:
            state = {k[len(_CKPT_PREFIX):]: v
                     for k, v in ckpt.items()
                     if k.startswith(_CKPT_PREFIX)}
            if not state:
                state = None
            if "deadline_remaining_s" in ckpt:
                remaining = float(ckpt["deadline_remaining_s"])
        return state, (None if remaining is None else float(remaining))

    # -- maintenance -------------------------------------------------------
    def forget(self, jid: str):
        """Drop one record entirely (corrupt-record cleanup)."""
        with self._lock:
            meta = self._index.pop(jid, None)
            if meta and meta.get("key"):
                self._keys.pop(meta["key"], None)
        for ext in ("json", "npz", "ckpt.npz", "done.npz"):
            try:
                os.remove(self._jpath(jid, ext))
            except OSError:
                pass

    def prune(self, keep_done: int = 256):
        """Bound the done-record history (oldest dropped first); the
        journal must not grow without bound under steady traffic.
        Called by the service at recovery and on a periodic scheduler
        cadence."""
        with self._lock:
            done = sorted((m for m in self._index.values()
                           if m.get("status") == "done"),
                          key=lambda m: int(m.get("seq", 0)))
        for meta in done[:max(0, len(done) - keep_done)]:
            self.forget(meta["id"])
