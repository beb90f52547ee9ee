"""Online per-fingerprint config autotuner (the port of
amgx_tpu/serving/autotune.py).

A mistuned client config burns capacity on every repeat of its
operator, and nobody hand-retunes client configs at serving scale.
`ConfigAutotuner` turns the diagnostics probe into an automatic,
measured, reversible search:

1. WATCH -- every completed request feeds per-fingerprint tallies
   (request count + share of total in-bucket exec seconds). A
   fingerprint crossing BOTH `autotune_hot_requests` and
   `autotune_hot_exec_share` becomes a search target; its most recent
   (matrix, rhs) is captured as the shadow workload (and retained in
   the journal's per-fingerprint workload sample when one is
   configured, so a restarted replica can keep searching).
2. GENERATE -- one shadow BASELINE solve of the production config with
   `diagnostics=1` overlaid runs the probe cycle; its bottleneck level
   / per-level reduction factors map to concrete config deltas through
   `telemetry.diagnostics.suggest_config_deltas`: smoother swap,
   relaxation re-damp, strength threshold, interpolation + truncation,
   cycle shape, `solve_precision`.
3. SHADOW -- each candidate is solved OFF the production path, against
   the captured workload, only when the service has idle capacity
   (empty queue AND nothing in flight). Each run is measured
   (iterations x solve wall of a warm second solve, so the first use's
   kernel builds and library handles never pollute the comparison),
   spanned (`autotune.shadow`), and bounded by `autotune_shadow_budget`
   per fingerprint. The wall is read by `_shadow_clock`, which waits
   for the card's queued work (`torch.cuda.synchronize`) before it
   reads the host clock: without the wait the score would time kernel
   launches, not the solve. A crashed shadow is absorbed: counted
   (`autotune.shadow.errors`), backed off, and can never fail a ticket.
4. PROMOTE -- the best converged candidate wins only if it beats the
   baseline score by `autotune_min_improvement` AND wins iterations
   and wall outright (hysteresis: noise cannot promote). The deltas
   become the fingerprint's serving overlay -- the next bucket build
   clones the service config, applies them, and (the engine's normal
   machinery) re-keys the hstore / warm-start entries; the idle bucket
   is retired so the win takes effect now, not at natural eviction.
   The record persists via `HierarchyStore.save_tuned` keyed by
   fingerprint alone, so a restarted replica resolves the overlay
   BEFORE its first build and serves the tuned config from the first
   request with zero full setups.
5. DEMOTE -- post-promotion, live exec medians are watched: a
   regression past `autotune_demote_factor` over
   `autotune_demote_window` completions drops the overlay, deletes
   the persisted record and retires the bucket.

Every generate/shadow/promote/demote decision lands on the flight
recorder tagged with a per-search trace id. `autotune=0` (the default)
never constructs this class: the serving path runs the same kernels
and host reads as a service without the tuner.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import Config
from ..resilience import faultinject as _fi
from ..telemetry import flightrec as _fr
from ..telemetry import metrics as _tm
from ..telemetry import spans as _spans

# phases of one fingerprint's tuner lifecycle
_WATCH = "watch"          # tallying; not hot yet
_HOT = "hot"              # crossed thresholds; baseline probe pending
_SEARCH = "search"        # candidates generated; shadows pending
_PROMOTED = "promoted"    # overlay live; demote watch running
_EXHAUSTED = "exhausted"  # budget spent / no win / backed off -- done
_DEMOTED = "demoted"      # regressed after promotion -- done


def _shadow_clock(device) -> float:
    """The host clock once the device's queued work has finished: a
    shadow solve's wall is the difference of two readings."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _median(seq) -> Optional[float]:
    vals = sorted(float(v) for v in seq)
    if not vals:
        return None
    return vals[len(vals) // 2]


class ConfigAutotuner:
    """Per-service online tuner (see module docs). Constructed by
    `SolveService` iff `autotune=1`; `note_finish` is the only method
    called under the service lock (dict/deque bookkeeping only), all
    shadow work runs from `maybe_step` at the scheduler cycle's
    off-lock tail."""

    def __init__(self, service):
        self.svc = service
        cfg, scope = service.cfg, service.scope
        self.hot_requests = int(
            cfg.get("autotune_hot_requests", scope))
        self.hot_share = float(
            cfg.get("autotune_hot_exec_share", scope))
        self.shadow_budget = int(
            cfg.get("autotune_shadow_budget", scope))
        self.min_improvement = float(
            cfg.get("autotune_min_improvement", scope))
        self.demote_factor = float(
            cfg.get("autotune_demote_factor", scope))
        self.demote_window = int(
            cfg.get("autotune_demote_window", scope))
        # guards _fp: note_finish mutates under the SERVICE lock while
        # maybe_step reads/mutates off it -- the tuner needs its own
        self._lock = threading.Lock()
        self._fp: Dict[str, Dict[str, Any]] = {}
        self._total_exec = 0.0
        # drain quiesce: while set, maybe_step schedules NO shadow
        # work (in-flight inline shadows finish their current solve;
        # they are not production work, so drain never waits on them)
        self._quiesced = False

    # -- bookkeeping (service lock held) ----------------------------------
    def _ensure(self, fp: str) -> Dict[str, Any]:
        rec = self._fp.get(fp)
        if rec is None:
            import collections
            rec = {
                "requests": 0, "exec_s": 0.0, "phase": _WATCH,
                "sample": None, "workload_saved": False,
                "budget": self.shadow_budget,
                "candidates": [], "results": [],
                "baseline": None, "overlay": None, "knob": None,
                "trace": None, "errors": 0, "not_before": 0.0,
                "pre_exec": None, "restored": False, "retire": False,
                "hstore_checked": False,
                "post": collections.deque(maxlen=self.demote_window),
            }
            self._fp[fp] = rec
        return rec

    def note_finish(self, ticket, exec_s: float):
        """One completed in-bucket request (called from _finish, under
        the service lock -- tallies and sample capture only)."""
        with self._lock:
            rec = self._ensure(ticket.fingerprint)
            rec["requests"] += 1
            rec["exec_s"] += float(exec_s)
            self._total_exec += float(exec_s)
            if rec["phase"] == _PROMOTED:
                rec["post"].append(float(exec_s))
            elif rec["phase"] in (_WATCH, _HOT, _SEARCH) \
                    and ticket.A is not None:
                # the freshest workload sample: references only (the
                # arrays already live on the ticket)
                rec["sample"] = (ticket.A, ticket.b)

    # -- overlay resolution (engine-build path, off the service lock) ------
    def overlay_for(self, fingerprint: str
                    ) -> Optional[List[Dict[str, Any]]]:
        """The promoted config deltas for a fingerprint, or None. A
        cold fingerprint consults the hstore ONCE (restart durability:
        the persisted record resolves before the first build) and
        caches the answer either way."""
        with self._lock:
            rec = self._fp.get(fingerprint)
            if rec is not None:
                if rec["overlay"] is not None:
                    return [dict(d) for d in rec["overlay"]]
                if rec["hstore_checked"]:
                    return None
        hs = self.svc.hstore
        tuned = hs.load_tuned(fingerprint) if hs is not None else None
        with self._lock:
            rec = self._ensure(fingerprint)
            rec["hstore_checked"] = True
            if rec["overlay"] is not None:    # raced a live promotion
                return [dict(d) for d in rec["overlay"]]
            if tuned is None:
                return None
            rec["overlay"] = [dict(d) for d in tuned["deltas"]]
            rec["knob"] = tuned.get("knob")
            rec["phase"] = _PROMOTED
            rec["restored"] = True
        _tm.inc("autotune.overlay.restored")
        _fr.record("autotune.restore", trace=tuned.get("trace"),
                   fingerprint=fingerprint[:24],
                   knob=tuned.get("knob"),
                   deltas=self._fmt_deltas(tuned["deltas"]))
        return [dict(d) for d in tuned["deltas"]]

    @staticmethod
    def _fmt_deltas(deltas) -> str:
        return ",".join(f"{d['param']}={d['value']}" for d in deltas)

    @staticmethod
    def apply_overlay(cfg: Config, deltas) -> Config:
        """A clone of `cfg` with each delta applied: the parameter is
        overridden at EVERY scope that sets it, else at the default
        scope (which every scoped lookup falls back to) -- one generic
        applier for any solver-tree shape."""
        out = cfg.clone()
        for d in deltas:
            name, value = d["param"], d["value"]
            scopes = [s for (s, n) in cfg.values if n == name]
            for s in scopes or ["default"]:
                out.set(name, value, s)
        return out

    # -- scheduler hook (off the service lock) -----------------------------
    def maybe_step(self):
        """At most ONE unit of tuner work per scheduler cycle: a
        demote check, or (gated on idle capacity) one shadow solve.
        Called from the cycle's off-lock tail; quiesced during
        drain()."""
        if self._quiesced:
            return
        self._check_demotions()
        job = self._next_job()
        if job is None:
            return
        fp, rec, kind, payload = job
        if kind == "baseline":
            self._run_baseline(fp, rec)
        else:
            self._run_candidate(fp, rec, payload)

    def _idle_capacity(self, fp: str) -> bool:
        """Shadow gating: the queue is empty AND nothing is in flight
        -- shadow work may only occupy capacity production is not
        using, and the scheduler thread that would run the shadow is
        the same one advancing in-flight chunks, so 'a free slot on a
        busy bucket' is NOT idle capacity (the shadow would stall the
        neighbors; the paired-p99 gate measures exactly this)."""
        svc = self.svc
        with svc._lock:
            return not svc._queue and svc._inflight() == 0

    def _next_job(self):
        """Pick one pending shadow job (hotness promotion happens
        here: tallies are read under the tuner lock, the decision is
        recorded off it)."""
        now = time.monotonic()
        newly_hot = []
        job = None
        with self._lock:
            for fp, rec in self._fp.items():
                if rec["phase"] == _WATCH:
                    if rec["requests"] >= self.hot_requests \
                            and self._total_exec > 0.0 \
                            and rec["exec_s"] / self._total_exec \
                            >= self.hot_share \
                            and rec["sample"] is not None:
                        rec["phase"] = _HOT
                        rec["trace"] = _spans.new_trace_id()
                        newly_hot.append((fp, rec))
                if rec["phase"] not in (_HOT, _SEARCH):
                    continue
                if rec["not_before"] > now:
                    continue
                out_of_budget = rec["budget"] <= 0
                if out_of_budget and rec["phase"] == _HOT:
                    rec["phase"] = _EXHAUSTED
                    continue
                if job is None:
                    if rec["phase"] == _HOT:
                        job = (fp, rec, "baseline", None)
                    elif rec["candidates"] and not out_of_budget:
                        job = (fp, rec, "candidate",
                               rec["candidates"][0])
                    else:
                        # candidates all measured (or budget gone):
                        # decide on what was measured
                        job = (fp, rec, "candidate", None)
        for fp, rec in newly_hot:
            _tm.inc("autotune.hot")
            _fr.record("autotune.watch", trace=rec["trace"],
                       fingerprint=fp[:24],
                       requests=rec["requests"],
                       exec_share=round(
                           rec["exec_s"] / max(self._total_exec,
                                               1e-12), 4))
            # retain the workload in the journal so a restarted
            # replica can shadow-solve this fingerprint again
            jr = self.svc.journal
            if jr is not None and not rec["workload_saved"] \
                    and rec["sample"] is not None:
                A, b = rec["sample"]
                jr.save_workload(fp, A, b)
                rec["workload_saved"] = True
        if job is not None and job[3] is None and job[2] == "candidate":
            # decision step needs no capacity
            self._decide(job[0], job[1])
            return None
        if job is not None and not self._idle_capacity(job[0]):
            return None
        return job

    def _workload(self, fp: str, rec) -> Optional[Tuple[Any, Any]]:
        if rec["sample"] is not None:
            return rec["sample"]
        jr = self.svc.journal
        if jr is not None:
            wl = jr.load_workload(fp)
            if wl is not None:
                rec["sample"] = wl
                return wl
        return None

    # -- shadow solves -----------------------------------------------------
    def _shadow_solve(self, fp: str, rec, deltas, label: str):
        """One shadow solve of the service config + `deltas` against
        the fingerprint's captured workload. Returns a measurement
        dict or None (crash absorbed + backed off). The measured wall
        is the WARM second solve, timed by `_shadow_clock` -- the first
        use's kernel builds and library handles must never pollute a
        comparison production would pay only once."""
        from ..solvers.base import create_solver
        wl = self._workload(fp, rec)
        if wl is None:
            return None
        A, b = wl
        cfg = self.apply_overlay(self.svc.cfg, deltas)
        dev = self.svc.device
        t0 = time.perf_counter()
        try:
            with _spans.span("autotune.shadow", args={
                    "trace": rec["trace"], "fingerprint": fp[:24],
                    "candidate": label}), \
                    (torch.cuda.device(dev) if dev.type == "cuda"
                     else contextlib.nullcontext()):
                _fi.service_crash("shadow_crash")
                slv = create_solver(cfg, self.svc.scope, device=dev)
                slv.setup(A)
                b = b.to(dev)
                slv.solve(b)               # first use: builds + cold pass
                w0 = _shadow_clock(dev)
                res = slv.solve(b)         # the measured warm pass
                wall = max(_shadow_clock(dev) - w0, 1e-9)
        except Exception as e:
            _tm.inc("autotune.shadow.errors")
            rec["errors"] += 1
            rec["budget"] -= 1
            # back off: one error pauses this fingerprint's search,
            # two retire it -- a crashing candidate config must never
            # consume the idle capacity forever
            rec["not_before"] = time.monotonic() + 0.25
            if rec["errors"] >= 2:
                rec["phase"] = _EXHAUSTED
            _fr.record("autotune.shadow_crash", trace=rec["trace"],
                       fingerprint=fp[:24], candidate=label,
                       error=str(e)[:160],
                       backed_off=rec["phase"] == _EXHAUSTED)
            return None
        total_wall = time.perf_counter() - t0
        iters = max(int(res.iterations), 1)
        m = {"iters": iters, "wall_s": wall,
             "score": iters * wall,
             "converged": bool(getattr(res, "converged", False)),
             "report": getattr(res, "report", None)}
        _tm.inc("autotune.shadow.runs")
        _tm.observe("autotune.shadow_wall_s", total_wall)
        _fr.record("autotune.shadow", trace=rec["trace"],
                   fingerprint=fp[:24], candidate=label,
                   iters=iters, wall_s=round(wall, 6),
                   score=round(m["score"], 9),
                   converged=m["converged"])
        return m

    def _run_baseline(self, fp: str, rec):
        """The GENERATE step: probe the production config
        (diagnostics=1 + residual history overlaid -- both bitwise-off
        knobs production never pays for) and map the report to
        candidates."""
        from ..telemetry.diagnostics import suggest_config_deltas
        rec["budget"] -= 1
        probe = [{"param": "diagnostics", "value": 1},
                 {"param": "store_res_history", "value": 1}]
        m = self._shadow_solve(fp, rec, probe, "baseline")
        if m is None:
            return
        rec["errors"] = 0
        rec["baseline"] = m
        diag = None
        if m["report"] is not None:
            diag = getattr(m["report"], "diagnostics", None)
        cands = suggest_config_deltas(diag)
        with self._lock:
            rec["candidates"] = cands
            rec["phase"] = _SEARCH
        _tm.inc("autotune.candidates", max(len(cands), 0))
        _fr.record("autotune.candidates", trace=rec["trace"],
                   fingerprint=fp[:24], n=len(cands),
                   baseline_iters=m["iters"],
                   baseline_wall_s=round(m["wall_s"], 6),
                   knobs=[c["knob"] for c in cands])
        if not cands:
            with self._lock:
                rec["phase"] = _EXHAUSTED
            self._decision(fp, rec, "no_candidates")

    def _run_candidate(self, fp: str, rec, cand):
        rec["budget"] -= 1
        m = self._shadow_solve(fp, rec, cand["deltas"], cand["knob"])
        with self._lock:
            if cand in rec["candidates"]:
                rec["candidates"].remove(cand)
        if m is None:
            return
        rec["errors"] = 0
        rec["results"].append((cand, m))

    def _decide(self, fp: str, rec):
        """All candidates measured (or budget gone): promote the best
        converged winner past the hysteresis gate, else retire the
        search."""
        base = rec["baseline"]
        best = None
        for cand, m in rec["results"]:
            if not m["converged"]:
                continue
            if best is None or m["score"] < best[1]["score"]:
                best = (cand, m)
        if best is not None:
            # near-ties on score are decided by iterations: the wall
            # half of the score carries single-solve timing noise,
            # iteration count is exact -- within the hysteresis margin
            # the noise-free signal picks the winner
            for cand, m in rec["results"]:
                if (m["converged"]
                        and m["score"] <= best[1]["score"]
                        * self.min_improvement
                        and m["iters"] < best[1]["iters"]):
                    best = (cand, m)
        wins = (
            best is not None and base is not None
            and base["score"] / best[1]["score"]
            >= self.min_improvement
            and best[1]["iters"] <= base["iters"]
            and best[1]["wall_s"] <= base["wall_s"])
        if not wins:
            with self._lock:
                rec["phase"] = _EXHAUSTED
            self._decision(fp, rec, "no_win")
            return
        cand, m = best
        with self._lock:
            rec["overlay"] = [dict(d) for d in cand["deltas"]]
            rec["knob"] = cand["knob"]
            rec["phase"] = _PROMOTED
            rec["retire"] = True
            rec["post"].clear()
            rec["pre_exec"] = _median(
                self.svc._exec_fp.get(fp, ()))
        _tm.inc("autotune.promotions")
        _tm.set_gauge("autotune.tuned_fingerprints",
                      self._promoted_count())
        speedup = round(rec["baseline"]["score"] / m["score"], 3)
        _fr.record("autotune.promote", trace=rec["trace"],
                   fingerprint=fp[:24], knob=cand["knob"],
                   deltas=self._fmt_deltas(cand["deltas"]),
                   baseline_iters=base["iters"],
                   tuned_iters=m["iters"],
                   baseline_wall_s=round(base["wall_s"], 6),
                   tuned_wall_s=round(m["wall_s"], 6),
                   speedup_x=speedup)
        _spans.mark("autotune.decision", args={
            "trace": rec["trace"], "fingerprint": fp[:24],
            "decision": "promote", "knob": cand["knob"],
            "speedup_x": speedup})
        hs = self.svc.hstore
        if hs is not None:
            hs.save_tuned(fp, {
                "deltas": rec["overlay"], "knob": cand["knob"],
                "trace": rec["trace"],
                "baseline": {"iters": base["iters"],
                             "wall_s": base["wall_s"]},
                "tuned": {"iters": m["iters"],
                          "wall_s": m["wall_s"]}})
        self._retire_bucket(fp, rec)

    def _decision(self, fp: str, rec, verdict: str):
        _fr.record("autotune.decision", trace=rec["trace"],
                   fingerprint=fp[:24], verdict=verdict,
                   budget_left=rec["budget"],
                   shadows=len(rec["results"]))
        _spans.mark("autotune.decision", args={
            "trace": rec["trace"], "fingerprint": fp[:24],
            "decision": verdict})

    def _retire_bucket(self, fp: str, rec):
        """Drop the fingerprint's idle bucket so the next build picks
        up the overlay change now, not at natural eviction. A busy
        bucket stays (never disturb in-flight work) and retires at a
        later cycle via the pending flag."""
        svc = self.svc
        with svc._lock:
            eng = svc.buckets.peek(fp)
            if eng is None:
                rec["retire"] = False
                return
            if eng.idle:
                svc.buckets.pop(fp)
                rec["retire"] = False

    def _check_demotions(self):
        """Live regression watch over the promoted set (and pending
        bucket retirements)."""
        to_demote, to_retire = [], []
        with self._lock:
            for fp, rec in self._fp.items():
                if rec["phase"] != _PROMOTED:
                    continue
                if rec["retire"]:
                    to_retire.append((fp, rec))
                if rec["pre_exec"] is None \
                        or len(rec["post"]) < self.demote_window:
                    continue
                med = _median(rec["post"])
                if med is not None and med > \
                        rec["pre_exec"] * self.demote_factor:
                    to_demote.append((fp, rec, med))
        # bucket retirement takes the SERVICE lock -- never while the
        # tuner lock is held (note_finish acquires svc -> tuner)
        for fp, rec in to_retire:
            self._retire_bucket(fp, rec)
        for fp, rec, med in to_demote:
            with self._lock:
                rec["overlay"] = None
                rec["phase"] = _DEMOTED
                rec["retire"] = True
            _tm.inc("autotune.demotions")
            _tm.set_gauge("autotune.tuned_fingerprints",
                          self._promoted_count())
            _fr.record("autotune.demote", trace=rec["trace"],
                       fingerprint=fp[:24],
                       pre_exec_s=round(rec["pre_exec"], 6),
                       post_exec_s=round(med, 6),
                       factor=round(med / rec["pre_exec"], 3))
            _spans.mark("autotune.decision", args={
                "trace": rec["trace"], "fingerprint": fp[:24],
                "decision": "demote"})
            hs = self.svc.hstore
            if hs is not None:
                hs.drop_tuned(fp)
            self._retire_bucket(fp, rec)

    def _promoted_count(self) -> int:
        return sum(1 for r in self._fp.values()
                   if r["overlay"] is not None)

    # -- drain quiesce + fleet handoff ------------------------------------
    def quiesce(self):
        """Stop scheduling shadow work (drain()): search state is
        KEPT -- the search resumes after the drain."""
        self._quiesced = True

    def resume(self):
        self._quiesced = False

    def export_promoted(self) -> Dict[str, Dict[str, Any]]:
        """The promoted overlays, JSON-shaped -- what drain_replica
        hands to the adopting replica alongside the journal."""
        with self._lock:
            return {fp: {"deltas": [dict(d) for d in rec["overlay"]],
                         "knob": rec["knob"],
                         "trace": rec["trace"]}
                    for fp, rec in self._fp.items()
                    if rec["overlay"] is not None}

    def adopt(self, fingerprint: str, state: Dict[str, Any]):
        """Install another replica's promoted overlay (fleet
        drain/failover handoff): served from this replica's next
        build of that fingerprint, persisted in this replica's hstore
        so the adoption survives its own restarts too."""
        with self._lock:
            rec = self._ensure(fingerprint)
            rec["overlay"] = [dict(d) for d in state["deltas"]]
            rec["knob"] = state.get("knob")
            rec["trace"] = state.get("trace") or rec["trace"]
            rec["phase"] = _PROMOTED
            rec["hstore_checked"] = True
            rec["retire"] = True
        _fr.record("autotune.adopt", trace=state.get("trace"),
                   fingerprint=fingerprint[:24],
                   knob=state.get("knob"),
                   deltas=self._fmt_deltas(state["deltas"]))
        hs = self.svc.hstore
        if hs is not None:
            hs.save_tuned(fingerprint, {
                "deltas": [dict(d) for d in state["deltas"]],
                "knob": state.get("knob"),
                "trace": state.get("trace")})

    # -- observability -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """stats()/C-API view of the tuner's live state."""
        with self._lock:
            fps = {}
            for fp, rec in self._fp.items():
                fps[fp[:24]] = {
                    "phase": rec["phase"],
                    "requests": rec["requests"],
                    "budget_left": rec["budget"],
                    "knob": rec["knob"],
                    "overlay": None if rec["overlay"] is None
                    else self._fmt_deltas(rec["overlay"]),
                    "restored": rec["restored"],
                    "errors": rec["errors"],
                }
            return {"enabled": True, "quiesced": self._quiesced,
                    "promoted": self._promoted_count(),
                    "fingerprints": fps}
