"""The serving core in amgx_tpu_torch (amgx_tpu_torch.serving and the
chunked solve entry `Solver._build_chunk_fns`) against the JAX package,
on the CPU.

The cases are the JAX package's own serving tests' (tests/test_serving.py)
on its shapes: `poisson16`, the 5-pt 16^2 Poisson under BATCHED_CG, and
`geo10`, the 7-pt 10^3 one under SERVING_CG, float64, right-hand sides
from seeded numpy, services of 2 slots stepping 4 iterations a cycle.
Each case ends in the statuses, counters and tickets the JAX tests
assert; the iterations a ticket reports are the JAX package's for the
same system (`_jax_iterations`). The port's chunked stepping is held bit
for bit to a one-shot `solve_many` of the same width (the JAX package
holds its chunked entry to its one-shot solve: the port's one-shot
single solve reduces its dots on (n,) vectors, a batch on (B, n) rows).
The C-API service calls are held in tests/test_torch_capi.py and the
fleet in tests/test_torch_fleet.py; the bench smoke lines are not
ported (they belong to the port's benchmark).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.presets import BATCHED_CG as JAX_BATCHED_CG
from amgx_tpu.presets import SERVING_CG as JAX_SERVING_CG

import amgx_tpu_torch as pt
from amgx_tpu_torch.batch import BatchedSolver, stack_solve_datas
from amgx_tpu_torch.errors import BadParametersError
from amgx_tpu_torch.ops import cuda_build
from amgx_tpu_torch.presets import BATCHED_CG, SERVING_CG
from amgx_tpu_torch.resilience import faultinject
from amgx_tpu_torch.resilience.status import SolveStatus
from amgx_tpu_torch.serving import (AotStore, BucketEngine, HierarchyCache,
                                    SolveService, choose_slots,
                                    parse_ladder, solve_data_bytes)
from amgx_tpu_torch.telemetry import metrics
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

jx.initialize()


@pytest.fixture(scope="module")
def poisson16():
    return pt.gallery.poisson("5pt", 16, 16, device="cpu").init()


@pytest.fixture(scope="module")
def geo10():
    return pt.gallery.poisson("7pt", 10, 10, 10, device="cpu").init()


def _shift(A, c):
    rows = torch.repeat_interleave(torch.arange(A.num_rows),
                                   torch.diff(A.row_offsets.long()))
    v = A.values.clone()
    v[rows == A.col_indices.long()] += c
    return A.with_values(v)


def _rhs(A, seed=0):
    return np.random.default_rng(seed).standard_normal(A.num_rows)


def _svc_cfg(base=BATCHED_CG, extra=""):
    return pt.Config.from_string(
        base + ", serving_bucket_slots=2, serving_chunk_iters=4"
        + (", " + extra if extra else ""))


def _svc(base=BATCHED_CG, extra=""):
    return SolveService(_svc_cfg(base, extra), device="cpu")


_JAX_SOLVERS = {}


def _jax_iterations(A, b, cfg=JAX_BATCHED_CG, extra=""):
    """The JAX package's (iterations, status) for one system (the port's
    matrix A, rhs b) under `cfg` + `extra`."""
    key = (cfg, extra, A.num_rows)
    slv = _JAX_SOLVERS.get(key)
    if A.grid_shape is not None and A.grid_shape[-1] > 1:
        # GEO (geo10) needs the gallery's grid annotation
        Aj = jx.gallery.poisson("7pt", *A.grid_shape).init().with_values(
            A.values.numpy())
    else:
        Aj = jx.CsrMatrix.from_scipy_like(
            A.row_offsets.numpy(), A.col_indices.numpy(), A.values.numpy(),
            A.num_rows, A.num_cols).init()
    if slv is None:
        slv = _JAX_SOLVERS[key] = jx.create_solver(
            JaxConfig.from_string(cfg + (", " + extra if extra else "")))
        slv.setup(Aj)
    else:
        slv.resetup(Aj)
    r = slv.solve(np.asarray(b))
    return int(r.iterations), str(r.status).lower()


# ---------------------------------------------------------------------------
# chunked solve entry
# ---------------------------------------------------------------------------


def _stacked(base, A, mats):
    bs = BatchedSolver(pt.Config.from_string(base), device="cpu")
    bs.setup(A.with_values(A.values * 1))
    data, _ = stack_solve_datas(bs._per_system_data(mats))
    return bs, data


@pytest.mark.parametrize("base", ["BATCHED_CG", "SERVING_CG"])
def test_chunk_fns_match_solve_many_bit_identical(poisson16, geo10, base):
    """Stepping the chunked entry to completion reproduces a one-shot
    batched solve of the same width: same iterations, statuses and
    residual norms, bit-identical x; the stats row unpacks to them."""
    A = poisson16 if base == "BATCHED_CG" else geo10
    cfg = BATCHED_CG if base == "BATCHED_CG" else SERVING_CG
    mats = [_shift(A, 0.3 * i) for i in range(4)]
    B = torch.from_numpy(np.stack([_rhs(A, i) for i in range(4)]))
    bs, data = _stacked(cfg, A, mats)
    ref = bs.solve_many(B, matrices=mats)
    init, step, finish = bs.solver._build_chunk_fns(3)
    st = init(data, B, torch.zeros_like(B))
    for _ in range(100):
        st = step(data, B, st)
        if bool((st["done"] | (st["iters"] >= bs.solver.max_iters)).all()):
            break
    x, stats = finish(data, B, st)
    assert torch.equal(x, ref.x)
    for i in range(4):
        it, cv, sc, n0, rn, hist = bs.solver.unpack_stats(
            stats[i], bs.solver.max_iters + 1)
        assert (it, cv, sc) == (int(ref.iterations[i]),
                                bool(ref.converged[i]), int(ref.status[i]))
        assert rn == ref.res_norm[i] and n0 == ref.norm0[i]
        assert len(hist) == it + 1
        assert (it, "success") == _jax_iterations(
            mats[i], B[i].numpy(),
            JAX_BATCHED_CG if base == "BATCHED_CG" else JAX_SERVING_CG)


def test_chunk_window_is_per_system_relative(poisson16):
    """A step advances each system at most `chunk` iterations from ITS
    entry count, whatever iteration it resumed at."""
    mats = [poisson16, poisson16]
    B = torch.from_numpy(np.stack([_rhs(poisson16, 2), _rhs(poisson16, 3)]))
    bs, data = _stacked(BATCHED_CG, poisson16, mats)
    init, step, _ = bs.solver._build_chunk_fns(5)
    st = init(data, B, torch.zeros_like(B))
    st = step(data, B, st)
    assert st["iters"].tolist() == [5, 5]
    # system 1 restarts from iteration 0: both advance 5 in the next step
    fresh = init(data, B, torch.zeros_like(B))
    for k in st:
        st[k][1] = fresh[k][1]
    st = step(data, B, st)
    assert st["iters"].tolist() == [10, 5]


# ---------------------------------------------------------------------------
# continuous batching parity + refill
# ---------------------------------------------------------------------------


def test_service_parity_vs_one_shot_solve_many(poisson16):
    """Continuous batching delivers the per-system iterates of a one-shot
    batched solve over the same systems (4 systems through 2 slots, rtol
    1e-12 as the JAX test) and the JAX package's iterations."""
    mats = [_shift(poisson16, 0.3 * i) for i in range(4)]
    bs_rhs = np.stack([_rhs(poisson16, i) for i in range(4)])
    svc = _svc()
    tickets = [svc.submit(m, b) for m, b in zip(mats, bs_rhs)]
    svc.drain(timeout_s=300)
    one = BatchedSolver(pt.Config.from_string(BATCHED_CG), device="cpu")
    one.setup(mats[0])
    ref = one.solve_many(torch.from_numpy(bs_rhs), matrices=mats)
    assert ref.all_converged
    for i, t in enumerate(tickets):
        assert t.done and t.result.converged
        assert t.result.iterations == int(ref.iterations[i])
        np.testing.assert_allclose(t.result.x.numpy(), ref.x[i].numpy(),
                                   rtol=1e-12, atol=1e-12)
        assert (t.result.iterations, t.result.status) == _jax_iterations(
            mats[i], bs_rhs[i])


def test_service_bit_identical_to_solve_many_at_its_width(geo10):
    """Four SERVING_CG systems admitted together into a 4-slot bucket:
    bit for bit a solve_many of the same four."""
    mats = [_shift(geo10, 0.1 * (i % 3)) for i in range(4)]
    B = np.stack([_rhs(geo10, 20 + i) for i in range(4)])
    svc = SolveService(pt.Config.from_string(
        SERVING_CG + ", serving_bucket_slots=4, serving_chunk_iters=2"),
        device="cpu")
    tickets = [svc.submit(m, b) for m, b in zip(mats, B)]
    svc.drain(timeout_s=300)
    bs, _ = _stacked(SERVING_CG, geo10, mats)
    ref = bs.solve_many(torch.from_numpy(B), matrices=mats)
    for i, t in enumerate(tickets):
        assert t.result.iterations == int(ref.iterations[i])
        assert torch.equal(t.result.x, ref.x[i])


def test_slot_refill_without_reprobe(poisson16):
    """5 systems through a 2-slot bucket: drained slots are refilled
    mid-flight and the bucket probes its solve data once."""
    mats = [_shift(poisson16, 0.2 * i) for i in range(5)]
    base = metrics.get("serving.retrace")
    svc = _svc()
    tickets = [svc.submit(m, _rhs(m, i)) for i, m in enumerate(mats)]
    svc.drain(timeout_s=300)
    assert all(t.result.converged for t in tickets)
    assert len(svc.buckets) == 1
    eng = svc.buckets.peek(tickets[0].fingerprint)
    assert eng.slots == 2 and eng.idle
    assert eng.trace_count == 1
    assert metrics.get("serving.retrace") - base == 1


def test_background_build_failure_rejects_tickets(poisson16):
    svc = _svc(extra="scaling=DIAGONAL_SYMMETRIC")   # engine refuses
    svc.start()
    try:
        t = svc.submit(poisson16, _rhs(poisson16, 20))
        assert t.wait(timeout=300)
        assert t.result.status_code == int(SolveStatus.BREAKDOWN)
        assert t.error is not None and "scaling" in str(t.error)
        assert svc.idle
    finally:
        svc.stop()


def test_sync_build_failure_rejects_tickets(poisson16):
    svc = _svc(extra="scaling=DIAGONAL_SYMMETRIC")
    t = svc.submit(poisson16, _rhs(poisson16, 21))
    done = svc.step()
    assert t in done and t.done
    assert t.result.status_code == int(SolveStatus.BREAKDOWN)
    assert t.error is not None
    assert svc.idle and svc.step() == []


def test_submit_validates_rhs_length(poisson16):
    with pytest.raises(BadParametersError, match="rhs length"):
        _svc().submit(poisson16, np.ones(7))


def test_service_background_thread(poisson16):
    svc = _svc()
    svc.start()
    try:
        t = svc.submit(poisson16, _rhs(poisson16, 3))
        assert t.wait(timeout=300) and t.result.converged
        assert t.latency_s > 0
    finally:
        svc.stop()


def test_builder_thread_and_rebuild_land_on_the_service_device(poisson16):
    """A bucket built by the builder thread, and the one rebuilt after a
    quarantine, hold every tensor on the service's device; solver nodes
    built without a device resolve to the card (none here: they raise)."""
    svc = _svc(extra="serving_chunk_iters=1, s:tolerance=1e-12")
    svc.start()
    try:
        t = svc.submit(poisson16, _rhs(poisson16, 60))
        assert t.wait(timeout=300)
    finally:
        svc.stop()
    eng = svc.buckets.peek(t.fingerprint)
    assert eng.device == svc.device == torch.device("cpu")
    leaves = [x for x in eng.footprint_tree()[0]]
    assert leaves and all(x.device == svc.device for x in leaves)
    t2 = svc.submit(poisson16, _rhs(poisson16, 61))
    svc.step()
    with faultinject.inject("step_crash", fires=1):
        svc.step()
    svc.drain(timeout_s=300)
    assert t2.result.converged
    eng2 = svc.buckets.peek(t2.fingerprint)
    assert eng2 is not eng
    assert all(x.device == svc.device for x in eng2.footprint_tree()[0])
    from amgx_tpu_torch.solvers.polynomial import ChebyshevPolySolver
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ChebyshevPolySolver(pt.Config.from_string(SERVING_CG))


def test_autotune_knob_builds_the_tuner():
    """autotune=1 builds the service's ConfigAutotuner; autotune=0
    builds none."""
    from amgx_tpu_torch.serving import ConfigAutotuner
    assert isinstance(_svc(extra="autotune=1")._tuner, ConfigAutotuner)
    assert _svc()._tuner is None


# ---------------------------------------------------------------------------
# deadlines + admission control
# ---------------------------------------------------------------------------


def test_deadline_inflight_partial_never_hangs(poisson16):
    svc = _svc(extra="serving_chunk_iters=1, s:tolerance=1e-14")
    b = _rhs(poisson16, 4)
    miss0 = metrics.get("serving.deadline_miss")
    t = svc.submit(poisson16, b, tenant="late", deadline_s=1e9)
    svc.step()
    assert not t.done
    t.deadline_t = 0.0
    svc.step()
    assert t.done
    assert t.result.status_code == int(SolveStatus.DEADLINE_EXCEEDED)
    assert t.result.status == "deadline_exceeded"
    assert not t.result.converged
    assert float(torch.linalg.norm(t.result.x)) > 0
    assert metrics.get("serving.deadline_miss") - miss0 == 1
    assert svc.stats()["tenants"]["late"]["deadline_miss"] == 1
    t2 = svc.submit(poisson16, b)
    svc.drain(timeout_s=300)
    assert t2.result.converged


def test_deadline_queued_expiry_rejects(poisson16):
    svc = _svc()
    t = svc.submit(poisson16, _rhs(poisson16, 5), deadline_s=0.0)
    svc.step()
    assert t.done and t.result.iterations == 0
    assert t.result.status_code == int(SolveStatus.DEADLINE_EXCEEDED)
    assert float(torch.linalg.norm(t.result.x)) == 0


def test_deadline_action_reject_returns_initial_iterate(poisson16):
    svc = _svc(extra="serving_deadline_action=reject, "
                     "serving_chunk_iters=1, s:tolerance=1e-14")
    t = svc.submit(poisson16, _rhs(poisson16, 6), deadline_s=1e9)
    svc.step()
    t.deadline_t = 0.0
    svc.step()
    assert t.done
    assert t.result.status_code == int(SolveStatus.DEADLINE_EXCEEDED)
    assert float(torch.linalg.norm(t.result.x)) == 0


def test_admission_control_queue_bound(poisson16):
    svc = _svc(extra="serving_max_queue=1")
    rej0 = metrics.get("serving.rejected")
    ovl0 = metrics.get("serving.shed.overload")
    t1 = svc.submit(poisson16, _rhs(poisson16, 7))
    t2 = svc.submit(poisson16, _rhs(poisson16, 8))
    assert not t1.done
    assert t2.done and t2.result.status_code == \
        int(SolveStatus.OVERLOADED)
    assert t2.result.status == "overloaded"
    assert metrics.get("serving.rejected") - rej0 == 1
    assert metrics.get("serving.shed.overload") - ovl0 == 1
    svc.drain(timeout_s=300)
    assert t1.result.converged


# ---------------------------------------------------------------------------
# hierarchy cache
# ---------------------------------------------------------------------------


def test_cache_hit_routes_to_value_resetup(geo10):
    """After the bucket exists, every repeat-pattern admit goes through
    the value-only resetup; the full-setup counter stays flat; each
    ticket takes the JAX package's iterations."""
    svc = _svc(base=SERVING_CG)
    base = metrics.snapshot()
    t0 = svc.submit(geo10, _rhs(geo10, 0))
    svc.drain(timeout_s=300)
    mid = metrics.snapshot()
    assert mid["amg.setup.full"] - base["amg.setup.full"] == 1
    assert mid["serving.cache.miss"] - base["serving.cache.miss"] == 1
    mats = [_shift(geo10, 0.2 * i) for i in range(1, 4)]
    tickets = [svc.submit(m, _rhs(geo10, i))
               for i, m in zip(range(1, 4), mats)]
    svc.drain(timeout_s=300)
    cur = metrics.snapshot()
    assert all(t.result.converged for t in tickets + [t0])
    assert cur["amg.setup.full"] == mid["amg.setup.full"]
    assert cur["amg.resetup.value"] - mid["amg.resetup.value"] >= 3
    assert cur["serving.cache.hit"] > mid["serving.cache.hit"]
    for i, (m, t) in enumerate(zip(mats, tickets), start=1):
        assert (t.result.iterations, t.result.status) == _jax_iterations(
            m, _rhs(geo10, i), JAX_SERVING_CG)


def test_cache_eviction_by_bytes(poisson16):
    ev0 = metrics.get("serving.cache.evictions")
    svc = _svc(extra="serving_cache_bytes=1")
    other = pt.gallery.poisson("5pt", 12, 12, device="cpu").init()
    svc.submit(poisson16, _rhs(poisson16, 9))
    svc.drain(timeout_s=300)
    svc.submit(other, _rhs(other, 10))
    svc.drain(timeout_s=300)
    assert len(svc.buckets) == 1
    assert svc.buckets.evictions >= 1
    assert metrics.get("serving.cache.evictions") - ev0 >= 1
    assert metrics.get("serving.live_buckets") == 1


def test_cache_never_evicts_busy_or_newest_bucket():
    class E:
        def __init__(self, idle):
            self.idle = idle

    cache = HierarchyCache(budget_bytes=10, counters={},
                           can_evict=lambda e: e.idle)
    busy, idle = E(False), E(True)
    cache.put("busy", busy, nbytes=100)
    assert "busy" in cache
    cache.put("idle", idle, nbytes=100)
    assert "busy" in cache and "idle" in cache
    busy.idle = True
    cache.evict_to_budget()
    assert "busy" not in cache and "idle" in cache
    assert cache.evictions == 1


def test_solve_data_bytes_counts_unique_storages(poisson16):
    slv = pt.create_solver(pt.Config.from_string(BATCHED_CG), device="cpu")
    slv.setup(poisson16)
    nb = solve_data_bytes(slv)
    assert nb >= poisson16.values.numel() * 8
    leaf = torch.ones(1000)
    assert solve_data_bytes([leaf, leaf]) == 4000
    # views of one storage count once, whatever their number
    stacked = torch.ones(4, 1000)
    assert solve_data_bytes([stacked, stacked[0], stacked[1:]]) == 16000


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------


def test_warm_start_round_trip_zero_reprobe(poisson16, tmp_path):
    """A fresh service against a warm store builds its bucket without the
    probe resetup (serving.retrace 0), loads the bundle's libraries, and
    gives identical results; a torn bundle is counted and built cold."""
    cfg = _svc_cfg(extra=f"serving_aot_dir={tmp_path}")
    b = _rhs(poisson16, 11)
    exp0 = metrics.get("serving.aot.export")
    err0 = metrics.get("serving.aot.error")
    svc1 = SolveService(cfg, device="cpu")
    t1 = svc1.submit(poisson16, b)
    svc1.drain(timeout_s=300)
    assert metrics.get("serving.aot.export") - exp0 == 1
    assert metrics.get("serving.aot.error") - err0 == 0
    retr0 = metrics.get("serving.retrace")
    load0 = metrics.get("serving.aot.load")
    svc2 = SolveService(cfg, device="cpu")
    t2 = svc2.submit(poisson16, b)
    svc2.drain(timeout_s=300)
    assert metrics.get("serving.retrace") - retr0 == 0
    assert metrics.get("serving.aot.load") - load0 == 1
    eng = svc2.buckets.peek(t2.fingerprint)
    assert eng.aot_warm and eng.trace_count == 0
    assert cuda_build.BUILT == []
    assert t2.result.iterations == t1.result.iterations
    assert torch.equal(t2.result.x, t1.result.x)
    # a bundle torn on disk: detected, counted, built cold
    store = AotStore(str(tmp_path))
    for name in os.listdir(tmp_path):
        path = os.path.join(tmp_path, name)
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:-7])
    err1 = metrics.get("serving.aot.error")
    svc3 = SolveService(cfg, device="cpu")
    t3 = svc3.submit(poisson16, b)
    svc3.drain(timeout_s=300)
    assert metrics.get("serving.aot.error") - err1 == 1
    assert not svc3.buckets.peek(t3.fingerprint).aot_warm
    assert torch.equal(t3.result.x, t1.result.x)
    assert store.load_meta("missing") is None


# ---------------------------------------------------------------------------
# fault tolerance: journal, checkpoints, crash recovery
# ---------------------------------------------------------------------------


def test_checkpoint_restart_resumes_bit_identical(poisson16, tmp_path):
    b = _rhs(poisson16, 30)
    kr = (f"serving_journal_dir={tmp_path}, serving_checkpoint_cycles=1,"
          " serving_chunk_iters=1, s:tolerance=1e-12")
    ref = _svc(extra="serving_chunk_iters=1, s:tolerance=1e-12")
    rt = ref.submit(poisson16, b)
    ref.drain(timeout_s=300)
    victim = _svc(extra=kr)
    vt = victim.submit(poisson16, b, tenant="acme", deadline_s=1e6,
                       request_key="kr-0")
    for _ in range(4):
        victim.step()
    assert not vt.done
    del victim
    rep0 = metrics.get("serving.recovery.replayed")
    res0 = metrics.get("serving.recovery.resumed")
    succ = _svc(extra=kr)
    assert metrics.get("serving.recovery.replayed") - rep0 == 1
    done = succ.drain(timeout_s=300)
    assert len(done) == 1 and done[0].done
    assert metrics.get("serving.recovery.resumed") - res0 == 1
    assert done[0].result.iterations == rt.result.iterations
    assert torch.equal(done[0].result.x, rt.result.x)
    assert done[0].result.converged
    assert succ.stats()["journal_pending"] == 0


def test_submit_request_key_idempotent(poisson16, tmp_path):
    b = _rhs(poisson16, 31)
    cfg = _svc_cfg(extra=f"serving_journal_dir={tmp_path}")
    svc = SolveService(cfg, device="cpu")
    ded0 = metrics.get("serving.dedupe")
    t1 = svc.submit(poisson16, b, request_key="abc")
    t2 = svc.submit(poisson16, b, request_key="abc")
    assert t2 is t1
    assert metrics.get("serving.dedupe") - ded0 == 1
    svc.drain(timeout_s=300)
    assert t1.result.converged
    svc2 = SolveService(cfg, device="cpu")
    t3 = svc2.submit(poisson16, b, request_key="abc")
    assert t3.done and t3 is not t1
    assert metrics.get("serving.dedupe") - ded0 == 2
    assert torch.equal(t3.result.x, t1.result.x)
    assert svc2.idle


def test_journal_corrupt_record_dropped_not_wedged(poisson16, tmp_path):
    cfg = _svc_cfg(extra=f"serving_journal_dir={tmp_path},"
                         " serving_chunk_iters=1, s:tolerance=1e-12")
    svc = SolveService(cfg, device="cpu")
    svc.submit(poisson16, _rhs(poisson16, 32))
    with faultinject.inject("journal_corrupt", fires=1):
        svc.submit(poisson16, _rhs(poisson16, 33))
    svc.submit(poisson16, _rhs(poisson16, 34))
    del svc
    jc0 = metrics.get("serving.recovery.journal_corrupt")
    rep0 = metrics.get("serving.recovery.replayed")
    succ = SolveService(cfg, device="cpu")
    assert metrics.get("serving.recovery.journal_corrupt") - jc0 == 1
    assert metrics.get("serving.recovery.replayed") - rep0 == 2
    done = succ.drain(timeout_s=300)
    assert len(done) == 2 and all(t.result.converged for t in done)
    assert succ.idle


def test_journal_corrupt_pattern_self_heals(poisson16, tmp_path):
    cfg = _svc_cfg(extra=f"serving_journal_dir={tmp_path},"
                         " serving_chunk_iters=1, s:tolerance=1e-12")
    svc = SolveService(cfg, device="cpu")
    with faultinject.inject("journal_corrupt", fires=1):
        svc.submit(poisson16, _rhs(poisson16, 53))
    del svc
    succ = SolveService(cfg, device="cpu")
    assert succ.stats()["journal_pending"] == 0
    t = succ.submit(poisson16, _rhs(poisson16, 54))
    for _ in range(3):
        succ.step()
    assert not t.done
    del succ
    succ2 = SolveService(cfg, device="cpu")
    done = succ2.drain(timeout_s=300)
    assert len(done) == 1 and done[0].result.converged


def test_hierarchy_store_restart_zero_full_setups(geo10, tmp_path):
    """A restarted service with warm hierarchy and warm-start stores
    serves its first request via the snapshot load + structure-reuse
    rebuild and the stored split: zero full setups, zero probes,
    identical results."""
    cfg = _svc_cfg(base=SERVING_CG,
                   extra=f"serving_hierarchy_dir={tmp_path}/h,"
                         f" serving_aot_dir={tmp_path}/a")
    b = _rhs(geo10, 35)
    hs0 = metrics.get("serving.recovery.hstore_save")
    svc1 = SolveService(cfg, device="cpu")
    t1 = svc1.submit(geo10, b)
    svc1.drain(timeout_s=300)
    assert metrics.get("serving.recovery.hstore_save") - hs0 == 1
    full0 = metrics.get("amg.setup.full")
    rest0 = metrics.get("amg.setup.restored")
    retr0 = metrics.get("serving.retrace")
    svc2 = SolveService(cfg, device="cpu")
    t2 = svc2.submit(geo10, b)
    svc2.drain(timeout_s=300)
    assert metrics.get("amg.setup.full") - full0 == 0
    assert metrics.get("amg.setup.restored") - rest0 == 1
    assert metrics.get("serving.retrace") - retr0 == 0
    eng = svc2.buckets.peek(t2.fingerprint)
    assert eng.hier_restored and eng.aot_warm
    assert torch.equal(t2.result.x, t1.result.x)


# ---------------------------------------------------------------------------
# lock split
# ---------------------------------------------------------------------------


def test_submit_never_waits_for_device_cycle(poisson16, monkeypatch):
    svc = _svc(extra="serving_chunk_iters=1, s:tolerance=1e-14")
    t1 = svc.submit(poisson16, _rhs(poisson16, 36))
    svc.step()
    assert not t1.done
    in_step, release = threading.Event(), threading.Event()
    orig_step = BucketEngine.step

    def blocked_step(self):
        in_step.set()
        assert release.wait(30)
        return orig_step(self)

    monkeypatch.setattr(BucketEngine, "step", blocked_step)
    th = threading.Thread(target=svc.step)
    th.start()
    try:
        assert in_step.wait(30)
        t0 = time.monotonic()
        t2 = svc.submit(poisson16, _rhs(poisson16, 37))
        dt = time.monotonic() - t0
        assert th.is_alive()
        assert not t2.done and dt < 5.0
    finally:
        release.set()
        th.join()
    monkeypatch.setattr(BucketEngine, "step", orig_step)
    svc.drain(timeout_s=300)
    assert t1.result.converged and t2.result.converged


# ---------------------------------------------------------------------------
# backpressure & load shedding
# ---------------------------------------------------------------------------


def test_shed_deadline_unmeetable_overloaded(poisson16):
    svc = _svc(extra="serving_shed_policy=deadline")
    warm = svc.submit(poisson16, _rhs(poisson16, 38))
    svc.drain(timeout_s=300)
    assert warm.result.converged
    svc._exec_recent.extend([0.05, 0.05, 0.05])
    shd0 = metrics.get("serving.shed.deadline")
    t = svc.submit(poisson16, _rhs(poisson16, 39), deadline_s=1e-4)
    assert t.done
    assert t.result.status_code == int(SolveStatus.OVERLOADED)
    assert metrics.get("serving.shed.deadline") - shd0 == 1
    t2 = svc.submit(poisson16, _rhs(poisson16, 40), deadline_s=1e6)
    svc.drain(timeout_s=300)
    assert t2.result.converged


def test_shed_tenant_quota(poisson16):
    svc = _svc(extra="serving_tenant_quota=1")
    q0 = metrics.get("serving.shed.quota")
    t1 = svc.submit(poisson16, _rhs(poisson16, 41), tenant="greedy")
    t2 = svc.submit(poisson16, _rhs(poisson16, 42), tenant="greedy")
    t3 = svc.submit(poisson16, _rhs(poisson16, 43), tenant="modest")
    assert not t1.done and not t3.done
    assert t2.done and t2.result.status == "overloaded"
    assert metrics.get("serving.shed.quota") - q0 == 1
    assert svc.stats()["tenants"]["greedy"]["shed"] == 1
    svc.drain(timeout_s=300)
    assert t1.result.converged and t3.result.converged


# ---------------------------------------------------------------------------
# supervision, quarantine & the service-level chaos scenarios
# ---------------------------------------------------------------------------


def test_step_crash_quarantines_and_resumes_bit_identical(poisson16):
    extra = "serving_chunk_iters=1, s:tolerance=1e-12"
    ref = _svc(extra=extra)
    b = _rhs(poisson16, 44)
    rt = ref.submit(poisson16, b)
    ref.drain(timeout_s=300)
    svc = _svc(extra=extra)
    q0 = metrics.get("serving.recovery.quarantined")
    rq0 = metrics.get("serving.recovery.requeued")
    t = svc.submit(poisson16, b)
    svc.step()
    with faultinject.inject("step_crash", fires=1):
        svc.step()
    assert metrics.get("serving.recovery.quarantined") - q0 == 1
    assert metrics.get("serving.recovery.requeued") - rq0 == 1
    assert not t.done
    svc.drain(timeout_s=300)
    assert t.result.converged
    assert t.result.iterations == rt.result.iterations
    assert torch.equal(t.result.x, rt.result.x)


def test_wedged_bucket_detected_and_recovered(poisson16):
    svc = _svc(extra="serving_supervisor_cycles=2, serving_chunk_iters=1,"
                     " s:tolerance=1e-12")
    q0 = metrics.get("serving.recovery.quarantined")
    t = svc.submit(poisson16, _rhs(poisson16, 45))
    svc.step()
    with faultinject.inject("step_wedge", fires=4):
        for _ in range(5):
            svc.step()
    assert metrics.get("serving.recovery.quarantined") - q0 >= 1
    svc.drain(timeout_s=300)
    assert t.done and t.result.converged


def test_build_crash_retry_backoff_converges(poisson16):
    svc = _svc(extra="serving_fault_policy=BUILD_FAILED>retry_backoff,"
                     " serving_retry_backoff_s=0.01")
    r0 = metrics.get("serving.recovery.build_retries")
    with faultinject.inject("build_crash", fires=1):
        t = svc.submit(poisson16, _rhs(poisson16, 46))
        svc.drain(timeout_s=300)
    assert t.result.converged
    assert metrics.get("serving.recovery.build_retries") - r0 == 1


def test_build_crash_attempts_bounded_then_reject(poisson16):
    svc = _svc(extra="serving_fault_policy=BUILD_FAILED>retry_backoff,"
                     " serving_retry_backoff_s=0.001,"
                     " serving_retry_max_attempts=2")
    with faultinject.inject("build_crash", fires=None):
        t = svc.submit(poisson16, _rhs(poisson16, 47))
        svc.drain(timeout_s=60)
    assert t.done
    assert t.result.status_code == int(SolveStatus.BREAKDOWN)
    assert isinstance(t.error, faultinject.ChaosInjected)
    assert svc.idle


def test_step_crash_attempts_bounded_then_reject(poisson16):
    svc = _svc(extra="serving_retry_max_attempts=1, serving_chunk_iters=1")
    with faultinject.inject("step_crash", fires=None):
        t = svc.submit(poisson16, _rhs(poisson16, 51))
        svc.drain(timeout_s=120)
    assert t.done
    assert t.result.status_code == int(SolveStatus.BREAKDOWN)
    assert svc.idle
    t2 = svc.submit(poisson16, _rhs(poisson16, 52))
    svc.drain(timeout_s=300)
    assert t2.result.converged


def test_engine_admit_occupied_slot_still_raises(poisson16):
    eng = BucketEngine(_svc_cfg(), "default", poisson16, slots=2, chunk=4,
                       device="cpu")
    eng.admit(0, poisson16, _rhs(poisson16, 55))
    with pytest.raises(BadParametersError, match="occupied"):
        eng.admit(0, poisson16, _rhs(poisson16, 56))


def test_bucket_failure_status_does_not_poison_neighbors(poisson16):
    """A slot that hits NAN_DETECTED mid-chunk finalizes with that status
    while a neighbour in the same bucket still finalizes CONVERGED."""
    with faultinject.inject("spmv_nan", iteration=3, fires=None):
        svc = _svc(extra="serving_chunk_iters=2")
        bad = svc.submit(poisson16, _rhs(poisson16, 48))
        zero = svc.submit(poisson16, np.zeros(poisson16.num_rows))
        svc.drain(timeout_s=300)
    assert bad.done
    assert bad.result.status_code == int(SolveStatus.NAN_DETECTED)
    assert not bad.result.converged
    assert zero.done and zero.result.converged
    assert zero.result.iterations == 0
    svc2 = _svc(extra="serving_chunk_iters=2")
    ok = svc2.submit(poisson16, _rhs(poisson16, 48))
    svc2.drain(timeout_s=300)
    assert ok.result.converged


def test_clock_skew_deadlines_stay_terminal(poisson16):
    with faultinject.inject("clock_skew", value=600.0, fires=None):
        svc = _svc()
        t1 = svc.submit(poisson16, _rhs(poisson16, 49), deadline_s=1e9)
        t2 = svc.submit(poisson16, _rhs(poisson16, 50), deadline_s=0.0)
        svc.drain(timeout_s=300)
    assert t1.done and t1.result.converged
    assert t2.done and t2.result.status_code == \
        int(SolveStatus.DEADLINE_EXCEEDED)


def test_bucket_ladder_widths():
    assert parse_ladder("1|4|16") == (1, 4, 16)
    assert parse_ladder("") == ()
    assert choose_slots((1, 4, 16), 3, 2) == 4
    assert choose_slots((1, 4, 16), 40, 2) == 16
    assert choose_slots((), 3, 2) == 2
    with pytest.raises(BadParametersError):
        parse_ladder("4|1")


# ---------------------------------------------------------------------------
# telemetry catalog
# ---------------------------------------------------------------------------


def test_serving_metrics_declared():
    snap = metrics.snapshot()
    for name in ("serving.requests", "serving.completed",
                 "serving.rejected", "serving.deadline_miss",
                 "serving.cache.hit", "serving.cache.miss",
                 "serving.cache.evictions", "serving.retrace",
                 "serving.aot.export", "serving.aot.load",
                 "serving.aot.error", "batch.bucket_evictions",
                 "serving.recovery.checkpoints",
                 "serving.recovery.replayed",
                 "serving.recovery.resumed",
                 "serving.recovery.restart_fresh",
                 "serving.recovery.journal_corrupt",
                 "serving.recovery.quarantined",
                 "serving.recovery.salvaged",
                 "serving.recovery.requeued",
                 "serving.recovery.build_retries",
                 "serving.recovery.hstore_save",
                 "serving.recovery.hstore_load",
                 "serving.recovery.hstore_skip",
                 "serving.recovery.hstore_error",
                 "serving.dedupe", "serving.shed.overload",
                 "serving.shed.deadline", "serving.shed.quota",
                 "amg.setup.restored", "resilience.config_fallback"):
        assert name in snap
    assert "serving.exec_s" in metrics.HISTOGRAMS
    # the serving names have their sites, and so have the fleet's and
    # the autotuner's
    assert metrics.waiting("serving.requests") is None
    assert metrics.waiting("fleet.route.warm") is None
    assert metrics.waiting("autotune.promotions") is None
