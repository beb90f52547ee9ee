"""Tests of amgx_tpu_torch that need the CUDA card: marked `card`, they
skip where PyTorch sees none. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_card.py

(`--noconftest`: tests/conftest.py sets up the JAX package, which this
file does not use and a machine with the card need not have).

The coarse tail kernel (csrc/tail.cu, B5 and its batch form K5) takes a
dynamic-shared-memory limit that belongs to the kernel function and so
to every plan and thread of the process. These tests build tails of
different sizes one after another, and in the serving layer's builder
thread while another bucket steps on the scheduler thread, and hold
every launch to a clean result.
"""
import numpy as np
import pytest
import torch

import amgx_tpu_torch as pt
from amgx_tpu_torch.batch import BatchedSolver
from amgx_tpu_torch.ops import cuda_tail
from amgx_tpu_torch.presets import SERVING_CG
from amgx_tpu_torch.serving import SolveService
from amgx_tpu_torch.telemetry import metrics

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _poisson(n, dev):
    return pt.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                              device=dev).init()


def _rhs(rows, count, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((count, rows)).astype(
        np.float32)).to(dev)


def _tail_smems():
    return {p.smem for plans in cuda_tail._PLANS.values()
            for p in plans.values()}


def test_smaller_tail_plan_keeps_a_larger_tail_launching(card):
    """A batch whose tail needs more shared memory solves again, bit for
    bit, after a batch with a smaller tail built its plan in between."""
    cfg = pt.Config.from_string(SERVING_CG)
    big, small = BatchedSolver(cfg, device=card), BatchedSolver(
        cfg, device=card)
    big.setup(_poisson(34, card))
    small.setup(_poisson(16, card))
    Bb, Bs = _rhs(34 ** 3, 2, 0, card), _rhs(16 ** 3, 2, 1, card)
    first = big.solve_many(Bb)
    smems = _tail_smems()
    small_res = small.solve_many(Bs)
    assert len(_tail_smems()) > len(smems), "the two tails share a size"
    again = big.solve_many(Bb)
    torch.cuda.synchronize()
    assert bool(np.all(np.asarray(small_res.converged)))
    assert bool(np.all(np.asarray(first.converged)))
    assert torch.equal(first.x, again.x)
    assert np.array_equal(np.asarray(first.iterations),
                          np.asarray(again.iterations))


def test_builder_thread_builds_other_sizes_while_a_bucket_steps(card):
    """Buckets of four other sizes are built by the builder thread while
    the hot bucket steps one iteration a cycle on the scheduler thread:
    every ticket converges, none fails or is retried, and the hot
    tickets give the bits of the same requests served alone."""
    cfg = pt.Config.from_string(
        SERVING_CG + ", serving_bucket_slots=2, serving_chunk_iters=1")
    hot = _poisson(32, card)
    others = [_poisson(n, card) for n in (18, 22, 26, 30)]
    hot_b = _rhs(hot.num_rows, 6, 2, card)
    watched = ("serving.recovery.build_retries",
               "serving.recovery.quarantined", "serving.recovery.requeued",
               "serving.rejected")
    before = {k: metrics.get(k) for k in watched}
    svc = SolveService(cfg, device=card)
    svc.start()
    try:
        tickets = [svc.submit(hot, hot_b[0])]
        assert tickets[0].wait(timeout=300)
        for i, A in enumerate(others):
            tickets.append(svc.submit(hot, hot_b[i + 1]))
            tickets.append(svc.submit(A, _rhs(A.num_rows, 1, 10 + i,
                                              card)[0]))
        tickets.append(svc.submit(hot, hot_b[5]))
        svc.drain(timeout_s=600)
    finally:
        svc.stop()
    assert svc._thread_error is None
    errors = [repr(t.error) for t in tickets if t.error is not None]
    assert not errors, errors
    assert all(t.done and t.result.converged for t in tickets), \
        [t.result.status for t in tickets]
    assert {k: metrics.get(k) - before[k] for k in watched} \
        == dict.fromkeys(watched, 0)
    assert len(_tail_smems()) >= 2
    alone = SolveService(cfg, device=card)
    hot_tickets = [t for t in tickets if t.fingerprint == tickets[0]
                   .fingerprint]
    for t, b in zip(hot_tickets, hot_b):
        ref = alone.submit(hot, b)
        alone.drain(timeout_s=300)
        assert torch.equal(ref.result.x, t.result.x)


def test_concurrent_launches_all_counted(card):
    """Two threads launch B1 at once (two fleet replicas on one card):
    every launch is counted, and the library is loaded once."""
    import threading
    from amgx_tpu_torch.ops import cuda_build
    from amgx_tpu_torch.ops.spmv import spmv
    A = _poisson(24, card)
    x = _rhs(24 ** 3, 1, 3, card)[0]
    libs, errors = [], []
    n0 = pt.kernel_launches()["dia_spmv"]

    def work():
        try:
            libs.append(cuda_build.library("dia.cu"))
            for _ in range(500):
                spmv(A, x)
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors
    assert pt.kernel_launches()["dia_spmv"] - n0 == 1000
    assert libs[0] is libs[1]


def test_fleet_background_replicas_match_inline(card):
    """Two SERVING_CG replicas on one card, each with its own builder and
    scheduler threads: every ticket converges with the bits of the same
    requests served by an inline-driven fleet."""
    from amgx_tpu_torch.serving import FleetRouter
    cfg = pt.Config.from_string(
        SERVING_CG + ", serving_bucket_slots=2, serving_chunk_iters=2")
    mats = [_poisson(16, card), _poisson(18, card)]
    reqs = [(mats[i % 2], _rhs(mats[i % 2].num_rows, 1, i, card)[0])
            for i in range(8)]
    runs = []
    for background in (True, False):
        fleet = FleetRouter.build(cfg, 2, device=card)
        if background:
            fleet.start()
        ts = [fleet.submit(M, b) for M, b in reqs]
        fleet.drain(timeout_s=300)
        fleet.stop()
        assert all(t.done and t.result.converged and t.error is None
                   for t in ts)
        runs.append([t.result.x for t in ts])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_eigensolvers_on_card_match_cpu(card):
    """LANCZOS and POWER_ITERATION on a box with three distinct sides:
    the card's float32 run takes the CPU's iterations and eigenvalues
    (to float32 rounding), through B1."""
    from amgx_tpu_torch.eigen import create_eigensolver
    for cfg in ("eig_solver=LANCZOS, eig_wanted_count=2, "
                "eig_subspace_size=30, eig_tolerance=1e-4",
                "eig_solver=POWER_ITERATION, eig_max_iters=3000, "
                "eig_tolerance=1e-4"):
        res = {}
        for dev in (card, torch.device("cpu")):
            A = pt.gallery.poisson("7pt", 12, 10, 9, dtype=torch.float32,
                                   device=dev).init()
            es = create_eigensolver(pt.Config.from_string(cfg), device=dev)
            es.setup(A)
            n0 = pt.kernel_launches()["dia_spmv"]
            res[dev.type] = (es.solve(),
                             pt.kernel_launches()["dia_spmv"] - n0)
        (rc, launches), (rh, _) = res["cuda"], res["cpu"]
        assert rc.converged and rh.converged and launches > 0
        assert abs(rc.iterations - rh.iterations) <= 1
        np.testing.assert_allclose(rc.eigenvalues, rh.eigenvalues,
                                   rtol=1e-5)


def test_shadow_clock_waits_for_the_card(card):
    """The autotuner's shadow clock reads the host clock only after the
    card's queued work finished."""
    from amgx_tpu_torch.serving.autotune import _shadow_clock
    a = torch.randn(4096, 4096, device=card)
    for _ in range(8):
        a = a @ a / 64.0
    _shadow_clock(card)
    assert torch.cuda.current_stream(card).query()


def test_capi_flagship_on_card_matches_direct(card, tmp_path):
    """The C API on its default resources (the card): FLAGSHIP at 32^3
    through AMGX_generate_distributed_poisson_7pt gives the direct
    solve's x bit for bit, and again after a binary write, an
    AMGX_read_system and AMGX_matrix_attach_geometry; x downloads as
    numpy and AMGX_matrix_vector_multiply equals spmv's bits."""
    from amgx_tpu_torch import capi
    from amgx_tpu_torch.ops.spmv import spmv
    from amgx_tpu_torch.presets import FLAGSHIP
    n = 32
    ok = capi.RC.OK

    def call(out):
        rc = out if isinstance(out, capi.RC) else out[0]
        assert rc == ok, capi.last_error()
        return out

    call(capi.AMGX_initialize())
    cfg = call(capi.AMGX_config_create(FLAGSHIP))[1]
    rs = call(capi.AMGX_resources_create_simple(cfg))[1]
    A = call(capi.AMGX_matrix_create(rs, "dDDI"))[1]
    b, x, y = (call(capi.AMGX_vector_create(rs, "dDDI"))[1]
               for _ in range(3))
    slv = call(capi.AMGX_solver_create(rs, "dDDI", cfg))[1]
    call(capi.AMGX_generate_distributed_poisson_7pt(A, b, x, 1, 1, n, n, n))
    assert capi._get(A).A.device.type == "cuda"
    call(capi.AMGX_solver_setup(slv, A))
    call(capi.AMGX_solver_solve_with_0_initial_guess(slv, b, x))
    xs = call(capi.AMGX_vector_download(x))[1]
    direct = pt.create_solver(pt.Config.from_string(FLAGSHIP), device=card)
    Ad = pt.gallery.poisson("7pt", n, n, n, device=card)
    direct.setup(Ad)
    xd = direct.solve(torch.ones(n ** 3, dtype=torch.float64,
                                 device=card)).x
    assert isinstance(xs, np.ndarray)
    assert np.array_equal(xs, xd.cpu().numpy())
    call(capi.AMGX_matrix_vector_multiply(A, x, y))
    assert torch.equal(capi._get(y).v, spmv(Ad.init(), xd))
    path = str(tmp_path / "sys.bin")
    pt.io.write_system(path, Ad, b=torch.ones(n ** 3, dtype=torch.float64),
                       fmt="binary")
    A2 = call(capi.AMGX_matrix_create(rs, "dDDI"))[1]
    x2 = call(capi.AMGX_vector_create(rs, "dDDI"))[1]
    call(capi.AMGX_read_system(A2, b, x2, path))
    i = np.arange(n ** 3)
    call(capi.AMGX_matrix_attach_geometry(A2, i % n, (i // n) % n,
                                          i // (n * n)))
    slv2 = call(capi.AMGX_solver_create(rs, "dDDI", cfg))[1]
    call(capi.AMGX_solver_setup(slv2, A2))
    call(capi.AMGX_solver_solve(slv2, b, x2))
    assert np.array_equal(call(capi.AMGX_vector_download(x2))[1], xs)
    call(capi.AMGX_finalize())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ordered_sum_kernel_gives_the_plain_bits(card, dtype):
    """K8 (csrc/segment.cu) adds each segment in stored order in its
    dtype: the plain form's bits, one launch a call, every segment length
    from empty to thousands; other dtypes raise on the card."""
    from amgx_tpu_torch.ops import cuda_spmv, segment
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 12, 5000)
    lengths[:4] = (0, 3000, 1, 777)
    starts = torch.zeros(lengths.size + 1, dtype=torch.int64)
    torch.cumsum(torch.from_numpy(lengths), 0, out=starts[1:])
    vals = torch.from_numpy(rng.standard_normal(int(starts[-1]))
                            * 10.0 ** rng.integers(-4, 5, int(starts[-1])))
    vals = vals.to(dtype).to(card)
    plan = segment.ordered_sum_plan(starts.to(card))
    before = cuda_spmv.LAUNCHES["ordered_sum"]
    got = segment.ordered_sum(vals, plan, lengths.size)
    assert cuda_spmv.LAUNCHES["ordered_sum"] == before + 1
    want = segment.ordered_sum_plain(vals, plan, lengths.size)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), segment.ordered_sum(
        vals.cpu(), segment.ordered_sum_plan(starts), lengths.size))
    with pytest.raises(TypeError):
        segment.ordered_sum(vals.to(torch.bfloat16), plan, lengths.size)
