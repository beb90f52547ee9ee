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
