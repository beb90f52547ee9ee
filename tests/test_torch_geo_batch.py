"""Batched GEO + CHEBYSHEV_POLY solves (SERVING_CG) in amgx_tpu_torch
against the JAX package, on the CPU.

The shapes are the JAX package's own serving tests' `geo10` (the 7-pt
10^3 Poisson): batches of 4 right-hand sides from seeded numpy, the
multi-matrix systems A + 0.1 (s mod 3) I. Per system the two packages
give the same status and iterations; x agrees within 1e-6 relative in
float32 and 1e-12 in float64. With the coarse tail on (the default: at
10^3 the whole cycle is the tail) the port's batch runs the plain form
of K5 (`cuda_tail.dia_coarse_tail_multi`), the JAX package its
`tail_cycle_multi`; with it off the cycle composes the GEO transfers on
a (B, n) axis and smooths through the plain forms of K2 with per-system
damping factors. The kernels K5 and K2 with per-system taus run only on
the card (chip_smoke.py `phase_serving` holds them to B5 and B2-mf bit
for bit); here their plain forms are held to the JAX package's multi
forms and to the single plain forms row by row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.batch import BatchedSolver as JaxBatched
from amgx_tpu.batch.core import stack_solve_datas as jax_stack
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.presets import SERVING_CG as JAX_SERVING_CG

import amgx_tpu_torch as pt
from amgx_tpu_torch.batch import BatchedSolver, stack_solve_datas
from amgx_tpu_torch.errors import BadParametersError
from amgx_tpu_torch.ops import cuda_batched as KB
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import cuda_tail as T
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.presets import SERVING_CG
from _torch_util import rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

jx.initialize()

N = 10
NSYS = 4
SHIFTS = tuple(0.1 * (s % 3) for s in range(NSYS))
# x per system: two implementations of the same float arithmetic
TOL = {"float32": 1e-6, "float64": 1e-12}
# one cycle in float32 through two implementations (tests/test_torch_tail)
TOL32 = 1e-5
TAIL_OFF = ", amg:cycle_fusion_tail_rows=0"


def _jax_shift(A, c):
    vals = np.asarray(A.values).copy()
    vals[np.asarray(A.diag_idx)] += c
    return A.with_values(vals)


def _port_shift(A, c):
    rows = torch.repeat_interleave(torch.arange(A.num_rows),
                                   torch.diff(A.row_offsets.long()))
    v = A.values.clone()
    v[rows == A.col_indices.long()] += c
    return A.with_values(v)


def _grids(dtype):
    Aj = jx.gallery.poisson("7pt", N, N, N,
                            dtype=getattr(jnp, dtype)).init()
    Ap = pt.gallery.poisson("7pt", N, N, N, device="cpu",
                            dtype=getattr(torch, dtype)).init()
    return Aj, Ap


def _rhs(dtype, seed):
    return np.random.default_rng(seed).standard_normal(
        (NSYS, N ** 3)).astype(dtype)


@pytest.fixture
def tail_calls(monkeypatch):
    """The port's K5 (plain form) calls: the batch sizes it ran on."""
    seen = []
    real = T.dia_coarse_tail_multi_plain

    def spy(spec, arrs, b, x):
        seen.append(x.shape[0])
        return real(spec, arrs, b, x)

    monkeypatch.setattr(T, "dia_coarse_tail_multi_plain", spy)
    return seen


@pytest.mark.parametrize("tail", ["on", "off", "unfused"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_serving_cg_solve_many_matches_jax(dtype, tail, tail_calls):
    """SERVING_CG solve_many, multi-RHS and multi-matrix: per system the
    JAX package's status and iterations exactly, x within TOL. "unfused"
    (cycle_fusion=0: no transfer tables) restricts by the GEO pair sums
    on the batch axis."""
    extra = {"on": "", "off": TAIL_OFF,
             "unfused": ", amg:cycle_fusion=0"}[tail]
    Aj, Ap = _grids(dtype)
    jb = JaxBatched(JaxConfig.from_string(JAX_SERVING_CG + extra))
    jb.setup(Aj)
    pb = BatchedSolver(pt.Config.from_string(SERVING_CG + extra),
                       device="cpu")
    pb.setup(Ap)
    B = _rhs(dtype, 5)
    jm = [_jax_shift(Aj, c) for c in SHIFTS]
    pm = [_port_shift(Ap, c) for c in SHIFTS]
    for mats in (None, "shifted"):
        rj = jb.solve_many(B, matrices=None if mats is None else jm)
        rp = pb.solve_many(torch.from_numpy(B),
                           matrices=None if mats is None else pm)
        np.testing.assert_array_equal(rp.iterations,
                                      np.asarray(rj.iterations))
        np.testing.assert_array_equal(rp.status, np.asarray(rj.status))
        assert rp.all_converged
        xj, xp = np.asarray(rj.x), rp.x.numpy()
        for i in range(NSYS):
            assert np.abs(xp[i] - xj[i]).max() \
                <= TOL[dtype] * np.abs(xj[i]).max()
    # the tail (float32 and bfloat16 cycles only, as B5): one K5 call a
    # batched V-cycle, none with it off
    assert (len(tail_calls) > 0) == (tail == "on" and dtype == "float32")
    assert set(tail_calls) <= {NSYS}


def test_per_system_taus_match_jax():
    """Each system's CHEBYSHEV_POLY taus come from its own spectral bound
    and stack to (B, T) as the JAX package's do."""
    Aj, Ap = _grids("float64")
    jb = JaxBatched(JaxConfig.from_string(JAX_SERVING_CG))
    jb.setup(Aj)
    pb = BatchedSolver(pt.Config.from_string(SERVING_CG), device="cpu")
    pb.setup(Ap)
    jd, _ = jax_stack(jb._per_system_data([_jax_shift(Aj, c)
                                           for c in SHIFTS]))
    pd, _ = stack_solve_datas(pb._per_system_data([_port_shift(Ap, c)
                                                   for c in SHIFTS]))
    tj = np.asarray(jd["precond"]["amg"]["levels"][0]["smoother"]["taus"])
    tp = pd["precond"]["amg"]["levels"][0]["smoother"]["taus"]
    assert tuple(tp.shape) == tj.shape == (NSYS, 5)
    np.testing.assert_allclose(tp.numpy(), tj, rtol=1e-12)
    # the shifted systems' bounds differ, so do their schedules
    assert not torch.equal(tp[0], tp[1])
    # each system's coarse inverse, stacked
    assert pd["precond"]["amg"]["coarse"]["inv"].shape[0] == NSYS


@pytest.mark.parametrize("route", ["shared", "stacked"])
def test_tail_multi_plain_matches_tail_cycle_multi(route, tail_calls):
    """One batched V-cycle of SERVING_CG's AMG through the batch form of
    B5's plain twin against the JAX package's vmapped cycle, whose tail
    runs `tail_cycle_multi` (shared hierarchy) or the vmapped single tail
    (stacked, multi-matrix hierarchy), float32."""
    Aj, Ap = _grids("float32")
    jb = JaxBatched(JaxConfig.from_string(JAX_SERVING_CG))
    jb.setup(Aj)
    pb = BatchedSolver(pt.Config.from_string(SERVING_CG), device="cpu")
    pb.setup(Ap)
    if route == "shared":
        jd, jaxes = jb.solver.solve_data(), None
        pd = pb.solver.solve_data()
    else:
        jd, jaxes = jax_stack(jb._per_system_data(
            [_jax_shift(Aj, c) for c in SHIFTS]))
        pd, _ = stack_solve_datas(pb._per_system_data(
            [_port_shift(Ap, c) for c in SHIFTS]))
    rng = np.random.default_rng(9)
    B = rng.standard_normal((NSYS, N ** 3)).astype(np.float32)
    X = rng.standard_normal((NSYS, N ** 3)).astype(np.float32)
    jamg = jb.solver.preconditioner.amg
    in_axes = (None if jaxes is None else jaxes["precond"]["amg"], 0, 0)
    xj = jax.vmap(lambda d, b, x: jamg.cycle(d, b, x), in_axes=in_axes)(
        jd["precond"]["amg"], jnp.asarray(B), jnp.asarray(X))
    pamg = pb.solver.preconditioner.amg
    xp = pamg.cycle(pd["precond"]["amg"], torch.from_numpy(B),
                    torch.from_numpy(X))
    assert tail_calls == [NSYS]
    for i in range(NSYS):
        assert rel(xp[i], np.asarray(xj)[i]) < TOL32


def test_tail_multi_plain_rows_are_single_tails():
    """K5's plain form, row s: the single tail's plain form on system s's
    arrays (shared leaves as they are, stacked leaves' row s)."""
    from amgx_tpu_torch.ops.smooth import _tail_plan
    _, Ap = _grids("float32")
    pb = BatchedSolver(pt.Config.from_string(SERVING_CG), device="cpu")
    pb.setup(Ap)
    pd, _ = stack_solve_datas(pb._per_system_data(
        [_port_shift(Ap, c) for c in SHIFTS]))
    amg = pb.solver.preconditioner.amg
    g = torch.Generator().manual_seed(2)
    B, X = (torch.randn(NSYS, N ** 3, generator=g) for _ in range(2))
    spec, arrs = _tail_plan(amg, "V", pd["precond"]["amg"], 0, X)
    assert arrs[0]["taus_pre"].shape == (NSYS, 5)
    assert arrs[-1]["inv"].dim() == 3
    got = T.dia_coarse_tail_multi(spec, arrs, B, X)
    for s in range(NSYS):
        one = T.dia_coarse_tail_plain(spec, T.system_arrays(arrs, s), B[s],
                                      X[s])
        assert torch.equal(got[s], one)
    with pytest.raises(NotImplementedError, match="Queue B.1"):
        T.dia_coarse_tail_multi(spec, arrs, B, X, with_dot=True)


@pytest.mark.parametrize("form", ["slab", "stencil"])
def test_k2_per_system_taus_rows(form):
    """K2's plain forms with (B, T) damping factors: row s equals the
    single plain form with system s's taus, bit for bit; (T,) taus are
    the shared schedule's rows."""
    _, Ap = _grids("float32")
    g = torch.Generator().manual_seed(4)
    n = Ap.num_rows
    B, X = (torch.randn(NSYS, n, generator=g) for _ in range(2))
    taus = 0.1 + torch.rand(NSYS, 3, generator=g)
    if form == "slab":
        vals, offs = Ap.dia_vals, Ap.dia_offsets
        got = KB.dia_smooth_multi(vals, offs, taus, B, X, None, True)
        for s in range(NSYS):
            one = K.dia_smooth_plain(vals, offs, taus[s], B[s], X[s], None,
                                     True)
            assert all(torch.equal(a[s], b) for a, b in zip(got, one))
        shared = KB.dia_smooth_multi(vals, offs, taus[0], B, X, None, True)
        stacked = KB.dia_smooth_multi(vals, offs, taus[:1].expand(
            NSYS, 3).contiguous(), B, X, None, True)
    else:
        st = mf.detect_stencil(Ap)
        got = KB.dia_smooth_mf_multi(st, taus, B, X, True)
        for s in range(NSYS):
            one = mf._xla_smooth(st.spec(), st.coeffs, taus[s], B[s], X[s],
                                 True)
            assert all(torch.equal(a[s], b) for a, b in zip(got, one))
        shared = KB.dia_smooth_mf_multi(st, taus[0], B, X, True)
        stacked = KB.dia_smooth_mf_multi(st, taus[:1].expand(
            NSYS, 3).contiguous(), B, X, True)
    for a, b in zip(shared, stacked):
        assert torch.equal(a, b)


def test_bf16_serving_batch_stays_refused():
    """A bfloat16 cycle has no batched form (ROADMAP.md Queue A item
    9.5): solve_many raises, naming it."""
    _, Ap = _grids("float32")
    pb = BatchedSolver(pt.Config.from_string(
        SERVING_CG + ", solve_precision=bfloat16"), device="cpu")
    pb.setup(Ap)
    with pytest.raises(BadParametersError, match="item 9"):
        pb.solve_many(torch.zeros(2, Ap.num_rows))
