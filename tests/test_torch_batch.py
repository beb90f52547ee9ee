"""Batched solves in amgx_tpu_torch (amgx_tpu_torch.batch, Solver.solve_many,
the plain forms' batch axis and ops/batched.py) against the JAX
package's amgx_tpu.batch, on the CPU.

The shape is the JAX package's own batch test's (tests/test_batch.py):
the 5-point 16^2 Poisson, BATCHED_CG in float64, batches of 4 and 3
from seeded numpy, multi-matrix systems A + c I. Per system the two
packages give the same iterations, status and `converged`, x and the
residual norm within 1e-10 relative and the same NaN mask in the
history; the port's batch gives its own solo solves' iterations and x
within 1e-12. The kernels K1-K4 run only on the card (chip_smoke.py
`phase_batch` holds them to their single kernels bit for bit); here
their plain versions run, which these tests hold to the JAX package's
multi forms of the same work.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.batch import BatchedSolver as JaxBatched
from amgx_tpu.batch import RequestBatcher as JaxBatcher
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import batched as jbatched
from amgx_tpu.ops.pallas_spmv import LANES, transfer_quota_rows

import amgx_tpu_torch as pt
from amgx_tpu_torch.batch import (BatchedSolver, RequestBatcher,
                                  pad_to_bucket_size, pattern_fingerprint,
                                  stack_solve_datas)
from amgx_tpu_torch.errors import BadParametersError
from amgx_tpu_torch.ops import batched as pbatched
from amgx_tpu_torch.ops import cuda_spmv
from amgx_tpu_torch.ops.cuda_csr import csr_spmv_plain
from amgx_tpu_torch.ops.spmv import residual, spmv
from amgx_tpu_torch.ops.smooth import children_table
from amgx_tpu_torch.presets import BATCHED_CG
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

jx.initialize()

# float64 solves in two implementations (the JAX batch test's 1e-10 on
# res_norm); the port's batch against its own solo solves; the multi
# forms (float64 compositions of the same products)
TOL = 1e-10
TOL_SOLO = 1e-12
TOL_FORM = 1e-12
CFG = BATCHED_CG + ", s:store_res_history=1"
SHIFTS = (0.0, 0.5, 4.0)


def _rhs(n, n_sys, seed):
    return np.random.default_rng(seed).standard_normal((n_sys, n))


def _jax_shift(A, c):
    vals = np.asarray(A.values).copy()
    vals[np.asarray(A.diag_idx)] += c
    return A.with_values(vals)


def _port_shift(A, c):
    """A + c I through the values (with_values keeps the structure)."""
    rows = torch.repeat_interleave(torch.arange(A.num_rows),
                                   torch.diff(A.row_offsets.long()))
    v = A.values.clone()
    v[rows == A.col_indices.long()] += c
    return A.with_values(v)


@pytest.fixture(scope="module")
def grids():
    return (jx.gallery.poisson("5pt", 16, 16).init(),
            pt.gallery.poisson("5pt", 16, 16, device="cpu").init())


def _batched(cfg, A, port):
    if port:
        bs = BatchedSolver(pt.Config.from_string(cfg), device="cpu")
    else:
        bs = JaxBatched(JaxConfig.from_string(cfg))
    bs.setup(A)
    return bs


def _same(rj, rp, tol=TOL):
    """Per system: iterations, status, converged equal; x and res_norm
    within `tol` relative; the history's NaN mask equal."""
    np.testing.assert_array_equal(np.asarray(rp.iterations),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(np.asarray(rp.status),
                                  np.asarray(rj.status))
    np.testing.assert_array_equal(np.asarray(rp.converged),
                                  np.asarray(rj.converged))
    xj, xp = np.asarray(rj.x), rp.x.numpy()
    for i in range(xj.shape[0]):
        assert np.abs(xp[i] - xj[i]).max() <= tol * np.abs(xj[i]).max()
    np.testing.assert_allclose(rp.res_norm, np.asarray(rj.res_norm),
                               rtol=tol)
    np.testing.assert_array_equal(np.isnan(rp.res_history),
                                  np.isnan(np.asarray(rj.res_history)))


def _multi_matrix(grids, cfg, seed=4):
    Aj, Ap = grids
    B = _rhs(Ap.num_rows, len(SHIFTS), seed)
    jm = [_jax_shift(Aj, c) for c in SHIFTS]
    pm = [_port_shift(Ap, c) for c in SHIFTS]
    rj = _batched(cfg, jm[0], False).solve_many(B, matrices=jm)
    bp = _batched(cfg, pm[0], True)
    return rj, bp.solve_many(torch.from_numpy(B), matrices=pm), bp, pm, B


@pytest.fixture(scope="module")
def multi_rhs(grids):
    Aj, Ap = grids
    B = _rhs(Ap.num_rows, 4, 1)
    rj = _batched(CFG, Aj, False).solve_many(B)
    bp = _batched(CFG, Ap, True)
    return rj, bp.solve_many(torch.from_numpy(B)), bp, B


@pytest.fixture(scope="module")
def multi_matrix(grids):
    return _multi_matrix(grids, CFG)


def test_multi_rhs_matches_jax(multi_rhs):
    rj, rp, _, _ = multi_rhs
    assert rp.all_converged and rp.batch_size == 4
    _same(rj, rp)


def test_multi_matrix_matches_jax_and_freezes(multi_matrix):
    """Distinct iteration counts in one batch: each frozen system's x and
    residual are its own stopping iteration's, as in the JAX package."""
    rj, rp, _, _, _ = multi_matrix
    _same(rj, rp)
    its = rp.iterations.tolist()
    assert len(set(its)) == 3 and its[0] > its[2], its
    # the history ends at each system's own stop
    for i, h in enumerate(rp.res_history):
        assert np.isfinite(h[:its[i] + 1]).all()
        assert np.isnan(h[its[i] + 1:]).all()


def test_matrix_free_multi_matrix(grids):
    """amg:matrix_free=1: level 0 smooths from per-system stencil
    coefficients (the plain forms of K2's coefficient mode), held to the
    JAX package's matrix-free level 0."""
    cfg = CFG + ", amg:matrix_free=1"
    rj, rp, bp, pm, _ = _multi_matrix(grids, cfg)
    jamg = _batched(cfg, grids[0], False).solver.preconditioner.amg
    assert jamg.levels[0].smoother._mf_stencil is not None
    _same(rj, rp)
    datas = bp._per_system_data(pm)
    data, _ = stack_solve_datas(datas)
    st = data["precond"]["amg"]["levels"][0]["stencil"]
    assert tuple(st.coeffs.shape) == (3, st.k)
    assert data["precond"]["amg"]["levels"][0]["A"].dia_vals is None


def _solo(bs, matrices, B):
    out = []
    for i in range(B.shape[0]):
        if matrices is not None:
            bs.solver.resetup(matrices[i])
        out.append(bs.solver.solve(torch.from_numpy(B[i])))
    return out


@pytest.mark.parametrize("case", ["multi_rhs", "multi_matrix"])
def test_batch_matches_own_solo_solves(case, request):
    got = request.getfixturevalue(case)
    rp, bp, B = got[1], got[2], got[-1]
    solo = _solo(bp, got[3] if case == "multi_matrix" else None, B)
    for i, r in enumerate(solo):
        assert int(rp.iterations[i]) == r.iterations
        assert int(rp.status[i]) == r.status_code
        assert (rp.x[i] - r.x).abs().max() <= TOL_SOLO * r.x.abs().max()
        np.testing.assert_allclose(rp.res_norm[i], r.res_norm, rtol=TOL)


@pytest.mark.parametrize("cfg", [
    "solver=CG, max_iters=400, monitor_residual=1, tolerance=1e-10",
    "solver=CG, max_iters=400, monitor_residual=1, tolerance=1e-10,"
    " krylov_fusion=0",
    CFG.replace("s:store_res_history=1", "s:krylov_fusion=0"),
    CFG + ", amg:cycle=W"])
def test_solver_solve_many_matches_solo(grids, cfg):
    """Solver.solve_many on CG, both krylov_fusion routes of PCG and a
    W-cycle: per system its solo solve's iterations and x."""
    _, Ap = grids
    s = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    s.setup(Ap)
    B = _rhs(Ap.num_rows, 3, 5)
    res = s.solve_many(B)
    assert res.all_converged
    assert s._batched is not None and s._batched.solver is s
    for i in range(3):
        ref = s.solve(torch.from_numpy(B[i]))
        assert int(res.iterations[i]) == ref.iterations
        assert (res.x[i] - ref.x).abs().max() <= TOL_SOLO * ref.x.abs().max()


def test_solve_many_matches_jax_cg(grids):
    Aj, Ap = grids
    cfg = "solver=CG, max_iters=400, monitor_residual=1, tolerance=1e-10"
    B = _rhs(Ap.num_rows, 3, 5)
    sj = jx.create_solver(JaxConfig.from_string(cfg))
    sj.setup(Aj)
    sp = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    sp.setup(Ap)
    rj, rp = sj.solve_many(B), sp.solve_many(B)
    np.testing.assert_array_equal(rp.iterations, np.asarray(rj.iterations))
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=TOL * np.abs(np.asarray(rj.x)).max())


# ---------------------------------------------------------------------------
# rejected configurations: the JAX package's errors, and the solvers with
# no batched iteration in the port
# ---------------------------------------------------------------------------


def _two(A):
    return [A, _port_shift(A, 1.0)]


REJECT = {
    "structure_reuse_0": (CFG.replace("amg:structure_reuse_levels=-1",
                                      "amg:structure_reuse_levels=0"),
                          True, "structure_reuse"),
    "trace_baking": ("solver(s)=PCG, s:max_iters=100, s:monitor_residual=1,"
                     " s:tolerance=1e-8, s:preconditioner(c)=CHEBYSHEV,"
                     " c:max_iters=2, c:chebyshev_lambda_estimate_mode=2,"
                     " c:preconditioner=NOSOLVER", True, "bakes"),
    "scaling": (CFG + ", s:scaling=DIAGONAL_SYMMETRIC", False, "scaling"),
    "gmres": ("solver=FGMRES, max_iters=50, monitor_residual=1,"
              " preconditioner(amg)=AMG, amg:algorithm=AGGREGATION,"
              " amg:selector=SIZE_2, amg:smoother=JACOBI_L1,"
              " amg:max_iters=1", False, "GMRES / FGMRES"),
    "classical": (CFG.replace("amg:algorithm=AGGREGATION",
                              "amg:algorithm=CLASSICAL"),
                  False, "classical levels"),
    # batched since the GEO + CHEBYSHEV_POLY batch (ROADMAP.md Queue A
    # item 9.2): solve_many now runs them (match None)
    "chebyshev_poly": (CFG.replace("amg:smoother(sm)=JACOBI_L1",
                                   "amg:smoother(sm)=CHEBYSHEV_POLY"),
                       True, None),
    "geo": (CFG.replace("amg:selector=SIZE_2", "amg:selector=GEO"), True,
            None),
    "k_cycle": (CFG.replace("amg:cycle=V", "amg:cycle=CG"), False,
                "CG cycle"),
    "bicgstab": (CFG.replace("solver(s)=PCG", "solver(s)=PBICGSTAB"), False,
                 "item 9"),
    "bf16_hierarchy": (CFG + ", amg:amg_precision=bfloat16", False,
                       "reduced-precision hierarchies"),
}


@pytest.mark.parametrize("name", sorted(REJECT))
def test_rejected_configurations(grids, name):
    cfg, multi, match = REJECT[name]
    _, Ap = grids
    bs = _batched(cfg, Ap, True)
    B = _rhs(Ap.num_rows, 2, 2)
    if match is None:
        # no longer refused: each system converges as its solo solve
        res = bs.solve_many(B, matrices=_two(Ap) if multi else None)
        assert res.all_converged
        return
    with pytest.raises(BadParametersError, match=match):
        bs.solve_many(B, matrices=_two(Ap) if multi else None)


def test_rejected_shapes_and_counts(grids):
    _, Ap = grids
    bs = BatchedSolver(pt.Config.from_string(CFG), device="cpu")
    B = _rhs(Ap.num_rows, 2, 2)
    with pytest.raises(BadParametersError, match="before setup"):
        bs.solve_many(B)
    bs.setup(Ap)
    with pytest.raises(BadParametersError, match="2 matrices for 3"):
        bs.solve_many(_rhs(Ap.num_rows, 3, 2), matrices=_two(Ap))
    with pytest.raises(BadParametersError, match="must stack"):
        bs.solve_many(_rhs(Ap.num_rows + 1, 2, 2))
    # another pattern: the hierarchy's levels differ in shape or count
    other = pt.gallery.poisson("5pt", 12, 12, device="cpu").init()
    datas = [bs.solver.solve_data()]
    bs2 = _batched(CFG, other, True)
    datas.append(bs2.solver.solve_data())
    with pytest.raises(BadParametersError,
                       match="structure differs|shapes differ"):
        stack_solve_datas(datas)
    with pytest.raises(BadParametersError, match="shapes differ"):
        stack_solve_datas([{"v": torch.zeros(3)}, {"v": torch.zeros(4)}])
    with pytest.raises(BadParametersError, match="structure differs"):
        stack_solve_datas([{"v": torch.zeros(3)}, {"w": torch.zeros(3)}])


def test_stacked_data_shares_structure(multi_matrix):
    """One copy of the structure, B of the values: every integer leaf and
    the children / transfer tables shared, the values stacked, the level
    view of A and the solver's A stacked once."""
    _, _, bp, pm, _ = multi_matrix
    data, axes = stack_solve_datas(bp._per_system_data(pm))
    A = data["A"]
    assert tuple(A.values.shape) == (3, A.nnz)
    assert A.row_offsets is pm[0].row_offsets
    assert tuple(A.dia_vals.shape) == (3, len(A.dia_offsets), A.num_rows)
    amg = data["precond"]["amg"]
    assert amg["levels"][0]["A"] is data["precond"]["A"]
    for ld, la in zip(amg["levels"], axes["precond"]["amg"]["levels"]):
        assert la["children"] is None and la["aggregates"] is None
        assert la["A"]["values"] == 0 and la["A"]["row_offsets"] is None
        assert ld["smoother"]["dinv"].dim() == 2
    assert amg["coarse"]["qt"].dim() == 3


# ---------------------------------------------------------------------------
# the request batcher
# ---------------------------------------------------------------------------


def _stream(Aj, Ap):
    """(JAX matrices, port matrices, rhs) of a mixed stream: 3 requests on
    the 16^2 pattern (two shifted), 2 on a 6^3 7-point one, then 2 more on
    16^2 sharing one matrix."""
    jo = jx.gallery.poisson("7pt", 6, 6, 6).init()
    po = pt.gallery.poisson("7pt", 6, 6, 6, device="cpu").init()
    jm = [Aj, _jax_shift(Aj, 0.5), _jax_shift(Aj, 4.0), jo, jo]
    pm = [Ap, _port_shift(Ap, 0.5), _port_shift(Ap, 4.0), po, po]
    rng = np.random.default_rng(8)
    bs = [rng.standard_normal(M.num_rows) for M in pm]
    return jm, pm, bs


def test_request_batcher_matches_jax(grids):
    Aj, Ap = grids
    jm, pm, bs = _stream(Aj, Ap)
    rbj = JaxBatcher(JaxConfig.from_string(BATCHED_CG))
    rbp = RequestBatcher(pt.Config.from_string(BATCHED_CG), device="cpu")
    rj = [rbj.submit(M, b) for M, b in zip(jm, bs)]
    rp = [rbp.submit(M, b) for M, b in zip(pm, bs)]
    assert rbp.pending_count() == 5
    assert len(rbp.drain()) == 5 and rbp.pending_count() == 0
    rbj.drain()
    # a second drain: one shared matrix object, the fast path
    b2 = _rhs(Ap.num_rows, 2, 9)
    rj += [rbj.submit(jm[1], b) for b in b2]
    rp += [rbp.submit(pm[1], b) for b in b2]
    rbj.drain()
    rbp.drain()
    assert [(r, p) for _, r, p in rbp.dispatch_log] == \
        [(r, p) for _, r, p in rbj.dispatch_log] == [(3, 4), (2, 2), (2, 2)]
    assert rbp.live_buckets == 2
    for a, b in zip(rj, rp):
        assert b.done and b.result.iterations == a.result.iterations
        assert b.result.status_code == int(a.result.status_code)
        xj = np.asarray(a.result.x)
        assert np.abs(b.result.x.numpy() - xj).max() \
            <= TOL * np.abs(xj).max()


def test_request_batcher_template_not_stale_after_duplicates(grids):
    """Interleaved duplicates in a multi-matrix dispatch leave the solver
    on the last first-seen system's values; the next single-matrix drain
    resetups instead of trusting its bookkeeping."""
    _, Ap = grids
    rb = RequestBatcher(pt.Config.from_string(BATCHED_CG), device="cpu")
    rng = np.random.default_rng(12)
    A1 = _port_shift(Ap, 5.0)
    for M in (Ap, A1, Ap):
        rb.submit(M, rng.standard_normal(M.num_rows))
    rb.drain()
    b = torch.from_numpy(rng.standard_normal(Ap.num_rows))
    req = rb.submit(Ap, b)
    rb.solve_many([Ap], [rng.standard_normal(Ap.num_rows)])
    assert req.done
    r = b - pt.ops.spmv.spmv(Ap, req.result.x)
    assert float(r.norm()) <= 1e-6 * float(b.norm())


def test_request_batcher_lru(grids):
    _, Ap = grids
    rb = RequestBatcher(pt.Config.from_string(BATCHED_CG), device="cpu",
                        max_buckets=1)
    other = pt.gallery.poisson("5pt", 12, 12, device="cpu").init()
    rb.solve_many([Ap, other], [torch.ones(Ap.num_rows),
                                torch.ones(other.num_rows)])
    assert rb.live_buckets == 1 and rb.bucket_evictions == 1
    with pytest.raises(BadParametersError, match="ladder"):
        RequestBatcher(pt.Config.from_string(BATCHED_CG), device="cpu",
                       batch_sizes=(4, 2))


def test_pattern_fingerprint_and_ladder(grids):
    Aj, Ap = grids
    other = pt.gallery.poisson("7pt", 6, 6, 6, device="cpu").init()
    fp = pattern_fingerprint(Ap)
    assert fp == pattern_fingerprint(Ap.with_values(Ap.values * 3.0))
    assert fp == pattern_fingerprint(_port_shift(Ap, 2.0))
    assert fp != pattern_fingerprint(other)
    assert [pad_to_bucket_size(n) for n in (1, 2, 3, 5, 8, 9, 31, 32, 99)] \
        == [1, 2, 4, 8, 8, 16, 32, 32, 32]


# ---------------------------------------------------------------------------
# the port's plain forms on a batch (the kernels' CPU route) and its two
# Krylov-shell compositions against the JAX package's multi forms,
# shared and per system
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def forms():
    Aj = jx.gallery.poisson("5pt", 9, 7).init()
    Ap = pt.gallery.poisson("5pt", 9, 7, device="cpu").init()
    rng = np.random.default_rng(3)
    n, nb = Ap.num_rows, 3
    scale = rng.uniform(0.5, 2.0, (nb, Ap.nnz))
    vals = [np.asarray(Aj.values) * scale[i] for i in range(nb)]
    per_j = [Aj.with_values(v) for v in vals]
    stacked = torch.stack([Ap.with_values(torch.from_numpy(v)).dia_vals
                           for v in vals])
    per_p = dataclasses.replace(Ap, dia_vals=stacked,
                                values=torch.from_numpy(np.stack(vals)))
    V = {k: rng.standard_normal((nb, n)) for k in ("X", "B", "P", "Z", "D")}
    V["dinv"] = rng.uniform(0.1, 0.3, n)
    V["beta"] = rng.standard_normal(nb)
    return types.SimpleNamespace(Aj=Aj, Ap=Ap, per_j=per_j, per_p=per_p,
                                 V=V, nb=nb, n=n)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("per", [False, True], ids=["shared", "per_system"])
@pytest.mark.parametrize("form", ["spmv_dia_multi", "spmv_multi",
                                  "residual_multi", "smooth_dia_multi",
                                  "spmv_dot_multi"])
def test_operator_forms_match_jax(forms, form, per):
    import jax.numpy as jnp
    V, nb = forms.V, forms.nb
    taus = np.array([0.7, 1.1])
    jfun = getattr(jbatched, form)

    def jax_call(A, sl):
        X, B, P, Z = (jnp.asarray(V[k][sl]) for k in "XBPZ")
        if form in ("spmv_dia_multi", "spmv_multi"):
            return (jfun(A, X),)
        if form == "residual_multi":
            return (jfun(A, X, B),)
        if form == "smooth_dia_multi":
            return jfun(A, B, X, jnp.asarray(taus),
                        jnp.asarray(V["dinv"]), True)
        return jfun(A, P, Z, jnp.asarray(V["beta"][sl]))

    def port_call(A):
        X, B, P, Z = (_t(V[k]) for k in "XBPZ")
        if form == "spmv_dia_multi":
            return (cuda_spmv.dia_spmv_plain(A.dia_vals, A.dia_offsets, X),)
        if form == "spmv_multi":
            return (spmv(A, X),)
        if form == "residual_multi":
            return (residual(A, X, B),)
        if form == "smooth_dia_multi":
            return cuda_spmv.dia_smooth_plain(A.dia_vals, A.dia_offsets,
                                              _t(taus), B, X, _t(V["dinv"]),
                                              True)
        return pbatched.spmv_dot_multi(A, P, Z, _t(V["beta"]), product=spmv)

    got = port_call(forms.per_p if per else forms.Ap)
    if per:
        rows = [jax_call(forms.per_j[i], slice(i, i + 1)) for i in range(nb)]
        want = [np.concatenate([np.asarray(r[j]) for r in rows])
                for j in range(len(rows[0]))]
    else:
        want = jax_call(forms.Aj, slice(None))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_FORM


def test_csr_and_update_forms_match_jax(forms):
    """The port's CSR products against spmv_multi (a per-system operator
    too), cg_update_multi, and its restriction and prolongation against
    restrict_multi (unit and weighted) and prolong_corr_multi (aggregates
    and weighted rows)."""
    import jax.numpy as jnp
    V, nb, n = forms.V, forms.nb, forms.n
    Aj = jx.gallery.poisson("5pt", 9, 7).init(ell="always")
    Ap = pt.gallery.poisson("5pt", 9, 7, device="cpu")
    Ap = dataclasses.replace(Ap, initialized=True)      # no DIA view
    assert Ap.dia_offsets is None
    assert _rel(csr_spmv_plain(Ap.row_offsets, Ap.col_indices, Ap.values,
                               _t(V["X"])),
                jbatched.spmv_multi(Aj, jnp.asarray(V["X"]))) <= TOL_FORM
    per = dataclasses.replace(Ap, values=forms.per_p.values)
    want = np.stack([np.asarray(jbatched.spmv_multi(
        Aj.with_values(jnp.asarray(forms.per_p.values[i].numpy())),
        jnp.asarray(V["X"][i:i + 1])))[0] for i in range(nb)])
    assert _rel(spmv(per, _t(V["X"])), want) <= TOL_FORM
    alpha = np.random.default_rng(5).standard_normal(nb)
    got = pbatched.cg_update_multi(_t(V["X"]), _t(V["P"]), _t(V["B"]),
                                   _t(V["Z"]), _t(alpha))
    want = jbatched.cg_update_multi(*(jnp.asarray(V[k]) for k in "XPBZ"),
                                    jnp.asarray(alpha))
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_FORM
    rng = np.random.default_rng(6)
    nc = 20
    agg = rng.permutation(np.arange(n) % nc)
    ctab = children_table(torch.from_numpy(agg), nc)
    m = ctab.shape[0]
    cwt = rng.uniform(0.2, 1.0, (m, nc))
    XC = rng.standard_normal((nb, nc))
    for wt in (None, cwt):
        ns = types.SimpleNamespace(ctab=jnp.asarray(ctab.numpy()), m=m,
                                   nc=nc, cwt=None if wt is None
                                   else jnp.asarray(wt))
        got = cuda_spmv.restrict_plain(ctab, _t(V["B"]),
                                       None if wt is None else _t(wt))
        assert _rel(got,
                    jbatched.restrict_multi(jnp.asarray(V["B"]), ns)) \
            <= TOL_FORM
    front = transfer_quota_rows(forms.Aj.dia_offsets, n)[0] * LANES
    atab = np.concatenate([np.zeros(front, np.int32), agg.astype(np.int32)])
    ns = types.SimpleNamespace(atab=jnp.asarray(atab), ptab=None)
    got = cuda_spmv.prolong_plain(_t(V["X"]), _t(XC), torch.from_numpy(agg),
                                  None, None)
    assert _rel(got, jbatched.prolong_corr_multi(
        forms.Aj, jnp.asarray(V["X"]), jnp.asarray(XC), ns)) <= TOL_FORM
    mp = 3
    ptab = rng.integers(-1, nc, (mp, n)).astype(np.int32)
    pwt = rng.uniform(0.1, 1.0, (mp, n))
    pad = np.full((mp, front), -1, np.int32)
    ns = types.SimpleNamespace(
        ptab=jnp.asarray(np.concatenate([pad, ptab], 1)), mp=mp,
        pwt=jnp.asarray(np.concatenate([np.zeros((mp, front)), pwt], 1)))
    got = cuda_spmv.prolong_plain(_t(V["X"]), _t(XC), None,
                                  torch.from_numpy(ptab), _t(pwt))
    assert _rel(got, jbatched.prolong_corr_multi(
        forms.Aj, jnp.asarray(V["X"]), jnp.asarray(XC), ns)) <= TOL_FORM


def test_batch_rows_equal_single_plain_forms(forms):
    """Row s of each batched plain form (the kernels' CPU route) has the
    single form's bits on system s: the same sums in the same order."""
    from amgx_tpu_torch.ops import cuda_batched, cuda_csr
    from amgx_tpu_torch.ops.stencil import detect_stencil
    A = pt.gallery.poisson("7pt", 5, 4, 3, dtype=torch.float32,
                           device="cpu").init()
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((3, A.num_rows))).float()
    B = torch.from_numpy(rng.standard_normal((3, A.num_rows))).float()
    taus = torch.tensor([0.8, 1.2])
    vals = torch.stack([A.dia_vals * (1 + 0.1 * s) for s in range(3)])
    st = detect_stencil(A, "l1")
    st3 = dataclasses.replace(st, coeffs=torch.stack(
        [st.coeffs * (1 + 0.1 * s) for s in range(3)]))
    for s in range(3):
        y = cuda_batched.dia_spmv_multi(vals, A.dia_offsets, X)
        assert torch.equal(y[s], cuda_spmv.dia_spmv(vals[s], A.dia_offsets,
                                                    X[s]))
        x3, r3 = cuda_batched.dia_smooth_mf_multi(st3, taus, B, X)
        x1, r1 = cuda_spmv.dia_smooth_mf(
            dataclasses.replace(st, coeffs=st3.coeffs[s]), taus, B[s], X[s])
        assert torch.equal(x3[s], x1) and torch.equal(r3[s], r1)
        y = cuda_batched.csr_spmv_multi(A.row_offsets, A.col_indices,
                                        A.values, X)
        assert torch.equal(y[s], cuda_csr.csr_spmv(
            A.row_offsets, A.col_indices, A.values, X[s]))


def test_reuse_message_names_the_energymin_item():
    """The base level's refusal of structure reuse no longer names the
    ENERGYMIN level: ported, it reuses its structure as a classical
    level does."""
    from amgx_tpu_torch.amg.classical import ClassicalAMGLevel
    from amgx_tpu_torch.amg.energymin import EnergyminAMGLevel
    from amgx_tpu_torch.amg.hierarchy import AMGLevel
    with pytest.raises(NotImplementedError, match="structure reuse") as e:
        AMGLevel._ghost(4).reuse_structure(None)
    assert "ENERGYMIN" not in str(e.value) and "item 8" not in str(e.value)
    assert EnergyminAMGLevel.reuse_structure is \
        ClassicalAMGLevel.reuse_structure
