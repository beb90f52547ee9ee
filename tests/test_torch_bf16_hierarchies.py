"""The bfloat16 aggregation and classical hierarchies of amgx_tpu_torch
(`amg_precision=bfloat16`, `solve_precision=bfloat16` on CSR levels and
weighted transfer rows) against the JAX package, on the CPU.

The JAX side runs its Pallas kernels under the interpreter
(`force_pallas_interpret`), the code a TPU runs, and its XLA ops where
the reference has no kernel. The inputs are the port's own 16^3
classical (PMIS + D2) and SIZE_2 aggregation levels, handed to both
packages as the same numpy arrays (the hierarchies themselves are held
to each other in test_torch_classical.py and test_torch_aggregation.py;
building them here with the JAX package would compile its classical
setup again).

- B9 bf16: two sweeps on a classical and an aggregation level against
  `swell_smooth_step` on bf16 value slabs (x' rounded to bf16 after each
  sweep), with and without dinv: within 1 bf16 ulp.
- B3w / B4w bf16 on the classical level 0 against `fused_smooth_restrict`
  / `fused_corr_smooth` with bf16 `build_csr_transfer_slabs`.
- The bf16 CSR products (a CSR level's trailing residual, R r, P xc)
  against `swell_spmv_xla` in bf16 as the reference's solves compile it
  (its fused gather-multiply-reduce sums the exact products in float32
  and rounds once): bit-equal. Rounding at every add (a bf16
  scatter-add) is not.
- The stock PCG_ and FGMRES_AGGREGATION_JACOBI with
  `amg:amg_precision=bfloat16` at 12^3: the JAX Pallas route's status,
  iterations and level rows (every CSR level in its SWELL layout, so the
  reference runs its bf16 sweep kernel there), and its residual history
  within 2 %, which the JAX package's own per-operation XLA route misses.
The classical bf16 solves are in test_torch_classical_solve.py and
test_torch_classical_refinement.py, beside the JAX setups they share.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.ops import pallas_swell as psw
from amgx_tpu.ops import smooth as jfused

import amgx_tpu_torch as pt
from amgx_tpu_torch.amg.hierarchy import AMG
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops import cuda_csr, cuda_spmv
from amgx_tpu_torch.ops.smooth import build_csr_transfer_tables
from amgx_tpu_torch.ops.spmv import residual, spmv

from chip_smoke import agg_config, swell_fit
from test_torch_bf16 import MAX_ULPS, MIN_EQUAL, bf16_ulps
from test_torch_classical import LEVEL_CFG

BF = torch.bfloat16
JBF = jnp.bfloat16
AGG_LEVEL_CFG = ("algorithm=AGGREGATION, selector=SIZE_2,"
                 " smoother=BLOCK_JACOBI, max_levels=3, min_coarse_rows=32")
# a stock aggregation file's residual history against the JAX Pallas
# route's, entry by entry: the port follows the kernel's rounding (0.6 %
# and 1.0 % apart at 12^3), the JAX package's XLA route, which rounds a
# bf16 sweep at every operation, does not (10 % and 34 %)
HIST_REL = 2e-2
# both solves stop at the 1e-6 monitored residual in float32 arithmetic
X_TOL = 1e-5
AGG_SIZE = 12
# the reference's XLA CSR product and residual, compiled as in its solves
_XLA_SPMV = jax.jit(psw.swell_spmv_xla)
_XLA_RES = jax.jit(lambda A, x, b: b - psw.swell_spmv_xla(A, x))


def _bf(a):
    """A float32 numpy array as a bf16 tensor (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)


def _jbf(t):
    """A bf16 tensor as the same bf16 values in JAX."""
    return jnp.asarray(t.float().numpy(), JBF)


def _vec(n, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return _bf(rng.standard_normal(n))
    return _bf(1.0 / rng.uniform(lo, hi, n))


def _f32(M):
    """(port matrix in float32, JAX matrix in float32 with its layout)."""
    Mp = M.astype(torch.float32)
    Mj = jx.CsrMatrix.from_scipy_like(
        Mp.row_offsets.numpy(), Mp.col_indices.numpy(), Mp.values.numpy(),
        Mp.num_rows, Mp.num_cols).init()
    return Mp, Mj


@pytest.fixture(scope="module")
def levels():
    """The port's 16^3 classical hierarchy (f64) and a SIZE_2 aggregation
    hierarchy on the float32 operator."""
    cls = AMG(Config.from_string(LEVEL_CFG)).setup(
        pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    agg = AMG(Config.from_string(AGG_LEVEL_CFG)).setup(
        pt.gallery.poisson("7pt", 16, 16, 16, dtype=torch.float32,
                           device="cpu"))
    return {"classical": cls.levels, "aggregation": agg.levels}


# ---------------------------------------------------------------------------
# B9 bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_dinv", [False, True], ids=["no_dinv", "dinv"])
@pytest.mark.parametrize("kind", ["classical", "aggregation"])
def test_b9_bf16_sweeps_match_swell_kernel(levels, kind, with_dinv):
    """Two sweeps on level 1's operator: the port's bf16 B9 form against
    the JAX package's bf16 SWELL sweep kernel, each sweep's x' rounded to
    bf16."""
    Mp, Mj = _f32(levels[kind][1].A)
    assert Mj.swell_vals is not None
    Ap, Aj = Mp.astype(BF), Mj.astype(JBF)
    n = Ap.num_rows
    b, x = _vec(n, 4), _vec(n, 5)
    dinv = _vec(n, 6, 8, 12) if with_dinv else None
    taus = torch.tensor([0.9, 0.7])
    xj = _jbf(x)
    for tau in taus.tolist():
        xj = psw.swell_smooth_step(Aj, _jbf(b), xj, jnp.float32(tau),
                                   None if dinv is None else _jbf(dinv),
                                   interpret=True)
    assert xj.dtype == JBF
    xp = cuda_csr.csr_smooth(Ap.row_offsets, Ap.col_indices, Ap.values,
                             taus, b, x, dinv)
    assert xp.dtype == BF
    ulps, equal = bf16_ulps(xp, np.asarray(xj, np.float32))
    assert ulps <= MAX_ULPS and equal >= MIN_EQUAL


def test_b9_bf16_rounds_every_sweep(levels):
    """The reference's wrapper rounds x' to bf16 after every sweep: the
    same two sweeps with the state kept float32 between them miss the
    1-ulp bound (the DIA kernels' contract is not B9's)."""
    Mp, Mj = _f32(levels["classical"][1].A)
    Ap, Aj = Mp.astype(BF), Mj.astype(JBF)
    n = Ap.num_rows
    b, x = _vec(n, 4), _vec(n, 5)
    taus = torch.tensor([0.9, 0.7])
    xj = _jbf(x)
    for tau in taus.tolist():
        xj = psw.swell_smooth_step(Aj, _jbf(b), xj, jnp.float32(tau),
                                   None, interpret=True)
    x32 = cuda_csr.csr_smooth(Mp.row_offsets, Mp.col_indices,
                              Ap.values.float(), taus, b.float(), x.float())
    ulps, equal = bf16_ulps(x32.to(BF), np.asarray(xj, np.float32))
    assert ulps > MAX_ULPS or equal < MIN_EQUAL


# ---------------------------------------------------------------------------
# B3w / B4w bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def level0(levels):
    """Classical level 0 in both packages: the bf16 DIA operator, the
    weighted tables (the port's cast to bf16, the JAX slabs built in
    bf16) from the same float32 P and R."""
    lv = levels["classical"][0]
    Ap = lv.A.astype(torch.float32)
    Pp, Pj = _f32(lv.P)
    Rp, Rj = _f32(lv.R)
    xfer = build_csr_transfer_tables(Ap, Pp, Rp)
    xfer = {k: (v.to(BF) if v.is_floating_point() else v)
            for k, v in xfer.items()}
    Aj = jx.gallery.poisson("7pt", 16, 16, 16, dtype=jnp.float32).init()
    Abj = Aj.astype(JBF)
    with ps.force_pallas_interpret():
        jt = jfused.build_csr_transfer_slabs(Abj, Pj, Rj, dtype=JBF)
    return Ap.astype(BF), Abj, xfer, jt


def _dinv_pair(n, with_dinv):
    if not with_dinv:
        return None, None
    d = _vec(n, 9, 8, 12)
    return d, _jbf(d)


@pytest.mark.parametrize("with_dinv", [False, True], ids=["no_dinv", "dinv"])
def test_b3w_bf16_matches_jax(level0, with_dinv):
    """x' and bc = R r within 1 ulp (both bit-equal here). Where the
    reference's restriction spans several TPU blocks it adds a coarse
    row's partial sums from two blocks in bf16, a second rounding the
    port's one-thread-per-coarse-row sum does not make; this level is one
    block (no coarse row straddles two), so no such row exists here."""
    Ap, Aj, xfer, jt = level0
    n = Ap.num_rows
    b, x = _vec(n, 7), _vec(n, 8)
    dinv, jd = _dinv_pair(n, with_dinv)
    taus = torch.full((2,), 0.9)
    with ps.force_pallas_interpret():
        slabs = jfused.build_fused_slabs(Aj, jd)
        xj, bcj = jfused.fused_smooth_restrict(
            {"A": Aj, "fused": slabs}, _jbf(b), _jbf(x),
            jnp.asarray(taus.numpy()), jt, dinv=jd)
    xp, bcp = cuda_spmv.dia_smooth_restrict(
        Ap.dia_vals, Ap.dia_offsets, taus, b, x, xfer["ctab"], dinv,
        weights=xfer["cwt"])
    assert xp.dtype == bcp.dtype == BF
    ulps, equal = bf16_ulps(xp, np.asarray(xj, np.float32))
    assert ulps <= MAX_ULPS and equal >= MIN_EQUAL
    ulps, equal = bf16_ulps(bcp, np.asarray(bcj, np.float32))
    assert ulps <= MAX_ULPS and equal >= MIN_EQUAL


@pytest.mark.parametrize("with_dinv", [False, True], ids=["no_dinv", "dinv"])
def test_b4w_bf16_matches_jax(level0, with_dinv):
    """x + P xc summed in float32 and read unrounded by the first step,
    then the steps: x' within 1 ulp."""
    Ap, Aj, xfer, jt = level0
    n, nc = Ap.num_rows, xfer["ctab"].shape[1]
    b, x, xc = _vec(n, 10), _vec(n, 11), _vec(nc, 12)
    dinv, jd = _dinv_pair(n, with_dinv)
    taus = torch.full((2,), 0.85)
    with ps.force_pallas_interpret():
        slabs = jfused.build_fused_slabs(Aj, jd)
        xj = jfused.fused_corr_smooth(
            {"A": Aj, "fused": slabs}, _jbf(b), _jbf(x), _jbf(xc),
            jnp.asarray(taus.numpy()), jt, dinv=jd)
    xp = cuda_spmv.dia_prolong_smooth(
        Ap.dia_vals, Ap.dia_offsets, taus, b, x, xc, dinv=dinv,
        ptab=xfer["ptab"], pwt=xfer["pwt"])
    assert xp.dtype == BF
    ulps, equal = bf16_ulps(xp, np.asarray(xj, np.float32))
    assert ulps <= MAX_ULPS and equal >= MIN_EQUAL


# ---------------------------------------------------------------------------
# the bf16 CSR products (XLA ops of the reference)
# ---------------------------------------------------------------------------


def _product_case(levels, which):
    if which == "agg_A1":
        M = levels["aggregation"][1].A
    else:
        lv = levels["classical"][1]
        M = {"A1": lv.A, "P1": lv.P, "R1": lv.R}[which]
    Mp, Mj = _f32(M)
    assert Mj.swell_vals is not None
    return Mp.astype(BF), Mj.astype(JBF)


@pytest.mark.parametrize("which", ["A1", "agg_A1", "P1", "R1"])
def test_bf16_csr_products_round_once(levels, which):
    """y = M v (and for an operator the trailing residual b - A x) in
    bf16: the float32 sum of the exact products rounded once, then b - y
    rounded, as the compiled `swell_spmv_xla` on bf16 operands computes
    them: the same bits. (Run op by op, outside a compiled program, XLA
    rounds each product to bf16 before the sum; the reference's solves
    are compiled.)"""
    Mp, Mj = _product_case(levels, which)
    v = _vec(Mp.num_cols, 13)
    yj = _XLA_SPMV(Mj, _jbf(v))
    yp = spmv(Mp, v)
    assert yp.dtype == BF and yj.dtype == JBF
    assert np.array_equal(yp.float().numpy(), np.asarray(yj, np.float32))
    if which in ("A1", "agg_A1"):
        b = _vec(Mp.num_rows, 14)
        rj = _XLA_RES(Mj, _jbf(v), _jbf(b))
        rp = residual(Mp, v, b)
        assert np.array_equal(rp.float().numpy(), np.asarray(rj, np.float32))


def test_bf16_per_add_rounding_misses(levels):
    """A bf16 scatter-add (the plain CSR product run in the vector's
    dtype, which rounds at every add) misses that bit-equality and, on a
    good share of the rows, the 1-ulp bound: the route matters."""
    Mp, Mj = _product_case(levels, "A1")
    v = _vec(Mp.num_cols, 13)
    yj = np.asarray(_XLA_SPMV(Mj, _jbf(v)), np.float32)
    rows = torch.repeat_interleave(torch.arange(Mp.num_rows),
                                   torch.diff(Mp.row_offsets.long()))
    y_add = torch.zeros(Mp.num_rows, dtype=BF).index_add_(
        0, rows, Mp.values * v[Mp.col_indices.long()])
    assert not np.array_equal(y_add.float().numpy(), yj)
    ulps, equal = bf16_ulps(y_add, yj)
    assert ulps > MAX_ULPS and equal < MIN_EQUAL


@pytest.mark.parametrize("which", ["A1", "agg_A1", "P1", "R1", "long_row"])
def test_swell_fit_is_the_reference_rule(levels, which):
    """chip_smoke.py's copy of the reference's SWELL rules (which CSR
    levels its bf16 sweep kernel takes, and which products gather) gives
    the JAX package's own answer: the layout `build_swell_host` makes
    (window, slot padding) and its sweep kernel's budget gate."""
    if which == "long_row":
        # one row of 300 entries: past SWELL_MAX_K, no layout
        n = 400
        ro = np.concatenate([[0, 300], 300 + np.arange(1, n)]).astype(
            np.int32)
        ci = np.concatenate([np.arange(300), np.arange(1, n)]).astype(
            np.int32)
        vals = np.ones(ci.shape[0], np.float32)
        Mp = pt.interop.matrix_from_numpy(ro, ci, vals, n, n, device="cpu")
        Mj = jx.CsrMatrix.from_scipy_like(ro, ci, vals, n, n).init()
    else:
        Mp, Mj = _product_case(levels, which)
        Mp = Mp.astype(torch.float32)
        Mj = Mj.astype(jnp.float32)
    fit = swell_fit(torch, Mp)
    ro = np.asarray(Mj.row_offsets)
    built = psw.build_swell_host(ro, np.asarray(Mj.col_indices),
                                 np.asarray(Mj.values, np.float32),
                                 Mj.num_rows, Mj.num_cols)
    assert fit["layout"] == (built is not None)
    if built is None:
        return
    assert (fit["kpad"], fit["w128"]) == (built[1].shape[2], built[4])
    with ps.force_pallas_interpret():
        assert fit["sweep"] == psw.swell_smooth_supported(
            Mj.astype(JBF), JBF)


# ---------------------------------------------------------------------------
# the stock aggregation files in bf16, whole solves
# ---------------------------------------------------------------------------


def _bf16_agg(Config_, name):
    cfg = agg_config(Config_, name)
    cfg.set("amg_precision", "bfloat16", scope="amg")
    cfg.set("store_res_history", 1)
    return cfg


def _jax_amg(slv):
    s = slv
    while not hasattr(s, "amg"):
        s = s.preconditioner
    return s.amg


@pytest.fixture(scope="module", params=["agg-pcg", "agg-fgmres"])
def agg_bf16(request):
    """A stock aggregation file + amg_precision=bfloat16 on the 7-pt
    12^3 Poisson in float32, b = 1: the JAX Pallas route, the JAX XLA
    route and the port's CPU route."""
    n = AGG_SIZE
    A = jx.gallery.poisson("7pt", n, n, n, dtype=np.float32).init()
    b = np.ones(n ** 3, np.float32)
    runs = {}
    for route in ("pallas", "xla"):
        js = jx.create_solver(_bf16_agg(JaxConfig, request.param))
        if route == "pallas":
            with ps.force_pallas_interpret():
                js.setup(A)
                runs[route] = (js, js.solve(b))
        else:
            js.setup(A)
            runs[route] = (js, js.solve(b))
    slv = pt.create_solver(_bf16_agg(Config, request.param), device="cpu")
    slv.setup(pt.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                                 device="cpu"))
    runs["port"] = (slv, slv.solve(torch.ones(n ** 3)))
    return runs


def test_agg_bf16_solve_matches_jax(agg_bf16):
    (js, rj), (ps_, rp) = agg_bf16["pallas"], agg_bf16["port"]
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    jamg, amg = _jax_amg(js), ps_.preconditioner.amg
    assert amg.level_rows() == [lv.A.num_rows for lv in jamg.levels] + [
        jamg.coarsest_A.num_rows]
    layouts = [jamg._layout_of(lv.A) for lv in jamg.levels]
    assert layouts[0] == "dia" and set(layouts[1:]) == {"swell"}
    # the solve data: every level bf16 (values, dinv), the coarse
    # subtree float32, the aggregation tables untouched integers
    data = amg.solve_data()
    for ld in data["levels"]:
        assert ld["A"].dtype == ld["smoother"]["dinv"].dtype == BF
    for ld in data["levels"][1:]:
        assert ld["children"].dtype == ld["aggregates"].dtype \
            == torch.int64
    assert data["coarse"]["A"].dtype == torch.float32


def test_agg_bf16_history_follows_the_kernel_route(agg_bf16):
    (_, rj), (_, rx), (_, rp) = (agg_bf16[k] for k in
                                 ("pallas", "xla", "port"))
    hj = np.asarray(rj.res_history, np.float64)
    hp = np.asarray(rp.res_history, np.float64)
    hx = np.asarray(rx.res_history, np.float64)
    assert hp.shape == hj.shape == hx.shape
    assert np.max(np.abs(hp - hj) / hj) <= HIST_REL
    assert np.max(np.abs(hx - hj) / hj) > HIST_REL
    xj = np.asarray(rj.x, np.float64)
    assert np.linalg.norm(rp.x.double().numpy() - xj) \
        <= X_TOL * np.linalg.norm(xj)
