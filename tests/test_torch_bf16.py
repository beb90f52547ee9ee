"""The bfloat16 cycle of amgx_tpu_torch (`solve_precision=bfloat16` on
the flagship) against the JAX package, on the CPU.

The JAX side runs its Pallas kernels under the interpreter
(`force_pallas_interpret`), the code a TPU runs: bf16 operand streams,
the state float32 across the steps of a call, only the final stores
rounded. The port's side runs the plain forms of its bf16 kernels, which
follow the same contract; chip_smoke.py holds the CUDA kernels to them.

- B2, B3, B4 and their coefficient-mode twins at 8^3, on the 7-pt
  operator scaled by 1/3 (its off-diagonal -1/3 is not a bf16 value, so
  every cast shows), with a Chebyshev and a JACOBI_L1 schedule: within 1
  bf16 ulp of each entry's scale and at least 99 % bit-equal. Rounding
  the state to bf16 after every step misses that bound.
- B5 and B5-mf: one V-cycle of the 16^3 flagship hierarchy that is one
  coarse-tail launch, and the same with the tail entered at level 1.
- The hierarchy's cast: the level leaves are `_cast_leaf`'s, the
  coarse payload stays float32, the kernels get float32 damping factors.
The whole FLAGSHIP + solve_precision=bfloat16 solves at 16^3 are in
test_torch_bf16_solve.py (a file of their own, so that a run that hands
out whole files to its workers runs the two halves side by side).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as jps
from amgx_tpu.ops import smooth as jfused
from amgx_tpu.ops import stencil as jst

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch.amg.hierarchy import AMG, _cast_leaf
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import cuda_tail as T
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.ops.smooth import build_transfer_tables
from amgx_tpu_torch.presets import FLAGSHIP
from amgx_tpu_torch.solvers.polynomial import chebyshev_poly_coeffs
from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                               safe_recip)

from _torch_util import geo_agg

BF = torch.bfloat16
JBF = jnp.bfloat16
SHAPE = (8, 8, 8)
# Two float32 computations of the same sums (XLA's and PyTorch's may
# contract or reassociate a multiply-add differently) round to bf16 at
# most one step apart, and rarely apart at all.
MAX_ULPS = 1
MIN_EQUAL = 0.99
FLAG_BF16 = FLAGSHIP + ", solve_precision=bfloat16"
# the cycle's own knobs for the four whole solves
TAIL600 = ", amg:cycle_fusion_tail_rows=600"
SOLVES = {"slab": ", amg:matrix_free=0",
          "slab_tail600": ", amg:matrix_free=0" + TAIL600,
          "mf": ", amg:matrix_free=1",
          "mf_tail600": ", amg:matrix_free=1" + TAIL600}


def bf16_ulps(got, want):
    """(largest |got - want| in bf16 ulps, share of entries bit-equal) for
    two bf16-valued arrays. An entry's ulp is that of max(|got|, |want|),
    floored at 2^-8 of the output's largest entry: where a sum cancels
    below that, what is left on both sides is the float32 rounding of its
    far larger terms, not a bf16 rounding of the entry."""
    g = np.asarray(got.float() if torch.is_tensor(got) else
                   np.asarray(got, np.float32), np.float64)
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    floor = 2.0 ** -8 * float(np.max(np.abs(w)))
    scale = np.maximum(np.maximum(np.abs(g), np.abs(w)), floor)
    ulp = 2.0 ** (np.floor(np.log2(np.where(scale > 0, scale, 1.0))) - 7)
    return float(np.max(np.abs(g - w) / ulp)), float(np.mean(g == w))


def _assert_close(got, want):
    ulps, equal = bf16_ulps(got, want)
    assert ulps <= MAX_ULPS and equal >= MIN_EQUAL, (ulps, equal)


# ---------------------------------------------------------------------------
# B2-B4 and B2-mf..B4-mf
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    """The 7-pt 8^3 operator / 3 in both packages (bf16 slabs, bf16
    stencils with and without the L1 dinv), bf16 vectors, the GEO
    transfer tables, and the two schedules (float32 taus)."""
    P = jx.gallery.poisson("7pt", *SHAPE)
    ro, ci = np.asarray(P.row_offsets), np.asarray(P.col_indices)
    vals = (np.asarray(P.values) / 3.0).astype(np.float32)
    n = P.num_rows
    Aj = dataclasses.replace(jx.CsrMatrix.from_scipy_like(ro, ci, vals, n, n),
                             grid_shape=SHAPE).init()
    Ap = pti.matrix_from_numpy(ro, ci, vals, n, n, grid_shape=SHAPE,
                               device="cpu")
    rng = np.random.default_rng(7)
    agg, nc = geo_agg(SHAPE)
    b, x = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    xc = rng.standard_normal(nc).astype(np.float32)
    dinv = safe_recip(l1_strengthened_diag(Ap)).to(BF)
    lam = float(Ap.dia_vals.abs().sum(dim=0).max())
    # one application each, as the flagship's levels call them (order 2,
    # one sweep) and a JACOBI_L1 level with two sweeps
    schedules = {
        "chebyshev": (chebyshev_poly_coeffs(2) / lam).astype(np.float32),
        "jacobi_l1": np.full(2, 0.75, np.float32)}
    Ajb = Aj.astype(JBF)
    return {
        "Aj": Ajb, "Ap": Ap.astype(BF), "n": n, "nc": nc,
        "stj": {m: dataclasses.replace(
            jst.detect_stencil(Aj, dinv_mode=m),
            coeffs=jst.detect_stencil(Aj, dinv_mode=m).coeffs.astype(JBF))
            for m in (None, "l1")},
        "stp": {m: _cast_leaf(mf.detect_stencil(Ap, dinv_mode=m), BF)
                for m in (None, "l1")},
        "xfer_j": jfused.build_transfer_slabs(Ajb, agg, nc),
        "xfer_p": build_transfer_tables(Ap, torch.from_numpy(agg), nc),
        "vec": {k: torch.from_numpy(v).to(BF)
                for k, v in (("b", b), ("x", x), ("xc", xc))},
        "dinv": dinv, "schedules": schedules}


def _jax_vec(t):
    return jnp.asarray(t.float().numpy()).astype(JBF)


def _run_pair(pb, kind, schedule, steps=None):
    """(port outputs, JAX outputs) of one bf16 kernel form: kind is
    B2 / B3 / B4 (slab) or B2-mf / B3-mf / B4-mf."""
    taus = pb["schedules"][schedule][:steps]
    jacobi = schedule == "jacobi_l1"
    v = pb["vec"]
    tt = torch.from_numpy(taus)
    jt = jnp.asarray(taus)
    jb, jx_, jxc = (_jax_vec(v[k]) for k in ("b", "x", "xc"))
    Ap, Aj = pb["Ap"], pb["Aj"]
    dinv = pb["dinv"] if jacobi else None
    jdinv = _jax_vec(dinv) if jacobi else None
    stp = pb["stp"]["l1" if jacobi else None]
    stj = pb["stj"]["l1" if jacobi else None]
    xp, xj = pb["xfer_p"], pb["xfer_j"]
    with jps.force_pallas_interpret():
        if kind.endswith("-mf"):
            if kind == "B2-mf":
                want = jst.stencil_fused_smooth(stj, jt, jb, jx_, True)
                got = K.dia_smooth_mf(stp, tt, v["b"], v["x"], True)
            elif kind == "B3-mf":
                want = jst.stencil_smooth_restrict(stj, jt, jb, jx_, xj)
                got = K.dia_smooth_restrict_mf(stp, tt, v["b"], v["x"],
                                               xp["ctab"])
            else:
                want = jst.stencil_corr_smooth(stj, jt, jb, jx_, jxc, xj)
                got = K.dia_prolong_smooth_mf(stp, tt, v["b"], v["x"],
                                              v["xc"], xp["agg"])
        else:
            slabs = jfused.build_fused_slabs(Aj, jdinv)
            data = {"A": Aj, "fused": slabs}
            vals, offs = Ap.dia_vals, Ap.dia_offsets
            if kind == "B2":
                want = jfused.dia_fused_smooth(Aj, slabs, jb, jx_, jt,
                                               dinv=jdinv, with_residual=True)
                got = K.dia_smooth(vals, offs, tt, v["b"], v["x"], dinv)
            elif kind == "B3":
                want = jfused.fused_smooth_restrict(data, jb, jx_, jt, xj,
                                                    dinv=jdinv)
                got = K.dia_smooth_restrict(vals, offs, tt, v["b"], v["x"],
                                            xp["ctab"], dinv)
            else:
                want = jfused.fused_corr_smooth(data, jb, jx_, jxc, jt, xj,
                                                dinv=jdinv)
                got = K.dia_prolong_smooth(vals, offs, tt, v["b"], v["x"],
                                           v["xc"], xp["agg"], dinv)
    assert want is not None, f"the JAX package declined {kind}"
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return got, want


KINDS = ["B2", "B3", "B4", "B2-mf", "B3-mf", "B4-mf"]


@pytest.mark.parametrize("schedule", ["chebyshev", "jacobi_l1"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_kernel_matches_pallas(problem, kind, schedule):
    got, want = _run_pair(problem, kind, schedule)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == BF and w.dtype == JBF
        _assert_close(g, w)


def test_bf16_state_stays_float32_between_steps(problem):
    """Five Chebyshev steps as one B2 call meet the bound; the same five
    steps with the state rounded to bf16 after each (five one-step
    calls, the JAX package's XLA route) do not."""
    pb = problem
    taus = np.tile(pb["schedules"]["chebyshev"], 3)[:5]
    v = pb["vec"]
    vals, offs = pb["Ap"].dia_vals, pb["Ap"].dia_offsets
    with jps.force_pallas_interpret():
        want = jfused.dia_fused_smooth(
            pb["Aj"], jfused.build_fused_slabs(pb["Aj"]), _jax_vec(v["b"]),
            _jax_vec(v["x"]), jnp.asarray(taus), with_residual=False)
    tt = torch.from_numpy(taus)
    _assert_close(K.dia_smooth(vals, offs, tt, v["b"], v["x"],
                               with_residual=False), want)
    x = v["x"]
    for t in range(5):
        x = K.dia_smooth(vals, offs, tt[t:t + 1], v["b"], x,
                         with_residual=False)
    ulps, equal = bf16_ulps(x, want)
    assert ulps > MAX_ULPS or equal < MIN_EQUAL


def test_bf16_kernels_refuse_what_is_not_ported():
    """No bf16 dot epilogue: on a tensor off the CPU (here the meta
    device) the wrapper raises before any launch, naming ROADMAP.md
    Queue B. The bf16 weighted transfer rows (B3w / B4w) and a bf16 CSR
    level's sweeps (B9) are ported: they pass that gate and stop only at
    the device check, where a CUDA tensor would launch."""
    n, nc = 64, 8
    m = {k: torch.empty(s, dtype=BF, device="meta")
         for k, s in (("v", (7, n)), ("x", (n,)), ("xc", (nc,)))}
    taus = torch.empty(2, device="meta")
    offs = (-16, -4, -1, 0, 1, 4, 16)
    ctab = torch.empty((8, nc), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="Queue B"):
        K.dia_prolong_smooth(m["v"], offs, taus, m["x"], m["x"], m["xc"],
                             agg=torch.empty(n, dtype=torch.int32,
                                             device="meta"), with_dot=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.dia_smooth_restrict(m["v"], offs, taus, m["x"], m["x"], ctab,
                              weights=torch.empty((8, nc), dtype=BF,
                                                  device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.dia_prolong_smooth(m["v"], offs, taus, m["x"], m["x"], m["xc"],
                             ptab=torch.empty((2, n), dtype=torch.int32,
                                              device="meta"),
                             pwt=torch.empty((2, n), dtype=BF,
                                             device="meta"))
    # a CSR level (aggregation's coarse levels, classical ones): B9's
    # bf16 form, never plain-PyTorch sweeps off the CPU
    from amgx_tpu_torch.matrix import CsrMatrix
    from amgx_tpu_torch.ops.smooth import fused_smooth
    csr = CsrMatrix(row_offsets=torch.empty(n + 1, dtype=torch.int32,
                                            device="meta"),
                    col_indices=torch.empty(3 * n, dtype=torch.int32,
                                            device="meta"),
                    values=torch.empty(3 * n, dtype=BF, device="meta"),
                    num_rows=n, num_cols=n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_smooth({"A": csr}, m["x"], m["x"], taus)


def test_float32_plain_forms_keep_their_bits(problem):
    """The float32 forms are untouched by the bf16 route: B2's plain form
    gives the bits of the step loop written in float32 throughout, each
    step's multiply-add fused as the kernel's (x + tau r)."""
    A = problem["Ap"].astype(torch.float32)
    v = {k: t.float() for k, t in problem["vec"].items()}
    taus = torch.from_numpy(problem["schedules"]["chebyshev"])
    x = v["x"]
    for t in range(taus.shape[0]):
        x = torch.addcmul(x, taus[t], v["b"] - K.dia_spmv_plain(
            A.dia_vals, A.dia_offsets, x))
    r = v["b"] - K.dia_spmv_plain(A.dia_vals, A.dia_offsets, x)
    got = K.dia_smooth(A.dia_vals, A.dia_offsets, taus, v["b"], v["x"])
    assert torch.equal(got[0], x) and torch.equal(got[1], r)


# ---------------------------------------------------------------------------
# the flagship's bf16 cycle through B5, the hierarchy's cast
# ---------------------------------------------------------------------------


def _inner_amg(solver):
    return solver.preconditioner.preconditioner.amg


@pytest.fixture(scope="module", params=sorted(SOLVES))
def flagship16(request):
    """FLAGSHIP + solve_precision=bfloat16 set up at 16^3 in both
    packages (the JAX one under the interpreter): (name, JAX solver, port
    solver). The whole solves are in test_torch_bf16_solve.py."""
    cfg = FLAG_BF16 + SOLVES[request.param]
    js = jx.create_solver(JaxConfig.from_string(cfg))
    with jps.force_pallas_interpret():
        js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
    ps = pt.create_solver(Config.from_string(cfg), device="cpu")
    ps.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    return request.param, js, ps


def test_flagship_bf16_cycle_matches_jax(flagship16, monkeypatch):
    """One V-cycle of the two hierarchies from the same (b, x): the whole
    cycle one B5 (B5-mf) launch with the default tail, B3 / B4 on level 0
    and B5 from level 1 with cycle_fusion_tail_rows=600; a bf16 tail
    with float32 damping factors, coefficients and coarse inverse."""
    name, js, ps = flagship16
    seen = []
    real = T.dia_coarse_tail

    def spy(spec, arrs, b, x, with_dot=False):
        seen.append((spec, arrs, x.dtype))
        return real(spec, arrs, b, x, with_dot)

    monkeypatch.setattr(T, "dia_coarse_tail", spy)
    rng = np.random.default_rng(11)
    b, x = (rng.standard_normal(16 ** 3).astype(np.float32)
            for _ in range(2))
    ja = _inner_amg(js)
    with jps.force_pallas_interpret():
        xj = ja.cycle(ja.solve_data(), jnp.asarray(b), jnp.asarray(x))
    pa = _inner_amg(ps)
    xp = pa.cycle(pa.solve_data(), torch.from_numpy(b), torch.from_numpy(x))
    _assert_close(xp.to(BF), np.asarray(xj))
    (spec, arrs, dt), = seen
    entry = 1 if name.endswith("tail600") else 0
    assert dt == BF and spec.levels[0].n == pa.levels[entry].A.num_rows
    assert all((ls.mf is not None) == name.startswith("mf")
               for ls in spec.levels)
    for ar in arrs[:-1]:
        assert ar["taus_pre"].dtype == ar["taus_post"].dtype == torch.float32
        assert ar["vals"] is None or ar["vals"].dtype == BF
        assert ar["coeffs"] is None or ar["coeffs"].dtype == torch.float32
    assert arrs[-1]["inv"].dtype == torch.float32


def test_flagship_bf16_solve_data_is_cast_leaf(flagship16):
    """The port's bf16 solve data holds the JAX package's `_cast_leaf`
    values: bf16 level operators, damping factors (rounded to bf16 as the
    JAX package rounds them) and stencil coefficients; the coarse-solver
    payload float32."""
    name, js, ps = flagship16
    with jps.force_pallas_interpret():
        jd = _inner_amg(js).solve_data()
    pd = _inner_amg(ps).solve_data()
    for lj, lp in zip(jd["levels"], pd["levels"]):
        sj, sp = lj["smoother"], lp["smoother"]
        assert sp["taus"].dtype == BF
        assert np.array_equal(sp["taus"].float().numpy(),
                              np.asarray(sj["taus"], np.float32))
        if name.startswith("mf"):
            assert lp["stencil"].coeffs.dtype == BF
            assert np.array_equal(lp["stencil"].coeffs.float().numpy(),
                                  np.asarray(lj["stencil"].coeffs,
                                             np.float32))
            assert lp["stencil"].host == tuple(
                lp["stencil"].coeffs.double().tolist())
        else:
            vp = lp["A"].dia_vals
            # the JAX package's slab is lane-padded: (k, rows, 128)
            vj = np.asarray(lj["A"].dia_vals, np.float32).reshape(
                vp.shape[0], -1)[:, :vp.shape[1]]
            assert vp.dtype == BF and np.array_equal(vp.float().numpy(), vj)
    assert all(v.dtype == torch.float32 for v in pd["coarse"].values()
               if torch.is_tensor(v))
    assert pd["coarse"]["A"].dtype == torch.float32


@pytest.mark.parametrize("smoother", ["CHEBYSHEV_POLY", "JACOBI_L1"])
@pytest.mark.parametrize("route", ["slab", "mf"])
def test_bf16_cycle_taus_widened_once(route, smoother, monkeypatch):
    """Under a bf16 cycle the smoothers hand B3 / B4 (and -mf) float32
    damping factors, the bf16-rounded schedule widened once per setup:
    the same tensor on every call of every cycle, so the kernels' own
    widening is a no-op."""
    from amgx_tpu_torch.ops import smooth as fused
    seen = []
    # taus is the argument after x (restrict) or after x, xc (corr)
    for at, entry in enumerate(("fused_smooth_restrict",
                                "fused_corr_smooth")):
        real = getattr(fused, entry)

        def spy(data, b, x, *args, _real=real, _at=at, **kw):
            seen.append((x.dtype, args[_at]))
            return _real(data, b, x, *args, **kw)

        monkeypatch.setattr(fused, entry, spy)
    slv = pt.create_solver(Config.from_string(
        FLAG_BF16 + SOLVES[route + "_tail600"]
        + f", amg:smoother={smoother}"), device="cpu")
    slv.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    amg = _inner_amg(slv)
    data = amg.solve_data()
    b = torch.ones(16 ** 3)
    for _ in range(2):
        amg.cycle(data, b, torch.zeros(16 ** 3))
    assert len(seen) == 4 and all(dt == BF for dt, _ in seen)
    pre, post = seen[0][1], seen[1][1]
    assert seen[2][1] is pre and seen[3][1] is post
    for taus in (pre, post):
        assert taus.dtype == torch.float32
        assert torch.equal(taus, taus.to(BF).float())


@pytest.mark.parametrize("knob", ["solve_precision", "amg_precision"])
def test_float_precision_knobs_unchanged(knob):
    """`solve_precision=float` and `amg_precision=float` cast the levels
    to float32 and leave the stencil of a matrix-free level float32 with
    the host floats the kernels took before (its coefficients rounded to
    float32)."""
    amg = AMG(Config.from_string(
        f"algorithm=AGGREGATION, selector=GEO, smoother=CHEBYSHEV_POLY,"
        f" max_levels=3, min_coarse_rows=32, matrix_free=1, {knob}=float"))
    amg.setup(pt.gallery.poisson("7pt", 8, 8, 8, device="cpu"))
    lv = amg.solve_data()["levels"][0]
    st = lv["stencil"]
    assert lv["smoother"]["taus"].dtype == st.coeffs.dtype == torch.float32
    assert st.host == tuple(float(np.float32(c))
                            for c in amg.levels[0].smoother._mf_stencil.host)


def test_interop_carries_bf16_bit_exactly():
    """A bf16 JAX array read out with np.asarray (numpy's bfloat16
    extension type) comes across with every bit."""
    v = np.random.default_rng(2).standard_normal(257).astype(np.float32)
    a = np.asarray(jnp.asarray(v).astype(JBF))
    t = pti.tensor_from_numpy(a, "cpu")
    assert t.dtype == BF
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
