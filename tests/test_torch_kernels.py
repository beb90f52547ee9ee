"""The port's DIA kernels B1-B4 (amgx_tpu_torch/ops/cuda_spmv.py) against
the JAX package's on the same inputs.

On the CPU each wrapper runs its plain PyTorch twin; the CUDA kernels
themselves are held against those twins on the card by chip_smoke.py.
The JAX side runs its Pallas kernels in interpret mode (float32), as
its own tests do, and its XLA slab forms (float64). Grids: 8^3 and a
ragged 13x9x7, so every offset's edges and odd-extent aggregates occur.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from amgx_tpu.ops import batched
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.ops import smooth as fused
from amgx_tpu.solvers.polynomial import chebyshev_poly_coeffs

from amgx_tpu_torch.ops import cuda_build
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops.smooth import build_transfer_tables

from _torch_util import geo_agg, grid_operator, rel, vectors
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

GRIDS = [(8, 8, 8), (13, 9, 7)]
# f64: the same arithmetic in another summation order
TOL64 = 1e-12
# Damping schedules: CHEBYSHEV_POLY taus over the Gershgorin bound 12 of
# the 7-pt operator, with the f32 tolerance of each. Order 2 (what the
# flagship's config names): the ROADMAP's 1e-6 for f32 kernel math.
# Order 5 (what the flagship's smoother takes, its order option being
# out of the smoother's scope): five dependent steps, the last with
# tau = 1.38 > 1, amplify each step's rounding -- measured ~1.1e-6,
# held to 3e-6.
SCHEDULES = {"cheb2": (chebyshev_poly_coeffs(2) / 12.0, 1e-6),
             "cheb5": (chebyshev_poly_coeffs(5) / 12.0, 3e-6)}
TOL32 = SCHEDULES["cheb2"][1]
TAUS = SCHEDULES["cheb5"][0]


def _case(shape, dtype):
    Aj, Ap = grid_operator(shape, dtype)
    agg, nc = geo_agg(shape)
    b, x, dinv, xc = vectors(Aj.num_rows, nc, dtype)
    xfer = build_transfer_tables(Ap, torch.from_numpy(agg), nc)
    return Aj, Ap, agg, nc, b, x, dinv, xc, xfer


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(Ap):
    return Ap.dia_vals, Ap.dia_offsets


@pytest.mark.parametrize("shape", GRIDS)
def test_b1_spmv_f32(shape):
    Aj, Ap, _, _, _, x, _, _, _ = _case(shape, np.float32)
    with ps.force_pallas_interpret():
        yj = ps.dia_spmv(Aj, jnp.asarray(x))
    yp = K.dia_spmv(*_port(Ap), _t(x))
    assert rel(yp, yj) < TOL32


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("with_dinv", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
def test_b2_smooth_f32(shape, with_dinv, with_residual, schedule):
    Aj, Ap, _, _, b, x, dinv, _, _ = _case(shape, np.float32)
    dinv = dinv if with_dinv else None
    taus, tol = SCHEDULES[schedule]
    taus = taus.astype(np.float32)
    with ps.force_pallas_interpret():
        slabs = fused.build_fused_slabs(
            Aj, None if dinv is None else jnp.asarray(dinv))
        outj = fused.dia_fused_smooth(
            Aj, slabs, jnp.asarray(b), jnp.asarray(x), jnp.asarray(taus),
            dinv=None if dinv is None else jnp.asarray(dinv),
            with_residual=with_residual)
    outp = K.dia_smooth(*_port(Ap), _t(taus), _t(b), _t(x),
                        None if dinv is None else _t(dinv), with_residual)
    if with_residual:
        assert rel(outp[0], outj[0]) < tol
        # r = b - A x' carries x''s error through A: bound it by
        # tol * ||A||_inf * ||x'||
        norm_a = float(Ap.dia_vals.abs().sum(dim=0).max())
        assert rel(outp[1], outj[1]) * np.linalg.norm(outj[1]) < \
            tol * norm_a * np.linalg.norm(outj[0])
    else:
        assert rel(outp, outj) < tol


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("with_dinv", [False, True])
def test_b3_smooth_restrict_f32(shape, with_dinv, schedule):
    Aj, Ap, agg, nc, b, x, dinv, _, xfer = _case(shape, np.float32)
    dinv = dinv if with_dinv else None
    taus, tol = SCHEDULES[schedule]
    taus = taus.astype(np.float32)
    jd = None if dinv is None else jnp.asarray(dinv)
    with ps.force_pallas_interpret():
        slabs = fused.build_fused_slabs(Aj, jd)
        jxfer = fused.build_transfer_slabs(Aj, agg, nc)
        xj, bcj = fused.fused_smooth_restrict(
            {"A": Aj, "fused": slabs}, jnp.asarray(b), jnp.asarray(x),
            jnp.asarray(taus), jxfer, dinv=jd)
    xp, bcp = K.dia_smooth_restrict(*_port(Ap), _t(taus), _t(b), _t(x),
                                    xfer["ctab"],
                                    None if dinv is None else _t(dinv))
    assert rel(xp, xj) < tol
    assert rel(bcp, bcj) < tol


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("with_dinv", [False, True])
def test_b4_prolong_smooth_f32(shape, with_dinv, schedule):
    Aj, Ap, agg, nc, b, x, dinv, xc, xfer = _case(shape, np.float32)
    dinv = dinv if with_dinv else None
    taus, tol = SCHEDULES[schedule]
    taus = taus.astype(np.float32)
    jd = None if dinv is None else jnp.asarray(dinv)
    with ps.force_pallas_interpret():
        slabs = fused.build_fused_slabs(Aj, jd)
        jxfer = fused.build_transfer_slabs(Aj, agg, nc)
        xj = fused.fused_corr_smooth(
            {"A": Aj, "fused": slabs}, jnp.asarray(b), jnp.asarray(x),
            jnp.asarray(xc), jnp.asarray(taus), jxfer, dinv=jd)
    xp = K.dia_prolong_smooth(*_port(Ap), _t(taus), _t(b), _t(x), _t(xc),
                              xfer["agg"],
                              None if dinv is None else _t(dinv))
    assert rel(xp, xj) < tol


# ---------------------------------------------------------------------------
# float64: the JAX package's XLA slab forms (its f64 parity references)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("kernel", ["spmv", "smooth", "smooth_restrict",
                                    "prolong_smooth"])
def test_plain_f64_against_slab_forms(shape, kernel):
    Aj, Ap, agg, nc, b, x, dinv, xc, xfer = _case(shape, np.float64)
    B, X, XC = (jnp.asarray(v)[None] for v in (b, x, xc))
    taus, jd = jnp.asarray(TAUS), jnp.asarray(dinv)
    vals, offs = _port(Ap)
    if kernel == "spmv":
        assert rel(K.dia_spmv(vals, offs, _t(x)),
                   batched.spmv_dia_multi(Aj, X)[0]) < TOL64
    elif kernel == "smooth":
        xj, rj = batched.smooth_dia_multi(Aj, B, X, taus, jd, True)
        xp, rp = K.dia_smooth(vals, offs, _t(TAUS), _t(b), _t(x), _t(dinv))
        assert rel(xp, xj[0]) < TOL64 and rel(rp, rj[0]) < TOL64
    elif kernel == "smooth_restrict":
        jxfer = fused.build_transfer_slabs(Aj, agg, nc)
        xj, bcj = batched.smooth_restrict_dia_multi(Aj, B, X, taus, jd,
                                                    jxfer)
        xp, bcp = K.dia_smooth_restrict(vals, offs, _t(TAUS), _t(b), _t(x),
                                        xfer["ctab"], _t(dinv))
        assert rel(xp, xj[0]) < TOL64 and rel(bcp, bcj[0]) < TOL64
    else:
        jxfer = fused.build_transfer_slabs(Aj, agg, nc)
        xj = batched.corr_smooth_dia_multi(Aj, B, X, XC, taus, jd, jxfer)
        xp = K.dia_prolong_smooth(vals, offs, _t(TAUS), _t(b), _t(x),
                                  _t(xc), xfer["agg"], _t(dinv))
        assert rel(xp, xj[0]) < TOL64


# ---------------------------------------------------------------------------
# wrapper contracts that hold without a card
# ---------------------------------------------------------------------------


def test_transfer_tables_match_jax_child_slab():
    """ctab lists each coarse row's fine rows in the order of the JAX
    package's child-index slab."""
    shape = (13, 9, 7)
    Aj, Ap = grid_operator(shape)
    agg, nc = geo_agg(shape)
    jxfer = fused.build_transfer_slabs(Aj, agg, nc)
    jctab = np.asarray(jxfer.ctab).reshape(jxfer.m, -1)[:, :nc]
    xfer = build_transfer_tables(Ap, torch.from_numpy(agg), nc)
    assert np.array_equal(xfer["ctab"].numpy(), jctab)
    assert np.array_equal(xfer["agg"].numpy(), agg)


def test_unported_modes_raise():
    """B2's x.b epilogue and B6's streamed-operand / self-dot variant
    (BiCGStab's) are not ported: the wrappers raise before any launch,
    whatever the device (here tensors on the meta device, which no kernel
    route takes). B3/B4's weighted rows are ported
    (tests/test_torch_classical.py)."""
    from amgx_tpu_torch.ops import cuda_krylov as KK
    _, Ap, _, nc, b, x, _, xc, xfer = _case((8, 8, 8), np.float32)
    args = (*_port(Ap), _t(TAUS.astype(np.float32)), _t(b), _t(x))
    with pytest.raises(NotImplementedError):
        K.dia_smooth(*args, with_dot=True)
    p = torch.empty(512, device="meta")
    beta = torch.empty((), device="meta")
    for mode in ({"d": p}, {"self_dot": True}):
        with pytest.raises(NotImplementedError):
            KK.dia_spmv_dot(Ap.dia_vals.to("meta"), Ap.dia_offsets, p, p,
                            beta, **mode)


def test_launch_checks_refuse_what_the_kernel_cannot_take():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K._check("dia_spmv", (0,), 8, {"x": (x, (8,))})
    with pytest.raises(ValueError, match="diagonals"):
        K._check("dia_spmv", tuple(range(40)), 8, {"x": (x, (8,))})
    with pytest.raises(ValueError, match="ascend"):
        K._check("dia_spmv", (1, 0), 8, {"x": (x, (8,))})


def test_cpu_route_launches_nothing():
    _, Ap, _, _, b, x, _, _, _ = _case((8, 8, 8), np.float32)
    before = dict(K.LAUNCHES)
    K.dia_spmv(*_port(Ap), _t(x))
    K.dia_smooth(*_port(Ap), _t(TAUS.astype(np.float32)), _t(b), _t(x))
    assert K.LAUNCHES == before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing compiler is an error, never a silent plain fallback."""
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    with pytest.raises(cuda_build.KernelBuildError):
        cuda_build.build_all()
