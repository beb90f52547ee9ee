"""Krylov solvers CG, PCG, PCGF, BiCGStab, PBiCGStab and Chebyshev (the
port of amgx_tpu/solvers/krylov.py; cg_solver.cu, pcg_solver.cu,
pcgf_solver.cu, bicgstab_solver.cu, pbicgstab_solver.cu, cheb_solver.cu).

Each iteration is a function over a dict state, as in the JAX package.
With krylov_fusion (the default) an iteration is two single-pass kernels
plus the preconditioner: B6 (p' = z + beta p, A p', p'.Ap'), B7 (x and r
updates with r'.r'), and PCG's r.z riding the AMG cycle's last kernel
(B4's or B5's x'.b epilogue). krylov_fusion=0 composes the unfused SpMV
and vector operations. float64 composes plain PyTorch on either route.
A fused BiCGStab iteration carries its dots in B6's streamed-dot form:
r~.v with v = A p^, and the t.s / t.t pair with t = A s^ (`spmv_ddot`).

The scalars alpha, beta, omega, rho, r.z and r.r stay 0-dim device
tensors, and the kernels read alpha and beta through a pointer: an
iteration meets the host once, when the solve loop reads the monitored
norm (with the breakdown flag in the same transfer, solvers/base.py).
Chebyshev's spectral bounds are host floats set at setup, as in the JAX
package.

CG and PCG also run a batch (amgx_tpu_torch/batch/): vectors (B, n), the
scalars (B,) tensors, one per system (`_safe_div` is elementwise), every
dot a row dot (`_dot`, `_ldot`), and a scalar meets a vector through
`_bc`. Under a batch the fused route computes the JAX package's vmap
route: B6's work as `spmv_dot_multi` (one K1 launch), B7's as
`cg_update_multi`, and r.z reduced explicitly (the cycle declines its
dot).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..ops import blas
from ..ops.spmv import spmv, spmv_ddot, spmv_pdot
from .base import Solver


def _safe_div(a, b):
    """a / b elementwise, 0 where b is 0 (0-dim scalars or a batch's
    (B,) ones)."""
    return a / torch.where(b == 0, torch.ones_like(b), b) * (b != 0)


def _dot(a, b):
    """a.b; one dot a row for a batch (B, n)."""
    return (a * b).sum(-1) if a.dim() == 2 else torch.dot(a, b)


def _ldot(a, b):
    """Dot accumulated in float32 or wider (the fused kernels' epilogue
    dtype); one a row for a batch."""
    cdt = torch.promote_types(a.dtype, torch.float32)
    return _dot(a.to(cdt), b.to(cdt))


def _bc(s, v):
    """A scalar shaped to scale v: a 0-dim one as it is, a batch's (B,)
    one as a column against v (B, n)."""
    return s[..., None] if s.dim() == 1 and v.dim() == 2 else s


class _KrylovBase(Solver):
    def __init__(self, cfg, scope="default", name="?", device="cpu"):
        super().__init__(cfg, scope, name, device)
        self.krylov_fusion = bool(int(cfg.get("krylov_fusion", scope)))

    def _precond(self, data, r):
        if self.preconditioner is not None:
            return self.preconditioner.apply(data["precond"], r)
        return r

    def _precond_dot(self, data, r):
        """(z, r.z): the dot from the preconditioner's last kernel when it
        carries one (an AMG cycle's output is z, its rhs r), the explicit
        reduction otherwise; no preconditioner gives (r, r.r)."""
        if self.preconditioner is None:
            return r, _ldot(r, r)
        z, d = self.preconditioner.apply_dot(data["precond"], r)
        return z, _ldot(r, z) if d is None else d

    def _zero_scalar(self, like):
        return torch.zeros_like(like)

    def _monitored(self, state, key):
        """sqrt(state[key]) stands in for the monitored norm when that is
        the scalar L2 norm of r (the port's matrices are scalar)."""
        if key not in state or self.norm_type.upper() != "L2":
            return None
        return torch.sqrt(state[key])


@registry.solvers.register("CG")
class CGSolver(_KrylovBase):
    """Unpreconditioned conjugate gradients."""

    batched_iteration = True

    def solve_init(self, data, b, x, r):
        if self.krylov_fusion:
            # the first fused iteration's p' = z + beta p with z = r,
            # beta = 0, p = 0 is the unfused p0 = r
            (rz,) = blas.psum_bundle((_ldot(r, r),))
            return {"p": torch.zeros_like(r), "beta": self._zero_scalar(rz),
                    "rz": rz, **self._guard_init()}
        return {"p": r, "rz": _dot(r, r), **self._guard_init()}

    def solve_iteration(self, data, b, st):
        if self.krylov_fusion:
            return self._fused_iteration(data, st)
        A = data["A"]
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        Ap = spmv(A, p)
        pAp = _dot(p, Ap)
        alpha = _safe_div(rz, pAp)
        x = x + _bc(alpha, p) * p
        r = r - _bc(alpha, Ap) * Ap
        rz_new = _dot(r, r)
        beta = _safe_div(rz_new, rz)
        p = r + _bc(beta, p) * p
        out = {**st, "x": x, "r": r, "p": p, "rz": rz_new}
        if self.health_guards:
            # p.Ap <= 0: A is not SPD on this Krylov space
            out["breakdown"] = pAp <= 0
        return out

    def _fused_iteration(self, data, st):
        A = data["A"]
        x, r, rz = st["x"], st["r"], st["rz"]
        p, Ap, pAp = spmv_pdot(A, st["p"], r, st["beta"])
        (pAp,) = blas.psum_bundle((pAp,))
        alpha = _safe_div(rz, pAp)
        x, r, rr = blas.cg_update(x, p, r, Ap, alpha)
        (rz_new,) = blas.psum_bundle((rr,))
        beta = _safe_div(rz_new, rz)
        out = {**st, "x": x, "r": r, "p": p, "rz": rz_new, "beta": beta}
        if self.health_guards:
            out["breakdown"] = pAp <= 0
        return out

    def internal_res_norm(self, state):
        # CG's rz is r.r on both routes
        return self._monitored(state, "rz")


@registry.solvers.register("PCG")
class PCGSolver(_KrylovBase):
    """Preconditioned CG."""

    uses_preconditioner = True
    batched_iteration = True

    def solve_init(self, data, b, x, r):
        if self.krylov_fusion:
            z, rz_l = self._precond_dot(data, r)
            rr, rz = blas.psum_bundle((_ldot(r, r), rz_l))
            return {"p": torch.zeros_like(r), "z": z,
                    "beta": self._zero_scalar(rz), "rz": rz, "rr": rr,
                    **self._guard_init()}
        z = self._precond(data, r)
        return {"p": z, "z": z, "rz": _dot(r, z), **self._guard_init()}

    def solve_iteration(self, data, b, st):
        if self.krylov_fusion:
            return self._fused_iteration(data, st)
        A = data["A"]
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        Ap = spmv(A, p)
        pAp = _dot(p, Ap)
        alpha = _safe_div(rz, pAp)
        x = x + _bc(alpha, p) * p
        r = r - _bc(alpha, Ap) * Ap
        z = self._precond(data, r)
        rz_new = _dot(r, z)
        beta = _safe_div(rz_new, rz)
        p = z + _bc(beta, p) * p
        out = {**st, "x": x, "r": r, "p": p, "z": z, "rz": rz_new}
        if self.health_guards:
            out["breakdown"] = pAp <= 0
        return out

    def _fused_iteration(self, data, st):
        A = data["A"]
        x, r, rz = st["x"], st["r"], st["rz"]
        p, Ap, pAp = spmv_pdot(A, st["p"], st["z"], st["beta"])
        (pAp,) = blas.psum_bundle((pAp,))
        alpha = _safe_div(rz, pAp)
        x, r, rr = blas.cg_update(x, p, r, Ap, alpha)
        z, rz_l = self._precond_dot(data, r)
        rr, rz_new = blas.psum_bundle((rr, rz_l))
        beta = _safe_div(rz_new, rz)
        out = {**st, "x": x, "r": r, "p": p, "z": z, "rz": rz_new,
               "rr": rr, "beta": beta}
        if self.health_guards:
            out["breakdown"] = pAp <= 0
        return out

    def internal_res_norm(self, state):
        # the fused route's r.r leaves B7's epilogue
        return self._monitored(state, "rr")


@registry.solvers.register("PCGF")
class PCGFSolver(_KrylovBase):
    """Flexible PCG: the Polak-Ribiere beta tolerates a preconditioner
    that varies between iterations."""

    uses_preconditioner = True

    def solve_init(self, data, b, x, r):
        if self.krylov_fusion:
            z, rz_l = self._precond_dot(data, r)
            rr, rz = blas.psum_bundle((_ldot(r, r), rz_l))
            return {"p": torch.zeros_like(r), "z": z,
                    "beta": self._zero_scalar(rz), "rz": rz, "rr": rr,
                    **self._guard_init()}
        z = self._precond(data, r)
        return {"p": z, "z": z, "r_old": r, "rz": torch.dot(r, z),
                **self._guard_init()}

    def solve_iteration(self, data, b, st):
        if self.krylov_fusion:
            return self._fused_iteration(data, st)
        A = data["A"]
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        Ap = spmv(A, p)
        pAp = torch.dot(p, Ap)
        alpha = _safe_div(rz, pAp)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = self._precond(data, r_new)
        rz_new = torch.dot(r_new, z)
        beta = _safe_div(torch.dot(r_new - r, z), rz)
        p = z + beta * p
        out = {**st, "x": x, "r": r_new, "p": p, "z": z, "r_old": r,
               "rz": rz_new}
        if self.health_guards:
            out["breakdown"] = pAp <= 0
        return out

    def _fused_iteration(self, data, st):
        """As PCG's, plus the Polak-Ribiere numerator <z, r_new - r>: the
        one reduction the kernels cannot carry (it needs the old r after
        the new one exists, so B7 writes fresh tensors)."""
        A = data["A"]
        x, r, rz = st["x"], st["r"], st["rz"]
        p, Ap, pAp = spmv_pdot(A, st["p"], st["z"], st["beta"])
        (pAp,) = blas.psum_bundle((pAp,))
        alpha = _safe_div(rz, pAp)
        x, r_new, rr = blas.cg_update(x, p, r, Ap, alpha)
        z, rz_l = self._precond_dot(data, r_new)
        dz_l = _ldot(r_new - r, z)
        rr, rz_new, dz = blas.psum_bundle((rr, rz_l, dz_l))
        beta = _safe_div(dz, rz)
        out = {**st, "x": x, "r": r_new, "p": p, "z": z, "rz": rz_new,
               "rr": rr, "beta": beta}
        if self.health_guards:
            out["breakdown"] = pAp <= 0
        return out

    def internal_res_norm(self, state):
        return self._monitored(state, "rr")


@registry.solvers.register("BICGSTAB")
class BiCGStabSolver(_KrylovBase):
    """BiCGStab. Without a preconditioner p^ = p and s^ = s, so the one
    iteration below is the JAX package's BiCGStabSolver and, with one,
    its PBiCGStabSolver, expression for expression."""

    def solve_init(self, data, b, x, r):
        if self.krylov_fusion:
            (rho,) = blas.psum_bundle((_ldot(r, r),))
        else:
            rho = torch.dot(r, r)
        return {"r_tld": r, "p": r, "rho": rho, **self._guard_init()}

    def solve_iteration(self, data, b, st):
        if self.krylov_fusion:
            return self._fused_iteration(data, st)
        A = data["A"]
        x, r = st["x"], st["r"]
        r_tld, p, rho = st["r_tld"], st["p"], st["rho"]
        p_hat = self._precond(data, p)
        v = spmv(A, p_hat)
        alpha = _safe_div(rho, torch.dot(r_tld, v))
        s = r - alpha * v
        s_hat = self._precond(data, s)
        t = spmv(A, s_hat)
        omega = _safe_div(torch.dot(t, s), torch.dot(t, t))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rho_new = torch.dot(r_tld, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        return self._next(st, x, r, p, v, rho_new, alpha, omega)

    def _fused_iteration(self, data, st):
        """Both SpMVs carry their dots in B6's epilogue: r~.v, and the
        t.s / t.t pair (self_dot); the dot operands r~ and s stream
        through the kernel beside the preconditioned vectors."""
        A = data["A"]
        x, r = st["x"], st["r"]
        r_tld, p, rho = st["r_tld"], st["p"], st["rho"]
        p_hat = self._precond(data, p)
        v, rtv = spmv_ddot(A, p_hat, r_tld)
        (rtv,) = blas.psum_bundle((rtv,))
        alpha = _safe_div(rho, rtv)
        a = alpha.to(r.dtype)
        s = r - a * v
        s_hat = self._precond(data, s)
        t, ts, tt = spmv_ddot(A, s_hat, s, self_dot=True)
        ts, tt = blas.psum_bundle((ts, tt))
        omega = _safe_div(ts, tt)
        w = omega.to(r.dtype)
        x = x + a * p_hat + w * s_hat
        r = s - w * t
        (rho_new,) = blas.psum_bundle((_ldot(r_tld, r),))
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = r + beta.to(r.dtype) * (p - w * v)
        return self._next(st, x, r, p, v, rho_new, alpha, omega)

    def _next(self, st, x, r, p, v, rho, alpha, omega):
        out = {**st, "x": x, "r": r, "p": p, "v": v, "rho": rho,
               "alpha": alpha, "omega": omega}
        if self.health_guards:
            # rho underflow (r~ orthogonal to r) or omega collapse: the
            # recurrence is dead
            out["breakdown"] = (rho == 0) | (omega == 0)
        return out


@registry.solvers.register("PBICGSTAB")
class PBiCGStabSolver(BiCGStabSolver):
    """Preconditioned BiCGStab."""

    uses_preconditioner = True


@registry.solvers.register("CHEBYSHEV")
class ChebyshevSolver(_KrylovBase):
    """Chebyshev iteration (cheb_solver.cu) with the JAX package's
    eigenvalue-estimate modes: 0/1 power iteration on the
    (preconditioned) operator at setup, lmax x 1.05 and lmin = lmax / 8;
    2 the Gershgorin bound, or 0.9 under a preconditioner, lmin = lmax /
    8; 3 the user's cheby_max_lambda / cheby_min_lambda under a
    preconditioner, Gershgorin otherwise. A solver and an AMG smoother
    (the base class's generic `smooth`). chebyshev_polynomial_order is
    not read, as in the JAX package."""

    uses_preconditioner = True
    is_smoother = True
    # the spectral bounds are host floats set at setup
    trace_bakes_values = True

    def __init__(self, cfg, scope="default", name="CHEBYSHEV",
                 device="cpu"):
        super().__init__(cfg, scope, name, device)
        self.estimate_mode = int(cfg.get("chebyshev_lambda_estimate_mode",
                                         scope))
        self.lmax = float(cfg.get("cheby_max_lambda", scope))
        self.lmin = float(cfg.get("cheby_min_lambda", scope))

    def solver_setup(self):
        mode = self.estimate_mode
        pre = self.preconditioner
        if mode in (0, 1):
            apply = None
            if pre is not None:
                pdata = pre.solve_data()
                apply = lambda v: pre.apply(pdata, v)  # noqa: E731
            self.lmax = float(power_lambda_max(self.A, apply)) * 1.05
            self.lmin = self.lmax / 8.0
        elif mode == 2:
            # under a preconditioner the reference assumes a spectrum
            # compressed to ~1 (cheb_solver.cu:193-196)
            self.lmax = 0.9 if pre is not None else float(
                gershgorin_lambda_max(self.A))
            self.lmin = self.lmax * 0.125
        elif mode == 3 and pre is None:
            self.lmax = float(gershgorin_lambda_max(self.A))
            self.lmin = self.lmax * 0.125
        self.set_bounds(self.lmax, self.lmin)

    def set_bounds(self, lmax: float, lmin: float):
        """Take [lmin, lmax] as the spectral interval (setup's estimate,
        or another implementation's: interop.hierarchy_from_numpy)."""
        self.lmax, self.lmin = lmax, lmin
        self._d = (lmax + lmin) / 2.0
        self._c = (lmax - lmin) / 2.0

    def computes_residual(self):
        return False

    def solve_init(self, data, b, x, r):
        return {"k": 0}

    def solve_iteration(self, data, b, st):
        d, c = self._d, self._c
        sigma = d / c
        x, k = st["x"], st["k"]
        z = self._precond(data, b - spmv(data["A"], x))
        if k == 0:
            rho = torch.full((), 1.0 / sigma, dtype=x.dtype, device=x.device)
            p = z * (1.0 / d)
        else:
            rho = 1.0 / (2.0 * sigma - st["rho"])
            p = rho * st["rho"] * st["p"] + (2.0 * rho * (1.0 / c)) * z
        return {**st, "x": x + p, "p": p, "rho": rho, "k": k + 1}


def gershgorin_lambda_max(A):
    """max_i sum_j |a_ij| / |a_ii| (cheb_solver.cu:46-74), the row sums
    as an SpMV of |A| with ones, as the JAX package forms them."""
    row_abs = spmv(A.with_values(A.values.abs()),
                   torch.ones(A.num_rows, dtype=A.dtype, device=A.device))
    return torch.max(row_abs / A.diagonal().abs())


def power_lambda_max(A, precond_apply=None, iters: int = 20, seed: int = 0):
    """Power-iteration estimate of lambda_max of M^-1 A from numpy's
    default_rng(seed) start vector, as the JAX package's
    `_power_lambda_max`: a 0-dim tensor."""
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        A.num_rows)).to(dtype=A.dtype, device=A.device)
    v = v / blas.nrm2(v)
    lam = torch.zeros((), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        w = spmv(A, v)
        if precond_apply is not None:
            w = precond_apply(w)
        lam = blas.nrm2(w)
        v = w / torch.where(lam == 0, torch.ones_like(lam), lam)
    return lam
