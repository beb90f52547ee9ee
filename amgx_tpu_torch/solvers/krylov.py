"""Conjugate-gradient solvers CG, PCG and PCGF (the port of those parts of
amgx_tpu/solvers/krylov.py; cg_solver.cu, pcg_solver.cu, pcgf_solver.cu).

Each iteration is a function over a dict state, as in the JAX package.
With krylov_fusion (the default) an iteration is two single-pass kernels
plus the preconditioner: B6 (p' = z + beta p, A p', p'.Ap'), B7 (x and r
updates with r'.r'), and PCG's r.z riding the AMG cycle's last kernel
(B4's or B5's x'.b epilogue). krylov_fusion=0 composes the unfused SpMV
and vector operations. float64 composes plain PyTorch on either route.

The scalars alpha, beta, r.z and r.r stay 0-dim device tensors, and the
kernels read alpha and beta through a pointer: an iteration meets the
host once, when the solve loop reads the monitored norm (with the breakdown
flag in the same transfer, solvers/base.py).
"""
from __future__ import annotations

import torch

from .. import registry
from ..ops import blas
from ..ops.spmv import spmv, spmv_pdot
from .base import Solver


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b) * (b != 0)


def _ldot(a, b):
    """Dot accumulated in float32 or wider (the fused kernels' epilogue
    dtype)."""
    cdt = torch.promote_types(a.dtype, torch.float32)
    return torch.dot(a.to(cdt), b.to(cdt))


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
        return torch.zeros((), dtype=like.dtype, device=like.device)

    def _monitored(self, state, key):
        """sqrt(state[key]) stands in for the monitored norm when that is
        the scalar L2 norm of r (the port's matrices are scalar)."""
        if key not in state or self.norm_type.upper() != "L2":
            return None
        return torch.sqrt(state[key])


@registry.solvers.register("CG")
class CGSolver(_KrylovBase):
    """Unpreconditioned conjugate gradients."""

    def solve_init(self, data, b, x, r):
        if self.krylov_fusion:
            # the first fused iteration's p' = z + beta p with z = r,
            # beta = 0, p = 0 is the unfused p0 = r
            (rz,) = blas.psum_bundle((_ldot(r, r),))
            return {"p": torch.zeros_like(r), "beta": self._zero_scalar(rz),
                    "rz": rz, **self._guard_init()}
        return {"p": r, "rz": torch.dot(r, r), **self._guard_init()}

    def solve_iteration(self, data, b, st):
        if self.krylov_fusion:
            return self._fused_iteration(data, st)
        A = data["A"]
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        Ap = spmv(A, p)
        pAp = torch.dot(p, Ap)
        alpha = _safe_div(rz, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = torch.dot(r, r)
        beta = _safe_div(rz_new, rz)
        p = r + beta * p
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

    def solve_init(self, data, b, x, r):
        if self.krylov_fusion:
            z, rz_l = self._precond_dot(data, r)
            rr, rz = blas.psum_bundle((_ldot(r, r), rz_l))
            return {"p": torch.zeros_like(r), "z": z,
                    "beta": self._zero_scalar(rz), "rz": rz, "rr": rr,
                    **self._guard_init()}
        z = self._precond(data, r)
        return {"p": z, "z": z, "rz": torch.dot(r, z), **self._guard_init()}

    def solve_iteration(self, data, b, st):
        if self.krylov_fusion:
            return self._fused_iteration(data, st)
        A = data["A"]
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        Ap = spmv(A, p)
        pAp = torch.dot(p, Ap)
        alpha = _safe_div(rz, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = self._precond(data, r)
        rz_new = torch.dot(r, z)
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
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
