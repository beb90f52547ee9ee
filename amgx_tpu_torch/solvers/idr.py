"""IDR(s), induced dimension reduction (the port of
amgx_tpu/solvers/idr.py; idr_solver.cu, idrmsync_solver.cu).

The biorthogonal IDR(s) of van Gijzen & Sonneveld (ACM TOMS 38(1),
2011); the shadow space dimension is `subspace_dim_s`. One iteration is
a whole cycle: s intermediate steps and the dimension-reduction step, s
+ 1 SpMVs, with the inner products against the shadow space as (n, s)
products. IDR and IDRMSYNC run this one formulation, as in the JAX
package. The shadow space P is numpy's default_rng(271828) followed by
a float64 QR, then cast: the JAX package's bits. The s x s work and
every scalar stay on the device; an iteration meets the host once, when
the solve loop reads the monitored norm.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..ops import blas
from ..ops.spmv import spmv
from .krylov import _KrylovBase, _safe_div


@registry.solvers.register("IDR")
@registry.solvers.register("IDRMSYNC")
class IDRSolver(_KrylovBase):
    """IDR(s) with biorthogonalization of the shadow residuals."""

    uses_preconditioner = True

    def __init__(self, cfg, scope="default", name="IDR", device="cpu"):
        super().__init__(cfg, scope, name, device)
        self.s = max(int(cfg.get("subspace_dim_s", scope)), 1)
        self.kappa = 0.7          # omega angle correction (standard)

    def solver_setup(self):
        n = self.A.num_rows
        P = np.random.default_rng(271828).standard_normal((n, self.s))
        P, _ = np.linalg.qr(P)
        self._P = torch.from_numpy(P).to(device=self.A.device,
                                         dtype=self.A.dtype)

    def solve_data(self):
        d = super().solve_data()
        d["P"] = self._P
        return d

    def solve_init(self, data, b, x, r):
        n, s = r.shape[0], self.s
        z = dict(dtype=r.dtype, device=r.device)
        return {"G": torch.zeros((n, s), **z), "U": torch.zeros((n, s), **z),
                "M": torch.eye(s, **z), "omega": torch.ones((), **z),
                **self._guard_init()}

    def solve_iteration(self, data, b, st):
        A, P = data["A"], data["P"]
        s = self.s
        x, r = st["x"], st["r"]
        G, U, M = st["G"].clone(), st["U"].clone(), st["M"].clone()
        omega = st["omega"]
        f = P.T @ r                                   # (s,)
        for k in range(s):
            # M[k:, k:] c = f[k:] (lower triangular); a zero pivot is a
            # shadow-space breakdown, guarded to keep NaN out of x
            M_safe = M + torch.diag((torch.diagonal(M) == 0).to(M.dtype))
            c = torch.linalg.solve_triangular(
                M_safe[k:, k:], f[k:, None], upper=False)[:, 0]
            v = self._precond(data, r - G[:, k:] @ c)
            u_k = omega * v + U[:, k:] @ c
            g_k = spmv(A, u_k)
            if k > 0:
                # biorthogonalize g_k against P[:, :k]
                dMk = torch.diagonal(M)[:k]
                alpha = (P[:, :k].T @ g_k) / torch.where(
                    dMk == 0, torch.ones_like(dMk), dMk) * (dMk != 0)
                g_k = g_k - G[:, :k] @ alpha
                u_k = u_k - U[:, :k] @ alpha
            G[:, k] = g_k
            U[:, k] = u_k
            M[:, k] = P.T @ g_k
            beta = _safe_div(f[k], M[k, k])
            r = r - beta * g_k
            x = x + beta * u_k
            if k + 1 < s:
                f = f.clone()
                f[k + 1:] += -beta * M[k + 1:, k]
                f[:k + 1] = 0.0
        # dimension-reduction step
        v = self._precond(data, r)
        t = spmv(A, v)
        tt = torch.dot(t, t)
        tr = torch.dot(t, r)
        om = _safe_div(tr, tt)
        # angle correction: keep |cos| >= kappa
        nr = blas.nrm2(r)
        nt = torch.sqrt(torch.where(tt == 0, torch.ones_like(tt), tt))
        rho = torch.abs(_safe_div(
            tr, nt * torch.where(nr == 0, torch.ones_like(nr), nr)))
        kappa = torch.full_like(om, self.kappa)    # no host copy
        om = torch.where(rho < kappa, om * _safe_div(kappa, rho), om)
        x = x + om * v
        r = r - om * t
        out = {**st, "x": x, "r": r, "G": G, "U": U, "M": M, "omega": om}
        if self.health_guards:
            # omega collapse: the dimension-reduction step degenerated
            out["breakdown"] = om == 0
        return out
