"""GMRES and FGMRES with restart (the port of amgx_tpu/solvers/gmres.py:
one base class, `flexible` picking the variant, as there).

One `solve_iteration` is one Arnoldi step, as in the JAX package and the
reference: the preconditioned direction z = M v_i (FGMRES stores it in Z,
since M may change between steps; GMRES applies its fixed M once more
when it reconstructs x = x0 + M (V^T y)), w = A z is orthogonalized
against the basis by
classical Gram-Schmidt with one reorthogonalization pass (CGS2, two
(m+1, n) matrix-vector pairs), and the Hessenberg column is reduced by
Givens rotations. The basis V and the directions Z are device tensors,
updated in place (each belongs to one cycle); the small Hessenberg
algebra -- rotations, the residual estimate |g[i+1]| that drives
convergence, the m x m triangular solve -- runs on the host in the
vectors' dtype. Its input, the new column, is the iteration's one
device->host transfer. x is reconstructed at restart boundaries and in
`finalize`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..ops import blas
from ..ops.spmv import residual, spmv
from .base import Solver, _host


def _combine(M, y):
    """M^T y as the pairwise tree of the rounded row products: the order
    the JAX package's compiled FGMRES adds them in. REFINEMENT's next
    defect is the rounding of this x, and its size decides the next
    inner solve's count."""
    P = M * y[:, None]
    while P.shape[0] > 1:
        half = P.shape[0] // 2
        pairs = P[0:2 * half:2] + P[1:2 * half:2]
        P = torch.cat([pairs, P[2 * half:]]) if P.shape[0] % 2 else pairs
    return P[0]


def _solve_upper(R, g):
    """y with R y = g for an upper-triangular R (host back substitution)."""
    y = np.zeros_like(g)
    for j in range(g.shape[0] - 1, -1, -1):
        y[j] = (g[j] - R[j, j + 1:] @ y[j + 1:]) / R[j, j]
    return y


class _GmresBase(Solver):
    batch_todo = ("ROADMAP.md Queue A item 9: BATCHED_GMRES / FGMRES, "
                  "per-system Arnoldi and Givens")

    uses_preconditioner = True
    flexible = False

    def __init__(self, cfg, scope="default", name="GMRES", device=None):
        super().__init__(cfg, scope, name, device)
        self.m = int(cfg.get("gmres_n_restart", scope))
        # gmres_krylov_dim caps the stored basis (0 = match the restart)
        kdim = int(cfg.get("gmres_krylov_dim", scope))
        if kdim > 0:
            self.m = min(self.m, kdim)

    def _precond(self, data, r):
        if self.preconditioner is not None:
            return self.preconditioner.apply(data["precond"], r)
        return r

    def computes_residual(self):
        return False

    def internal_res_norm(self, state):
        return state["est_res"]

    # -- state -----------------------------------------------------------
    def _cycle_state(self, r, x0, V=None, Z=None):
        """Fresh Krylov state around the residual r of the guess x0
        (reusing the V/Z storage of a finished cycle when given; Z is
        None unless flexible)."""
        m, n = self.m, r.shape[0]
        beta_t = blas.nrm2(r)
        beta = _host(beta_t)
        npdt = beta.dtype
        if V is None:
            V = torch.zeros((m + 1, n), dtype=r.dtype, device=r.device)
            if self.flexible:
                Z = torch.zeros((m, n), dtype=r.dtype, device=r.device)
        else:
            V.zero_()
            if Z is not None:
                Z.zero_()
        V[0] = r if beta == 0 else r / beta_t
        g = np.zeros(m + 1, npdt)
        g[0] = beta
        return {"x0": x0, "V": V, "Z": Z, "R": np.eye(m, dtype=npdt),
                "cs": np.ones(m, npdt), "sn": np.zeros(m, npdt), "g": g,
                "i": 0, "est_res": beta}

    def solve_init(self, data, b, x, r):
        st = self._cycle_state(r, x)
        st.update(self._guard_init())
        return st

    def _reconstruct(self, data, st):
        """x = x0 + Z^T y (flexible) or x0 + M (V[:m]^T y), R y = g[:m]."""
        y = _solve_upper(st["R"], st["g"][:self.m])
        V = st["V"]
        y = torch.from_numpy(y).to(V.device)
        if self.flexible:
            return st["x0"] + _combine(st["Z"], y)
        return st["x0"] + self._precond(data, _combine(V[:self.m], y))

    # -- one Arnoldi step -------------------------------------------------
    def solve_iteration(self, data, b, st):
        A = data["A"]
        m = self.m
        i = st["i"]
        V = st["V"]
        z = self._precond(data, V[i])
        if self.flexible:
            st["Z"][i] = z
        w = spmv(A, z)
        # CGS2 against all rows (rows past i are zero: no-ops)
        h = blas.mdot(V, w)
        w = w - V.T @ h
        h2 = blas.mdot(V, w)
        w = w - V.T @ h2
        h = h + h2
        h_last = blas.nrm2(w)
        V[i + 1] = w / torch.where(h_last == 0, torch.ones_like(h_last),
                                   h_last)
        col = _host(torch.cat([h, h_last[None]]))
        h = col[:m + 1].copy()
        h[i + 1] = col[m + 1]

        cs, sn, g = st["cs"], st["sn"], st["g"]
        # the rotations stored so far (the rest are the identity)
        for j in range(i):
            c, s = cs[j], sn[j]
            hj, hj1 = h[j], h[j + 1]
            h[j] = c * hj + s * hj1
            h[j + 1] = -s * hj + c * hj1
        # new rotation zeroing h[i+1]
        hi, hi1 = h[i], h[i + 1]
        denom = np.sqrt(hi * hi + hi1 * hi1)
        if denom == 0:
            c, s = np.ones((), h.dtype)[()], np.zeros((), h.dtype)[()]
        else:
            c, s = hi / denom, hi1 / denom
        h[i] = c * h[i] + s * h[i + 1]
        h[i + 1] = 0
        cs[i], sn[i] = c, s
        gi = g[i]
        g[i] = c * gi
        # a degenerate rotation reduces nothing: keep |g| instead of the
        # identity rotation's 0, which would read as false convergence
        g[i + 1] = gi if denom == 0 else -s * gi
        st["R"][:, i] = h[:m]
        new = dict(st)
        new["est_res"] = np.abs(g[i + 1])
        if self.health_guards:
            new["breakdown"] = bool(denom == 0 and np.abs(gi) > 0)
        if i + 1 >= m:
            # cycle boundary: reconstruct x and restart around it
            x_new = self._reconstruct(data, new)
            new.update(self._cycle_state(residual(A, x_new, b), x_new,
                                         V, new["Z"]))
            new["x"] = x_new
            return new
        new["i"] = i + 1
        return new

    def finalize(self, data, b, state):
        # mid-cycle exit: reconstruct; at a restart boundary x0 is x
        if state["i"] > 0:
            return self._reconstruct(data, state)
        return state["x0"]


@registry.solvers.register("GMRES")
class GMRESSolver(_GmresBase):
    flexible = False


@registry.solvers.register("FGMRES")
class FGMRESSolver(_GmresBase):
    flexible = True
