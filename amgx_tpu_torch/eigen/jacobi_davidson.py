"""Jacobi-Davidson eigensolver (the port of
amgx_tpu/eigen/jacobi_davidson.py).

The analog of src/eigensolvers/jacobi_davidson_eigensolver.cu.
Single-pair JD: a growing search subspace V, expanded each iteration by
an approximate solution t of the correction equation

    (I - u u^T)(A - theta I)(I - u u^T) t = -r,   t  ⊥  u

solved with a fixed number of (unpreconditioned) CG steps -- the analog
of the reference's inner solver. V lives in a fixed (m_max, n) buffer;
the column count is host bookkeeping (it does not depend on the data),
so each iteration's projected eigenproblem is the active j x j block,
and when the buffer is full the subspace restarts from the current Ritz
vector. The inner CG's guards are device-side `torch.where`s: an
iteration reads nothing back to the host.
"""
from __future__ import annotations

import torch

from .. import registry
from ..errors import BadParametersError
from .base import EigenSolver

_INNER_CG_STEPS = 8


@registry.eigensolvers.register("JACOBI_DAVIDSON")
class JacobiDavidsonEigenSolver(EigenSolver):

    def solver_setup(self):
        if self.wanted_count > 1:
            raise BadParametersError(
                "JACOBI_DAVIDSON computes one eigenpair; use LANCZOS or "
                "LOBPCG for eig_wanted_count > 1")
        m = self.subspace_size
        self.m_max = min(m if m > 0 else 12, self.A.num_rows)

    # -- pieces ----------------------------------------------------------
    def _proj_op(self, data, u, theta, t):
        """(I - uu^T)(A - theta I)(I - uu^T) t."""
        t = t - u * torch.dot(u, t)
        y = self.op.apply(data["op"], t) - theta * t
        return y - u * torch.dot(u, y)

    def _correction(self, data, u, theta, r):
        """Approximate JD correction by fixed CG steps (inner solver)."""
        b = -(r - u * torch.dot(u, r))
        zero = b.new_zeros(())
        t, p, res, rs = torch.zeros_like(b), b, b, torch.dot(b, b)
        for _ in range(_INNER_CG_STEPS):
            Ap = self._proj_op(data, u, theta, p)
            denom = torch.dot(p, Ap)
            alpha = torch.where(denom.abs() > 1e-30, rs / denom, zero)
            t = t + alpha * p
            res_n = res - alpha * Ap
            rs_n = torch.dot(res_n, res_n)
            beta = torch.where(rs > 1e-30, rs_n / rs, zero)
            p = res_n + beta * p
            res, rs = res_n, rs_n
        # fall back to steepest descent direction if CG broke down
        bad = torch.linalg.vector_norm(t) < 1e-14
        return torch.where(bad, b, t)

    # -- driver pieces ---------------------------------------------------
    def solve_init(self, data, x0):
        n, m = self.A.num_rows, self.m_max
        v0 = x0 / torch.clamp(torch.linalg.vector_norm(x0), min=1e-30)
        V = x0.new_zeros((m, n))
        V[0] = v0
        return {"V": V, "count": 1, "u": v0,
                "lambdas": torch.dot(v0, self.op.apply(data["op"], v0))
                .reshape(1),
                "resid": x0.new_full((1,), float("inf"))}

    def solve_iteration(self, data, state):
        m = self.m_max
        V, j = state["V"], state["count"]
        Vm = V[:j]
        AV = self.op.apply_rows(data["op"], Vm)
        G = Vm @ AV.T
        G = 0.5 * (G + G.T)
        lam, W = torch.linalg.eigh(G)
        sel = j - 1 if self.which != "smallest" else 0
        w = W[:, sel]
        u = Vm.T @ w
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-30)
        Au = self.op.apply(data["op"], u)
        theta = torch.dot(u, Au)
        r = Au - theta * u
        resid = torch.linalg.vector_norm(r)
        t = self._correction(data, u, theta, r)
        # orthogonalize t against the active columns (CGS x2)
        for _ in range(2):
            t = t - Vm.T @ (Vm @ t)
        t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-30)
        # append (j < m) or restart from the Ritz vector (j == m)
        if j >= m:
            V = torch.zeros_like(V)
            V[0] = u
            j_new = 1
        else:
            V = V.clone()
            V[j] = t
            j_new = j + 1
        return {"V": V, "count": j_new, "u": u,
                "lambdas": theta.reshape(1), "resid": resid.reshape(1)}

    def finalize(self, data, state):
        vec = state["u"][:, None] if self.want_vectors else None
        return state["lambdas"], vec, state["resid"]
