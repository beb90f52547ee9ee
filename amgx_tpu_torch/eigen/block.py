"""Block eigensolvers: LOBPCG and subspace iteration (the port of
amgx_tpu/eigen/block.py).

Analogs of src/eigensolvers/lobpcg_eigensolver.cu and
subspace_iteration_eigensolver.cu. Every step is (n, k) panels through
the operator (one application a column), a tall-skinny QR
(`torch.linalg.qr`) and a small dense Rayleigh-Ritz eigenproblem
(`torch.linalg.eigh`), all on the device.

LOBPCG optionally applies a preconditioner built from the standard
solver tree (the "preconditioner" parameter in the eigensolver scope) to
the residual block -- the analog of the reference wiring a Solver as the
LOBPCG preconditioner. Its `apply` is the solver's fixed-sweep
preconditioner action (`max_iters` iterations of its scope, no
monitoring), one column at a time.
"""
from __future__ import annotations

import torch

from .. import registry
from ..errors import BadParametersError
from .base import EigenSolver, seeded


def _block_apply(op, data, X):
    """Apply the operator to each column of (n, k) X."""
    return op.apply_rows(data, X.T.contiguous()).T


def _orthonormalize(X):
    Q, _ = torch.linalg.qr(X)
    return Q


def _rayleigh_ritz(op_data, op, S, k: int, which: str):
    """Rayleigh-Ritz on the subspace spanned by S's columns. Returns
    (lam (k,), X (n,k), AX (n,k))."""
    Q = _orthonormalize(S)
    AQ = _block_apply(op, op_data, Q)
    G = Q.T @ AQ
    G = 0.5 * (G + G.T)
    lam, W = torch.linalg.eigh(G)            # ascending
    m = G.shape[0]
    if which == "smallest":
        idx = torch.arange(k, device=G.device)
    else:
        idx = torch.arange(m - 1, m - 1 - k, -1, device=G.device)
    W_k = W[:, idx]
    return lam[idx], Q @ W_k, AQ @ W_k


@registry.eigensolvers.register("SUBSPACE_ITERATION")
class SubspaceIterationEigenSolver(EigenSolver):
    """Block power iteration with periodic Rayleigh-Ritz
    (subspace_iteration_eigensolver.cu)."""

    def solver_setup(self):
        if self.which == "smallest":
            # power steps amplify the dominant subspace; Rayleigh-Ritz
            # residuals would converge on dominant-subspace pairs that
            # are nowhere near the smallest eigenvalues
            raise BadParametersError(
                "SUBSPACE_ITERATION computes the dominant (largest) "
                "eigenpairs; use LANCZOS or LOBPCG for eig_which=smallest")
        k = self.wanted_count
        m = self.subspace_size
        self.block = min(max(m, k + 2) if m > 0 else max(2 * k, k + 2),
                         self.A.num_rows)

    def solve_init(self, data, x0):
        n, p = self.A.num_rows, self.block
        k = self.wanted_count
        X = seeded(7, (n, p), x0)
        X[:, 0] = x0
        return {"X": _orthonormalize(X),
                "lambdas": x0.new_zeros((k,)),
                "resid": x0.new_full((k,), float("inf"))}

    def solve_iteration(self, data, state):
        k = self.wanted_count
        X = state["X"]
        AX = _block_apply(self.op, data["op"], X)
        lam, Xr, AXr = _rayleigh_ritz(data["op"], self.op, AX, k,
                                      self.which)
        R = AXr - Xr * lam[None, :]
        resid = torch.linalg.vector_norm(R, dim=0)
        # refill the non-wanted part of the block from A X (power step)
        Xn = torch.cat([Xr, AX[:, k:self.block]], dim=1) \
            if self.block > k else Xr
        return {"X": _orthonormalize(Xn), "lambdas": lam, "resid": resid}

    def finalize(self, data, state):
        vec = state["X"][:, : self.wanted_count] if self.want_vectors \
            else None
        return state["lambdas"], vec, state["resid"]


@registry.eigensolvers.register("LOBPCG")
class LOBPCGEigenSolver(EigenSolver):
    """Locally optimal block preconditioned CG (lobpcg_eigensolver.cu).
    State blocks X (iterates), P (search directions); each step does
    Rayleigh-Ritz on span[X, W, P] with W the (preconditioned)
    residuals."""

    def solver_setup(self):
        self.k = max(self.wanted_count, 1)
        self.precond = None
        pname, pscope = self.cfg.get_solver("preconditioner", self.scope)
        if pname.upper() not in ("NOSOLVER", "DUMMY"):
            from ..solvers.base import make_solver
            self.precond = make_solver(pname, self.cfg, pscope, self.device)
            self.precond._owns_scaling = False
            self.precond.setup(self.A)

    def solve_data(self):
        d = super().solve_data()
        if self.precond is not None:
            d["precond"] = self.precond.solve_data()
        return d

    def solve_init(self, data, x0):
        n, k = self.A.num_rows, self.k
        X = seeded(11, (n, k), x0)
        X[:, 0] = x0
        X = _orthonormalize(X)
        return {"X": X, "P": x0.new_zeros((n, k)),
                "lambdas": x0.new_zeros((k,)),
                "resid": x0.new_full((k,), float("inf"))}

    def solve_iteration(self, data, state):
        k = self.k
        X, P = state["X"], state["P"]
        AX = _block_apply(self.op, data["op"], X)
        lam = torch.sum(X * AX, dim=0)        # Rayleigh quotients
        R = AX - X * lam[None, :]
        if self.precond is not None:
            W = torch.stack([self.precond.apply(data["precond"],
                                                R[:, j].contiguous())
                             for j in range(k)], dim=1)
        else:
            W = R
        S = torch.cat([X, W, P], dim=1)
        lam_k, Xn, AXn = _rayleigh_ritz(data["op"], self.op, S, k,
                                        self.which)
        # residuals of the POST-update eigenpairs (AXn is already in
        # hand from Rayleigh-Ritz, so this costs nothing extra)
        resid = torch.linalg.vector_norm(AXn - Xn * lam_k[None, :], dim=0)
        # new search directions: component of the update orthogonal to X
        Pn = Xn - X @ (X.T @ Xn)
        pn = torch.linalg.vector_norm(Pn, dim=0, keepdim=True)
        Pn = torch.where(pn > 1e-12, Pn / torch.clamp(pn, min=1e-30),
                         Pn.new_zeros(()))
        return {"X": Xn, "P": Pn, "lambdas": lam_k, "resid": resid}

    def finalize(self, data, state):
        vec = state["X"] if self.want_vectors else None
        return state["lambdas"], vec, state["resid"]
