"""Krylov eigensolvers: Lanczos (symmetric) and Arnoldi (general) (the
port of amgx_tpu/eigen/krylov.py).

Analogs of src/eigensolvers/lanczos_eigensolver.cu and
arnoldi_eigensolver.cu. Fixed-size Krylov bases (m+1, n) on the device,
one operator apply + orthogonalization per step, then the small
projected eigenproblem:

- Lanczos: the projected Gram matrix, solved on the device with
  `torch.linalg.eigh`; the driver restarts with the best Ritz vectors
  until the eigenpair residuals meet eig_tolerance.
- Arnoldi: Hessenberg H, solved on the host with numpy `eig` after the
  device factorization -- the reference defers the same m x m problem
  to LAPACK geev (src/amgx_lapack.cu).

Both use classical Gram-Schmidt applied twice (full
reorthogonalization): V @ w and V.T @ c are dense (m, n) products, so
full reorthogonalization costs a few matrix-vector products of the
basis and is more robust than the reference's selective schemes. A
breakdown (w in the span) is resolved on the device with a
`torch.where`, never a host read.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import registry
from .base import EigenResult, EigenSolver


def _krylov_dim(self) -> int:
    m = self.subspace_size
    if m is None or m <= 0:
        m = max(2 * self.wanted_count + 18, 20)
    return min(m, self.A.num_rows)


@registry.eigensolvers.register("LANCZOS")
class LanczosEigenSolver(EigenSolver):
    """Symmetric Lanczos with full reorthogonalization and thick restart
    (lanczos_eigensolver.cu). Each driver iteration expands the basis
    from the k kept Ritz vectors (plus the residual direction) to m
    vectors with the Lanczos chain w = A v_j orthogonalized against ALL
    built columns, then Rayleigh-Ritzes with an explicitly projected
    G = V (A V)^T (one extra panel of SpMVs in place of the arrowhead-T
    bookkeeping of classic thick-restart Lanczos)."""

    def solver_setup(self):
        self.m = _krylov_dim(self)
        if self.m <= self.wanted_count + 1:
            self.m = min(self.wanted_count + 2, self.A.num_rows)

    def solve_init(self, data, x0):
        n, dt, dev = self.A.num_rows, x0.dtype, x0.device
        k = self.wanted_count
        v0 = x0 / torch.clamp(torch.linalg.vector_norm(x0), min=1e-30)
        # X holds the k kept Ritz vectors; initially random orthonormal
        # with x0 as the first column (the JAX package's draws: one
        # generator, the block first, then the seed direction)
        rng = np.random.default_rng(3)
        X0 = torch.from_numpy(rng.standard_normal((n, k))).to(dev, dt)
        X0[:, 0] = v0
        X0, _ = torch.linalg.qr(X0)
        return {
            "X": X0,                       # (n, k) kept Ritz block
            # expansion seed: independent random direction (NOT in
            # span(X) -- the chain would degenerate)
            "q": torch.from_numpy(rng.standard_normal(n)).to(dev, dt),
            "lambdas": torch.zeros((k,), dtype=dt, device=dev),
            "resid": torch.full((k,), float("inf"), dtype=dt, device=dev),
        }

    def solve_iteration(self, data, state):
        m, k = self.m, self.wanted_count
        dt = state["X"].dtype
        n = self.A.num_rows
        # basis buffer: rows 0..k-1 = kept Ritz block, row k = seed
        V = torch.zeros((m, n), dtype=dt, device=state["X"].device)
        V[:k] = state["X"].T
        ar = torch.arange(n, dtype=dt, device=V.device)

        def _orth_unit(w, Vm, j):
            """Orthogonalize w against Vm's rows; on breakdown (w in
            span) fall back to a deterministic fresh direction."""
            for _ in range(2):
                w = w - Vm.T @ (Vm @ w)
            wn = torch.linalg.vector_norm(w)
            fb = torch.sin((float(j) + 2.0) * ar + 0.7)
            w = torch.where(wn > 1e-10, w, fb)
            for _ in range(2):
                w = w - Vm.T @ (Vm @ w)
            return w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)

        V[k] = _orth_unit(state["q"], state["X"].T, 0)
        for j in range(k, m - 1):
            w = self.op.apply(data["op"], V[j])
            V[j + 1] = _orth_unit(w, V[:j + 1], j)
        AV = self.op.apply_rows(data["op"], V)
        G = V @ AV.T
        G = 0.5 * (G + G.T)
        lam, S = torch.linalg.eigh(G)           # ascending
        if self.which == "smallest":
            idx = torch.arange(k, device=G.device)
        else:
            idx = torch.arange(m - 1, m - 1 - k, -1, device=G.device)
        lam_k, S_k = lam[idx], S[:, idx]
        X = V.T @ S_k                          # (n, k) Ritz vectors
        AX = AV.T @ S_k
        R = AX - X * lam_k[None, :]
        resid = torch.linalg.vector_norm(R, dim=0)
        # reseed from the least-converged pair so every wanted pair keeps
        # receiving Krylov directions
        q_next = R[:, torch.argmax(resid)]
        return {"X": X, "q": q_next, "lambdas": lam_k, "resid": resid}

    def finalize(self, data, state):
        vec = state["X"] if self.want_vectors else None
        return state["lambdas"], vec, state["resid"]


@registry.eigensolvers.register("ARNOLDI")
class ArnoldiEigenSolver(EigenSolver):
    """Arnoldi for general (nonsymmetric) matrices
    (arnoldi_eigensolver.cu). One m-step factorization builds V and H on
    the device; the host solves the Hessenberg eigenproblem (LAPACK-geev
    analog)."""

    def solver_setup(self):
        self.m = _krylov_dim(self)

    def _factorize(self, data, x0):
        n, m, dt = self.A.num_rows, self.m, x0.dtype
        v0 = x0 / torch.clamp(torch.linalg.vector_norm(x0), min=1e-30)
        V = torch.zeros((m + 1, n), dtype=dt, device=x0.device)
        V[0] = v0
        H = torch.zeros((m + 1, m), dtype=dt, device=x0.device)
        for j in range(m):
            w = self.op.apply(data["op"], V[j])
            Vm = V[:j + 1]
            h = Vm @ w
            w = w - Vm.T @ h
            h2 = Vm @ w
            w = w - Vm.T @ h2
            h = h + h2
            b = torch.linalg.vector_norm(w)
            w = w / torch.clamp(b, min=1e-30)
            H[:j + 1, j] = h
            H[j + 1, j] = b
            V[j + 1] = w
        return V, H

    def solve(self, x0=None) -> EigenResult:
        x0 = self._x0(x0)
        t0 = time.perf_counter()
        V, H = self._factorize(self.solve_data(), x0)
        H = H.cpu().numpy()                     # one host read
        solve_time = time.perf_counter() - t0
        m, k = self.m, self.wanted_count
        w, S = np.linalg.eig(H[:m, :m])
        order = np.argsort(w.real)
        idx = order[:k] if self.which == "smallest" else order[-k:][::-1]
        lam_k, S_k = w[idx], S[:, idx]
        res = np.abs(H[m, m - 1]) * np.abs(S_k[m - 1, :])
        vec = None
        if self.want_vectors:
            X = V[:m].T @ torch.from_numpy(S_k.real).to(V.device, V.dtype)
            vec = X / torch.clamp(torch.linalg.vector_norm(X, dim=0),
                                  min=1e-30)
        if np.allclose(lam_k.imag, 0):
            lam_k = lam_k.real
        scale = max(float(np.max(np.abs(lam_k))), 1e-30)
        return EigenResult(
            eigenvalues=np.atleast_1d(self.unshift(lam_k)),
            eigenvectors=vec, iterations=m,
            converged=bool(np.all(res <= self.tolerance * scale)),
            residuals=np.atleast_1d(res),
            setup_time=self.setup_time, solve_time=solve_time)
