"""Polynomial smoothers (the port of amgx_tpu/solvers/polynomial.py):
POLYNOMIAL, KPZ_POLYNOMIAL and CHEBYSHEV_POLY.

POLYNOMIAL: Chebyshev relaxation on [rho / 30, 1.1 rho], `kpz_order`
steps an application (0 means 6), rho from an 8-step Lanczos run at
setup (`_lanczos_rho`: `default_rng(17)`, the largest |Ritz value| times
1.01; each step one SpMV through ops/spmv.py and two host reads).
KPZ_POLYNOMIAL: the KPZ three-term recurrence of
kpz_polynomial_solver.cu with smax = the largest absolute column sum
(ordered: the entries sorted by column once, ops/segment.py) and smin =
smax / kpz_mu. Both are compositions of SpMVs (B1 / B8 in float32) and
elementwise updates.

CHEBYSHEV_POLY: the "magic damping" tau sequence of
chebyshev_poly.cu, tau_i = cos^2(beta) / (cos^2(beta(2i+1)) -
sin^2(beta)) / lambda with beta = pi/(4m+2) and lambda the Gershgorin
bound (max absolute row sum), applied as x += tau_i (b - A x).

The taus are solve data ("taus"), so a multi-matrix batch stacks them to
(B, T): each system smooths with the taus of its own spectral bound
(the batched kernels K2 / K2-mf and K5 take them per system)."""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import registry
from ..ops import smooth as fused
from ..ops.cuda_spmv import tau_at
from ..ops.segment import ordered_segment_sum, starts_from_ids
from ..ops.spmv import spmv
from ..ops.stencil import mf_slim
from ..precision import compute_dtype
from .base import Solver
from .multicolor import _scalar_only


def chebyshev_poly_coeffs(m: int):
    """The tau numerators; divide by the spectral bound for the taus."""
    beta = np.pi / (4.0 * m + 2.0)
    return np.asarray([
        np.cos(beta) ** 2
        / (np.cos(beta * (2 * i + 1)) ** 2 - np.sin(beta) ** 2)
        for i in range(m)
    ])


def _abs_row_sums(A):
    if A.dia_vals is not None:
        return A.dia_vals.abs().sum(dim=0)
    rows, _, vals = A.coo()
    s = torch.zeros(A.num_rows, dtype=A.dtype, device=A.device)
    return s.index_add_(0, rows, vals.abs())


def _lanczos_rho(A, steps: int = 8) -> float:
    """A spectral-radius estimate from a short Lanczos run (cusp's
    ritz_spectral_radius_symmetric), 1.01 x the largest |Ritz value|."""
    n = A.num_rows
    rng = np.random.default_rng(17)
    v = torch.tensor(rng.standard_normal(n), dtype=A.dtype, device=A.device)
    v = v / torch.linalg.norm(v)
    alphas, betas = [], []
    v_prev = torch.zeros_like(v)
    beta = 0.0
    for _ in range(min(steps, n)):
        w = spmv(A, v) - beta * v_prev
        alpha = float(torch.dot(v, w))
        w = w - alpha * v
        beta = float(torch.linalg.norm(w))
        alphas.append(alpha)
        betas.append(beta)
        if beta < 1e-12:
            break
        v_prev, v = v, w / beta
    T = np.diag(alphas)
    for i in range(len(alphas) - 1):
        T[i, i + 1] = T[i + 1, i] = betas[i]
    return float(np.max(np.abs(np.linalg.eigvalsh(T)))) * 1.01


@registry.solvers.register("POLYNOMIAL")
class PolynomialSolver(Solver):
    """Chebyshev relaxation (polynomial_solver.cu's scalar path): one
    application is `order` steps of the Chebyshev semi-iteration on
    [lmin, lmax] = [rho / 30, 1.1 rho]."""

    is_smoother = True

    def __init__(self, cfg, scope="default", name="POLYNOMIAL", device=None):
        super().__init__(cfg, scope, name, device)
        order = int(cfg.get("kpz_order", scope))
        self.order = order if order > 0 else 6
        self.lmin = self.lmax = None

    def solver_setup(self):
        _scalar_only(self.A, self.name)
        rho = _lanczos_rho(self.A)
        self.set_bounds(1.1 * rho, rho / 30.0)

    def set_bounds(self, lmax: float, lmin: float):
        """The Chebyshev interval (interop.py carries another
        implementation's)."""
        self.lmax, self.lmin = float(lmax), float(lmin)

    def computes_residual(self):
        return False

    def solve_iteration(self, data, b, st):
        A = data["A"]
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        x = st["x"]
        r = b - spmv(A, x)
        sigma = theta / delta
        rho_c = 1.0 / sigma
        d = r / theta
        for _ in range(self.order):
            x = x + d
            r = r - spmv(A, d)
            rho_new = 1.0 / (2.0 * sigma - rho_c)
            d = rho_new * rho_c * d + 2.0 * rho_new / delta * r
            rho_c = rho_new
        out = dict(st)
        out["x"] = x
        return out


@registry.solvers.register("KPZ_POLYNOMIAL")
class KPZPolynomialSolver(Solver):
    """The KPZ polynomial smoother (kpz_polynomial_solver.cu:140-193)."""

    is_smoother = True

    def __init__(self, cfg, scope="default", name="KPZ_POLYNOMIAL",
                 device=None):
        super().__init__(cfg, scope, name, device)
        self.mu = int(cfg.get("kpz_mu", scope))
        self.order = max(int(cfg.get("kpz_order", scope)), 1)
        self.l_inf = None

    def solver_setup(self):
        _scalar_only(self.A, self.name)
        # ||A||_inf of A^T: the largest absolute column sum
        _, cols, vals = self.A.coo()
        order = torch.argsort(cols.long(), stable=True)
        colsum = ordered_segment_sum(
            vals.abs()[order], starts_from_ids(cols[order],
                                               self.A.num_cols))
        self.l_inf = float(colsum.max())

    def computes_residual(self):
        return False

    def solve_iteration(self, data, b, st):
        A = data["A"]
        smax = self.l_inf
        smin = smax / self.mu
        smu0, smu1 = 1.0 / smax, 1.0 / smin
        skappa = math.sqrt(smax / smin)
        delta = (skappa - 1.0) / (skappa + 1.0)
        beta = (math.sqrt(smu0) + math.sqrt(smu1)) ** 2
        chi = 4.0 * smu0 * smu1 / beta
        x = st["x"]
        r = b - spmv(A, x)
        v0 = (smu0 + smu1) / 2.0 * r
        v = beta / 2.0 * r - smu0 * smu1 * spmv(A, r)
        for _ in range(2, self.order + 1):
            sn = r - spmv(A, v)
            sn = chi * sn + delta * delta * v - delta * delta * v0
            v0 = v
            v = v + sn
        out = dict(st)
        out["x"] = x + v
        return out


@registry.solvers.register("CHEBYSHEV_POLY")
class ChebyshevPolySolver(Solver):
    """One application = `chebyshev_polynomial_order` damped Richardson
    steps x += tau_i (b - A x)."""

    is_smoother = True
    batched_iteration = True
    # matrix-free capable (amg/hierarchy.py `matrix_free`): the damped
    # Richardson steps need only the stencil coefficients, no dinv
    supports_matrix_free = True
    matrix_free_dinv = None
    _mf_stencil = None

    def __init__(self, cfg, scope="default", name="CHEBYSHEV_POLY",
                 device=None):
        super().__init__(cfg, scope, name, device)
        order = int(cfg.get("chebyshev_polynomial_order", scope))
        self.order = min(10, max(order, 1))
        self.fused_smoother = bool(int(cfg.get("fused_smoother", scope)))
        self._tau_cache = {}

    def solver_setup(self):
        # lambda stays on the device: no host round trip per level
        lam = torch.max(_abs_row_sums(self.A))
        self._taus = torch.tensor(chebyshev_poly_coeffs(self.order),
                                  dtype=self.A.dtype,
                                  device=self.A.device) / lam
        self._tau_cache = {}

    def solve_data(self):
        d = super().solve_data()
        d["taus"] = self._taus
        if self._mf_stencil is not None:
            # matrix-free level: the operator view drops its value slab;
            # every smoothing entry routes through ops/stencil.py
            d["A"] = mf_slim(d["A"])
            d["stencil"] = self._mf_stencil
        return d

    def computes_residual(self):
        return False

    def solve_iteration(self, data, b, st):
        A = data["A"]
        x = st["x"]
        for i in range(self.order):
            x = x + tau_at(data["taus"], i) * (b - spmv(A, x))
        out = dict(st)
        out["x"] = x
        return out

    # -- the smoother kernels (ops/smooth.py) -----------------------------
    # `sweeps` applications are the tiled tau schedule.
    def _fused_taus(self, data, sweeps: int):
        """The level's taus tiled `sweeps` times in their compute dtype
        (a bf16 cycle's bf16 leaf widened to float32), made once per
        (taus leaf, sweeps); a batch's (B, T) taus tile along T."""
        taus = data["taus"]
        key = (id(taus), sweeps)
        hit = self._tau_cache.get(key)
        if hit is None or hit[0] is not taus:
            if len(self._tau_cache) > 64:
                # a multi-matrix batch stacks new taus each solve
                self._tau_cache.clear()
            reps = (1,) * (taus.dim() - 1) + (sweeps,)
            tiled = taus.repeat(reps) if sweeps > 1 else taus
            hit = self._tau_cache[key] = (
                taus, tiled.to(compute_dtype(taus.dtype)))
        return hit[1]

    def refresh_tau_cache(self):
        """Re-tile, in place, every cached schedule whose taus leaf was
        written in place (a serving bucket's admit copies a system's
        taus into its slot): the cached tensors keep their storage, so
        the card plans pointing at them stay valid."""
        for taus, tiled in self._tau_cache.values():
            if tiled is not taus:
                reps = (1,) * (taus.dim() - 1) + (
                    tiled.shape[-1] // max(taus.shape[-1], 1),)
                tiled.copy_(taus.repeat(reps))

    def smooth(self, data, b, x, sweeps: int):
        if sweeps > 0 and self.fused_smoother:
            out = fused.fused_smooth(data, b, x,
                                     self._fused_taus(data, sweeps),
                                     with_residual=False)
            if out is not None:
                return out
        return super().smooth(data, b, x, sweeps)

    def smooth_residual(self, data, b, x, sweeps: int):
        if sweeps > 0 and self.fused_smoother:
            out = fused.fused_smooth(data, b, x,
                                     self._fused_taus(data, sweeps),
                                     with_residual=True)
            if out is not None:
                return out
        return super().smooth_residual(data, b, x, sweeps)

    def smooth_restrict(self, data, b, x, sweeps: int, xfer):
        if sweeps < 1 or not self.fused_smoother:
            return None
        return fused.fused_smooth_restrict(
            data, b, x, self._fused_taus(data, sweeps), xfer)

    def smooth_corr(self, data, b, x, xc, sweeps: int, xfer,
                    want_dot: bool = False):
        if sweeps < 1 or not self.fused_smoother:
            return None
        return fused.fused_corr_smooth(
            data, b, x, xc, self._fused_taus(data, sweeps), xfer,
            want_dot=want_dot)

    def fused_tail_spec(self, data, sweeps: int, dtype):
        """(taus, dinv=None): the tiled damping schedule of `sweeps`
        applications for the coarse-tail kernel in `dtype` (float32 under
        a bf16 cycle too: the bf16 level's taus widened, as in the JAX
        package), or None when this smoother does not ride it."""
        if not self.fused_smoother:
            return None
        if sweeps <= 0:
            taus = data["taus"]
            return taus.new_zeros(taus.shape[:-1] + (0,), dtype=dtype), None
        return self._fused_taus(data, sweeps).to(dtype), None
