"""CHEBYSHEV_POLY smoother (the port of the CHEBYSHEV_POLY part of
amgx_tpu/solvers/polynomial.py): the "magic damping" tau sequence of
chebyshev_poly.cu, tau_i = cos^2(beta) / (cos^2(beta(2i+1)) -
sin^2(beta)) / lambda with beta = pi/(4m+2) and lambda the Gershgorin
bound (max absolute row sum), applied as x += tau_i (b - A x).

The taus are solve data ("taus"), so a multi-matrix batch stacks them to
(B, T): each system smooths with the taus of its own spectral bound
(the batched kernels K2 / K2-mf and K5 take them per system)."""
from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..ops import smooth as fused
from ..ops.cuda_spmv import tau_at
from ..ops.spmv import spmv
from ..ops.stencil import mf_slim
from ..precision import compute_dtype
from .base import Solver


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
