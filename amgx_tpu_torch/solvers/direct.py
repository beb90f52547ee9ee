"""Dense direct solver for the coarsest AMG level (the port of
amgx_tpu/solvers/direct.py): densify once at setup, factor by
Householder QR, and back-substitute per application. The factorization
and the triangular solve are plain PyTorch calls, as the JAX package
leaves them to `jnp.linalg.qr` outside any Pallas kernel."""
from __future__ import annotations

import torch

from .. import registry
from ..ops.spmv import residual
from .base import Solver


@registry.solvers.register("DENSE_LU_SOLVER")
class DenseLUSolver(Solver):
    def solver_setup(self):
        dense = self.A.to_dense()
        # guard singular rows (e.g. empty coarse rows) with unit diagonal
        zero_rows = torch.all(dense == 0, dim=1)
        dense = torch.where(torch.diag(zero_rows),
                            torch.eye(dense.shape[0], dtype=dense.dtype,
                                      device=dense.device), dense)
        q, r = torch.linalg.qr(dense)
        self._qt, self._r = q.T.contiguous(), r

    def solve_data(self):
        d = super().solve_data()
        d["qt"] = self._qt
        d["r"] = self._r
        return d

    @staticmethod
    def _direct(data, rhs):
        return torch.linalg.solve_triangular(
            data["r"], (data["qt"] @ rhs)[:, None], upper=True)[:, 0]

    def solve_iteration(self, data, b, st):
        x = self._direct(data, b)
        out = dict(st)
        out["x"] = x
        out["r"] = residual(data["A"], x, b)
        return out

    def apply(self, data, rhs):
        return self._direct(data, rhs)

    def smooth(self, data, b, x, sweeps):
        return self._direct(data, b)
