"""Dense direct solver for the coarsest AMG level (the port of
amgx_tpu/solvers/direct.py): densify once at setup, factor by
Householder QR, and back-substitute per application. The factorization
and the triangular solve are plain PyTorch calls, as the JAX package
leaves them to `jnp.linalg.qr` outside any Pallas kernel.

With cycle_fusion on and at most _TAIL_INV_MAX_ROWS rows, solve_data
also carries the explicit inverse `inv` = R^-1 Q^T in the factors' dtype:
the coarse-tail kernel (B5, ops/cuda_tail.py) applies the coarsest solve
as one matrix-vector product. It is built on either device, so the CPU
and the card take the same cycle route."""
from __future__ import annotations

import torch

from .. import registry
from ..ops.spmv import residual
from .base import Solver


@registry.solvers.register("DENSE_LU_SOLVER")
class DenseLUSolver(Solver):
    # the explicit inverse is built only up to this size (as in the JAX
    # package, whose tail kernel holds it in fast memory)
    _TAIL_INV_MAX_ROWS = 1024
    batched_iteration = True

    def __init__(self, cfg, scope="default", name="DENSE_LU_SOLVER",
                 device=None):
        super().__init__(cfg, scope, name, device)
        self.cycle_fusion = bool(int(cfg.get("cycle_fusion", scope)))

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
        if self.cycle_fusion and self.A is not None \
                and self.A.num_rows <= self._TAIL_INV_MAX_ROWS:
            # memoized on the current factors: repeated solve_data calls
            # do not redo the n^2-rhs triangular solve
            memo = getattr(self, "_inv_memo", None)
            if memo is None or memo[0] is not self._qt \
                    or memo[1] is not self._r:
                memo = (self._qt, self._r, torch.linalg.solve_triangular(
                    self._r, self._qt, upper=True).contiguous())
                self._inv_memo = memo
            d["inv"] = memo[2]
        return d

    @staticmethod
    def _direct(data, rhs):
        if rhs.dim() == 2:
            # a batch: (B, nc) right-hand sides against shared factors, or
            # each against its own (qt, r (B, nc, nc): a multi-matrix batch)
            return torch.linalg.solve_triangular(
                data["r"], data["qt"] @ rhs[..., None], upper=True)[..., 0]
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
