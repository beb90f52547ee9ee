"""BLAS-1 vector ops and norms (the port of amgx_tpu/ops/blas.py, single
device: the JAX package's psum reductions are the identity here), and
the Krylov shell's single-pass CG update (B7, ops/cuda_krylov.py).

A batch's vectors (B, n) reduce per row: `norm` gives one value per
system, and `cg_update` computes the JAX package's vmap route
of B7, `cg_update_multi` (ops/batched.py), with alpha (B,)."""
from __future__ import annotations

import torch

from . import cuda_krylov


def mdot(V, w):
    """Row-wise dots <V[j], w> as one (m, n) @ (n,) product."""
    return V @ w


def nrm1(x):
    return x.abs().sum(-1) if x.dim() == 2 else x.abs().sum()


def nrm2(x):
    if x.dim() == 2:
        return torch.linalg.vector_norm(x, dim=-1)
    return torch.linalg.vector_norm(x)


def nrmmax(x):
    return x.abs().amax(-1) if x.dim() == 2 else x.abs().max()


_NORMS = {"L1": nrm1, "L2": nrm2, "LMAX": nrmmax}


def norm(x, norm_type: str = "L2"):
    """Norm of a flat vector as a 0-d tensor on x's device; of each row
    of a batch (B, n) as a (B,) tensor."""
    return _NORMS[norm_type.upper()](x)


def cg_update(x, p, r, ap, alpha):
    """(x + alpha p, r - alpha Ap, r'.r') in one B7 launch for float32
    vectors; the same expressions composed for other dtypes. A batch
    composes `cg_update_multi` (alpha (B,))."""
    if x.dim() == 2:
        from .batched import cg_update_multi
        return cg_update_multi(x, p, r, ap, alpha)
    from ..telemetry import metrics as _tm
    if x.dtype == torch.float32:
        _tm.inc("krylov.fused_dispatch")
        return cuda_krylov.cg_update(x, p, r, ap, alpha)
    _tm.inc("krylov.fused_declined")
    return cuda_krylov.cg_update_plain(x, p, r, ap, alpha)


def psum_bundle(scalars):
    """Sum LOCAL scalars across devices in one packed collective: the
    identity on one device. Kept at the JAX package's call sites, where a
    distributed solve will reduce."""
    return tuple(scalars)
