"""BLAS-1 vector ops and norms (the port of amgx_tpu/ops/blas.py, single
device: the JAX package's psum reductions are the identity here), and
the Krylov shell's single-pass CG update (B7, ops/cuda_krylov.py)."""
from __future__ import annotations

import torch

from . import cuda_krylov


def mdot(V, w):
    """Row-wise dots <V[j], w> as one (m, n) @ (n,) product."""
    return V @ w


def nrm1(x):
    return x.abs().sum()


def nrm2(x):
    return torch.linalg.vector_norm(x)


def nrmmax(x):
    return x.abs().max()


_NORMS = {"L1": nrm1, "L2": nrm2, "LMAX": nrmmax}


def norm(x, norm_type: str = "L2"):
    """Norm of a flat vector as a 0-d tensor on x's device."""
    return _NORMS[norm_type.upper()](x)


def cg_update(x, p, r, ap, alpha):
    """(x + alpha p, r - alpha Ap, r'.r') in one B7 launch for float32
    vectors; the same expressions composed for other dtypes."""
    if x.dtype == torch.float32:
        return cuda_krylov.cg_update(x, p, r, ap, alpha)
    return cuda_krylov.cg_update_plain(x, p, r, ap, alpha)


def psum_bundle(scalars):
    """Sum LOCAL scalars across devices in one packed collective: the
    identity on one device. Kept at the JAX package's call sites, where a
    distributed solve will reduce."""
    return tuple(scalars)
