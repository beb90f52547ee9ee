"""BLAS-1 vector ops and norms (the port of amgx_tpu/ops/blas.py, single
device: the JAX package's psum reductions are the identity here)."""
from __future__ import annotations

import torch


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

