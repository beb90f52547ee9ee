"""Multi-system forms of the Krylov shell's fused products (the port of
amgx_tpu/ops/batched.py's `spmv_dot_multi` and `cg_update_multi`).

A batch's vectors are (B, n) tensors; per-system scalars are (B,). These
are the compositions a batched solve runs where it has no batched kernel
(B6's and B7's work), as the JAX package's `custom_vmap` rules run them.
The JAX package's other multi forms (`spmv_dia_multi`, `spmv_multi`,
`residual_multi`, `smooth_dia_multi`, `restrict_multi`,
`prolong_corr_multi`) need no twin here: the port's plain forms
(`cuda_spmv.dia_spmv_plain`, `dia_smooth_plain`, `restrict_plain`,
`prolong_plain`, `cuda_csr.csr_spmv_plain`) take a leading batch axis
and an operator shared or stacked, and are the CPU route of the batched
kernels K1-K4 (ops/cuda_batched.py).

`tail_cycle_multi` is K5 (ops/cuda_tail.py `dia_coarse_tail_multi`, its
plain form `dia_coarse_tail_multi_plain`); `rap_values_multi` has no
caller on the batched path yet (ROADMAP.md Queue A item 9);
`affine_window_sweeps` belongs to the distributed solves (item 13).
"""
from __future__ import annotations

import torch

from ..precision import compute_dtype


def spmv_dot_multi(A, P, Z=None, beta=None, D=None, self_dot=False, *,
                   product):
    """The multi-system form of B6: optional prologue P' = Z + beta P
    (beta (B,)), AP = A @ P', the row dots d . AP (d = D, else P') in
    float32 or wider and, with `self_dot`, AP . AP. Returns (AP, pdot[,
    sdot]) or, with the prologue, (P', AP, pdot[, sdot]). `product`
    computes A @ P' (ops/spmv.py passes its dispatch: K1 on the card)."""
    dt = P.dtype
    cdt = compute_dtype(dt)
    if Z is not None:
        P = (Z.to(cdt) + beta[..., None].to(cdt) * P.to(cdt)).to(dt)
    AP = product(A, P)
    dvec = (P if D is None else D).to(cdt)
    pdot = (dvec * AP.to(cdt)).sum(-1)
    out = (AP, pdot) if Z is None else (P, AP, pdot)
    if self_dot:
        out = out + ((AP.to(cdt) ** 2).sum(-1),)
    return out


def cg_update_multi(X, P, R, AP, alpha):
    """The multi-system form of B7: X' = X + alpha P, R' = R - alpha AP
    (alpha (B,)) in X's dtype, and the row dots r'.r' in float32 or
    wider."""
    a = alpha.to(X.dtype)[..., None]
    Xn = X + a * P
    Rn = R - a * AP
    rc = Rn.to(torch.promote_types(X.dtype, torch.float32))
    return Xn, Rn, (rc * rc).sum(-1)

