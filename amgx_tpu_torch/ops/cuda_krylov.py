"""Hopper kernels of the Krylov shell, with their plain PyTorch twins.

The counterparts of the Krylov-shell kernels of
`amgx_tpu/ops/pallas_spmv.py`; CUDA sources in
`amgx_tpu_torch/csrc/krylov.cu`, built by `cuda_build` and bound through
ctypes. Routing as in `cuda_spmv`: the plain version for CPU tensors,
the kernel or an exception for CUDA tensors. The kernels take float32;
other dtypes compose plain PyTorch in the callers (`ops/spmv.py
spmv_pdot` and `spmv_ddot`, `ops/blas.py cg_update`), where the JAX
package routes them to XLA. Launches count in `cuda_spmv.LAUNCHES`.

B6 `dia_spmv_dot` replaces `_dia_spmv_dot_call` (pallas_spmv.py:2116)
   in its two driven forms.
   beta prologue (CG, PCG, PCGF; `z`, `beta`): p' = z + beta p, Ap',
   p'.Ap'. One thread per row recomputes z_j + beta p_j at each
   neighbour (as the TPU kernel recomputes the prologue on its halo
   rows); p' goes to a new buffer. Bound by bytes: (k + 4) n floats.
   streamed dot operand (BiCGStab, PBiCGStab; `d`, `self_dot`): Ap, d.Ap
   and, with self_dot, Ap.Ap (the t.s / t.t pair). One thread per row
   with B1's row product; both sums leave one launch. d may be p itself.
   Bound by bytes: (k + 3) n floats (vals, p, d, Ap; (k + 2) n when d is
   p), 83,886,080 B = 0.02504 ms at 3.35 TB/s on the 7-pt 128^3. Its
   launches count as "dia_spmv_ddot". The TPU kernel's other forms (both
   operands, neither) have no caller: they raise.
B7 `cg_update` replaces `_cg_update_call` (pallas_spmv.py:2261):
   (x + alpha p, r - alpha Ap, r'.r') in one elementwise pass into fresh
   tensors. Bound by bytes: 6 n floats.

Both carry their dot as per-block partials that the last block to
finish adds in block order: one launch per call, deterministic, no float
atomics. alpha and beta are 0-dim device tensors read by the kernels
through a pointer, so a solver iteration keeps its scalars on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_spmv as _k
from .cuda_spmv import _check, _launch, _not_ported, _ptr, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("krylov.cu")
    lib.amgx_spmv_pdot.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                                   _P, _P, _P]
    lib.amgx_spmv_ddot.argtypes = [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P,
                                   _P, _P]
    lib.amgx_cg_update.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                   _P, _P]
    for fn in (lib.amgx_spmv_pdot, lib.amgx_spmv_ddot, lib.amgx_cg_update):
        fn.restype = _I
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the JAX package's XLA composes)
# ---------------------------------------------------------------------------


def dia_spmv_dot_plain(vals, offsets, p, z, beta):
    """`_spmv_pdot_xla` (amgx_tpu/ops/spmv.py:186): p' = z + beta p,
    Ap', p'.Ap'."""
    p = (z + beta * p).to(p.dtype)
    ap = _k.dia_spmv_plain(vals, offsets, p)
    return p, ap, torch.dot(p, ap)


def dia_spmv_ddot_plain(vals, offsets, p, d, self_dot=False):
    """`_spmv_ddot_xla` (amgx_tpu/ops/spmv.py:195): Ap, d.Ap [, Ap.Ap]."""
    ap = _k.dia_spmv_plain(vals, offsets, p)
    out = (ap, torch.dot(d, ap))
    return out + (torch.dot(ap, ap),) if self_dot else out


def cg_update_plain(x, p, r, ap, alpha):
    """The compose of `cg_update` (amgx_tpu/ops/blas.py:167-173): the
    updates in x's dtype, r'.r' accumulated in float32 or wider."""
    a = alpha.to(x.dtype)
    xn = x + a * p
    rn = r - a * ap
    rc = rn.to(torch.promote_types(x.dtype, torch.float32))
    return xn, rn, torch.dot(rc, rc)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _scalar(name, arg, t, device):
    if t.dim() != 0 or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name}: {arg} must be a 0-dim float32 tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def dia_spmv_dot(vals, offsets, p, z=None, beta=None, d=None,
                 self_dot=False):
    """B6. With z and beta (a 0-dim tensor): (p', Ap', p'.Ap') with p' =
    z + beta p. With d: (Ap, d.Ap) and, when self_dot, Ap.Ap too. The
    dots are 0-dim float32 tensors on p's device."""
    if d is not None:
        _not_ported("dia_spmv_dot",
                    prologue_with_streamed_operand=z is not None)
        return _spmv_ddot(vals, offsets, p, d, self_dot)
    _not_ported("dia_spmv_dot", prologue_with_self_dot=self_dot,
                no_prologue_no_streamed_operand=z is None)
    if p.device.type == "cpu":
        return dia_spmv_dot_plain(vals, offsets, p, z, beta)
    n = p.shape[0]
    _check("dia_spmv_dot", offsets, n,
           {"vals": (vals, (len(offsets), n)), "p": (p, (n,)),
            "z": (z, (n,))})
    _scalar("dia_spmv_dot", "beta", beta, p.device)
    with torch.cuda.device(p.device):
        pout, ap = torch.empty_like(p), torch.empty_like(p)
        partials, dot = _k.dot_scratch(n, p.device)
        _launch("dia_spmv_dot", _lib().amgx_spmv_pdot, _ptr(vals), _ptr(p),
                _ptr(z), _ptr(beta), _ptr(pout), _ptr(ap), n,
                _k._offsets_arg(tuple(offsets)), len(offsets),
                _ptr(partials), _ptr(_k.dot_counter(p.device)), _ptr(dot),
                _stream())
    return pout, ap, dot


def _spmv_ddot(vals, offsets, p, d, self_dot):
    if p.device.type == "cpu":
        return dia_spmv_ddot_plain(vals, offsets, p, d, self_dot)
    n = p.shape[0]
    _check("dia_spmv_ddot", offsets, n,
           {"vals": (vals, (len(offsets), n)), "p": (p, (n,)),
            "d": (d, (n,))})
    with torch.cuda.device(p.device):
        ap = torch.empty_like(p)
        partials, dots = _k.dot_scratch(n, p.device, 2 if self_dot else 1)
        _launch("dia_spmv_ddot", _lib().amgx_spmv_ddot, _ptr(vals), _ptr(p),
                _ptr(d), _ptr(ap), n, _k._offsets_arg(tuple(offsets)),
                len(offsets), int(self_dot), _ptr(partials),
                _ptr(_k.dot_counter(p.device)), _ptr(dots), _stream())
    return (ap, dots[0], dots[1]) if self_dot else (ap, dots)


def cg_update(x, p, r, ap, alpha):
    """B7: (x + alpha p, r - alpha Ap, r'.r') into fresh tensors (alpha
    a 0-dim tensor). The dot is a 0-dim float32 tensor on x's device."""
    if x.device.type == "cpu":
        return cg_update_plain(x, p, r, ap, alpha)
    n = x.shape[0]
    _check("cg_update", None, n, {"x": (x, (n,)), "p": (p, (n,)),
                                   "r": (r, (n,)), "ap": (ap, (n,))})
    _scalar("cg_update", "alpha", alpha, x.device)
    with torch.cuda.device(x.device):
        xo, ro = torch.empty_like(x), torch.empty_like(x)
        partials, rr = _k.dot_scratch(n, x.device)
        _launch("cg_update", _lib().amgx_cg_update, _ptr(x), _ptr(p),
                _ptr(r), _ptr(ap), _ptr(alpha), _ptr(xo), _ptr(ro), n,
                _ptr(partials), _ptr(_k.dot_counter(x.device)), _ptr(rr),
                _stream())
    return xo, ro, rr
