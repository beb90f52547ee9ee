"""Small dense solves (the port of `solve_qr` in amgx_tpu/ops/dense.py),
with K7, the batched QR patch solve, on the card.

`solve_qr(a, b)` solves a x = b by Householder QR, a = Q R, x = R^{-1}
Q^T b, over a batch of square patches. Its plain version is the JAX
package's: `torch.linalg.qr`, Q^T b, `torch.linalg.solve_triangular`
(LAPACK's Householder QR on the CPU, as XLA's). On a CUDA tensor of shape
(B, k, k) with b (B, k), float32 or float64, it launches K7
(`csrc/dense.cu`): one thread a patch, the QR in LAPACK's reflector
convention applied to b as it goes, Q never formed, then back
substitution. It replaces no TPU kernel: the JAX package leaves this
batch to XLA; at the energymin interpolator's 10^5 - 10^6 patches the
library route forms Q patch by patch (K7's `library_ms` in chip_smoke.py
is that route's time). Anything else on a CUDA tensor raises.

`qr_threads(k, itemsize)` is the launch's route: the threads of a block
that stage their patches in 48 KB of shared memory (at most 128, a
multiple of 32), or 0 for the global route, where the patches are too
wide for one warp's share and the kernel works on a workspace
interleaved across the batch. Every k runs.

A singular patch (a zero pivot) gives a non-finite x on both routes, as
the plain version does. Launches count in `cuda_spmv.LAUNCHES["qr_solve"]`.
`inverse`, `abs_det` and `safe_inverse` (the block-matrix helpers of the
JAX module) come with block matrices, ROADMAP.md Queue A item 8.4.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_spmv import _launch, _ptr, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int
QR_SMEM = 48 * 1024       # shared memory a staged block takes at most
QR_MAX_THREADS = 128


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("dense.cu")
    for fn in (lib.amgx_qr_solve_f32, lib.amgx_qr_solve_f64):
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def qr_threads(k: int, itemsize: int) -> int:
    """K7's threads a block for k x k patches of `itemsize` bytes: the
    most (a multiple of 32, at most 128) whose patches and right-hand
    sides fit QR_SMEM, or 0 (the global route) below one warp."""
    fit = QR_SMEM // ((k * k + k) * itemsize)
    return min(QR_MAX_THREADS, fit // 32 * 32)


def solve_qr_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x = b via QR; b is (..., n) or (..., n, m)."""
    q, r = torch.linalg.qr(a)
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b.unsqueeze(-1)
    x = torch.linalg.solve_triangular(r, q.transpose(-1, -2) @ b,
                                      upper=True)
    return x.squeeze(-1) if vec else x


def solve_qr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x = b via QR: the plain version for CPU tensors, K7 for a batch
    (B, k, k) with b (B, k) on the card."""
    if a.device.type == "cpu":
        return solve_qr_plain(a, b)
    if a.dim() != 3 or a.shape[1] != a.shape[2] or b.dim() != 2 \
            or tuple(b.shape) != tuple(a.shape[:2]):
        raise ValueError(f"qr_solve: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}; the kernel takes (B, k, k) "
                         f"and (B, k)")
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise TypeError(f"qr_solve: {a.dtype} / {b.dtype}; the kernel takes "
                        f"float32 or float64, the same for both")
    if b.device != a.device:
        raise ValueError(f"qr_solve: b on {b.device}, a on {a.device}")
    nb, k = a.shape[0], a.shape[1]
    if nb == 0 or k == 0:
        return torch.empty_like(b)
    a, b = a.contiguous(), b.contiguous()
    threads = qr_threads(k, a.element_size())
    lib = _lib()
    fn = lib.amgx_qr_solve_f64 if a.dtype == torch.float64 \
        else lib.amgx_qr_solve_f32
    with torch.cuda.device(a.device):
        x = torch.empty_like(b)
        work = None if threads else torch.empty(
            (k * k + k) * nb, dtype=a.dtype, device=a.device)
        _launch("qr_solve", fn, _ptr(a), _ptr(b), _ptr(x), _ptr(work), nb, k,
                threads, _stream())
    return x
