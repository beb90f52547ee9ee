"""The batched Hopper kernels K1-K4: B1, B2 / B2-mf, B8 and B9 over a
batch of systems, with their plain PyTorch twins and launch counters
(K5, the batched coarse tail, is in ops/cuda_tail.py).

A batched solve (amgx_tpu_torch/batch/) carries its vectors as (B, n)
tensors. Its operator is shared by every system (multi-RHS: the solve
data as it is) or stacked with a leading batch axis (multi-matrix: one
DIA slab (B, k, n), stencil coefficient set (B, k) or CSR value array
(B, nnz) a system; dinv (B, n)). The JAX package batches through
`jax.vmap`, under which every Pallas call gives way to its `custom_vmap`
rule, an XLA multi form (amgx_tpu/ops/batched.py); these kernels are the
port's counterparts of those forms. Their plain versions are the batch
forms of the single kernels' plain versions (ops/cuda_spmv.py,
ops/cuda_csr.py, ops/stencil.py), which take a leading batch axis.

K1 `dia_spmv_multi` (counter "dia_spmv_multi"), csrc/dia.cu: Y = A X,
   B1 with a system index; replaces `spmv_dia_multi` under
   `_spmv_dia_pallas`'s vmap rule. A shared slab's row is read from HBM
   once for the batch (one thread takes row i of every system).
K2 `dia_smooth_multi` / `dia_smooth_mf_multi` (counters
   "dia_step_multi" / "dia_step_mf_multi"), csrc/dia.cu: B2's per-step
   kernel and its residual kernel with a system index, the values from a
   slab (+ dinv) or from k stencil coefficients (each block stages its
   coefficient set in shared memory; a row's grid geometry and its
   synthesized dinv are computed once for all the systems a thread
   takes); one launch a step, one for the residual. The damping factors
   are shared (T,) or one schedule a system (B, T): a multi-matrix
   CHEBYSHEV_POLY batch's taus come from each system's spectral bound
   (system stride 0 or T in the launch). Replaces `smooth_dia_multi`
   and, on matrix-free levels, the vmapped `_xla_smooth`.
K3 `csr_spmv_multi` (counter "csr_spmv_multi"), csrc/csr.cu: B8's
   row-block kernel with grid.y over the systems; replaces the vmapped
   `swell_spmv_xla`.
K4 `csr_smooth_multi` (counter "csr_step_multi"), csrc/csr.cu: B9's
   sweep kernel with grid.y over the systems, one launch a sweep;
   replaces the vmapped `_xla_step` of `swell_smooth_step`.

Per system a batched kernel computes its single kernel's row sums and
updates in the same order with the same roundings, so row s of the
output has the single kernel's bits on system s (chip_smoke.py checks).
Routing as in `cuda_spmv`: the plain version for CPU tensors; for CUDA
tensors the kernel, or an exception for operands it does not take
(float32 only: no fallback). Bound by bytes: each must read the operator
once (shared) or B times (per system) and the vectors once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_spmv as _k
from .cuda_spmv import _check, _launch, _ptr, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

MAX_SYSTEMS = 65535       # the kernels' grid.y


@functools.lru_cache(maxsize=None)
def _dia():
    from .cuda_build import library
    lib = library("dia.cu")
    lib.amgx_dia_spmv_multi.argtypes = [_P, _P, _P, _I, _I, _I, _P, _I, _P]
    lib.amgx_dia_step_multi.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _P, _I, _P]
    lib.amgx_dia_step_mf_multi.argtypes = [
        ctypes.POINTER(_k.StencilArg), _P, _P, _I, _I, _P, _P, _P, _I, _I,
        _I, _I, _P, _I, _P]
    for fn in (lib.amgx_dia_spmv_multi, lib.amgx_dia_step_multi,
               lib.amgx_dia_step_mf_multi):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _csr():
    from .cuda_build import library
    lib = library("csr.cu")
    lib.amgx_csr_spmv_multi.argtypes = [_P, _P, _P, _P, _I, _P, _P, _I, _I,
                                        _L, _I, _I, _P]
    lib.amgx_csr_step_multi.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P,
                                        _I, _I, _L, _I, _I, _I, _P]
    for fn in (lib.amgx_csr_spmv_multi, lib.amgx_csr_step_multi):
        fn.restype = _I
    return lib


def _batch(name, x):
    """(B, n) of a batch of vectors, checked against the grid's limit."""
    if x.dim() != 2:
        raise ValueError(f"{name}: X must be (batch, n), got "
                         f"{tuple(x.shape)}")
    nb, n = x.shape
    if not 1 <= nb <= MAX_SYSTEMS:
        raise ValueError(f"{name}: {nb} systems; the kernel takes "
                         f"1..{MAX_SYSTEMS}")
    return nb, n


def _per(t, shared_dim: int) -> bool:
    """Does an operand carry the batch axis (one more than its shared
    form's `shared_dim` dimensions)?"""
    return t is not None and t.dim() == shared_dim + 1


def _shape(t, shared, nb):
    """An operand's expected shape: `shared`, or (nb, *shared)."""
    return None if t is None else (
        (nb,) + tuple(shared) if t.dim() == len(shared) + 1 else
        tuple(shared))


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def dia_spmv_multi(vals, offsets, x):
    """K1: Y = A X for X (B, n); vals (k, n) shared or (B, k, n)."""
    if x.device.type == "cpu":
        return _k.dia_spmv_plain(vals, offsets, x)
    nb, n = _batch("dia_spmv_multi", x)
    k = len(offsets)
    _check("dia_spmv_multi", offsets, n,
           {"vals": (vals, _shape(vals, (k, n), nb)), "x": (x, (nb, n))})
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("dia_spmv_multi", _dia().amgx_dia_spmv_multi, _ptr(vals),
                _ptr(x), _ptr(y), n, nb, int(_per(vals, 2)),
                _k._offsets_arg(tuple(offsets)), k, _stream())
    return y


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _steps_multi(name, launch, taus, b, x, with_residual):
    """One launch of a K2 entry (`launch(t, src, dst, resid)`) a damping
    factor, each step into a fresh buffer, then the residual's launch."""
    src = x
    for t in range(taus.shape[-1]):
        dst = torch.empty_like(x)
        _launch(name, launch, t, src, dst, 0)
        src = dst
    if not with_residual:
        return src
    r = torch.empty_like(x)
    _launch(name, launch, 0, src, r, 1)
    return src, r


def _check_taus(name, taus, nb):
    """The damping factors: (T,) shared by every system or (B, T), one
    schedule a system (CHEBYSHEV_POLY's taus come from each system's own
    spectral bound); returns the launches' system stride (0 or T)."""
    if taus.dim() not in (1, 2) or taus.shape[-1] < 1 or (
            taus.dim() == 2 and taus.shape[0] != nb):
        raise ValueError(f"{name}: needs at least one step, (T,) or "
                         f"({nb}, T) (taus {tuple(taus.shape)})")
    return taus.shape[-1] if taus.dim() == 2 else 0


def dia_smooth_multi(vals, offsets, taus, b, x, dinv=None,
                     with_residual=True):
    """K2 on a slab: T damped steps X <- X + (tau_t (B - A X)) dinv per
    system (+ R = B - A X'). vals (k, n) or (B, k, n), dinv (n,) or (B,
    n), taus (T,) or (B, T). Returns X' or (X', R)."""
    if x.device.type == "cpu":
        return _k.dia_smooth_plain(vals, offsets, taus, b, x, dinv,
                                   with_residual)
    name = "dia_step_multi"
    nb, n = _batch(name, x)
    tstride = _check_taus(name, taus, nb)
    k = len(offsets)
    _check(name, offsets, n,
           {"vals": (vals, _shape(vals, (k, n), nb)), "x": (x, (nb, n)),
            "b": (b, (nb, n)), "dinv": (dinv, _shape(dinv, (n,), nb))},
           f32={"taus": (taus, tuple(taus.shape))})
    lib, offs = _dia(), _k._offsets_arg(tuple(offsets))

    def launch(t, src, dst, resid):
        return lib.amgx_dia_step_multi(
            _ptr(vals), None if resid else _ptr(dinv), _ptr(taus), t,
            tstride,
            _ptr(b), _ptr(src), _ptr(dst), resid, n, nb,
            int(_per(vals, 2)), int(_per(dinv, 1)), offs, k, _stream())

    with torch.cuda.device(x.device):
        return _steps_multi(name, launch, taus, b, x, with_residual)


def dia_smooth_mf_multi(st, taus, b, x, with_residual=True):
    """K2 on a stencil (the coefficient mode): B2-mf's steps (+ the
    residual) per system from the coefficients `st.coeffs`, (k,) shared
    or (B, k), the dinv synthesized per `st.dinv_mode`, the damping
    factors (T,) or (B, T). Returns X' or (X', R)."""
    if x.device.type == "cpu":
        from .stencil import _xla_smooth
        return _xla_smooth(st.spec(), st.coeffs, taus, b, x, with_residual)
    name = "dia_step_mf_multi"
    nb, n = _batch(name, x)
    tstride = _check_taus(name, taus, nb)
    if st.num_rows != n or st.shape[0] * st.shape[1] * st.shape[2] != n:
        raise ValueError(f"{name}: the stencil's grid {st.shape} does not "
                         f"cover the {n} rows of X")
    coef = st.coeffs
    _check(name, st.offsets, n,
           {"x": (x, (nb, n)), "b": (b, (nb, n)),
            "coeffs": (coef, _shape(coef, (st.k,), nb))},
           f32={"taus": (taus, tuple(taus.shape))})
    # the geometry and dinv mode by value; the coefficients from `coef`
    sarg = _k._stencil_struct((0.0,) * st.k, st.shifts, st.shape,
                              st.diag_rank, st.dinv_mode)
    lib, offs = _dia(), _k._offsets_arg(tuple(st.offsets))

    def launch(t, src, dst, resid):
        return lib.amgx_dia_step_mf_multi(
            ctypes.byref(sarg), _ptr(coef), _ptr(taus), t, tstride, _ptr(b),
            _ptr(src), _ptr(dst), resid, n, nb, int(_per(coef, 1)), offs,
            st.k, _stream())

    with torch.cuda.device(x.device):
        return _steps_multi(name, launch, taus, b, x, with_residual)


# ---------------------------------------------------------------------------
# K3, K4
# ---------------------------------------------------------------------------


def _check_csr(name, row_offsets, col_indices, values, x, nrows, nb,
               floats=None, f32=None):
    nnz = col_indices.shape[0]
    f = {"values": (values, _shape(values, (nnz,), nb)),
         "x": (x, (nb, x.shape[1]))}
    f.update(floats or {})
    _check(name, None, nrows, f,
           {"row_offsets": (row_offsets, (nrows + 1,)),
            "col_indices": (col_indices, (nnz,))}, f32)
    return nnz


def csr_spmv_multi(row_offsets, col_indices, values, x):
    """K3: Y = A X for X (B, ncols); values (nnz,) shared or (B, nnz)."""
    if x.device.type == "cpu":
        from .cuda_csr import csr_spmv_plain
        return csr_spmv_plain(row_offsets, col_indices, values, x)
    name = "csr_spmv_multi"
    nb, ncols = _batch(name, x)
    nrows = row_offsets.shape[0] - 1
    nnz = _check_csr(name, row_offsets, col_indices, values, x, nrows, nb)
    from .cuda_csr import _row_blocks
    with torch.cuda.device(x.device):
        rb = _row_blocks(row_offsets)
        y = torch.empty((nb, nrows), dtype=x.dtype, device=x.device)
        _launch(name, _csr().amgx_csr_spmv_multi, _ptr(row_offsets),
                _ptr(col_indices), _ptr(values), _ptr(rb), rb.shape[0] - 1,
                _ptr(x), _ptr(y), nrows, ncols, nnz, nb,
                int(_per(values, 1)), _stream())
    return y


def csr_smooth_multi(row_offsets, col_indices, values, taus, b, x,
                     dinv=None, lanes: int = 1):
    """K4: len(taus) damped-Jacobi sweeps per system on a square CSR
    matrix, one launch a sweep; values (nnz,) or (B, nnz), dinv (n,) or
    (B, n). Returns X'."""
    if x.device.type == "cpu":
        from .cuda_csr import csr_smooth_plain
        return csr_smooth_plain(row_offsets, col_indices, values, taus, b,
                                x, dinv)
    name = "csr_step_multi"
    nb, n = _batch(name, x)
    if _check_taus(name, taus, nb):
        raise ValueError(f"{name}: per-system damping factors are not "
                         f"taken (CSR levels run the Jacobi family, whose "
                         f"omega is one for the batch)")
    if row_offsets.shape[0] - 1 != n:
        raise ValueError(f"{name}: the matrix must be square")
    nnz = _check_csr(name, row_offsets, col_indices, values, x, n, nb,
                     {"b": (b, (nb, n)),
                      "dinv": (dinv, _shape(dinv, (n,), nb))},
                     {"taus": (taus, (taus.shape[0],))})
    lib = _csr()
    with torch.cuda.device(x.device):
        src = x
        for t in range(taus.shape[0]):
            dst = torch.empty_like(x)
            _launch(name, lib.amgx_csr_step_multi, _ptr(row_offsets),
                    _ptr(col_indices), _ptr(values), _ptr(src), _ptr(b),
                    _ptr(dinv), _ptr(taus), t, _ptr(dst), n, int(lanes),
                    nnz, nb, int(_per(values, 1)), int(_per(dinv, 1)),
                    _stream())
            src = dst
    return src
