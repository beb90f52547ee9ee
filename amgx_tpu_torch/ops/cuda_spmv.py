"""Hopper kernels of the DIA SpMV / smoother family, with their plain
PyTorch twins and launch counters.

The counterpart of `amgx_tpu/ops/pallas_spmv.py`. The CUDA sources live
in `amgx_tpu_torch/csrc/dia.cu` (built by `cuda_build`, bound through
ctypes). A DIA operator is a contiguous (k, n) float32 slab `vals` with
`vals[d, i] = A[i, i + offsets[d]]` (zero where that column leaves
[0, n)) and an ascending offset tuple.

Routing: each wrapper takes its plain version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises -- there is no
fallback. Callers that must run another dtype (the f64 residual of
REFINEMENT's outer loop) route to the plain version themselves, where
the JAX package routes the same way (see `ops/spmv.py`).

Launch counts: `LAUNCHES[name]` grows by one at every kernel launch a
wrapper makes (a multi-application call launches several times) and
nowhere else; `amgx_tpu_torch.kernel_launches()` reads them. The dict
counts every kernel of the port: the Krylov-shell kernels
(`cuda_krylov`) and the coarse tail (`cuda_tail`) launch through
`_launch` here too.

The four kernels
----------------
B1 `dia_spmv` replaces `_dia_spmv_call` (amgx_tpu/ops/pallas_spmv.py:165).
   y = sum_d vals_d * x[i + off_d]. Bound by bytes: (k + 2) * n * 4. One
   thread per row, coalesced value and x streams.

B2 `dia_smooth` replaces `_dia_smooth_call` (pallas_spmv.py:649): s
   damped steps x <- x + (tau_t * (b - A x)) * dinv (dinv optional), then
   optionally r = b - A x. The TPU kernel runs every application in one
   pass by temporal blocking over a VMEM window that at 128^3 spans ~100k
   rows per block; a Hopper block's 227 KB of shared memory cannot hold
   it. Design: one grid-wide launch per application, x ping-ponging
   between the output and one scratch buffer, so a call launches
   s + (1 if with_residual) kernels and streams the value slab as often.
   Bound by bytes: the function must read vals, b, x (and dinv) once and
   write x' (and r) once.

B3 `dia_smooth_restrict` replaces `_dia_smooth_restrict_call`
   (pallas_spmv.py:1245): B2's s steps, then bc[c] = sum_j r[ctab[j, c]]
   with r = b - A x. The TPU kernel adds per-block partial coarse sums
   after the grid; Hopper blocks run in no order, so the epilogue is one
   thread per coarse row that walks its children and recomputes r at
   each -- deterministic, no atomics, r never stored. s + 1 launches.

B4 `dia_prolong_smooth` replaces `_dia_prolong_smooth_call`
   (pallas_spmv.py:1585): x <- x + xc[agg] folded into the first step's
   reads (x + P xc is never stored), then B2's remaining steps. s
   launches. `with_dot` also returns x'.b (PCG's r.z, the cycle-borne
   dot) from the last step's launch: each block writes its partial sum
   and the last block to finish adds them in block order -- one launch,
   deterministic, no float atomics. That launch counts as
   "dia_prolong_smooth_dot".

Not ported here (the wrappers raise): bf16 operand slabs, B2's x.b dot
epilogue (the JAX package has no caller for it), and B3/B4's weighted
transfer rows (classical AMG's cwt / ptab / pwt).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

LAUNCHES = {"dia_spmv": 0, "dia_smooth": 0, "dia_smooth_restrict": 0,
            "dia_prolong_smooth": 0, "dia_prolong_smooth_dot": 0,
            "dia_spmv_dot": 0, "cg_update": 0, "dia_coarse_tail": 0,
            "dia_coarse_tail_dot": 0}

MAX_OFFSETS = 32      # offsets per operator (csrc/common.cuh kMaxOffsets)
THREADS = 256         # rows per block (csrc/common.cuh kThreads)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("dia.cu")
    lib.amgx_dia_spmv.argtypes = [_P, _P, _P, _I, _P, _I, _P]
    lib.amgx_dia_step.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                                  _P, _I, _P, _P, _P, _P]
    lib.amgx_dia_residual.argtypes = [_P, _P, _P, _P, _I, _P, _I, _P]
    lib.amgx_dia_restrict.argtypes = [_P, _P, _P, _P, _I, _I, _P, _I, _P,
                                      _I, _P]
    for fn in (lib.amgx_dia_spmv, lib.amgx_dia_step, lib.amgx_dia_residual,
               lib.amgx_dia_restrict):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=256)
def _offsets_arg(offsets: tuple):
    return (ctypes.c_int * len(offsets))(*offsets)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream():
    """The current stream of the current device (the wrappers make the
    operands' device current around their launches)."""
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def dot_counter(device) -> torch.Tensor:
    """The zeroed int32 arrival counter of the dot epilogues on one
    device: the last block of a launch resets it, so launches reuse it
    in stream order (common.cuh `finish_dot`)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def dot_scratch(n: int, device):
    """(partials, dot) for a launch over n rows: one float per block of
    THREADS rows and the 0-dim result, in one allocation."""
    ws = torch.empty(-(-n // THREADS) + 1, dtype=torch.float32,
                     device=device)
    return ws[:-1], ws[-1]


def _launch(name: str, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed (code {rc}; -1 = arguments the "
            f"kernel does not take, else a cudaError_t)")
    LAUNCHES[name] += 1


def _check(name: str, offsets: Optional[Sequence[int]], n: int,
           floats: dict, ints: dict = None):
    """Validate operands of a CUDA launch: the offset table (unless
    None), one CUDA device, float32 / int32 dtypes, contiguity, and the
    shapes in the dicts' (tensor, shape) pairs. Raises on anything the
    kernels do not take."""
    if offsets is not None and not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{name}: {len(offsets)} diagonals; the kernel "
                         f"takes 1..{MAX_OFFSETS}")
    if offsets is not None and list(offsets) != sorted(offsets):
        raise ValueError(f"{name}: offsets must ascend, got {offsets}")
    if n < 1:
        raise ValueError(f"{name}: empty operator")
    dev = None
    for group, dtype in ((floats, torch.float32), (ints or {}, torch.int32)):
        for arg, (t, shape) in group.items():
            if t is None:
                continue
            if t.device.type != "cuda":
                raise ValueError(f"{name}: {arg} is on {t.device}, the "
                                 f"kernel needs a CUDA tensor")
            if dev is None:
                dev = t.device
            elif t.device != dev:
                raise ValueError(f"{name}: {arg} is on {t.device}, "
                                 f"other operands on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel "
                                f"takes {dtype} only")
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: {arg} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be contiguous")


def _not_ported(name: str, **modes):
    for mode, value in modes.items():
        if value:
            raise NotImplementedError(
                f"{name}: the {mode} mode of the TPU kernel is not ported "
                f"to CUDA yet")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU route and the kernels' on-card reference)
# ---------------------------------------------------------------------------


def dia_spmv_plain(vals, offsets, x):
    """y = A x: one shifted multiply-add per stored diagonal over a
    zero-padded copy of x (the slab form `spmv_dia_multi` of
    amgx_tpu/ops/batched.py)."""
    n = x.shape[0]
    left = max(0, -min(offsets))
    xp = torch.nn.functional.pad(x, (left, max(0, max(offsets))))
    y = torch.zeros_like(x)
    for d, o in enumerate(offsets):
        y = y + vals[d] * xp[left + o:left + o + n]
    return y


def dia_smooth_plain(vals, offsets, taus, b, x, dinv=None,
                     with_residual=True):
    for t in range(taus.shape[0]):
        upd = taus[t] * (b - dia_spmv_plain(vals, offsets, x))
        if dinv is not None:
            upd = upd * dinv
        x = x + upd
    if with_residual:
        return x, b - dia_spmv_plain(vals, offsets, x)
    return x


def restrict_plain(ctab, r):
    """bc[c] = sum_j r[ctab[j, c]] over the children present (>= 0)."""
    g = r[ctab.clamp(min=0).long()]
    return torch.where(ctab >= 0, g, torch.zeros_like(g)).sum(dim=0)


def dia_smooth_restrict_plain(vals, offsets, taus, b, x, ctab, dinv=None):
    x, r = dia_smooth_plain(vals, offsets, taus, b, x, dinv, True)
    return x, restrict_plain(ctab, r)


def dia_prolong_smooth_plain(vals, offsets, taus, b, x, xc, agg,
                             dinv=None, with_dot=False):
    x = x + xc[agg.long()]
    x = dia_smooth_plain(vals, offsets, taus, b, x, dinv, False)
    return (x, torch.dot(x, b)) if with_dot else x


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def dia_spmv(vals, offsets, x):
    """B1: y = A x."""
    if x.device.type == "cpu":
        return dia_spmv_plain(vals, offsets, x)
    n = x.shape[0]
    _check("dia_spmv", offsets, n,
           {"vals": (vals, (len(offsets), n)), "x": (x, (n,))})
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("dia_spmv", _lib().amgx_dia_spmv, _ptr(vals), _ptr(x),
                _ptr(y), n, _offsets_arg(tuple(offsets)), len(offsets),
                _stream())
    return y


def _steps(name, vals, offsets, taus, b, x, dinv, out, xc=None, agg=None,
           dot=None):
    """Launch len(taus) damped steps, the last one writing `out`; the
    first reads x (+ xc[agg] when given). With dot = (partials, result)
    the last launch also writes out.b into result and counts under
    name + "_dot". Returns `out`."""
    lib = _lib()
    n = x.shape[0]
    s = taus.shape[0]
    tmp = torch.empty_like(x) if s > 1 else None
    offs = _offsets_arg(tuple(offsets))
    src = x
    for t in range(s):
        dst = out if (s - 1 - t) % 2 == 0 else tmp
        last_dot = dot is not None and t == s - 1
        _launch(name + "_dot" if last_dot else name, lib.amgx_dia_step,
                _ptr(vals), _ptr(dinv), _ptr(taus), t, _ptr(b), _ptr(src),
                _ptr(xc) if t == 0 else None, _ptr(agg) if t == 0 else None,
                _ptr(dst), n, offs, len(offsets),
                _ptr(dot[0]) if last_dot else None,
                _ptr(dot_counter(x.device)) if last_dot else None,
                _ptr(dot[1]) if last_dot else None, _stream())
        src = dst
    return out


def _check_smooth(name, vals, offsets, taus, b, x, dinv, floats=None,
                  ints=None):
    n = x.shape[0]
    if taus.dim() != 1 or taus.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one step (taus "
                         f"{tuple(taus.shape)})")
    f = {"vals": (vals, (len(offsets), n)), "x": (x, (n,)),
         "b": (b, (n,)), "taus": (taus, (taus.shape[0],)),
         "dinv": (dinv, (n,))}
    f.update(floats or {})
    _check(name, offsets, n, f, ints)
    return n


def dia_smooth(vals, offsets, taus, b, x, dinv=None, with_residual=True,
               with_dot=False):
    """B2: len(taus) damped steps (+ the residual r = b - A x'). Returns
    x' or (x', r)."""
    _not_ported("dia_smooth", with_dot=with_dot)
    if x.device.type == "cpu":
        return dia_smooth_plain(vals, offsets, taus, b, x, dinv,
                                with_residual)
    n = _check_smooth("dia_smooth", vals, offsets, taus, b, x, dinv)
    with torch.cuda.device(x.device):
        out = _steps("dia_smooth", vals, offsets, taus, b, x, dinv,
                     torch.empty_like(x))
        if not with_residual:
            return out
        r = torch.empty_like(x)
        _launch("dia_smooth", _lib().amgx_dia_residual, _ptr(vals),
                _ptr(b), _ptr(out), _ptr(r), n,
                _offsets_arg(tuple(offsets)), len(offsets), _stream())
    return out, r


def dia_smooth_restrict(vals, offsets, taus, b, x, ctab, dinv=None,
                        weights=None):
    """B3: B2's steps, then bc = R (b - A x') through the child table
    ctab (m, nc). Returns (x', bc)."""
    _not_ported("dia_smooth_restrict", weighted_transfer=weights is not None)
    if x.device.type == "cpu":
        return dia_smooth_restrict_plain(vals, offsets, taus, b, x, ctab,
                                         dinv)
    if ctab.dim() != 2:
        raise ValueError("dia_smooth_restrict: ctab must be (m, nc)")
    m, nc = ctab.shape
    n = _check_smooth("dia_smooth_restrict", vals, offsets, taus, b, x, dinv,
                      ints={"ctab": (ctab, (m, nc))})
    if m < 1 or nc < 1:
        raise ValueError("dia_smooth_restrict: empty child table")
    with torch.cuda.device(x.device):
        out = _steps("dia_smooth_restrict", vals, offsets, taus, b, x,
                     dinv, torch.empty_like(x))
        bc = torch.empty(nc, dtype=x.dtype, device=x.device)
        _launch("dia_smooth_restrict", _lib().amgx_dia_restrict,
                _ptr(vals), _ptr(b), _ptr(out), _ptr(ctab), m, nc,
                _ptr(bc), n, _offsets_arg(tuple(offsets)), len(offsets),
                _stream())
    return out, bc


def dia_prolong_smooth(vals, offsets, taus, b, x, xc, agg, dinv=None,
                       weights=None, with_dot=False):
    """B4: len(taus) damped steps from x + xc[agg] (the correction read
    on the fly by the first step). Returns x', or (x', x'.b) with
    `with_dot` (the dot a 0-dim float32 tensor on x's device)."""
    _not_ported("dia_prolong_smooth", weighted_transfer=weights is not None)
    if x.device.type == "cpu":
        return dia_prolong_smooth_plain(vals, offsets, taus, b, x, xc, agg,
                                        dinv, with_dot)
    n = x.shape[0]
    _check_smooth("dia_prolong_smooth", vals, offsets, taus, b, x, dinv,
                  floats={"xc": (xc, (xc.shape[0],))},
                  ints={"agg": (agg, (n,))})
    with torch.cuda.device(x.device):
        dot = dot_scratch(n, x.device) if with_dot else None
        out = _steps("dia_prolong_smooth", vals, offsets, taus, b, x, dinv,
                     torch.empty_like(x), xc=xc, agg=agg, dot=dot)
    return (out, dot[1]) if with_dot else out
