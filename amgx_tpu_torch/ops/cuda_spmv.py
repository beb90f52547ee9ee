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
   pass by temporal blocking over a VMEM row window (~100k rows a block
   at 128^3, more than a Hopper block's 227 KB). Here, on a 7-point star
   grid level (`grid`, checked once per slab by `slab_grid`), the steps
   and the residual run in csrc/stencil_tb_slab.cu's 2.5-D temporally
   blocked kernel (as B3 below): the launches of `tiling.plan_calls`
   (at most SLAB_MAX_APPS applications each, 3 + 3 for five steps and
   the residual, any schedule length), each streaming the slab once and
   passing its float32 state to the next, the last storing r in the
   operands' dtype, rounded once; x' and r are the per-step route's
   bits. Anywhere else one grid-wide dia.cu launch a step, x
   ping-ponging through float32 scratch, and a residual launch
   ("dia_smooth_step"). Bound by bytes: the function must read vals, b,
   x (and dinv) once and write x' (and r) once.

B3 `dia_smooth_restrict` replaces `_dia_smooth_restrict_call`
   (pallas_spmv.py:1245): B2's s steps, then bc[c] = sum_j r[ctab[j, c]]
   with r = b - A x. On a 7-point star grid level (`grid`, checked once
   per slab by `slab_grid`) the steps, the residual and the restriction
   run temporally blocked in csrc/stencil_tb_slab.cu, streaming the slab
   once a launch: the few launches of `tiling.plan_calls`'s split (one
   for up to three applications), the restriction in the tile where
   every coarse row lies in one (GEO), else after the tiled steps in one
   untiled launch ("dia_smooth_restrict_epilogue"). Anywhere else one
   launch a step
   ("dia_smooth_restrict_step") and the untiled restriction: one thread
   per coarse row that walks its children and recomputes r at each --
   deterministic, no atomics, r never stored (each fine row has one
   coarse row there). With `weights` (cwt, (m, nc): classical AMG's R =
   P^T rows, the TPU kernel's `weighted=` form) bc[c] = sum_j cwt[j, c]
   r[ctab[j, c]], where a fine row is a child of up to
   interp_max_elements coarse rows: r is computed once a row and stored
   in float32 (by the tiled launches' last application on a 7-point star
   slab, else by dia.cu's residual kernel after the per-step launches),
   then B8's row-block kernel (csrc/csr.cu) sums bc = R r over R's
   compact rows (`rows`, ctab / cwt's entries in their order, each
   product rounded, then added in order); every launch counts as
   "dia_smooth_restrict_w".

B4 `dia_prolong_smooth` replaces `_dia_prolong_smooth_call`
   (pallas_spmv.py:1585): x <- x + xc[agg] folded into the first
   application's reads (x + P xc is never stored), then the steps: on a
   7-point star grid level temporally blocked as B3 (counted as
   "dia_prolong_smooth"), elsewhere one launch a step
   ("dia_prolong_smooth_step"). `with_dot` also returns x'.b (PCG's r.z,
   the cycle-borne dot) from the last launch: each block writes its
   partial sum and the last block to finish adds them in block order --
   deterministic, no float atomics. That launch counts as
   "dia_prolong_smooth_dot" ("dia_prolong_smooth_step_dot"). With
   `ptab`/`pwt` ((mp, n): classical AMG's P rows, the TPU kernel's
   `weighted=` form) the first step reads x_j + sum_t pwt[t, j]
   xc[ptab[t, j]] instead of x_j + xc[agg[j]], summed once a row by
   dia.cu's prologue kernel into a float32 x0 that the first step launch
   reads as its state (not once for each of the k stencil rows that read
   x_j), on every level; its launches count as "dia_prolong_smooth_w"
   (+ "_dot").

The coefficient ("matrix-free") mode
-----------------------------------
B2-mf `dia_smooth_mf`, B3-mf `dia_smooth_restrict_mf` and B4-mf
`dia_prolong_smooth_mf` replace `_dia_stencil_smooth_call`
(pallas_spmv.py:781), `_dia_stencil_smooth_restrict_call` (:1379) and
`_dia_stencil_prolong_smooth_call` (:1725): B2-B4 on a
constant-coefficient grid level (ops/stencil.py `StencilOperator`). The
kernels take the k coefficients, grid shifts and grid shape by value and
synthesize each row's values and its diagonal inverse ("jacobi", "l1" or
none) from the row's grid coordinates: no value slab, no dinv vector.
Bound by bytes: a step reads b and x and writes x' (the slab mode also
reads k value floats and dinv per row). The plain versions are the
masked forms of ops/stencil.py. Launches count under the names above
(B4-mf's dot launch as "dia_prolong_smooth_mf_dot").

B2-mf, B3-mf and B4-mf run in csrc/stencil_tb.cu: 2.5-D spatial and
temporal blocking, each block an x-y tile plus halo marching along a z
chunk with every step's state in shared memory (ops/tiling.py plans the
tiles). B3-mf and B4-mf launch ONCE a call. B2-mf splits its steps and
residual over the launches of `tiling.plan_calls(..., coef=True)` (at
most COEF_MAX_APPS applications each: the split the card measured
fastest, PERF.md), the state passed on in float32 and r stored in the
operands' dtype by the last; on any other stencil it launches dia.cu's
per-step kernel and its residual kernel ("dia_smooth_mf_step"). B3-mf's
residual and restriction run in the tile when every coarse row lies in
one (GEO); on other children tables the launch writes x' and dia.cu's
restriction kernel follows ("dia_smooth_restrict_mf_epilogue"). The
state stays float32 on chip, so the bf16 forms need no scratch. The
tiled kernel takes the 7-point star and at most six applications
(`tiling.star_fits`); any other stencil or a longer schedule runs
dia.cu's per-step launches, counted as "dia_smooth_restrict_mf_step" and
"dia_prolong_smooth_mf_step" (a dispatch on structure: both routes are
the kernels of this package).

The tiled slab route takes the 7-point star in its offset order, at most
six applications a B3 / B4 call (B2: any number), and a slab that stores
0 at every off-grid entry (a periodic coupling would be skipped):
`slab_grid` checks it at the first call on a slab (the level's, or its
bf16 cast's) and caches the answer. Its x', r and bc are the per-step
route's bits.

The bfloat16 forms
------------------
B2-B4 and B2-mf..B4-mf also take bfloat16 operands (the reduced-
precision cycle, `solve_precision=bfloat16`; the TPU kernels' bf16
operand dtype, `SMOOTH_DTYPES`): the value slab, dinv, b, x, xc and the
outputs in bf16, taus float32, every sum in float32 (`compute_dtype`).
The TPU kernel keeps its state in f32 across the steps of a call and
rounds only the final stores; on the per-step routes the steps are
separate launches whose state `_steps` passes through float32 scratch
(the tiled kernels keep it on chip, and a split call passes it from
launch to launch in float32): only the first step reads bf16 x (+
xc[agg], summed in f32, never rounded) and only the last stores bf16 x'.
The residual / restriction launch recomputes r from the last step's
float32 state (`keep`; the tiled B2 and B2-mf compute it in the tile),
and r and bc are rounded once at their store. The weighted transfer rows
(B3w / B4w, a bf16 classical hierarchy) take bf16 weights: bc = sum_j
cwt[j, c] r[ctab[j, c]] with r from the float32 state, stored in float32
and never rounded, the sum float32, bc rounded once; the first step
reads x_j + sum_t pwt[t, j] xc[ptab[t, j]] summed in float32 and never
rounded (x0). Launches count under the float32 names + "_bf16". Not in
bf16: the x.b dot epilogues (a reduced-precision cycle declines the
dot): those wrappers raise NotImplementedError on a CUDA tensor.

Not ported here (the wrappers raise): B2's x.b dot epilogue (the JAX
package has no caller for it).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence

import torch

from torch.utils.weak import WeakIdKeyDictionary

from ..precision import SMOOTH_DTYPES, compute_dtype
from . import tiling

_LAUNCH_LOCK = threading.Lock()
LAUNCHES = {"dia_spmv": 0, "dia_smooth": 0, "dia_smooth_restrict": 0,
            "dia_prolong_smooth": 0, "dia_prolong_smooth_dot": 0,
            "dia_smooth_restrict_w": 0, "dia_prolong_smooth_w": 0,
            "dia_prolong_smooth_w_dot": 0, "dia_smooth_mf": 0,
            "dia_smooth_restrict_mf": 0, "dia_prolong_smooth_mf": 0,
            "dia_prolong_smooth_mf_dot": 0,
            "dia_smooth_restrict_mf_epilogue": 0,
            "dia_smooth_restrict_mf_step": 0, "dia_prolong_smooth_mf_step": 0,
            "dia_prolong_smooth_mf_step_dot": 0, "dia_spmv_dot": 0,
            "dia_spmv_ddot": 0, "cg_update": 0, "dia_coarse_tail": 0,
            "dia_coarse_tail_dot": 0, "dia_coarse_tail_mf": 0,
            "dia_coarse_tail_mf_dot": 0, "csr_spmv": 0, "csr_smooth": 0,
            "rap_values": 0, "rap_values_relabel": 0,
            "dia_smooth_bf16": 0, "dia_smooth_restrict_bf16": 0,
            "dia_prolong_smooth_bf16": 0, "dia_smooth_mf_bf16": 0,
            "dia_smooth_restrict_mf_bf16": 0,
            "dia_smooth_restrict_mf_epilogue_bf16": 0,
            "dia_smooth_restrict_mf_step_bf16": 0,
            "dia_prolong_smooth_mf_step_bf16": 0,
            "dia_prolong_smooth_mf_bf16": 0, "dia_coarse_tail_bf16": 0,
            "dia_coarse_tail_mf_bf16": 0, "dia_smooth_restrict_w_bf16": 0,
            "dia_prolong_smooth_w_bf16": 0, "csr_spmv_bf16": 0,
            "csr_smooth_bf16": 0, "dia_smooth_restrict_step": 0,
            "dia_smooth_restrict_epilogue": 0, "dia_prolong_smooth_step": 0,
            "dia_prolong_smooth_step_dot": 0,
            "dia_smooth_restrict_step_bf16": 0,
            "dia_smooth_restrict_epilogue_bf16": 0,
            "dia_prolong_smooth_step_bf16": 0, "dia_smooth_step": 0,
            "dia_smooth_step_bf16": 0, "dia_smooth_mf_step": 0,
            "dia_smooth_mf_step_bf16": 0,
            # the batched forms K1-K4 (ops/cuda_batched.py)
            "dia_spmv_multi": 0, "dia_step_multi": 0,
            "dia_step_mf_multi": 0, "csr_spmv_multi": 0,
            # K5, the batched tail (ops/cuda_tail.py)
            "dia_coarse_tail_multi": 0, "dia_coarse_tail_mf_multi": 0,
            "csr_step_multi": 0,
            # port-added setup and smoother kernels: K6 the serial GS
            # sweep (ops/gs.py), K7 the batched QR patch solve
            # (ops/dense.py), K8 the ordered segment sum (ops/segment.py)
            "gs_sweep": 0, "qr_solve": 0, "ordered_sum": 0}

MAX_OFFSETS = 32      # offsets per operator (csrc/common.cuh kMaxOffsets)
THREADS = 256         # rows per block (csrc/common.cuh kThreads)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DINV_MODE = {None: 0, "jacobi": 1, "l1": 2}   # common.cuh DinvMode
# a step launch's operand storage (dia.cu StepMode): bf16 streams, then
# whether x is the float32 state and whether x' is stored as float32
_BF16, _X_F32, _OUT_F32 = 1, 2, 4


def fast_div(d: int):
    """(mul, shr) with n // d == (n * mul >> 32) >> shr for every
    0 <= n < 2**31 (csrc/common.cuh `FastDiv`); (0, 0) for d == 1."""
    if d < 1:
        raise ValueError(f"fast_div: divisor {d} < 1")
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()           # 31 + ceil(log2 d)
    return ((1 << p) + d - 1) // d, p - 32


class StencilArg(ctypes.Structure):
    """The host stencil the coefficient-mode kernels copy into their
    parameter block (csrc/common.cuh `Stencil`, field for field)."""
    _fields_ = [("c", ctypes.c_float * MAX_OFFSETS),
                ("sx", _I * MAX_OFFSETS), ("sy", _I * MAX_OFFSETS),
                ("sz", _I * MAX_OFFSETS), ("nx", _I), ("ny", _I),
                ("nz", _I), ("diag", _I), ("dinv", _I),
                ("nx_mul", ctypes.c_uint), ("nx_shr", _I),
                ("ny_mul", ctypes.c_uint), ("ny_shr", _I)]


@functools.lru_cache(maxsize=256)
def _stencil_struct(host, shifts, shape, diag_rank, dinv):
    k = len(host)
    sx, sy, sz = (tuple(s[a] for s in shifts) + (0,) * (MAX_OFFSETS - k)
                  for a in range(3))
    return StencilArg((ctypes.c_float * MAX_OFFSETS)(*host),
                      (_I * MAX_OFFSETS)(*sx), (_I * MAX_OFFSETS)(*sy),
                      (_I * MAX_OFFSETS)(*sz), *shape, diag_rank,
                      _DINV_MODE[dinv], *fast_div(shape[0]),
                      *fast_div(shape[1]))


def stencil_arg(st) -> StencilArg:
    """The kernels' parameter block of a StencilOperator (cached)."""
    return _stencil_struct(st.host, st.shifts, st.shape, st.diag_rank,
                           st.dinv_mode)


class TbGeomArg(ctypes.Structure):
    """The tiling a temporally blocked launch takes by value
    (csrc/stencil_tb.cuh `TbGeom`, field for field)."""
    _fields_ = [("tx", _I), ("ty", _I), ("tz", _I), ("apps", _I),
                ("steps", _I), ("tiles_x", _I), ("tiles_y", _I)]


@functools.lru_cache(maxsize=256)
def geom_arg(plan: "tiling.TilePlan") -> TbGeomArg:
    """The kernel's parameter block of a tile plan (cached)."""
    return TbGeomArg(*plan.tile, plan.chunk, plan.apps, plan.steps,
                     *plan.grid[:2])


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    """Streaming multiprocessors of a CUDA device (the planner's fill
    target; an H100's for another device, where only the dispatch is
    asked)."""
    if device.type != "cuda":
        return tiling.SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _tb_smooth(slab=False):
    """The temporally blocked kernels' C entry: csrc/stencil_tb.cu's
    `amgx_tb_smooth` (the coefficient mode), or with `slab`
    csrc/stencil_tb_slab.cu's `amgx_tb_smooth_slab`."""
    from .cuda_build import library
    fn = getattr(library("stencil_tb_slab.cu" if slab else "stencil_tb.cu"),
                 "amgx_tb_smooth_slab" if slab else "amgx_tb_smooth")
    fn.argtypes = [
        ctypes.POINTER(StencilArg), ctypes.POINTER(TbGeomArg), _I, _P, _P,
        _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P,
        _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("dia.cu")
    _S = ctypes.POINTER(StencilArg)
    lib.amgx_dia_spmv.argtypes = [_P, _P, _P, _I, _P, _I, _P]
    lib.amgx_dia_step.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                  _I, _P, _I, _P, _P, _P, _I, _P]
    lib.amgx_dia_residual.argtypes = [_P, _P, _P, _P, _I, _P, _I, _I, _I,
                                      _P]
    lib.amgx_dia_restrict.argtypes = [_P, _P, _P, _P, _I, _I, _P, _I, _P,
                                      _I, _I, _P]
    lib.amgx_dia_prolong_w.argtypes = [_P, _P, _P, _P, _I, _P, _I, _I, _P]
    lib.amgx_dia_step_mf.argtypes = [_S, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                     _P, _I, _P, _P, _P, _I, _P]
    lib.amgx_dia_residual_mf.argtypes = [_S, _P, _P, _P, _I, _P, _I, _I, _P]
    lib.amgx_dia_restrict_mf.argtypes = [_S, _P, _P, _P, _I, _I, _P, _I, _P,
                                         _I, _I, _P]
    for fn in (lib.amgx_dia_spmv, lib.amgx_dia_step, lib.amgx_dia_residual,
               lib.amgx_dia_restrict, lib.amgx_dia_prolong_w,
               lib.amgx_dia_step_mf,
               lib.amgx_dia_residual_mf, lib.amgx_dia_restrict_mf):
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


def dot_scratch(n: int, device, dots: int = 1, blocks: int = None):
    """(partials, dot) for a launch over n rows: `dots` floats per block
    (of THREADS rows, or `blocks` of them) and the result (0-dim, or
    (dots,) when dots > 1), in one allocation."""
    nb = -(-n // THREADS) if blocks is None else blocks
    ws = torch.empty(dots * (nb + 1), dtype=torch.float32, device=device)
    part, out = ws[:dots * nb], ws[dots * nb:]
    return part, (out[0] if dots == 1 else out)


def _launch(name: str, fn, *args, detail: str = ""):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch{detail} failed (code {rc}; -1 = "
            f"arguments the kernel does not take, else a cudaError_t)")
    # fleet replicas launch from several threads: a count is a
    # read-modify-write, so it takes the lock
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def _check(name: str, offsets: Optional[Sequence[int]], n: int,
           floats: dict, ints: dict = None, f32: dict = None,
           bf16_ok: bool = False):
    """Validate operands of a CUDA launch: the offset table (unless
    None), one CUDA device, dtypes, contiguity, and the shapes in the
    dicts' (tensor, shape) pairs. `floats` are the operand streams:
    float32, or with `bf16_ok` one dtype of SMOOTH_DTYPES shared by all
    of them; `f32` are float32 always (damping factors, weights, the coarse
    inverse); `ints` int32. Raises on anything the kernels do not
    take."""
    if offsets is not None and not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{name}: {len(offsets)} diagonals; the kernel "
                         f"takes 1..{MAX_OFFSETS}")
    if offsets is not None and list(offsets) != sorted(offsets):
        raise ValueError(f"{name}: offsets must ascend, got {offsets}")
    if n < 1:
        raise ValueError(f"{name}: empty operator")
    dev = None
    stream = torch.float32
    if bf16_ok:
        given = {t.dtype for t, _ in floats.values() if t is not None}
        if len(given) > 1:
            raise TypeError(f"{name}: operand streams in "
                            f"{sorted(given, key=str)}; the kernel takes "
                            f"one dtype for all of them")
        stream = given.pop() if given else torch.float32
        if stream not in SMOOTH_DTYPES:
            raise TypeError(f"{name}: operands are {stream}; the kernel "
                            f"takes {SMOOTH_DTYPES}")
    for group, dtype in ((floats, stream), (f32 or {}, torch.float32),
                         (ints or {}, torch.int32)):
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


def bf16_not_ported(name: str, what: str):
    """The bfloat16 forms this port does not have yet: on the card they
    raise rather than run plain PyTorch ops."""
    raise NotImplementedError(
        f"{name}: {what} in bfloat16 is not ported to CUDA yet (ROADMAP.md "
        f"Queue B)")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU route and the kernels' on-card reference)
# ---------------------------------------------------------------------------


def dia_spmv_plain(vals, offsets, x):
    """y = A x: one shifted multiply-add per stored diagonal over a
    zero-padded copy of x (the slab form `spmv_dia_multi` of
    amgx_tpu/ops/batched.py), each fused into one rounding as the kernel
    (nvcc) and the JAX package's compiled XLA make it. A batch: x (B, n)
    and vals (k, n) shared or (B, k, n), row by row the same sums."""
    n = x.shape[-1]
    left = max(0, -min(offsets))
    xp = torch.nn.functional.pad(x, (left, max(0, max(offsets))))
    y = torch.zeros_like(x)
    for d, o in enumerate(offsets):
        y = torch.addcmul(y, vals[..., d, :], xp[..., left + o:left + o + n])
    return y


def damped_update(x, tau, r, dinv=None):
    """x + (tau r) dinv with the kernels' rounding: the last multiply and
    the add fused (what nvcc contracts), tau r rounded first when dinv
    scales it."""
    if dinv is None:
        return torch.addcmul(x, tau, r)
    return torch.addcmul(x, tau * r, dinv)


def tau_at(taus, t):
    """Damping factor t of a schedule: a 0-dim scalar of a shared (T,)
    schedule, or a (B, 1) column of a batch's per-system (B, T) ones."""
    return taus[..., t, None] if taus.dim() == 2 else taus[t]


def _up(*ts):
    """The tensors in the compute dtype of the first one's (identity for
    float32 and float64; None stays None)."""
    cdt = compute_dtype(ts[0].dtype)
    return tuple(None if t is None else t.to(cdt) for t in ts)


def _smooth_state(vals, offsets, taus, b, x, dinv):
    """The damped steps in the compute dtype: (state, b, vals) widened,
    nothing rounded."""
    x, b, vals, dinv, taus = _up(x, b, vals, dinv, taus)
    for t in range(taus.shape[-1]):
        x = damped_update(x, tau_at(taus, t),
                          b - dia_spmv_plain(vals, offsets, x), dinv)
    return x, b, vals


def dia_smooth_plain(vals, offsets, taus, b, x, dinv=None,
                     with_residual=True, x32=None):
    """B2's steps; bf16 operands widen to float32 and only x' and r
    round back (the state stays float32 from step to step). `x32`, when
    given, is the first step's x in the compute dtype (B4's corrected x,
    which the first step reads unrounded)."""
    dt = x.dtype
    s, b, vals = _smooth_state(vals, offsets, taus, b,
                               x if x32 is None else x32, dinv)
    if with_residual:
        return s.to(dt), (b - dia_spmv_plain(vals, offsets, s)).to(dt)
    return s.to(dt)


def restrict_plain(ctab, r, weights=None):
    """bc[c] = sum_j weights[j, c] r[ctab[j, c]] over the children
    present (>= 0); unit weights when `weights` is None. Each product
    rounded, then added one child at a time in ctab order from 0 (the
    kernels' order: B3w's restriction walks R's rows, whose entries are
    ctab's in this order; the JAX package's `_xla_restrict`). r may be a batch (B, n)."""
    g = r[..., ctab.clamp(min=0).long()]
    if weights is not None:
        g = g * weights
    g = torch.where(ctab >= 0, g, torch.zeros_like(g))
    bc = torch.zeros(r.shape[:-1] + (ctab.shape[1],), dtype=r.dtype,
                     device=r.device)
    for j in range(ctab.shape[0]):
        bc = bc + g[..., j, :]
    return bc


def prolong_plain(x, xc, agg=None, ptab=None, pwt=None):
    """x + P xc: xc[agg] (unit weights), or sum_t pwt[t] xc[ptab[t]]
    over each row's entries (ptab >= 0) in entry order, each term one
    fused multiply-add onto the sum (the kernel's chain, csrc/dia.cu
    `WeightedXT`; in float64, where the product of two float32 values is
    exact, rounded back once a term), then x added. x and xc may be a
    batch (B, n), (B, nc)."""
    if ptab is None:
        return x + xc[..., agg.long()]
    corr = torch.zeros_like(x)
    for t in range(ptab.shape[0]):
        g = xc[..., ptab[t].clamp(min=0).long()]
        fma = (pwt[t].double() * g.double() + corr.double()).to(x.dtype)
        corr = torch.where(ptab[t] >= 0, fma, corr)
    return x + corr


def dia_smooth_restrict_plain(vals, offsets, taus, b, x, ctab, dinv=None,
                              weights=None):
    """B3's steps and bc = R r, r from the unrounded final state and bc
    summed in the compute dtype, rounded once."""
    dt = x.dtype
    s, b32, vals = _smooth_state(vals, offsets, taus, b, x, dinv)
    r = b32 - dia_spmv_plain(vals, offsets, s)
    w = None if weights is None else weights.to(r.dtype)
    return s.to(dt), restrict_plain(ctab, r, w).to(dt)


def dia_prolong_smooth_plain(vals, offsets, taus, b, x, xc, agg,
                             dinv=None, with_dot=False, ptab=None,
                             pwt=None):
    """B4: the steps from x + P xc, summed in the compute dtype and read
    unrounded by the first step."""
    x32, xc32, pw = _up(x, xc, pwt)
    xp = prolong_plain(x32, xc32, agg, ptab, pw)
    x = dia_smooth_plain(vals, offsets, taus, b, x, dinv, False, x32=xp)
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


def _steps(name, step, head, offsets, taus, b, x, out, xc=None, agg=None,
           dot=None, keep=False, x_f32=False):
    """Launch len(taus) damped steps through the C entry `step` (whose
    leading arguments are `head`: vals and dinv, or the stencil), the last
    one writing `out`; the first reads x (+ xc[agg], when given; x is
    float32 with `x_f32`, B4w's corrected x). The steps before the last
    pass their state through float32 scratch (two buffers, ping-pong).
    With dot = (partials, result) the last launch also writes out.b into
    result and counts under name + "_dot". Returns `out`, or with `keep`
    (out, the final state in float32): `out` itself for float32 operands,
    a scratch buffer that the last launch also writes for bfloat16
    ones."""
    n = x.shape[0]
    s = taus.shape[0]
    half = out.dtype == torch.bfloat16
    scratch = torch.empty((2, n), dtype=torch.float32, device=x.device) \
        if s > 1 or (keep and half) else None
    offs = _offsets_arg(tuple(offsets))
    src, state = x, out
    for t in range(s):
        first, last = t == 0, t == s - 1
        dst = out if last else scratch[t % 2]
        kept = None
        if last and keep and half:
            kept = state = scratch[t % 2]
        mode = _BF16 | (0 if first and not x_f32 else _X_F32) \
            | (0 if last else _OUT_F32) if half else 0
        last_dot = dot is not None and last
        _launch(name + "_dot" if last_dot else name, step, *head,
                _ptr(taus), t, _ptr(b), _ptr(src),
                _ptr(xc) if first else None, _ptr(agg) if first else None,
                _ptr(dst), _ptr(kept), n, offs, len(offsets),
                _ptr(dot[0]) if last_dot else None,
                _ptr(dot_counter(x.device)) if last_dot else None,
                _ptr(dot[1]) if last_dot else None, mode, _stream())
        src = dst
    return (out, state) if keep else out


def _name(base, x):
    """A wrapper's launch-counter name: + "_bf16" for bfloat16 operands."""
    return base + "_bf16" if x.dtype == torch.bfloat16 else base


def _check_smooth(name, vals, offsets, taus, b, x, dinv, floats=None,
                  ints=None, f32=None):
    n = x.shape[0]
    if taus.dim() != 1 or taus.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one step (taus "
                         f"{tuple(taus.shape)})")
    f = {"vals": (vals, (len(offsets), n)), "x": (x, (n,)),
         "b": (b, (n,)), "dinv": (dinv, (n,))}
    f.update(floats or {})
    w = {"taus": (taus, (taus.shape[0],))}
    w.update(f32 or {})
    _check(name, offsets, n, f, ints, w, bf16_ok=True)
    return n


def _slab_smooth_steps(name, vals, offsets, taus, b, x, dinv, r=None):
    """B2's per-step route, counted under `name`: one dia.cu launch a
    step, then (given `r`) dia.cu's residual kernel from the last step's
    float32 state, storing r = b - A x' into `r` in its dtype (the
    operands', or float32 for B3w's restriction). Returns x' or (x', r)."""
    got = _steps(name, _lib().amgx_dia_step, (_ptr(vals), _ptr(dinv)),
                 offsets, taus, b, x, torch.empty_like(x),
                 keep=r is not None)
    if r is None:
        return got
    out, state = got
    _launch(name, _lib().amgx_dia_residual, _ptr(vals), _ptr(b),
            _ptr(state), _ptr(r), x.shape[0], _offsets_arg(tuple(offsets)),
            len(offsets), int(x.dtype == torch.bfloat16),
            int(r.dtype == torch.float32), _stream())
    return out, r


def dia_smooth(vals, offsets, taus, b, x, dinv=None, with_residual=True,
               with_dot=False, grid=None):
    """B2: len(taus) damped steps (+ the residual r = b - A x'). Returns
    x' or (x', r). Operands float32 or bfloat16, taus float32. `grid`:
    the operator's grid shape (A.grid_shape), as for dia_smooth_restrict.

    On the card, by structure: on a level the tiled kernel takes
    (`slab_grid`) the launches of `smooth_plans` (any number of steps:
    split over launches of at most SLAB_MAX_APPS applications, the last
    one storing r in the operands' dtype), counted as "dia_smooth";
    elsewhere one dia.cu launch a step and its residual kernel, counted
    as "dia_smooth_step"; each + "_bf16" for bf16 operands."""
    _not_ported("dia_smooth", with_dot=with_dot)
    if x.device.type == "cpu":
        return dia_smooth_plain(vals, offsets, taus, b, x, dinv,
                                with_residual)
    name = _name("dia_smooth", x)
    _check_smooth(name, vals, offsets, taus, b, x, dinv)
    with torch.cuda.device(x.device):
        plans = smooth_plans(vals, offsets, grid, dinv, x, taus.shape[0],
                             with_residual)
        r = torch.empty_like(x) if with_residual else None
        if plans is None:
            return _slab_smooth_steps(_name("dia_smooth_step", x), vals,
                                      offsets, taus, b, x, dinv, r)
        out = _tb_calls(name, plans, vals, dinv, taus, b, x, resid=r)
    return (out, r) if with_residual else out


_SLAB_GRID = WeakIdKeyDictionary()


def slab_grid(vals, offsets, grid):
    """The grid (nx, ny, nz) on which the tiled kernel may run a slab
    call, or None: `vals` (k, n) holds the 7-point star in its offset
    order on the grid `grid`, of at least two planes, and stores 0 at
    every entry whose shift leaves the grid (`stencil.off_grid_zero`:
    the kernel skips off-grid neighbours from their coordinates). One
    compare and one host read per slab, at its first call; the verdict
    is cached on the slab (weakly, by identity: a level's values never
    change in place)."""
    if grid is None:
        return None
    shape = tuple(int(e) for e in grid)
    key = (tuple(int(o) for o in offsets), shape)
    per = _SLAB_GRID.get(vals)
    if per is None:
        per = _SLAB_GRID[vals] = {}
    if key not in per:
        from .stencil import off_grid_zero, stencil_shifts
        shifts = None if len(shape) != 3 or shape[0] * shape[1] * shape[2] \
            != vals.shape[1] else stencil_shifts(key[0], shape)
        per[key] = shape if shifts is not None and tiling.star_fits(
            shifts, shape, 1) and bool(off_grid_zero(vals, shifts, shape)) \
            else None
    return per[key]


def _grid_arg(shape):
    """The kernels' parameter block of a slab level's grid: a Stencil
    with the 7-point star's shifts and no coefficients."""
    return _stencil_struct((0.0,) * 7, tiling.STAR, shape, 3, None)


def _slab_plans(vals, offsets, grid, dinv, x, apps, residual):
    """The launches (`tiling.plan_calls`) of a tiled slab call of `apps`
    applications on x's card, or None where the tiled kernel does not
    take the level."""
    shape = slab_grid(vals, offsets, grid)
    if shape is None:
        return None
    return tiling.plan_calls(shape, apps, residual, _sms(x.device),
                             dinv=dinv is not None)


def smooth_plans(vals, offsets, grid, dinv, x, steps, with_residual):
    """The launches of a slab B2 call of `steps` damped steps (+ the
    residual, in the last launch) on x's card where the tiled kernel
    takes the level, whatever the schedule's length (`tiling.plan_calls`
    splits it); None elsewhere (the per-step route)."""
    return _slab_plans(vals, offsets, grid, dinv, x,
                       steps + int(with_residual), with_residual)


def slab_route(vals, offsets, grid, dinv, x, steps, ctab=None,
               weighted=False):
    """How the card runs a slab B3 call (with its children table `ctab`)
    or B4 call (without) of `steps` damped steps: ("tiled", plans,
    lists): every application, and B3's residual and restriction in the
    tile (`lists`, `tiling.restrict_lists`), in the launches `plans`;
    ("tiled+epilogue", plans, None): B3's steps in those launches, then
    the untiled restriction (a children table that crosses the tiles:
    SIZE_2 pairs); ("step", None, None): one launch a step (a level the
    tiled kernel does not take, a longer schedule). `weighted`: B3w
    (with ctab) ("tiled", plans, None), the last launch storing r for
    the restriction over R's rows, where the tiled kernel takes the
    level and the schedule; B4w (without) always ("step", None, None):
    its prologue launch, then one launch a step (faster at the classical
    128^3 level 0 than summing x + P xc in the tiles, PERF.md). A B3 /
    B4 call takes at most STAR_MAX_APPS applications tiled."""
    def calls(apps, residual):
        return None if apps > tiling.STAR_MAX_APPS else _slab_plans(
            vals, offsets, grid, dinv, x, apps, residual)
    if weighted:
        plans = None if ctab is None else calls(steps + 1, True)
        return ("step", None, None) if plans is None \
            else ("tiled", plans, None)
    if ctab is not None:
        plans = calls(steps + 1, True)
        lists = None if plans is None \
            else tiling.restrict_lists(plans[-1], ctab)
        if lists is not None:
            return "tiled", plans, lists
    plans = calls(steps, False)
    if plans is None:
        return "step", None, None
    return "tiled" if ctab is None else "tiled+epilogue", plans, None


def _tb_calls(name, plans, vals, dinv, taus, b, x, xc=None, agg=None,
              ctab=None, lists=None, bc=None, dot=None, keep=False,
              resid=None, sarg=None):
    """The launches of a tiled call, from the slab `vals` and `dinv`, or
    with `sarg` (and no slab) from the coefficients of that Stencil,
    counted under `name` (the last one + "_dot" with the dot): the first
    reads x (+ xc[agg]), each later one the float32 state the one before
    wrote (two scratch buffers in turn), the last writes x' (and bc, or r
    to `resid` in its dtype, or the dot). Returns x', or with `keep` (x',
    its float32 state)."""
    n, k = x.shape[0], len(plans)
    half = x.dtype == torch.bfloat16
    out = torch.empty_like(x)
    mid, kept = min(k - 1, 2), keep and half
    ws = torch.empty((mid + kept, n), dtype=torch.float32,
                     device=x.device) if mid + kept else None
    grid = _grid_arg(plans[0].shape) if sarg is None else sarg
    at, src = 0, x
    for i, plan in enumerate(plans):
        last = i == k - 1
        dst, st = (out, ws[mid] if kept else None) if last \
            else (None, ws[i % 2])
        _tb_launch(name + "_dot" if last and dot is not None else name,
                   grid, 7, plan, taus[at:at + plan.steps], b, src, dst,
                   xc=xc if i == 0 else None, agg=agg if i == 0 else None,
                   keep=st, ctab=ctab if last else None,
                   lists=lists if last else None,
                   bc=bc if last else None, resid=resid if last else None,
                   dot=dot if last else None, vals=vals, dinv=dinv,
                   x_f32=i > 0)
        at += plan.steps
        src = st
    if not keep:
        return out
    return out, (ws[mid] if kept else out)


def _restrict(name, vals, b, state, ctab, bc, offsets):
    """bc = R (b - A x') through the unit-weight ctab from x' in float32
    (`state`): one dia.cu launch, counted under `name`."""
    m, nc = ctab.shape
    _launch(name, _lib().amgx_dia_restrict, _ptr(vals), _ptr(b),
            _ptr(state), _ptr(ctab), m, nc, _ptr(bc), b.shape[0],
            _offsets_arg(tuple(offsets)), len(offsets),
            int(b.dtype == torch.bfloat16), _stream())


def _smooth_residual_w(name, vals, offsets, taus, b, x, ctab, dinv, grid):
    """A weighted B3 call's steps and r = b - A x' in float32, each row's
    residual once, counted under `name`: the tiled launches (the last
    storing r) where `slab_route` says so, else one launch a step and
    dia.cu's residual kernel. Returns (x', r)."""
    r = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    _, plans, _ = slab_route(vals, offsets, grid, dinv, x, taus.shape[0],
                             ctab, weighted=True)
    if plans is not None:
        return _tb_calls(name, plans, vals, dinv, taus, b, x, resid=r), r
    return _slab_smooth_steps(name, vals, offsets, taus, b, x, dinv, r)


def dia_smooth_restrict(vals, offsets, taus, b, x, ctab, dinv=None,
                        weights=None, grid=None, rows=None):
    """B3: B2's steps, then bc = R (b - A x') through the child table
    ctab (m, nc), weighted by `weights` (m, nc, the operands' dtype) when
    given. `grid`: the operator's grid shape (A.grid_shape), which lets
    a call on a 7-point star level run temporally blocked. `rows`: R's
    compact rows (row offsets, columns, values in the operands' dtype),
    the entries of ctab / weights in the same order; a weighted call on
    the card restricts over them. Returns (x', bc).

    On the card, by structure: the tiled launches (`_tb_calls`) run the
    steps, the residual and the restriction when the tiled kernel takes
    the level (`slab_grid`) and the schedule and every coarse row of ctab
    lies in one tile of the last launch's plan (GEO's aggregates);
    otherwise the steps run tiled where the kernel takes them, else one
    launch a step ("dia_smooth_restrict_step"), and the untiled
    restriction follows from their float32 state
    ("dia_smooth_restrict_epilogue"); each name + "_bf16" for bf16
    operands. Weighted tables compute each fine row's r once, in float32
    (`_smooth_residual_w`), then bc = R r over `rows` in one launch of
    B8's row-block kernel (csrc/csr.cu, x read as float32), every launch
    counted as "dia_smooth_restrict_w" (+ "_bf16")."""
    if x.device.type == "cpu":
        return dia_smooth_restrict_plain(vals, offsets, taus, b, x, ctab,
                                         dinv, weights)
    if ctab.dim() != 2:
        raise ValueError("dia_smooth_restrict: ctab must be (m, nc)")
    m, nc = ctab.shape
    name = _name("dia_smooth_restrict" if weights is None
                 else "dia_smooth_restrict_w", x)
    _check_smooth(name, vals, offsets, taus, b, x, dinv,
                  floats={"weights": (weights, (m, nc))},
                  ints={"ctab": (ctab, (m, nc))})
    if m < 1 or nc < 1:
        raise ValueError(f"{name}: empty child table")
    if weights is not None:
        if rows is None:
            raise ValueError(f"{name}: a weighted call on the card needs "
                             f"R's rows")
        ro, ci, rv = rows
        _check(name, None, nc, {"rows values": (rv, (ci.shape[0],)),
                                "x": (x, (x.shape[0],))},
               {"row offsets": (ro, (nc + 1,)),
                "columns": (ci, (ci.shape[0],))}, bf16_ok=True)
        from .cuda_csr import spmv_into
        with torch.cuda.device(x.device):
            out, r = _smooth_residual_w(name, vals, offsets, taus, b, x,
                                        ctab, dinv, grid)
            bc = torch.empty(nc, dtype=x.dtype, device=x.device)
            spmv_into(name, ro, ci, rv, r, bc)
        return out, bc
    with torch.cuda.device(x.device):
        route, plans, lists = slab_route(vals, offsets, grid, dinv, x,
                                         taus.shape[0], ctab)
        bc = torch.empty(nc, dtype=x.dtype, device=x.device)
        if route == "tiled":
            out = _tb_calls(name, plans, vals, dinv, taus, b, x, ctab=ctab,
                            lists=lists, bc=bc)
            return out, bc
        if route == "tiled+epilogue":
            out, state = _tb_calls(name, plans, vals, dinv, taus, b, x,
                                   keep=True)
        else:
            out, state = _steps(
                _name("dia_smooth_restrict_step", x), _lib().amgx_dia_step,
                (_ptr(vals), _ptr(dinv)), offsets, taus, b, x,
                torch.empty_like(x), keep=True)
        _restrict(_name("dia_smooth_restrict_epilogue", x), vals, b, state,
                  ctab, bc, offsets)
    return out, bc


def dia_prolong_smooth(vals, offsets, taus, b, x, xc, agg=None, dinv=None,
                       with_dot=False, ptab=None, pwt=None, grid=None):
    """B4: len(taus) damped steps from x + P xc, the correction read on
    the fly by the first application: xc[agg] (aggregation), or the
    weighted rows ptab / pwt (mp, n; pwt in the operands' dtype) of a
    general P. Returns x', or (x', x'.b) with `with_dot` (the dot a 0-dim
    float32 tensor on x's device). `grid` as for dia_smooth_restrict:
    with agg, on a level the tiled kernel takes, the tiled launches
    ("dia_prolong_smooth", the last "..._dot" with the dot); otherwise
    one launch a step ("dia_prolong_smooth_step", "..._step_dot"). With
    ptab each row's x + P xc is summed once, by dia.cu's prologue kernel
    into a float32 x0, and one launch a step follows, the first reading
    x0 as the state (on every level); every launch counted as
    "dia_prolong_smooth_w" (the dot's as "..._w_dot")."""
    if (agg is None) == (ptab is None) or (ptab is None) != (pwt is None):
        raise ValueError("dia_prolong_smooth: give agg, or ptab and pwt")
    if x.device.type == "cpu":
        return dia_prolong_smooth_plain(vals, offsets, taus, b, x, xc, agg,
                                        dinv, with_dot, ptab, pwt)
    n = x.shape[0]
    name = "dia_prolong_smooth" if ptab is None else "dia_prolong_smooth_w"
    if x.dtype == torch.bfloat16 and with_dot:
        bf16_not_ported(name, "the x.b dot epilogue")
    name = _name(name, x)
    mp = 0 if ptab is None else ptab.shape[0]
    _check_smooth(name, vals, offsets, taus, b, x, dinv,
                  floats={"xc": (xc, (xc.shape[0],)),
                          "pwt": (pwt, (mp, n))},
                  ints={"agg": (agg, (n,)), "ptab": (ptab, (mp, n))})
    with torch.cuda.device(x.device):
        _, plans, _ = slab_route(vals, offsets, grid, dinv, x,
                                 taus.shape[0], weighted=ptab is not None)
        if plans is not None:
            dot = dot_scratch(n, x.device, blocks=plans[-1].blocks) \
                if with_dot else None
            out = _tb_calls(name, plans, vals, dinv, taus, b, x, xc=xc,
                            agg=agg, dot=dot)
        elif ptab is not None:
            dot = dot_scratch(n, x.device) if with_dot else None
            x0 = torch.empty(n, dtype=torch.float32, device=x.device)
            _launch(name, _lib().amgx_dia_prolong_w, _ptr(x), _ptr(xc),
                    _ptr(ptab), _ptr(pwt), mp, _ptr(x0), n,
                    int(x.dtype == torch.bfloat16), _stream())
            out = _steps(name, _lib().amgx_dia_step,
                         (_ptr(vals), _ptr(dinv)), offsets, taus, b, x0,
                         torch.empty_like(x), dot=dot, x_f32=True)
        else:
            dot = dot_scratch(n, x.device) if with_dot else None
            out = _steps(_name("dia_prolong_smooth_step", x),
                         _lib().amgx_dia_step, (_ptr(vals), _ptr(dinv)),
                         offsets, taus, b, x, torch.empty_like(x), xc=xc,
                         agg=agg, dot=dot)
    return (out, dot[1]) if with_dot else out


# ---------------------------------------------------------------------------
# the coefficient mode (B2-mf, B3-mf, B4-mf)
# ---------------------------------------------------------------------------


def _check_mf(name, st, taus, b, x, floats=None, ints=None):
    """Validate a coefficient-mode launch: the stencil against x, then
    the operands as _check_smooth does (no slab, no dinv)."""
    n = x.shape[0]
    if st.num_rows != n or len(st.host) != st.k \
            or st.shape[0] * st.shape[1] * st.shape[2] != n:
        raise ValueError(f"{name}: the stencil's grid {st.shape} does not "
                         f"cover the {n} rows of x")
    if taus.dim() != 1 or taus.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one step (taus "
                         f"{tuple(taus.shape)})")
    f = {"x": (x, (n,)), "b": (b, (n,))}
    f.update(floats or {})
    _check(name, st.offsets, n, f, ints,
           {"taus": (taus, (taus.shape[0],))}, bf16_ok=True)
    return n


def _mf_smooth_steps(name, st, taus, b, x, with_residual):
    """B2-mf's per-step route, counted under `name`: one dia.cu launch a
    step, then (with the residual) dia.cu's residual kernel from the last
    step's float32 state. Returns x' or (x', r)."""
    got = _mf_steps(name, st, taus, b, x, keep=with_residual)
    if not with_residual:
        return got
    out, state = got
    r = torch.empty_like(x)
    _launch(name, _lib().amgx_dia_residual_mf, ctypes.byref(stencil_arg(st)),
            _ptr(b), _ptr(state), _ptr(r), x.shape[0],
            _offsets_arg(st.offsets), st.k, int(x.dtype == torch.bfloat16),
            _stream())
    return out, r


def mf_smooth_plans(st, x, steps, with_residual):
    """The launches of a B2-mf call of `steps` damped steps (+ the
    residual, in the last launch) on x's card where the tiled kernel takes
    the stencil (`tiling.star_fits` limits a launch, not a call):
    `tiling.plan_calls(..., coef=True)`; None elsewhere (the per-step
    route)."""
    if not tiling.star_fits(st.shifts, st.shape, 1):
        return None
    return tiling.plan_calls(st.shape, steps + int(with_residual),
                             with_residual, _sms(x.device), coef=True)


def dia_smooth_mf(st, taus, b, x, with_residual=True):
    """B2-mf: len(taus) damped steps (+ the residual) on the stencil
    `st`. Returns x' or (x', r). On the card, by structure: on the 7-point
    star the launches of `mf_smooth_plans` (csrc/stencil_tb.cu, the last
    one storing r in the operands' dtype), counted as "dia_smooth_mf";
    on any other stencil one dia.cu launch a step and its residual
    kernel, counted as "dia_smooth_mf_step"; each + "_bf16" for bf16
    operands."""
    if x.device.type == "cpu":
        from .stencil import _xla_smooth
        return _xla_smooth(st.spec(), st.coeffs, taus, b, x, with_residual)
    name = _name("dia_smooth_mf", x)
    _check_mf(name, st, taus, b, x)
    with torch.cuda.device(x.device):
        plans = mf_smooth_plans(st, x, taus.shape[0], with_residual)
        if plans is None:
            return _mf_smooth_steps(_name("dia_smooth_mf_step", x), st, taus,
                                    b, x, with_residual)
        r = torch.empty_like(x) if with_residual else None
        out = _tb_calls(name, plans, None, None, taus, b, x, resid=r,
                        sarg=stencil_arg(st))
    return (out, r) if with_residual else out


def _tb_plan(st, x, apps, residual):
    """The tile plan of a temporally blocked launch on x's card, or None
    where the tiled kernel does not take the stencil or the schedule
    (`tiling.star_fits`)."""
    if not tiling.star_fits(st.shifts, st.shape, apps):
        return None
    return tiling.plan_tiles(st.shape, apps, residual, _sms(x.device))


def _mf_steps(name, st, taus, b, x, xc=None, agg=None, dot=None,
              keep=False):
    """len(taus) launches of dia.cu's per-step kernel on the stencil `st`,
    counted under `name`: the route of B2-mf, B3-mf and B4-mf on the
    levels and schedules the tiled kernel does not take."""
    return _steps(name, _lib().amgx_dia_step_mf,
                  (ctypes.byref(stencil_arg(st)),), st.offsets, taus, b, x,
                  torch.empty_like(x), xc=xc, agg=agg, dot=dot, keep=keep)


def _tb_launch(name, sarg, k, plan, taus, b, x, out, xc=None, agg=None,
               keep=None, ctab=None, lists=None, bc=None, dot=None,
               vals=None, dinv=None, x_f32=False, resid=None):
    """One launch of the temporally blocked kernel (csrc/stencil_tb.cuh)
    with `plan` on the grid of the kernels' Stencil `sarg` (k diagonals):
    from its coefficients (stencil_tb.cu), or with `vals` from the slab
    and `dinv` (stencil_tb_slab.cu); x read as float32 when `x_f32`; r
    stored to `resid` in its dtype, float32 (B3w) or the operands' (B2)
    (the callers set the device and checked the operands)."""
    m, nc = (0, 0) if ctab is None else ctab.shape
    rows, roff = (None, None) if lists is None else lists
    _launch(name, _tb_smooth(vals is not None),
            ctypes.byref(sarg), ctypes.byref(geom_arg(plan)), k, _ptr(vals),
            _ptr(dinv), _ptr(taus), _ptr(b), _ptr(x),
            int(x_f32), _ptr(xc), _ptr(agg), _ptr(out), _ptr(keep),
            _ptr(ctab), m, nc, _ptr(rows), _ptr(roff), _ptr(resid),
            int(resid is not None and resid.dtype == torch.bfloat16),
            _ptr(bc),
            _ptr(None if dot is None else dot[0]),
            _ptr(dot_counter(b.device)) if dot is not None else None,
            _ptr(None if dot is None else dot[1]), b.shape[0], plan.blocks,
            plan.smem_bytes, int(b.dtype == torch.bfloat16), _stream())


def _mf_restrict(st, b, state, ctab, bc):
    """bc = R (b - A x') through ctab from x' in float32 (`state`): one
    dia.cu launch, counted as "dia_smooth_restrict_mf_epilogue" (+
    "_bf16")."""
    m, nc = ctab.shape
    _launch(_name("dia_smooth_restrict_mf_epilogue", b),
            _lib().amgx_dia_restrict_mf, ctypes.byref(stencil_arg(st)),
            _ptr(b), _ptr(state), _ptr(ctab), m, nc, _ptr(bc), b.shape[0],
            _offsets_arg(st.offsets), st.k, int(b.dtype == torch.bfloat16),
            _stream())


def dia_smooth_restrict_mf(st, taus, b, x, ctab):
    """B3-mf: B2-mf's steps, then bc = R (b - A x') through the child
    table ctab (m, nc). Returns (x', bc).

    On the card, by structure: one temporally blocked launch
    (csrc/stencil_tb.cu) runs the steps, the residual and the restriction
    when the tiled kernel takes the stencil and the schedule and every
    coarse row of ctab lies in one tile of its plan (GEO's aggregates).
    Otherwise the steps run in one tiled launch where the kernel takes
    them, else one dia.cu launch a step ("dia_smooth_restrict_mf_step"),
    and dia.cu's restriction kernel follows from their float32 state
    ("dia_smooth_restrict_mf_epilogue"); each name + "_bf16" for bf16
    operands."""
    if x.device.type == "cpu":
        from .stencil import _xla_restrict
        return _xla_restrict(st.spec(), st.coeffs, taus, b, x, ctab)
    if ctab.dim() != 2:
        raise ValueError(f"dia_smooth_restrict_mf: ctab must be (m, nc), "
                         f"got {tuple(ctab.shape)}")
    m, nc = ctab.shape
    name = _name("dia_smooth_restrict_mf", x)
    n = _check_mf(name, st, taus, b, x, ints={"ctab": (ctab, (m, nc))})
    s = taus.shape[0]
    with torch.cuda.device(x.device):
        plan = _tb_plan(st, x, s + 1, True)
        lists = None if plan is None else tiling.restrict_lists(plan, ctab)
        bc = torch.empty(nc, dtype=x.dtype, device=x.device)
        if lists is not None:
            out = torch.empty_like(x)
            _tb_launch(name, stencil_arg(st), st.k, plan, taus, b, x, out,
                       ctab=ctab, lists=lists, bc=bc)
            return out, bc
        plan = _tb_plan(st, x, s, False)
        if plan is None:
            out, keep = _mf_steps(_name("dia_smooth_restrict_mf_step", x),
                                  st, taus, b, x, keep=True)
        else:
            out = torch.empty_like(x)
            keep = out if x.dtype == torch.float32 else torch.empty(
                n, dtype=torch.float32, device=x.device)
            _tb_launch(name, stencil_arg(st), st.k, plan, taus, b, x, out,
                       keep=None if keep is out else keep)
        _mf_restrict(st, b, keep, ctab, bc)
    return out, bc


def dia_prolong_smooth_mf(st, taus, b, x, xc, agg, with_dot=False):
    """B4-mf: len(taus) damped steps on the stencil `st` from x + xc[agg],
    the correction summed as the tiles load x. Returns x', or (x', x'.b)
    with `with_dot` (a 0-dim float32 tensor). One temporally blocked
    launch on the card (csrc/stencil_tb.cu), the dot's launch counted as
    "dia_prolong_smooth_mf_dot"; on the levels and schedules the tiled
    kernel does not take, one dia.cu launch a step, counted as
    "dia_prolong_smooth_mf_step" (the last as "..._step_dot" with the
    dot)."""
    if x.device.type == "cpu":
        from .stencil import _xla_corr
        return _xla_corr(st.spec(), st.coeffs, taus, b, x, xc, agg,
                         with_dot=with_dot)
    if with_dot and x.dtype == torch.bfloat16:
        bf16_not_ported("dia_prolong_smooth_mf", "the x.b dot epilogue")
    name = _name("dia_prolong_smooth_mf", x)
    n = _check_mf(name, st, taus, b, x,
                  floats={"xc": (xc, (xc.shape[0],))},
                  ints={"agg": (agg, (x.shape[0],))})
    with torch.cuda.device(x.device):
        plan = _tb_plan(st, x, taus.shape[0], False)
        if plan is None:
            dot = dot_scratch(n, x.device) if with_dot else None
            out = _mf_steps(_name("dia_prolong_smooth_mf_step", x), st,
                            taus, b, x, xc=xc, agg=agg, dot=dot)
        else:
            dot = dot_scratch(n, x.device, blocks=plan.blocks) \
                if with_dot else None
            out = torch.empty_like(x)
            _tb_launch(name + "_dot" if with_dot else name,
                       stencil_arg(st), st.k, plan, taus, b, x, out, xc=xc,
                       agg=agg, dot=dot)
    return (out, dot[1]) if with_dot else out
