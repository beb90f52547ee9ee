"""B8 and B9, the unstructured (CSR) SpMV and damped-Jacobi sweep
kernels, with their plain PyTorch twins.

B8 `csr_spmv` replaces `_swell_spmv_call` (amgx_tpu/ops/pallas_swell.py:
   254, body `_swell_kernel`): y = A x over a float32 CSR matrix.
B9 `csr_smooth` replaces `_swell_smooth_call` (pallas_swell.py:412):
   len(taus) sweeps x <- x + (tau_t * (b - A x)) * dinv, one launch each,
   each sweep into a fresh buffer (neighbouring rows read the old x).

CUDA source `amgx_tpu_torch/csrc/csr.cu`. The port keeps CSR (no SWELL:
its 128-lane windows exist for the TPU's gathers). B8 walks row blocks:
`csr_row_blocks` cuts the rows once per matrix structure into runs of
consecutive rows whose entries fit CSR_CHUNK (a row of more than
CSR_LONG_ROW entries alone), cached on the row offsets tensor so that
calls and value resetups (`CsrMatrix.with_values` keeps the structure
tensors) reuse it; one CUDA block per row block stages the products in
shared memory and each thread sums one row in its stored order (a long
row: strided shares and a fixed tree). B9 walks a row with `lanes` lanes
of a warp (1 for short rows, up to 32), as `CsrMatrix.init()` recorded
in `csr_lanes`. Bound by bytes: B8 must read nnz values and columns, the
row offsets, x, and write y; B9 adds b, x and dinv read once per sweep.
Deterministic: every row sums in a fixed order.

The bfloat16 forms (a bf16 hierarchy's CSR levels): values, x, b, dinv
and the outputs bf16, every sum float32, each output rounded once. B9's
is the TPU kernel's bf16 form (`swell_smooth_supported` takes bf16 value
slabs; `swell_smooth_step` rounds x' to bf16 after every sweep, so the
sweeps hand each other bf16 x). B8's computes the XLA op the JAX
package compiles in its place (its kernel is float32 only):
`swell_spmv_xla` on bf16 operands, whose fused gather-multiply-reduce
sums a row's exact products in float32 and rounds the sum once -- the
trailing residual b - A x of a bf16 CSR level (y rounded, then the
difference), classical R r and P xc. Launches count as
"csr_smooth_bf16" and "csr_spmv_bf16".

Routing as in `cuda_spmv`: the plain version for CPU tensors, the kernel
or an exception for CUDA tensors; float32 and bfloat16 (`ops/spmv.py`
routes float64 to the plain product, as the JAX package's gates take
float32 and bf16 only). Launches count in `cuda_spmv.LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..precision import compute_dtype
from .cuda_spmv import _check, _launch, _name, _ptr, _stream, damped_update

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("csr.cu")
    lib.amgx_csr_spmv.argtypes = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P]
    lib.amgx_csr_step.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                                  _I, _I, _P]
    for fn in (lib.amgx_csr_spmv, lib.amgx_csr_step):
        fn.restype = _I
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU route and the kernels' on-card reference)
# ---------------------------------------------------------------------------


def csr_spmv_plain(row_offsets, col_indices, values, x):
    """y = A x: the products of each entry added into its row, in the
    compute dtype (a bf16 operand widened, the sum rounded once). A
    batch: x (B, ncols), values (nnz,) shared or (B, nnz)."""
    n = row_offsets.shape[0] - 1
    cdt = compute_dtype(x.dtype)
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), torch.diff(row_offsets.long()),
        output_size=col_indices.shape[0])
    y = torch.zeros(x.shape[:-1] + (n,), dtype=cdt, device=x.device)
    y.index_add_(-1, rows,
                 values.to(cdt) * x.to(cdt)[..., col_indices.long()])
    return y.to(x.dtype)


def csr_smooth_plain(row_offsets, col_indices, values, taus, b, x,
                     dinv=None):
    """len(taus) sweeps, each in the compute dtype from the vector dtype's
    x and rounded back to it (a bf16 level's x' is bf16 after every
    sweep, as the TPU kernel's wrapper rounds it)."""
    cdt = compute_dtype(x.dtype)
    values, b = values.to(cdt), b.to(cdt)
    dinv = None if dinv is None else dinv.to(cdt)
    for t in range(taus.shape[0]):
        x32 = x.to(cdt)
        ax = csr_spmv_plain(row_offsets, col_indices, values, x32)
        x = damped_update(x32, taus[t].to(cdt), b - ax, dinv).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_csr(name, row_offsets, col_indices, values, x, floats=None,
               f32=None):
    n = row_offsets.shape[0] - 1
    f = {"values": (values, (values.shape[0],)), "x": (x, (x.shape[0],))}
    f.update(floats or {})
    _check(name, None, n, f,
           {"row_offsets": (row_offsets, (n + 1,)),
            "col_indices": (col_indices, (values.shape[0],))}, f32,
           bf16_ok=True)
    return n


# csrc/csr.cu kChunk, kLongRow; BLOCK_ROWS caps a row block's rows (four
# a thread of its 256)
CSR_CHUNK = 2048
CSR_LONG_ROW = 128
CSR_BLOCK_ROWS = 1024

# row offsets tensor -> its row-block table
_ROW_BLOCKS = WeakIdKeyDictionary()


def csr_row_blocks(row_offsets):
    """B8's row blocks of a CSR structure: int32 (blocks + 1,), the first
    row of each block, then the row count. A row of more than CSR_LONG_ROW
    entries is a block of its own; otherwise a block's rows all start in
    one window of CSR_CHUNK - CSR_LONG_ROW entries (so the block holds at
    most CSR_CHUNK) and number at most CSR_BLOCK_ROWS. Built on the
    offsets' device with one host read (the block count)."""
    ro = row_offsets.long()
    n = ro.shape[0] - 1
    start, lens = ro[:-1], torch.diff(ro)
    cut = torch.arange(n, device=ro.device) % CSR_BLOCK_ROWS == 0
    window = start // (CSR_CHUNK - CSR_LONG_ROW)
    cut[1:] |= window[1:] != window[:-1]
    long = lens > CSR_LONG_ROW
    cut |= long
    cut[1:] |= long[:-1]
    starts = torch.nonzero(cut).flatten()
    return torch.cat([starts, starts.new_tensor([n])]).to(torch.int32)


def _row_blocks(row_offsets):
    """csr_row_blocks of a structure, built at its first product."""
    rb = _ROW_BLOCKS.get(row_offsets)
    if rb is None:
        rb = _ROW_BLOCKS[row_offsets] = csr_row_blocks(row_offsets)
    return rb


def spmv_into(name, row_offsets, col_indices, values, x, y):
    """One launch of B8's kernel, y = A x, counted under `name` (the
    caller checked the operands and set the device): values and y of one
    dtype, x of theirs or float32 (B3w's restriction of its float32
    residual, `cuda_spmv.dia_smooth_restrict`)."""
    rb = _row_blocks(row_offsets)
    _launch(name, _lib().amgx_csr_spmv, _ptr(row_offsets),
            _ptr(col_indices), _ptr(values), _ptr(rb), rb.shape[0] - 1,
            _ptr(x), _ptr(y), int(values.dtype == torch.bfloat16),
            int(x.dtype == torch.float32), _stream())


def csr_spmv(row_offsets, col_indices, values, x):
    """B8: y = A x (A: n x len(x) CSR; values and x float32 or both
    bfloat16), one CUDA block per row block (`csr_row_blocks`)."""
    if x.device.type == "cpu":
        return csr_spmv_plain(row_offsets, col_indices, values, x)
    name = _name("csr_spmv", x)
    n = _check_csr(name, row_offsets, col_indices, values, x)
    with torch.cuda.device(x.device):
        y = torch.empty(n, dtype=x.dtype, device=x.device)
        spmv_into(name, row_offsets, col_indices, values, x, y)
    return y


def csr_smooth(row_offsets, col_indices, values, taus, b, x, dinv=None,
               lanes: int = 1):
    """B9: len(taus) damped-Jacobi sweeps on a square CSR matrix, one
    launch each; values, b, x, dinv float32 or all bfloat16, taus float32.
    Returns x'."""
    if x.device.type == "cpu":
        return csr_smooth_plain(row_offsets, col_indices, values, taus, b,
                                x, dinv)
    n = x.shape[0]
    if taus.dim() != 1 or taus.shape[0] < 1:
        raise ValueError(f"csr_smooth: needs at least one sweep (taus "
                         f"{tuple(taus.shape)})")
    name = _name("csr_smooth", x)
    _check_csr(name, row_offsets, col_indices, values, x,
               {"b": (b, (n,)), "dinv": (dinv, (n,))},
               {"taus": (taus, (taus.shape[0],))})
    if row_offsets.shape[0] - 1 != n:
        raise ValueError("csr_smooth: the matrix must be square")
    lib = _lib()
    half = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        src = x
        for t in range(taus.shape[0]):
            dst = torch.empty_like(x)
            _launch(name, lib.amgx_csr_step, _ptr(row_offsets),
                    _ptr(col_indices), _ptr(values), _ptr(src), _ptr(b),
                    _ptr(dinv), _ptr(taus), t, _ptr(dst), n, int(lanes),
                    half, _stream())
            src = dst
    return src
