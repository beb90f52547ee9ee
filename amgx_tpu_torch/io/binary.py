"""Binary system format (the port of amgx_tpu/io/binary.py; the
reference's NVAMGBinary reader/writer role, src/readers.cu:1700,
src/matrix_io.cu:301-390).

The layout is the JAX package's, so a file written by either package
reads back in the other:

  magic   b"AMGXTPU1"
  header  7 x int64: num_rows num_cols nnz block_dimx block_dimy
                     flags (bit0 diag, bit1 rhs, bit2 soln) dtype_code
  arrays  row_offsets int32[n+1], col_indices int32[nnz],
          values dtype[nnz*bx*by], [diag dtype[n*bx*by]],
          [rhs dtype[n*bx]], [soln dtype[m*by]]

The port writes and reads scalar files without a diagonal (bx = by = 1,
bit0 clear); a block or external-diagonal file raises (ROADMAP.md Queue
A item 8.4). Each array is read into host memory once and copied to the
device once.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..device import resolve_device
from ..errors import IOError_
from ..matrix import CsrMatrix
from ._common import host, refuse_block

_MAGIC = b"AMGXTPU1"
_DTYPES = {0: np.float32, 1: np.float64, 2: np.complex64, 3: np.complex128}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_system(path: str, A: CsrMatrix, b=None, x=None):
    vals = host(A.values)
    if A.dtype == torch.bfloat16 or vals.dtype not in _CODES:
        raise IOError_(
            f"binary system files hold float32, float64, complex64 or "
            f"complex128 values, not {A.dtype}")
    flags = (2 if b is not None else 0) | (4 if x is not None else 0)
    header = np.array([A.num_rows, A.num_cols, A.nnz, 1, 1, flags,
                       _CODES[vals.dtype]], np.int64)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(header.tobytes())
        f.write(host(A.row_offsets).astype(np.int32).tobytes())
        f.write(host(A.col_indices).astype(np.int32).tobytes())
        f.write(vals.tobytes())
        for vec in (b, x):
            if vec is not None:
                f.write(host(vec).astype(vals.dtype).tobytes())


def _read(f, dtype, count: int) -> np.ndarray:
    out = np.fromfile(f, dtype, count)
    if out.size != count:
        raise IOError_(f"binary system file truncated: {out.size} of "
                       f"{count} {np.dtype(dtype).name} values")
    return out


def read_system(path: str, dtype=None, device=None):
    """(A, rhs | None, solution | None) on `device` (None: the card).
    The values keep the file's dtype; `dtype` is accepted for the
    readers' common signature and unused, as in the JAX package."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise IOError_(f"{path}: not an AMGXTPU binary system file")
        n, m, nnz, bx, by, flags, code = (
            int(v) for v in _read(f, np.int64, 7))
        if bx * by != 1 or flags & 1:
            refuse_block(f"{path}: block {bx}x{by}, flags {flags}")
        vdtype = _DTYPES[code]
        row_offsets = _read(f, np.int32, n + 1)
        col_indices = _read(f, np.int32, nnz)
        values = _read(f, vdtype, nnz)
        b = torch.from_numpy(_read(f, vdtype, n)).to(device) \
            if flags & 2 else None
        x = torch.from_numpy(_read(f, vdtype, m)).to(device) \
            if flags & 4 else None
    A = CsrMatrix.from_scipy_like(
        torch.from_numpy(row_offsets), torch.from_numpy(col_indices),
        torch.from_numpy(values), n, m, device=device)
    return A, b, x


registry.matrix_io_readers.register("BINARY")(read_system)
registry.matrix_io_writers.register("BINARY")(write_system)
