"""MatrixMarket system reader/writer (the port of
amgx_tpu/io/matrix_market.py; the reference's src/matrix_io.cu and
src/readers.cu).

Standard ``%%MatrixMarket matrix coordinate <field> <symmetry>`` files
plus the AMGX extension line

    %%AMGX <token>...

with tokens ``rhs`` / ``solution`` (vectors appended after the matrix)
and ``base0`` (0-based indices). ``pattern`` matrices read with values
of 1.0, complex fields into a complex CsrMatrix, and symmetric,
skew-symmetric and hermitian files expand to both triangles. Parsing is
the numpy tokenizer on the host; the matrix and the vectors land on the
requested device. Files with block dimensions or an external diagonal
(``diagonal``) raise: the port's CsrMatrix holds neither (ROADMAP.md
Queue A item 8.4).

The CSR equals the JAX package's reader's: a stable (row, col) sort and
duplicates summed in file order. The writer prints what the JAX
package's prints, byte for byte.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import registry
from ..device import resolve_device
from ..errors import IOError_
from ..matrix import CsrMatrix
from ._common import cast, host, refuse_block, torch_dtype


def _parse_header(lines):
    if not lines or not lines[0].startswith("%%MatrixMarket"):
        raise IOError_("missing %%MatrixMarket header")
    tokens = lines[0].split()[1:]
    if not tokens or tokens[0] != "matrix":
        raise IOError_("expecting 'matrix' keyword in MatrixMarket header")
    fmt = tokens[1] if len(tokens) > 1 else "coordinate"
    field = tokens[2] if len(tokens) > 2 else "real"
    symmetry = tokens[3] if len(tokens) > 3 else "general"
    amgx_tokens = []
    body_start = 1
    for i, ln in enumerate(lines[1:], start=1):
        s = ln.strip()
        if s.startswith("%%AMGX"):
            amgx_tokens += s.split()[1:]
            continue
        if s.startswith("%") or not s:
            continue
        body_start = i
        break
    return fmt, field, symmetry, amgx_tokens, body_start


def _parse_body(body_lines) -> np.ndarray:
    """Every number of the body, in order, as float64 (comment lines
    skipped)."""
    body_vals = []
    for ln in body_lines:
        s = ln.split()
        if not s or s[0].startswith("%"):
            continue
        body_vals.extend(s)
    return np.array(body_vals, dtype=np.float64)


def read_system(path: str, dtype=torch.float64, device=None
                ) -> Tuple[CsrMatrix, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """Read (A, rhs | None, solution | None) from a MatrixMarket file,
    on `device` (None: the card)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    with open(path) as f:
        lines = f.readlines()
    fmt, field, symmetry, amgx_tokens, body = _parse_header(lines)
    if fmt != "coordinate":
        raise IOError_(f"unsupported MatrixMarket format {fmt!r} "
                       "(only 'coordinate')")
    is_complex = field == "complex"
    is_pattern = field == "pattern"
    if is_complex:
        dtype = torch.complex128 if dtype == torch.float64 \
            else torch.complex64
    symmetric = symmetry in ("symmetric", "skew-symmetric", "hermitian")
    skew = symmetry == "skew-symmetric"
    hermitian = symmetry == "hermitian"

    if "diagonal" in amgx_tokens or any(t.isdigit() for t in amgx_tokens):
        refuse_block(f"{path}: %%AMGX {' '.join(amgx_tokens)}")
    has_rhs = "rhs" in amgx_tokens
    has_soln = "solution" in amgx_tokens
    base = 0 if "base0" in amgx_tokens else 1

    size_line = lines[body].split()
    n, m, entries = (int(size_line[0]), int(size_line[1]),
                     int(size_line[2]))
    per_entry = 2 + (0 if is_pattern else (2 if is_complex else 1))
    need = entries * per_entry
    data = _parse_body(lines[body + 1:])
    if data.size < need:
        raise IOError_(f"matrix body truncated: {data.size} < {need} numbers")
    ent = data[:need].reshape(entries, per_entry)
    rest = data[need:]
    r = ent[:, 0].astype(np.int64) - base
    c = ent[:, 1].astype(np.int64) - base
    if is_pattern:
        v = np.ones(entries, np.float64)
    elif is_complex:
        v = ent[:, 2] + 1j * ent[:, 3]
    else:
        v = ent[:, 2]

    if symmetric:
        off = r != c
        rs, cs, vs = c[off], r[off], v[off]
        if skew:
            vs = -vs
        elif hermitian:
            vs = np.conj(vs)
        r = np.concatenate([r, rs])
        c = np.concatenate([c, cs])
        v = np.concatenate([v, vs])

    A = CsrMatrix.from_coo(torch.from_numpy(r), torch.from_numpy(c),
                           cast(v, dtype, "cpu"), n, m).to(device)
    pos = 0
    b = x = None
    cmul = 2 if is_complex else 1
    for present, size, slot in ((has_rhs, n, "b"), (has_soln, m, "x")):
        if not present:
            continue
        raw = rest[pos:pos + size * cmul]
        pos += size * cmul
        vec = cast(raw[0::2] + 1j * raw[1::2], torch.complex128, device) \
            if is_complex else cast(raw, dtype, device)
        if slot == "b":
            b = vec
        else:
            x = vec
    return A, b, x


def read_matrix(path: str, dtype=torch.float64, device=None) -> CsrMatrix:
    return read_system(path, dtype, device)[0]


def write_system(path: str, A: CsrMatrix, b=None, x=None):
    """Write (A [, rhs][, solution]) in MatrixMarket + %%AMGX format
    (AMGX_write_system analog, src/matrix_io.cu)."""
    n, m = A.num_rows, A.num_cols
    rows, cols, vals = (host(t) for t in A.coo())
    is_complex = np.iscomplexobj(vals)
    field = "complex" if is_complex else "real"
    tokens = []
    if b is not None:
        tokens.append("rhs")
    if x is not None:
        tokens.append("solution")
    out = [f"%%MatrixMarket matrix coordinate {field} general\n"]
    if tokens:
        out.append("%%AMGX " + " ".join(tokens) + "\n")
    out.append(f"{n} {m} {A.nnz}\n")
    if is_complex:
        out += [f"{int(i) + 1} {int(j) + 1} {val.real:.17g} {val.imag:.17g}\n"
                for i, j, val in zip(rows, cols, vals)]
    else:
        out += [f"{int(i) + 1} {int(j) + 1} {val:.17g}\n"
                for i, j, val in zip(rows, cols, vals)]
    for vec in (b, x):
        if vec is None:
            continue
        v = host(vec).reshape(-1)
        if is_complex:
            out += [f"{val.real:.17g} {val.imag:.17g}\n" for val in v]
        else:
            out += [f"{val:.17g}\n" for val in v]
    with open(path, "w") as f:
        f.write("".join(out))


registry.matrix_io_readers.register("MATRIXMARKET")(read_system)
registry.matrix_io_writers.register("MATRIXMARKET")(write_system)
