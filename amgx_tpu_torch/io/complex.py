"""Complex -> real system conversion (the port of amgx_tpu/io/complex.py;
the reference reader's complex_conversion path, src/readers.cu:200-420).

A complex n x n system is rewritten as the 2n real system of the
equivalent-real-formulation K<k> (Day & Heroux, "Solving complex-valued
linear systems via equivalent real formulations"):

    K1: [[ Re, -Im], [ Im,  Re]]   b = [Re; Im]   x = [Re;  Im]
    K2: [[ Re,  Im], [ Im, -Re]]   b = [Re; Im]   x = [Re; -Im]
    K3: [[ Im,  Re], [ Re, -Im]]   b = [Im; Re]   x = [Re;  Im]
    K4: [[ Im, -Re], [ Re,  Im]]   b = [Im; Re]   x = [Re; -Im]

The JAX package's modes 221..224 give the same stencils as an n-row
system of 2x2 blocks; the port's CsrMatrix holds no blocks, so those
modes raise (ROADMAP.md Queue A item 8.4).
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import BadParametersError
from ..matrix import CsrMatrix, lexsort_rc
from ._common import host, refuse_block

# per-mode 2x2 coefficient stencil: entries are (source, sign) with
# source 're' or 'im', laid out [[TL, TR], [BL, BR]]
_K = {
    1: ((("re", 1), ("im", -1)), (("im", 1), ("re", 1))),
    2: ((("re", 1), ("im", 1)), (("im", 1), ("re", -1))),
    3: ((("im", 1), ("re", 1)), (("re", 1), ("im", -1))),
    4: ((("im", 1), ("re", -1)), (("re", 1), ("im", 1))),
}


def _mode(mode: int):
    """(scalar K mode, block?) of a complex_conversion value."""
    block = 220 < mode < 225
    if block:
        mode -= 220
    if mode not in _K:
        raise BadParametersError(
            f"complex_conversion={mode}: supported modes are 1..4 "
            "(scalar ERF) and 221..224 (2x2-block ERF)")
    return mode, block


def _parts(vals, spec):
    src, sign = spec
    v = np.real(vals) if src == "re" else np.imag(vals)
    return sign * v


def complex_system_to_real(A: CsrMatrix, b=None, x=None, mode: int = 1):
    """The K<mode> real form of a complex system: (A, b, x), each on A's
    device (b and x None when not given)."""
    mode, block = _mode(mode)
    if block:
        refuse_block(f"complex_conversion={mode + 220}")
    rows, cols, vals = (host(t) for t in A.coo())
    n, m = A.num_rows, A.num_cols
    ((tl, tr), (bl, br)) = _K[mode]
    r2 = np.concatenate([rows, rows, rows + n, rows + n])
    c2 = np.concatenate([cols, cols + m, cols, cols + m])
    v2 = np.concatenate([_parts(vals, tl), _parts(vals, tr),
                         _parts(vals, bl), _parts(vals, br)])
    dev = A.device
    r2, c2, v2 = (torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                  for t in (r2, c2, v2))
    # the four stencils' entries are distinct: sorted, not coalesced
    order = lexsort_rc(r2, c2)
    A2 = CsrMatrix.from_rows(r2[order], c2[order], v2[order], 2 * n, 2 * m)

    def conv_vec(v, order):
        if v is None:
            return None
        v = host(v)
        re, im = np.real(v), np.imag(v)
        parts = {"re_im": (re, im), "im_re": (im, re),
                 "re_negim": (re, -im)}[order]
        return torch.from_numpy(np.concatenate(parts)).to(dev)

    b_order = "re_im" if mode in (1, 2) else "im_re"
    x_order = "re_im" if mode in (1, 3) else "re_negim"
    return A2, conv_vec(b, b_order), conv_vec(x, x_order)


def real_solution_to_complex(x, mode: int = 1):
    """The complex solution from the real ERF solution (a complex
    tensor on x's device, the CPU for a numpy x)."""
    mode, block = _mode(mode)
    if block:
        refuse_block(f"complex_conversion={mode + 220}")
    dev = x.device if torch.is_tensor(x) else torch.device("cpu")
    x = host(x)
    n = x.shape[0] // 2
    re, im = x[:n], x[n:]
    if mode in (2, 4):
        im = -im
    return torch.from_numpy(re + 1j * im).to(dev)
