"""CSR transpose (the port of amgx_tpu/ops/transpose.py), on the
matrix's device.

A stable sort of the column indices regroups the entries by column, so
within each row of the transpose the columns (the source rows) ascend
and the entry order equals the JAX package's: R = P^T's entries are
indexed by position in the transfer tables and the RAP plan.
"""
from __future__ import annotations

import torch

from ..matrix import CsrMatrix


def transpose(A: CsrMatrix) -> CsrMatrix:
    rows, cols, vals = A.coo()
    order = torch.argsort(cols.long(), stable=True)
    return CsrMatrix.from_rows(cols[order], rows[order], vals[order],
                               A.num_cols, A.num_rows)
