"""Build the port's objects from plain numpy arrays: a matrix from CSR
components, and an AMG hierarchy from another implementation's
per-level arrays (for example the JAX package's, read out as numpy by
the caller). Holding one V-cycle of the port against another
implementation on identical operators then needs no shared setup.

Takes numpy arrays only; imports nothing outside this package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .amg.aggregation import AggregationAMGLevel
from .amg.classical import ClassicalAMGLevel
from .amg.hierarchy import AMG
from .config import Config
from .device import resolve_device
from .matrix import CsrMatrix
from .solvers.base import make_solver


def matrix_from_numpy(row_offsets, col_indices, values, num_rows, num_cols,
                      grid_shape=None, device=None) -> CsrMatrix:
    """An initialized port CsrMatrix (DIA view when banded) from CSR
    arrays. `device=None` means the card."""
    return CsrMatrix.from_scipy_like(
        np.asarray(row_offsets), np.asarray(col_indices),
        np.asarray(values), num_rows, num_cols, grid_shape=grid_shape,
        device=resolve_device(device)).init()


def _matrix(d: dict, device) -> CsrMatrix:
    return matrix_from_numpy(d["row_offsets"], d["col_indices"],
                             d["values"], d["num_rows"], d["num_cols"],
                             d.get("grid_shape"), device)


def _classical_level(d: dict, cfg, scope, i, device):
    level = ClassicalAMGLevel(_matrix(d, device), cfg, scope, i)
    level.cf_map = torch.tensor(np.asarray(d["cf_map"], np.int32),
                                device=device)
    level.coarse_size = int(d["coarse_size"])
    level.P = _matrix(d["P"], device)
    level.R = _matrix(d["R"], device)
    xfer = d.get("xfer")
    if xfer is not None:
        level._xfer_memo = ({k: torch.tensor(np.asarray(v), device=device)
                             for k, v in xfer.items()},)
    return level


def hierarchy_from_numpy(levels: Sequence[dict], coarse: dict, cfg: Config,
                         scope: str = "default", device=None) -> AMG:
    """A set-up port AMG (aggregation or classical levels) from per-level
    arrays.

    Each entry of `levels` holds the level operator's CSR arrays
    (`row_offsets`, `col_indices`, `values`, `num_rows`, `num_cols`,
    optional `grid_shape`), its `coarse_size`, and the smoother's
    payload: CHEBYSHEV_POLY's `taus`, or the Jacobi family's `dinv`. An
    aggregation level adds its `aggregates` and the GEO pairing
    (`geo_axes`, `geo_fine_shape`, `geo_coarse_shape`; None for
    non-geometric levels). A classical level (one with `cf_map`) adds
    `P` and `R` as CSR-array dicts and, optionally, its weighted
    transfer tables `xfer` (`ctab`, `cwt`, `ptab`, `pwt` on the port's
    layout; built from P and R when absent and cycle_fusion is on).
    `coarse` holds the coarsest operator's CSR arrays, its DENSE_LU
    factors `qt`, `r` and, when the other implementation built one, the
    explicit inverse `inv` (the coarse-tail kernel's coarsest solve).
    The smoother and coarse solver named by `cfg` at `scope` are
    attached with these values instead of being set up again.
    """
    device = resolve_device(device)
    amg = AMG(cfg, scope)
    for i, d in enumerate(levels):
        if d.get("cf_map") is not None:
            level = _classical_level(d, cfg, scope, i, device)
        else:
            level = AggregationAMGLevel(_matrix(d, device), cfg, scope, i)
            level.aggregates = torch.tensor(
                np.asarray(d["aggregates"], np.int32), device=device)
            level.coarse_size = int(d["coarse_size"])
        if d.get("geo_axes") is not None:
            level.geo_axes = tuple(int(a) for a in d["geo_axes"])
            level.geo_fine_shape = tuple(int(e) for e in d["geo_fine_shape"])
            level.geo_coarse_shape = tuple(
                int(e) for e in d["geo_coarse_shape"])
        name, sm_scope = amg._smoother_spec(i)
        sm = make_solver(name, cfg, sm_scope, device)
        sm.A = level.A
        for key in ("taus", "dinv"):
            if d.get(key) is not None:
                setattr(sm, "_" + key, torch.tensor(
                    np.asarray(d[key]), device=device, dtype=level.A.dtype))
        level.smoother = sm
        amg.levels.append(level)
    amg.coarsest_A = _matrix(coarse, device)
    cs_name, cs_scope = cfg.get_solver("coarse_solver", scope)
    cs = make_solver(cs_name, cfg, cs_scope, device)
    cs.A = amg.coarsest_A
    cs._qt = torch.tensor(np.asarray(coarse["qt"]), device=device)
    cs._r = torch.tensor(np.asarray(coarse["r"]), device=device)
    if coarse.get("inv") is not None:
        cs._inv_memo = (cs._qt, cs._r, torch.tensor(
            np.asarray(coarse["inv"]), device=device))
    amg.coarse_solver = cs
    return amg
