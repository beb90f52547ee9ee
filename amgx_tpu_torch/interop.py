"""Build the port's objects from plain numpy arrays: a matrix from CSR
components, and an AMG hierarchy from another implementation's
per-level arrays (for example the JAX package's, read out as numpy by
the caller). Holding one V-cycle of the port against another
implementation on identical operators then needs no shared setup.

Takes numpy arrays only; imports nothing outside this package. numpy has
no bfloat16 of its own: an array of the `bfloat16` extension type (what
JAX's `np.asarray` gives for a bf16 array) comes across through float32,
which holds every bf16 value exactly (`tensor_from_numpy`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import registry
from .amg.aggregation import AggregationAMGLevel
from .amg.classical import ClassicalAMGLevel
from .amg.hierarchy import AMG
from .config import Config
from .device import resolve_device
from .matrix import CsrMatrix
from .solvers.base import make_solver


def tensor_from_numpy(a, device=None, dtype=None) -> torch.Tensor:
    """A tensor with a numpy array's values (bit for bit, bfloat16
    included), on `device` (None: the card), in `dtype` when given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=resolve_device(device),
                dtype=t.dtype if dtype is None else dtype)


def matrix_from_numpy(row_offsets, col_indices, values, num_rows, num_cols,
                      grid_shape=None, device=None) -> CsrMatrix:
    """An initialized port CsrMatrix (DIA view when banded) from CSR
    arrays. `device=None` means the card."""
    return CsrMatrix.from_scipy_like(
        np.asarray(row_offsets), np.asarray(col_indices),
        tensor_from_numpy(values, "cpu"), num_rows, num_cols,
        grid_shape=grid_shape, device=resolve_device(device)).init()


def _matrix(d: dict, device) -> CsrMatrix:
    return matrix_from_numpy(d["row_offsets"], d["col_indices"],
                             d["values"], d["num_rows"], d["num_cols"],
                             d.get("grid_shape"), device)


def _classical_level(d: dict, cfg, scope, i, device):
    """A classical level, or the configured subclass of one (ENERGYMIN)."""
    cls = registry.amg_levels.get(str(cfg.get("algorithm", scope)))
    if not issubclass(cls, ClassicalAMGLevel):
        cls = ClassicalAMGLevel
    level = cls(_matrix(d, device), cfg, scope, i)
    level.cf_map = torch.tensor(np.asarray(d["cf_map"], np.int32),
                                device=device)
    level.coarse_size = int(d["coarse_size"])
    level.P = _matrix(d["P"], device)
    level.R = _matrix(d["R"], device)
    xfer = d.get("xfer")
    if xfer is not None:
        from .ops.smooth import r_rows
        level._xfer_memo = ({**r_rows(level.R),
                             **{k: tensor_from_numpy(v, device)
                                for k, v in xfer.items()}},)
    return level


def _stencil(d, A):
    """A StencilOperator from another implementation's stencil payload
    (`coeffs`, `offsets`, `shifts`, `shape`, `dinv_mode`), or None."""
    if d is None:
        return None
    from .ops.stencil import StencilOperator
    coeffs = tensor_from_numpy(d["coeffs"], A.device, A.dtype)
    offsets = tuple(int(o) for o in d["offsets"])
    return StencilOperator(
        coeffs=coeffs, host=tuple(coeffs.cpu().tolist()), offsets=offsets,
        shifts=tuple(tuple(int(v) for v in s) for s in d["shifts"]),
        shape=tuple(int(e) for e in d["shape"]), num_rows=A.num_rows,
        dinv_mode=d.get("dinv_mode"),
        diag_rank=offsets.index(0) if 0 in offsets else -1)


def hierarchy_from_numpy(levels: Sequence[dict], coarse: dict, cfg: Config,
                         scope: str = "default", device=None) -> AMG:
    """A set-up port AMG (aggregation or classical levels) from per-level
    arrays.

    Each entry of `levels` holds the level operator's CSR arrays
    (`row_offsets`, `col_indices`, `values`, `num_rows`, `num_cols`,
    optional `grid_shape`), its `coarse_size`, and the smoother's
    payload: CHEBYSHEV_POLY's `taus`, the Jacobi family's `dinv`,
    CHEBYSHEV's and POLYNOMIAL's spectral bounds `lmax` and `lmin`
    (floats; CHEBYSHEV's preconditioner, if any, is set up on the
    level's operator), KPZ_POLYNOMIAL's `l_inf` (a float), or a
    multicolor smoother's coloring `row_colors` and `num_colors` with
    MULTICOLOR_DILU's `Einv` (MULTICOLOR_GS's `dinv`), MULTICOLOR_ILU's
    factors `ilu_L`, `ilu_U` (CSR-array dicts) and `u_diag`, KACZMARZ's
    `inv_rn2`; GS takes `gs_diag` and `dinv`, CF_JACOBI `dinv` and the
    level's CF split. An
    aggregation level adds its `aggregates` and the GEO pairing
    (`geo_axes`, `geo_fine_shape`, `geo_coarse_shape`; None for
    non-geometric levels). A classical level (one with `cf_map`) adds
    `P` and `R` as CSR-array dicts (an ENERGYMIN configuration makes
    it an energymin level) and, optionally, its weighted
    transfer tables `xfer` (`ctab`, `cwt`, `ptab`, `pwt` on the port's
    layout, R's rows `rro`, `rci`, `rwt` taken from `R` where absent;
    built from P and R when absent and cycle_fusion is on). A
    level may carry the `stencil` another implementation detected on it
    (`coeffs`, `offsets`, `shifts`, `shape`, `dinv_mode`): the hierarchy
    installs it where `cfg`'s `matrix_free` lets it detect one, instead
    of running the detector.
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
        sm._owns_scaling = False
        sm.A = level.A
        for key in ("taus", "dinv", "Einv", "gs_diag", "u_diag",
                    "inv_rn2"):
            if d.get(key) is not None:
                setattr(sm, "_" + key, tensor_from_numpy(
                    d[key], device, level.A.dtype))
        if d.get("row_colors") is not None:
            sm.row_colors = tensor_from_numpy(d["row_colors"], device,
                                              torch.int32)
            sm.num_colors = int(d["num_colors"])
        if d.get("lmax") is not None:
            if sm.preconditioner is not None:
                sm.preconditioner.setup(level.A)
            sm.set_bounds(float(d["lmax"]), float(d["lmin"]))
        if d.get("l_inf") is not None:
            sm.l_inf = float(d["l_inf"])
        if d.get("ilu_L") is not None:
            from .solvers.multicolor import csr_only
            sm._Lp = csr_only(_matrix(d["ilu_L"], device))
            sm._Up = csr_only(_matrix(d["ilu_U"], device))
        if getattr(sm, "needs_cf_map", False):
            sm.set_cf_map(getattr(level, "cf_map", None))
        level.smoother = sm
        amg._maybe_install_stencil(level, _stencil(d.get("stencil"),
                                                   level.A))
        amg.levels.append(level)
    amg.coarsest_A = _matrix(coarse, device)
    cs_name, cs_scope = cfg.get_solver("coarse_solver", scope)
    cs = make_solver(cs_name, cfg, cs_scope, device)
    cs._owns_scaling = False
    cs.A = amg.coarsest_A
    cs._qt = tensor_from_numpy(coarse["qt"], device)
    cs._r = tensor_from_numpy(coarse["r"], device)
    if coarse.get("inv") is not None:
        cs._inv_memo = (cs._qt, cs._r,
                        tensor_from_numpy(coarse["inv"], device))
    amg.coarse_solver = cs
    return amg
