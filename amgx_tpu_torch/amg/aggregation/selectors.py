"""Aggregation selectors (the port of the GEO selector of
amgx_tpu/amg/aggregation/selectors.py). The matching selectors (SIZE_2,
SIZE_4, ...) are not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from ... import registry
from ...config import Config
from ...errors import BadParametersError
from ...matrix import CsrMatrix


class AggregationSelector:
    def __init__(self, cfg: Config, scope: str = "default"):
        self.cfg = cfg
        self.scope = scope

    def set_aggregates(self, A: CsrMatrix):
        """(aggregates (n,) int32 tensor on A's device, coarse size)."""
        raise NotImplementedError


@registry.aggregation_selectors.register("GEO")
class GeoSelector(AggregationSelector):
    """Geometric aggregation on a structured grid (CsrMatrix.grid_shape):
    each aggregate is the 2x2x2 block of grid points, every axis with
    extent >= 2 halved (rounding up):

      agg(x, y, z) = linear coarse index of (x//2, y//2, z//2).

    Sets `pair_axes`, `fine_shape` and `coarse_shape` for the level's
    structured transfers and Galerkin product."""

    def set_aggregates(self, A: CsrMatrix):
        shape = A.grid_shape
        n = A.num_rows
        if shape is None or int(np.prod(shape)) != n:
            raise BadParametersError(
                "GEO selector requires a structured-grid matrix "
                "(CsrMatrix.grid_shape)")
        nx, ny, nz = shape
        axes = tuple(a for a, e in enumerate((nx, ny, nz)) if e >= 2)
        self.fine_shape = tuple(shape)
        i = torch.arange(n, dtype=torch.int32, device=A.device)
        if not axes:
            self.pair_axes = None
            self.coarse_shape = tuple(shape)
            return i, n
        cnx = (nx + 1) // 2 if 0 in axes else nx
        cny = (ny + 1) // 2 if 1 in axes else ny
        cnz = (nz + 1) // 2 if 2 in axes else nz
        x, t = i % nx, i // nx
        y, z = t % ny, t // ny
        cx = x // 2 if 0 in axes else x
        cy = y // 2 if 1 in axes else y
        cz = z // 2 if 2 in axes else z
        self.pair_axes = axes
        self.coarse_shape = (cnx, cny, cnz)
        return (cz * cny + cy) * cnx + cx, int(cnx * cny * cnz)
