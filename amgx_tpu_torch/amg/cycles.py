"""Multigrid cycles V, W, F (the port of amgx_tpu/amg/cycles.py):
presmooth -> residual -> restrict -> recurse -> prolongate + correct ->
postsmooth, recursing in Python over the static hierarchy depth. The
K-cycles (CG, CGF) are not ported yet."""
from __future__ import annotations

import torch

from ..ops.spmv import residual


def _smooth(level, data, b, x, sweeps: int):
    if sweeps <= 0 or level.smoother is None:
        return x
    return level.smoother.smooth(data["smoother"], b, x, sweeps)


def _smooth_residual(level, data, b, x, sweeps: int):
    if sweeps <= 0 or level.smoother is None:
        return x, residual(data["A"], x, b)
    return level.smoother.smooth_residual(data["smoother"], b, x, sweeps)


def _smooth_restrict(amg, level, data, b, x, sweeps: int):
    """Presmooth + restriction: with cycle_fusion the restriction rides
    the presmoother kernel's epilogue (B3); otherwise smooth_residual
    (B2) then the level's restrict."""
    if amg.cycle_fusion and sweeps > 0 and \
            "restrict" in level.supports_fusion(data):
        out = level.restrict_fused(data, b, x, sweeps)
        if out is not None:
            return out
    x, r = _smooth_residual(level, data, b, x, sweeps)
    return x, level.restrict(data, r)


def _prolongate_smooth(amg, level, data, b, x, xc, sweeps: int):
    """Prolongation + correction + postsmooth: with cycle_fusion the
    correction is read inside the postsmoother's first application
    (B4); otherwise x + P xc, then the smoother."""
    if amg.cycle_fusion and sweeps > 0 and \
            "prolongate" in level.supports_fusion(data):
        out = level.prolongate_smooth(data, b, x, xc, sweeps)
        if out is not None:
            return out
    x = x + level.prolongate(data, xc)
    return _smooth(level, data, b, x, sweeps)


def apply_coarse_solver(cs, data, bc, xc, coarsest_sweeps: int):
    """Coarsest-level dispatch: relaxation-type coarse solvers run
    `coarsest_sweeps` sweeps from xc, direct ones their own apply."""
    if cs.is_smoother:
        return cs.smooth(data, bc, xc, coarsest_sweeps)
    return cs.apply(data, bc)


def _cycle(amg, shape: str, data, lvl: int, b, x):
    """FixedCycle::cycle analog: recursion count per level V=1, W=2,
    F = one F-visit then one V-visit."""
    levels = amg.levels
    if lvl == len(levels):
        return apply_coarse_solver(amg.coarse_solver, data["coarse"], b, x,
                                   amg.coarsest_sweeps)
    level = levels[lvl]
    ldata = data["levels"][lvl]
    x, bc = _smooth_restrict(amg, level, ldata, b, x,
                             amg._sweeps(lvl, pre=True))
    xc = torch.zeros_like(bc)
    if shape == "V":
        xc = _cycle(amg, "V", data, lvl + 1, bc, xc)
    elif shape == "W":
        xc = _cycle(amg, "W", data, lvl + 1, bc, xc)
        if lvl + 1 < len(levels):
            xc = _cycle(amg, "W", data, lvl + 1, bc, xc)
    elif shape == "F":
        xc = _cycle(amg, "F", data, lvl + 1, bc, xc)
        if lvl + 1 < len(levels):
            xc = _cycle(amg, "V", data, lvl + 1, bc, xc)
    else:
        raise ValueError(f"unknown fixed cycle {shape!r}")
    return _prolongate_smooth(amg, level, ldata, b, x, xc,
                              amg._sweeps(lvl, pre=False))


def run_cycle(amg, name: str, data, b, x):
    name = name.upper()
    if name in ("V", "W", "F"):
        return _cycle(amg, name, data, 0, b, x)
    raise NotImplementedError(f"cycle {name!r} is not ported yet")
