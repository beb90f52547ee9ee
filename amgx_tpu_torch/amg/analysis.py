"""Per-level cycle convergence analysis (the port of
amgx_tpu/amg/analysis.py; the reference's
src/cycles/convergence_analysis.cu:222).

For the first `convergence_analysis` levels, one instrumented
error-propagation cycle (b = 0, x = e random, so the cycle acts on pure
error) reports the residual reduction of each phase -- pre-smoothing,
coarse-grid correction, post-smoothing -- per level. The cycle runs the
per-level eager route of amg/cycles.py (`_smooth`, `_coarse_solve`, the
level's restrict and prolongate), never the fused coarse tail, and forms
each residual with the operator the cycle itself uses
(`level_operator`: a matrix-free level's stencil matrix). The error
vector is `np.random.default_rng(seed).standard_normal(n)`, the JAX
package's numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.spmv import residual
from ..ops.stencil import level_operator


def _nrm(v) -> float:
    return float(torch.linalg.norm(v))


def _analyze(amg, data, lvl, b, x, rows):
    from .cycles import _coarse_solve, _smooth
    levels = amg.levels
    if lvl == len(levels):
        return _coarse_solve(amg, data, b, x)
    level = levels[lvl]
    ldata = data["levels"][lvl]
    A = level_operator(ldata)
    instrument = lvl < amg.convergence_analysis
    rec = {"level": lvl, "n": level.A.num_rows}
    if instrument:
        rec["pre_in"] = _nrm(residual(A, x, b))
    x = _smooth(level, ldata, b, x, amg._sweeps(lvl, pre=True))
    if instrument:
        rec["pre_out"] = _nrm(residual(A, x, b))
    r = residual(A, x, b)
    bc = level.restrict(ldata, r)
    xc = torch.zeros_like(bc)
    xc = _analyze(amg, data, lvl + 1, bc, xc, rows)
    x = x + level.prolongate(ldata, xc)
    if instrument:
        rec["coarse_out"] = _nrm(residual(A, x, b))
    x = _smooth(level, ldata, b, x, amg._sweeps(lvl, pre=False))
    if instrument:
        rec["post_out"] = _nrm(residual(A, x, b))
        rows.append(rec)
    return x


def analysis_rows(amg, data=None, seed: int = 0):
    """The instrumented levels' phase norms: one dict a level with the
    residual norms before and after presmoothing (pre_in, pre_out),
    after the coarse correction (coarse_out) and after postsmoothing
    (post_out)."""
    if data is None:
        data = amg.solve_data()
    A0 = level_operator(data["levels"][0])
    e = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        amg.levels[0].A.num_rows)).to(device=A0.device, dtype=A0.dtype)
    rows = []
    _analyze(amg, data, 0, torch.zeros_like(e), e, rows)
    return sorted(rows, key=lambda r: r["level"])


def convergence_analysis(amg, data=None, seed: int = 0) -> str:
    """Run the instrumented error-propagation cycle and format the
    per-level phase-reduction report (printConvergenceAnalysis
    analog)."""
    out = ["Convergence analysis (error-propagation cycle, b=0):",
           f"{'level':>5} {'rows':>10} {'presmooth':>10} "
           f"{'coarse':>10} {'postsmooth':>10} {'total':>10}"]

    def ratio(a, c):
        return c / a if a > 0 else 0.0
    for r in analysis_rows(amg, data, seed):
        pre = ratio(r["pre_in"], r["pre_out"])
        crs = ratio(r["pre_out"], r["coarse_out"])
        post = ratio(r["coarse_out"], r["post_out"])
        tot = ratio(r["pre_in"], r["post_out"])
        out.append(f"{r['level']:>5} {r['n']:>10} {pre:>10.4f} "
                   f"{crs:>10.4f} {post:>10.4f} {tot:>10.4f}")
    return "\n".join(out)
