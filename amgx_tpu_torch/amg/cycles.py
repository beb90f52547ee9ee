"""Multigrid cycles V, W, F, CG and CGF (the port of
amgx_tpu/amg/cycles.py):
presmooth -> residual -> restrict -> recurse -> prolongate + correct ->
postsmooth, recursing in Python over the static hierarchy depth. With
cycle_fusion the sub-cycle below the first level of at most
cycle_fusion_tail_rows rows runs as one coarse-tail launch (B5,
ops/smooth.py `coarse_tail_cycle`), on the CPU through its plain twin.
The K-cycles CG and CGF accelerate each level's coarse-grid correction
by `cycle_iters` steps (at least 1) of CG on the coarse equation,
preconditioned by the next-coarser K-cycle from a zero guess: CG takes
the Fletcher-Reeves beta (the next r.z), CGF the Polak-Ribiere one
((r - r_old).z), both guarded against a zero denominator, and the last
step skips its trailing preconditioner. A K-cycle never enters the
coarse tail (B5), as the reference's does not, and carries no
cycle-borne dot. A residual the cycle forms
itself reads the level's operator through ops/stencil.py
`level_operator`, which rebuilds a matrix-free level's matrix. A
bfloat16 cycle solves its coarsest level in float32 (the precision
policy keeps the coarse-solver payload at float32 or wider).

Two things make a fixed cycle take the composed route at a level (no
B5 tail; the correction and the postsmooth apart): a diagnostics
recorder (telemetry/diagnostics.py) records the level's stage residual
norms, and an iteration targeted by an armed SpMV fault
(resilience/faultinject.py) poisons each level's restricted residual, as
the JAX package's XLA route poisons the SpMVs inside its cycle. Neither
is active in a normal cycle: one attribute read a level visit."""
from __future__ import annotations

import torch

from ..ops.spmv import residual, spmv
from ..ops.stencil import level_operator
from ..resilience import faultinject as _fi
from ..solvers.krylov import _safe_div
from ..telemetry import diagnostics as _diag


def _smooth(level, data, b, x, sweeps: int):
    if sweeps <= 0 or level.smoother is None:
        return x
    return level.smoother.smooth(data["smoother"], b, x, sweeps)


def _smooth_residual(level, data, b, x, sweeps: int):
    if sweeps <= 0 or level.smoother is None:
        return x, residual(level_operator(data), x, b)
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


def _prolongate_smooth(amg, level, data, b, x, xc, sweeps: int,
                       want_dot: bool = False):
    """Prolongation + correction + postsmooth: with cycle_fusion the
    correction is read inside the postsmoother's first application
    (B4); otherwise x + P xc, then the smoother. With want_dot the
    return is (x', x'.b) when the fused kernel carries the dot, else
    (x', None)."""
    if amg.cycle_fusion and sweeps > 0 and \
            "prolongate" in level.supports_fusion(data):
        out = level.prolongate_smooth(data, b, x, xc, sweeps,
                                      want_dot=want_dot)
        if out is not None:
            return out
    x = x + level.prolongate(data, xc)
    x = _smooth(level, data, b, x, sweeps)
    return (x, None) if want_dot else x


def apply_coarse_solver(cs, data, bc, xc, coarsest_sweeps: int):
    """Coarsest-level dispatch: NOSOLVER/DUMMY means no coarse correction
    (xc stays zero), relaxation-type coarse solvers run `coarsest_sweeps`
    sweeps from xc, direct ones their own apply."""
    if cs.name in ("NOSOLVER", "DUMMY"):
        return xc
    if cs.is_smoother:
        return cs.smooth(data, bc, xc, coarsest_sweeps)
    return cs.apply(data, bc)


def _coarse_solve(amg, data, bc, xc):
    """The coarsest level's solve; a bfloat16 cycle widens bc and xc to
    float32 around it and rounds the correction back
    (amgx_tpu/amg/cycles.py `_coarse_solve`)."""
    if bc.dtype == torch.bfloat16:
        out = apply_coarse_solver(amg.coarse_solver, data["coarse"],
                                  bc.to(torch.float32),
                                  xc.to(torch.float32), amg.coarsest_sweeps)
        return out.to(bc.dtype)
    return apply_coarse_solver(amg.coarse_solver, data["coarse"], bc, xc,
                               amg.coarsest_sweeps)


def _cycle(amg, shape: str, data, lvl: int, b, x, want_dot: bool = False):
    """FixedCycle::cycle analog: recursion count per level V=1, W=2,
    F = one F-visit then one V-visit. want_dot asks the entry level's
    last kernel (its postsmoother, or the whole-cycle tail) for x'.b;
    levels below never carry it."""
    levels = amg.levels
    if lvl == len(levels):
        out = _coarse_solve(amg, data, b, x)
        return (out, None) if want_dot else out
    rec = _diag.current()
    fault = _fi.loop_fault_hit()
    if amg.cycle_fusion and rec is None and fault is None:
        from ..ops.smooth import coarse_tail_cycle
        out = coarse_tail_cycle(amg, shape, data, lvl, b, x,
                                want_dot=want_dot)
        if out is not None:
            return out
    level = levels[lvl]
    ldata = data["levels"][lvl]
    if rec is not None:
        rec.record(lvl, 0, level_operator(ldata), x, b)
    x, bc = _smooth_restrict(amg, level, ldata, b, x,
                             amg._sweeps(lvl, pre=True))
    if rec is not None:
        rec.record(lvl, 1, level_operator(ldata), x, b)
    if fault is not None:
        bc = _fi.corrupt_spmv(bc)
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
    if rec is not None:
        x = x + level.prolongate(ldata, xc)
        rec.record(lvl, 2, level_operator(ldata), x, b)
        x = _smooth(level, ldata, b, x, amg._sweeps(lvl, pre=False))
        rec.record(lvl, 3, level_operator(ldata), x, b)
        return (x, None) if want_dot else x
    return _prolongate_smooth(amg, level, ldata, b, x, xc,
                              amg._sweeps(lvl, pre=False),
                              want_dot=want_dot)


def _kcycle(amg, data, lvl: int, b, x, flex: bool):
    """CG / CGF cycle (cg_cycle.cu, cg_flex_cycle.cu)."""
    levels = amg.levels
    if lvl == len(levels):
        return _coarse_solve(amg, data, b, x)
    level = levels[lvl]
    ldata = data["levels"][lvl]
    x, bc = _smooth_restrict(amg, level, ldata, b, x,
                             amg._sweeps(lvl, pre=True))
    nxt = lvl + 1

    def M(v):
        return _kcycle(amg, data, nxt, v, torch.zeros_like(v), flex)

    def Ac_mv(v):
        if nxt == len(levels):
            if v.dtype == torch.bfloat16:
                # the coarsest operator stays float32 under a bf16 cycle
                return spmv_coarsest(amg, data, v.to(torch.float32)).to(
                    v.dtype)
            return spmv_coarsest(amg, data, v)
        return spmv(level_operator(data["levels"][nxt]), v)

    xc = torch.zeros_like(bc)
    rc = bc
    z = M(rc)
    p = z
    rz = torch.dot(rc, z)
    k_iters = max(amg.cycle_iters, 1)
    for it in range(k_iters):
        Ap = Ac_mv(p)
        alpha = _safe_div(rz, torch.dot(p, Ap))
        xc = xc + alpha * p
        rc_old = rc
        rc = rc - alpha * Ap
        if it + 1 == k_iters:
            break             # the last step needs no M, beta or p
        z = M(rc)
        rz_new = torch.dot(rc, z)
        # Polak-Ribiere tolerates a varying M; Fletcher-Reeves reuses rz
        num = torch.dot(rc - rc_old, z) if flex else rz_new
        beta = _safe_div(num, rz)
        rz = rz_new
        p = z + beta * p
    return _prolongate_smooth(amg, level, ldata, b, x, xc,
                              amg._sweeps(lvl, pre=False))


def spmv_coarsest(amg, data, v):
    """v times the coarsest operator (the coarse solver's matrix)."""
    return spmv(data["coarse"]["A"], v)


def run_cycle(amg, name: str, data, b, x):
    name = name.upper()
    if name in ("V", "W", "F"):
        return _cycle(amg, name, data, 0, b, x)
    if name in ("CG", "CGF"):
        return _kcycle(amg, data, 0, b, x, flex=name == "CGF")
    raise ValueError(f"unknown cycle {name!r}")


def run_cycle_dot(amg, name: str, data, b, x):
    """One cycle that also asks its last kernel for x'.b (the Krylov
    shell's cycle-borne r.z). Returns (x', dot), dot None when the cycle
    cannot carry it (a K-cycle never does) -- the caller then reduces
    explicitly."""
    name = name.upper()
    if name in ("V", "W", "F"):
        return _cycle(amg, name, data, 0, b, x, want_dot=True)
    return run_cycle(amg, name, data, b, x), None
