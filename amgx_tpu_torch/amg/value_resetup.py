"""Value-only resetup of a GEO hierarchy (the port of
amgx_tpu/amg/value_resetup.py).

A structure-reuse resetup (src/amg.cu:232-262) keeps the coarsening and
reruns the Galerkin products. On a hierarchy of GEO-paired DIA levels
smoothed by CHEBYSHEV_POLY (or nothing) over a DENSE_LU coarsest level,
that is a chain of value computations: each level's GeoRapPlan
(aggregation/galerkin.py) turns the fine value slab into the coarse
one, the Chebyshev taus come from the slab's Gershgorin bound, a
matrix-free level's stencil coefficients from the level above's through
`GeoRapPlan.coarse_coeffs` (or, below a level that is not matrix-free,
`stencil_candidate`), and the coarsest level's dense QR from its new
values. Nothing is read back but ONE small tensor: the GEO wrap flags
and the stencil-constancy flags of every level, folded into one, and
the matrix-free levels' coefficients (the CUDA kernels take them as
host floats). The results are then spliced into the live hierarchy.

A hierarchy of another shape, values that fail the flag (a wrap, a
stencil that is no longer constant), or a level-0 operator of another
offset set, row count or depth decline: the caller runs the generic
reuse loop. All this is plain torch on the operator's device: the JAX
package computes it as XLA ops outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from ..matrix import CsrMatrix


def _level_plan(level, Ac: CsrMatrix):
    """The GeoRapPlan that built `level`'s coarse operator `Ac`, or None
    when the level is not a GEO-paired DIA level of that product."""
    from .aggregation import AggregationAMGLevel
    if type(level) is not AggregationAMGLevel or level.geo_axes is None:
        return None
    A = level.A
    memo = getattr(level, "_geo_plan_memo", None)
    if not memo or A.dia_vals is None or Ac.dia_vals is None \
            or A.grid_shape != tuple(level.geo_fine_shape):
        return None
    plan = memo[0]
    if plan.dia_offsets != tuple(A.dia_offsets) \
            or tuple(int(k[0]) for k in plan.coffsets) != Ac.dia_offsets:
        return None
    return plan


def _smoother_plan(sm):
    name = getattr(sm, "name", "")
    if name == "CHEBYSHEV_POLY":
        return ("cheb", sm.order)
    if name in ("NOSOLVER", "DUMMY"):
        return ("none",)
    return None


def _lam_rowmax(vals2d):
    """The Gershgorin bound from a (k, n) DIA slab: the largest row
    absolute sum (off-grid slots hold 0)."""
    return vals2d.abs().sum(dim=0).max()


def _mf_on(amg):
    return [getattr(lv.smoother, "_mf_stencil", None) is not None
            for lv in amg.levels]


def build_plan(amg):
    """The value route's recipe for `amg`'s current hierarchy, or None
    when it is not eligible."""
    from ..solvers.polynomial import chebyshev_poly_coeffs
    cs = amg.coarse_solver
    if not amg.levels or cs is None \
            or getattr(cs, "name", "") != "DENSE_LU_SOLVER":
        return None
    geo, sms = [], []
    for i, lv in enumerate(amg.levels):
        nxt = (amg.levels[i + 1].A if i + 1 < len(amg.levels)
               else amg.coarsest_A)
        p, sp = _level_plan(lv, nxt), _smoother_plan(lv.smoother)
        if p is None or sp is None:
            return None
        geo.append(p)
        sms.append(sp)
    Az = amg.coarsest_A
    if Az.dia_offsets is None or Az.num_rows > 4096:
        return None
    A0 = amg.levels[0].A
    cheb = {sp[1]: torch.tensor(chebyshev_poly_coeffs(sp[1]),
                                dtype=A0.dtype, device=A0.device)
            for sp in sms if sp[0] == "cheb"}
    return {"geo": geo, "sm": sms, "cheb": cheb, "mf_on": _mf_on(amg),
            "l0_sig": (tuple(A0.dia_offsets), A0.num_rows, len(geo))}


def _run(plan, dia0):
    """Every level's (values_c, dia_c), taus and matrix-free
    coefficients from the level-0 slab, and the folded flag (0-dim bool:
    a wrap, or a stencil no longer constant). No host read."""
    from ..ops.stencil import stencil_candidate
    outs = {"vals": [], "dia": [], "taus": [], "mf": []}
    flags = []
    dia = dia0
    for i, gp in enumerate(plan["geo"]):
        flags.append(gp.wrap_flag(dia))
        c = None
        if plan["mf_on"][i]:
            if i > 0 and plan["mf_on"][i - 1]:
                # a constant fine stencil (even extents) coarsens to a
                # constant stencil: no re-compare
                c = plan["geo"][i - 1].coarse_coeffs(outs["mf"][i - 1])
            if c is None:
                ok, c = stencil_candidate(dia, gp.shifts, gp.fine_shape)
                flags.append(~ok)
        outs["mf"].append(c)
        sp = plan["sm"][i]
        outs["taus"].append(plan["cheb"][sp[1]].to(dia.dtype)
                            / _lam_rowmax(dia) if sp[0] == "cheb" else None)
        values_c, dia = gp.values(dia)
        outs["vals"].append(values_c)
        outs["dia"].append(dia)
    return outs, torch.stack(flags).any()


def _read_back(flag, coeffs):
    """(flag, each coefficient tensor as a tuple of floats) in one host
    read."""
    if not coeffs:
        return bool(flag), []
    host = torch.cat([flag.to(coeffs[0].dtype)[None]]
                     + [c.to(coeffs[0].dtype) for c in coeffs]).cpu()
    host = host.tolist()
    out, at = [], 1
    for c in coeffs:
        out.append(tuple(host[at:at + c.numel()]))
        at += c.numel()
    return bool(host[0]), out


def try_value_resetup(amg, A: CsrMatrix) -> bool:
    """Resetup `amg` on A's values through the value route; False (and
    nothing changed) when the hierarchy or the values do not qualify."""
    if not A.initialized or A.dia_vals is None:
        return False
    plan = amg._vr_plan
    if plan is None or (plan and plan["mf_on"] != _mf_on(amg)):
        plan = build_plan(amg)
        amg._vr_plan = plan if plan is not None else False
    if not plan or (tuple(A.dia_offsets), A.num_rows,
                    len(amg.levels)) != plan["l0_sig"]:
        return False
    outs, flag = _run(plan, A.dia_vals)
    mf = [c for c in outs["mf"] if c is not None]
    bad, host = _read_back(flag, mf)      # the one host read
    if bad:
        amg._vr_plan = None
        return False
    # -- splice ------------------------------------------------------------
    host = iter(host)
    amg.levels[0].A = fine = A
    for i, lv in enumerate(amg.levels):
        last = i + 1 == len(amg.levels)
        old = amg.coarsest_A if last else amg.levels[i + 1].A
        Ac = dataclasses.replace(old, values=outs["vals"][i],
                                 dia_vals=outs["dia"][i])
        if last:
            amg.coarsest_A = Ac
        else:
            amg.levels[i + 1].A = Ac
        sm = lv.smoother
        sm.A = fine
        st = getattr(sm, "_mf_stencil", None)
        if st is not None:
            sm._mf_stencil = dataclasses.replace(
                st, coeffs=outs["mf"][i], host=next(host))
        if outs["taus"][i] is not None:
            sm._taus = outs["taus"][i]
            sm._tau_cache = {}
        fine = Ac
    cs = amg.coarse_solver
    cs.A = amg.coarsest_A
    cs.solver_setup()                     # the dense QR of the new values
    # B5's plans hold the old slabs, coefficients and taus; a reduced-
    # precision hierarchy's casts are memoized per leaf
    amg._tail_plans = {}
    amg._cast_memo = {}
    return True
