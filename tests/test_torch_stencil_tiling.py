"""The tile plans and the tile-by-tile emulation of the temporally blocked
coefficient-mode kernels (amgx_tpu_torch/ops/tiling.py; the CUDA kernels
csrc/stencil_tb.cu that B3-mf and B4-mf launch on the card).

The emulation computes what one launch computes, block by block: each
block's halo loads, its time levels on shrinking regions (values outside
a block's previous level are NaN, so a halo too small shows), and B3-mf's
restriction of each coarse row inside its tile in ctab order. It must
give the untiled plain forms (ops/stencil.py `_xla_restrict`,
`_xla_corr`: the CPU route and the kernels' reference on the card) bit
for bit, in float32 and bfloat16; the dot epilogue adds block partials
in block order, so it is held to torch.dot within float32 rounding and
its x' to the bit. The planner must tile every driven path's levels
exactly once within a Hopper block's shared memory and threads, and say
"one tile per coarse row" for GEO's tables and not for SIZE_2's. The
kernel takes the 7-point star and at most six applications; other
stencils and longer schedules take the per-step kernels. One small case
is held to the JAX package's plain references.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.ops import stencil as jst

import amgx_tpu_torch as pt
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.ops import tiling as TL
from amgx_tpu_torch.ops.smooth import build_transfer_tables, children_table
from amgx_tpu_torch.solvers.polynomial import chebyshev_poly_coeffs

from _torch_util import geo_agg

# f32 kernel math in two implementations (ROADMAP.md)
TOL32 = 1e-6


def _operator(shape, points="7pt", shifts=None):
    """(spec, coeffs) of a constant-coefficient grid operator: the
    gallery's stencil, or `shifts` with seeded coefficients (a diagonal
    of 6.5 and off-diagonals in [-1.2, -0.8]) for shapes the gallery has
    none of."""
    if shifts is None:
        A = pt.gallery.poisson(points, *shape, dtype=torch.float32,
                               device="cpu").init()
        st = mf.detect_stencil(A)
        return st.spec(), st.coeffs
    nx, ny, _ = shape
    order = sorted(range(len(shifts)), key=lambda d: (
        shifts[d][2] * nx * ny + shifts[d][1] * nx + shifts[d][0]))
    shifts = tuple(tuple(shifts[d]) for d in order)
    offsets = tuple(s[2] * nx * ny + s[1] * nx + s[0] for s in shifts)
    rng = np.random.default_rng(3)
    c = [6.5 if s == (0, 0, 0) else -rng.uniform(0.8, 1.2) for s in shifts]
    n = int(np.prod(shape))
    spec = mf.StencilSpec(offsets, shifts, tuple(shape), n, None,
                          offsets.index(0))
    return spec, torch.tensor(c, dtype=torch.float32)


def _vectors(n, nc, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, x = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    xc = torch.from_numpy(rng.standard_normal(nc).astype(np.float32))
    return b.to(dtype), x.to(dtype), xc.to(dtype)


def _taus(s):
    if s == 5:
        return torch.from_numpy(
            (chebyshev_poly_coeffs(5) / 12.0).astype(np.float32))
    return torch.full((s,), 0.75)


def _plan(spec, apps, residual, tile, chunk):
    assert TL.star_fits(spec.shifts, spec.shape, apps)
    if tile is None:          # the planner's own choice, on a small card
        return TL.plan_tiles(spec.shape, apps, residual, sms=6)
    return TL.plan_tiles(spec.shape, apps, residual, tile=tile, chunk=chunk)


def _dinv(spec, mode):
    return spec._replace(dinv=mode) if mode else spec


# (shape, stencil, steps, dtype, tile, chunk, dinv)
CASES = [
    ((8, 8, 8), "7pt", 5, torch.float32, (4, 2), 2, None),
    ((9, 7, 5), "7pt", 2, torch.float32, (4, 4), 2, "l1"),
    ((13, 11, 9), "7pt", 5, torch.bfloat16, None, None, None),
    ((20, 20, 20), "7pt", 1, torch.float32, None, None, "jacobi"),
    ((10, 12, 16), "7pt", 5, torch.float32, (6, 4), 4, "l1"),
    ((11, 9, 7), "7pt", 4, torch.bfloat16, (4, 6), 2, "jacobi"),
]
# levels the tiled kernel does not take: (shape, stencil, steps)
PER_STEP = [((12, 10, 16), "27pt", 2), ((11, 9, 7), "27pt", 5),
            ((16, 12, 1), "7pt", 5), ((14, 10, 6), "radius2", 2),
            ((8, 8, 8), "7pt", 6), ((8, 8, 8), "7pt", 20)]
_RADIUS2 = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (-2, 0, 0), (2, 0, 0),
            (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]


def _case(shape, stencil):
    spec, c = _operator(shape, shifts=_RADIUS2 if stencil == "radius2"
                        else None, points=stencil)
    agg, nc = geo_agg(shape)
    agg = torch.from_numpy(agg)
    return spec, c, agg, nc, children_table(agg, nc)


def _ids(case):
    shape, stencil, s, dt, tile, _, dinv = case
    return (f"{'x'.join(map(str, shape))}-{stencil}-s{s}-"
            f"{str(dt).split('.')[-1]}-{'plan' if tile is None else 'tile'}"
            f"-{dinv}")


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_emulation_equals_the_untiled_plain_forms(case):
    """B3-mf (steps, residual, in-tile restriction) and B4-mf (x + xc[agg]
    prologue, steps) block by block give the plain forms' bits."""
    shape, stencil, s, dt, tile, chunk, dinv = case
    spec, c, agg, nc, ctab = _case(shape, stencil)
    spec = _dinv(spec, dinv)
    n = spec.n
    b, x, xc = _vectors(n, nc, dt)
    taus = _taus(s)
    p3 = _plan(spec, s + 1, True, tile, chunk)
    assert TL.restrict_lists(p3, ctab) is not None
    got = TL.emulate(p3, spec, c, taus, b, x, ctab=ctab)
    want = mf._xla_restrict(spec, c, taus, b, x, ctab)
    for g, w in zip(got, want):
        assert g.dtype == dt and torch.equal(g, w)
    p4 = _plan(spec, s, False, tile, chunk)
    got = TL.emulate(p4, spec, c, taus, b, x, xc=xc, agg=agg)
    assert torch.equal(got, mf._xla_corr(spec, c, taus, b, x, xc, agg))


@pytest.mark.parametrize("shape,stencil,s", PER_STEP,
                         ids=[f"{'x'.join(map(str, c[0]))}-{c[1]}-s{c[2]}"
                              for c in PER_STEP])
def test_other_levels_take_the_per_step_route(shape, stencil, s):
    """A stencil other than the 7-point star, a 2-D grid, or more than
    STAR_MAX_APPS applications: the tiled kernel does not take the call
    (B4-mf with s steps, B3-mf with s + 1), so the wrappers launch dia.cu's
    per-step kernels; the planner and the emulation refuse it."""
    spec, c, agg, nc, ctab = _case(shape, stencil)
    star = TL.star_fits(spec.shifts, spec.shape, s)
    assert not TL.star_fits(spec.shifts, spec.shape, s + 1)
    assert star == (stencil == "7pt" and shape[2] > 1
                    and s <= TL.STAR_MAX_APPS)
    b, x, _ = _vectors(spec.n, nc, torch.float32)
    assert K._tb_plan(spec, x, s + 1, True) is None      # the dispatch
    if star:                    # B3-mf steps tiled, the restriction after
        plan = TL.plan_tiles(spec.shape, s, False, tile=(4, 4), chunk=2)
        assert torch.equal(TL.emulate(plan, spec, c, _taus(s), b, x),
                           mf._xla_restrict(spec, c, _taus(s), b, x,
                                            ctab)[0])
        return
    if tuple(spec.shifts) == TL.STAR:       # the schedule is too long
        with pytest.raises(ValueError, match="8, 8, 8"):
            TL.plan_tiles(spec.shape, s + 1, True)
        return
    with pytest.raises(ValueError, match="7-point star"):
        TL.emulate(TL.TilePlan(spec.shape, 2, False, (4, 4), 2), spec, c,
                   _taus(2), b, x)


@pytest.mark.parametrize("shape", [(10, 9, 8), (17, 6, 12)])
def test_emulated_dot_is_the_plain_dot(shape):
    """B4-mf's x'.b: x' to the bit; the dot (block partials added in block
    order, the kernel's tree inside a block differs) to float32 rounding
    of sum |x'_i b_i|."""
    spec, c, agg, nc, _ = _case(shape, "7pt")
    spec = _dinv(spec, "l1")
    b, x, xc = _vectors(spec.n, nc, torch.float32, seed=4)
    taus = _taus(2)
    plan = _plan(spec, 2, False, (4, 4), 4)
    (gx, gd) = TL.emulate(plan, spec, c, taus, b, x, xc=xc, agg=agg,
                          with_dot=True)
    (wx, wd) = mf._xla_corr(spec, c, taus, b, x, xc, agg, with_dot=True)
    assert torch.equal(gx, wx)
    scale = float((wx * b).abs().sum())
    assert abs(float(gd) - float(wd)) <= 4 * np.finfo(np.float32).eps * scale


def test_pair_tables_take_the_two_launch_route():
    """A SIZE_2-like pair table crosses tile edges: no in-tile
    restriction; the launch's x' (and its float32 state) still equal the
    plain form's, and the untiled restriction of that state gives bc."""
    shape = (12, 10, 8)
    spec, c, _, _, _ = _case(shape, "7pt")
    n = spec.n
    agg = (torch.arange(n) + 1) // 2
    nc = int(agg.max()) + 1
    ctab = children_table(agg, nc)
    b, x, _ = _vectors(n, nc, torch.float32, seed=7)
    taus = _taus(5)
    assert TL.restrict_lists(_plan(spec, 6, True, (4, 4), 2), ctab) is None
    plan = _plan(spec, 5, False, (4, 4), 2)
    xs = TL.emulate(plan, spec, c, taus, b, x)
    wx, wbc = mf._xla_restrict(spec, c, taus, b, x, ctab)
    assert torch.equal(xs, wx)
    r = b - mf._apply_vec(spec, c, xs)
    assert torch.equal(K.restrict_plain(ctab, r), wbc)


def test_emulation_matches_jax_plain_references():
    """One small case against the JAX package's plain forms of
    `_dia_stencil_smooth_restrict_call` and
    `_dia_stencil_prolong_smooth_call` (amgx_tpu/ops/stencil.py), on
    tests/test_torch_matrix_free.py's ragged grid and two-step schedule
    (two float32 implementations: 1e-6)."""
    shape = (9, 7, 5)
    Aj = jx.gallery.poisson("7pt", *shape).init()
    sj = jst.detect_stencil(Aj)
    spec, c, agg, nc, ctab = _case(shape, "7pt")
    b, x, xc = _vectors(spec.n, nc, torch.float32, seed=9)
    taus = torch.from_numpy(
        (chebyshev_poly_coeffs(2) / 12.0).astype(np.float32))
    p3 = _plan(spec, 3, True, (4, 4), 2)
    gx, gbc = TL.emulate(p3, spec, c, taus, b, x, ctab=ctab)
    wx, wbc = jst._xla_restrict(
        sj.spec(), sj.coeffs.astype(jnp.float32), jnp.asarray(taus.numpy()),
        jnp.asarray(b.numpy()), jnp.asarray(x.numpy()),
        jnp.asarray(ctab.numpy())[:, :, None], nc)
    p4 = _plan(spec, 2, False, (4, 4), 2)
    gy = TL.emulate(p4, spec, c, taus, b, x, xc=xc, agg=agg)
    wy = jst._xla_corr(sj.spec(), sj.coeffs.astype(jnp.float32),
                       jnp.asarray(taus.numpy()), jnp.asarray(b.numpy()),
                       jnp.asarray(x.numpy()), jnp.asarray(xc.numpy()),
                       jnp.asarray(agg.numpy()))
    for g, w in ((gx, wx), (gbc, wbc), (gy, wy)):
        w = np.asarray(w, dtype=np.float32)
        assert float(np.max(np.abs(g.numpy() - w))) <= \
            TOL32 * max(float(np.max(np.abs(w))), 1.0)


def _covers_once(plan):
    """Every grid point lies in exactly one block's interior."""
    nx, ny, nz = plan.shape
    hits = np.zeros((nz, ny, nx), np.int32)
    for blk in range(plan.blocks):
        x0, y0, z0 = plan.origin(blk)
        hits[z0:z0 + plan.chunk, y0:y0 + plan.tile[1],
             x0:x0 + plan.tile[0]] += 1
    return bool((hits == 1).all())


# (label, shape, applications, residual, element size of b -- the plan
# does not depend on it: the kernel keeps b's planes in float32): F / Fb
# levels 0
# and 1 (CHEBYSHEV_POLY's 5 steps; B3-mf + its residual), P1 / P0 (PCG's
# JACOBI_L1: 1 presweep + residual, 2 postsweeps), AP / AF / APb / AFb
# (BLOCK_JACOBI's 3 postsweeps on the SIZE_2 level 0, and B3-mf there
# without the in-tile restriction)
DRIVEN = [
    ("F l0", (128,) * 3, 6, True, 4), ("F l0", (128,) * 3, 5, False, 4),
    ("F l1", (64,) * 3, 6, True, 4), ("F l1", (64,) * 3, 5, False, 4),
    ("Fb l0", (128,) * 3, 6, True, 2), ("Fb l0", (128,) * 3, 5, False, 2),
    ("Fb l1", (64,) * 3, 6, True, 2), ("Fb l1", (64,) * 3, 5, False, 2),
    ("P l0", (128,) * 3, 2, True, 4), ("P l0", (128,) * 3, 2, False, 4),
    ("P l1", (64,) * 3, 2, True, 4), ("P l1", (64,) * 3, 2, False, 4),
    ("A l0", (128,) * 3, 3, False, 4), ("Ab l0", (128,) * 3, 3, False, 2),
    ("A32 l0", (32,) * 3, 3, False, 4),
]


@pytest.mark.parametrize("label,shape,apps,residual,es", DRIVEN,
                         ids=[f"{d[0]}-{d[2]}{'r' if d[3] else ''}-{d[4]}"
                              for d in DRIVEN])
def test_planner_covers_the_driven_levels(label, shape, apps, residual, es):
    """The tiled kernel's plan on each driven level (132 SMs): within
    227 KB and 1024 threads, every point in one block, blocks for at
    least 90 % of the SMs (a block takes a whole SM's registers)."""
    assert TL.star_fits(TL.STAR, shape, apps)
    plan = TL.plan_tiles(shape, apps, residual)
    assert plan.steps == apps - int(residual)
    assert plan.smem_bytes <= TL.SMEM_BLOCK_MAX - TL.SMEM_STATIC
    assert plan.threads <= TL.MAX_THREADS
    assert plan.tile[0] % 2 == 0 and plan.tile[1] % 2 == 0 \
        and plan.chunk % 2 == 0
    assert plan.blocks >= 0.9 * min(TL.SMS, int(np.prod(shape)) // 4096)
    assert _covers_once(plan)
    assert plan.region(0) == (plan.tile[0] + 2 * apps,
                              plan.tile[1] + 2 * apps)


def test_geo_tables_restrict_in_tile_size2_do_not():
    """GEO's 2x2x2 aggregates lie in one tile of every driven B3-mf plan
    (128^3 and 64^3 in both dtypes); the stock SIZE_2 matching's level 0
    at 128^3 does not (B3-mf's two-launch route there)."""
    for n in (128, 64):
        agg, nc = geo_agg((n, n, n))
        ctab = children_table(torch.from_numpy(agg), nc)
        for apps in (6, 2):
            plan = TL.plan_tiles((n,) * 3, apps, True)
            rows, offs = TL.restrict_lists(plan, ctab)
            assert sorted(rows.tolist()) == list(range(nc))
            assert int(offs[-1]) == nc and offs.shape[0] == \
                plan.blocks * plan.chunk + 1
    from chip_smoke import agg_config
    A = pt.gallery.poisson("7pt", 128, 128, 128, dtype=torch.float32,
                           device="cpu").init()
    cfg = agg_config(pt.Config, "agg-pcg")
    _, scope = cfg.get_solver("preconditioner")
    sel = pt.registry.aggregation_selectors.get("SIZE_2")(cfg, scope)
    agg, nc = sel.set_aggregates(A)
    xfer = build_transfer_tables(A, agg, nc)
    plan = TL.plan_tiles((128,) * 3, 4, True)
    assert TL.restrict_lists(plan, xfer["ctab"]) is None


def test_planner_raises_naming_the_shape():
    with pytest.raises(ValueError, match=r"\(40, 40, 40\)"):
        TL.plan_tiles((40, 40, 40), TL.STAR_MAX_APPS + 1)
    with pytest.raises(ValueError, match=r"\(40, 40, 1\)"):
        TL.plan_tiles((40, 40, 1), 2)
    assert not TL.star_fits(TL.STAR, (8, 8, 1), 2)
    assert not TL.star_fits(TL.STAR, (8, 8, 8), TL.STAR_MAX_APPS + 1)


def test_the_launch_geometry_mirrors_the_plan():
    """The kernel's parameter block carries the plan's tiling."""
    plan = TL.plan_tiles((64, 64, 64), 6, True)
    g = K.geom_arg(plan)
    assert (g.tx, g.ty, g.tz, g.apps, g.steps) == (*plan.tile, plan.chunk,
                                                   6, 5)
    assert (g.tiles_x, g.tiles_y) == plan.grid[:2]
    assert K.geom_arg(plan) is g
