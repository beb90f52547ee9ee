"""Tile plans of the temporally blocked smoother kernels (B2-mf, B3-mf,
B4-mf and the slab B2, B3, B4: csrc/stencil_tb.cuh), and a plain
tile-by-tile emulation of them.

One launch runs every damped step of a call (and B2's residual, B3's
residual and restriction) on a 7-point star grid level: each block owns
an x-y tile of the grid and a chunk of its z planes, loads its tile plus
a halo, and marches along z through its chunk, one plane a step, keeping
for every time level a ring of three planes in shared memory (2.5-D
spatial and temporal blocking). Time level t (t = 0: x as read, t =
steps: x') is computed on the tile grown by apps - t points per axis, so
the last application needs nothing from outside the block. One thread
owns each column of the grown tile (so the tile plus its halo holds at
most 1024 columns), and each level lags the one below by one plane, so
a step reads only values of earlier steps: one barrier a step. The kernel has
the applications compiled in, at most STAR_MAX_APPS; `star_fits` says
whether it takes a level and a schedule. Any other stencil or a longer
schedule of B3 / B4 launches dia.cu's per-step kernels
(ops/cuda_spmv.py); B2 / B2-mf split a longer one over several launches.

- `plan_tiles`: the tile's x-y extent, the z chunk, the shared-memory
  bytes, the threads and the block count for a grid shape, a number
  of applications and the value source (the coefficients, or a stored
  slab staged in a shared ring: `ring` floats a row). It picks the
  tiling the cost model below finds fastest on the card (every step's
  barrier and every time level's point updates over every block, by
  waves of resident blocks) within the 227 KB and 1024 threads a Hopper
  block may use, and raises where the kernel does not take the
  schedule, naming the shape.
- `plan_calls`: a slab call's launches. Each launch streams the value
  slab once, and its halo and value ring grow with its applications, so
  a call splits its applications over the fewest launches of at most
  SLAB_MAX_APPS each, as evenly as may be (3 + 3 for six, 3 + 2 for
  five): the splits the card measured fastest (PERF.md). With `coef`, a
  B2-mf call's launches from the coefficients: at most COEF_MAX_APPS
  applications each, the split the card measured fastest for B2-mf.
  `split_plans` plans any other split (tests and tools/kernel_turns.py
  compare them).
- `restrict_lists`: for B3-mf, whether every coarse row of a children
  table `ctab` lies in one block (all children in one tile and one z
  chunk, over at most two adjacent planes) and, when it does, the
  coarse rows of each (block, plane) in the order the kernel sums them.
  True of GEO's 2x2x2 aggregates on tiles at even coordinates; a
  SIZE_2 matching's pairs cross tile edges, so B3-mf then writes x'
  and its float32 state and the untiled restriction launch follows.
- `emulate`: the kernel's computation in plain PyTorch, block by block
  (halo loads, shrinking time levels, the in-tile restriction in ctab
  order, the dot's block partials), from the coefficients or from a
  value slab; `emulate_calls` chains a split call's launches through
  their float32 state. The tests hold them to the untiled plain forms
  (ops/stencil.py `_xla_restrict`, `_xla_corr`; ops/cuda_spmv.py
  `dia_smooth_restrict_plain`, `dia_prolong_smooth_plain`) bit for bit.
  Nothing in the package calls them.

Plans are cached per (shape, applications, residual); restriction lists
per children table (weakly, by identity: the level's transfer tables
are built once per level).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.weak import WeakIdKeyDictionary

SMEM_BLOCK_MAX = 232448   # bytes of shared memory one Hopper block may use
SMEM_SM = 233472          # per SM; each resident block also reserves 1 KB
SMEM_STATIC = 256         # the kernel's static shared memory (the dot's)
MAX_THREADS = 1024        # columns of a block (stencil_tb.cuh kTbMaxThreads)
SM_THREADS = 2048         # resident threads per SM
SM_REGS = 65536           # registers per SM; the kernel takes at most 64
STAR_MAX_APPS = 6         # applications per launch (kTbStarApps)
MAX_KIDS = 8              # children of an in-tile coarse row (kTbStarKids)
SLAB_MAX_APPS = 3         # applications a slab launch takes (kTbSlabApps)
COEF_MAX_APPS = 3         # applications a B2-mf launch takes (kTbCoefApps;
                          # the fastest split, PERF.md §6)
# the 7-point star's grid shifts in ascending offset order
STAR = ((0, 0, -1), (0, -1, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0), (0, 1, 0),
        (0, 0, 1))
SMS = 132                 # streaming multiprocessors of an H100 SXM
_TILES = (64, 48, 32, 24, 20, 16, 12, 10, 8, 6, 4, 2)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch's tiling. `apps` applications of the stencil per tile:
    the damped steps, plus B3-mf's residual when `residual` (the
    restriction then runs in the tile). Block b covers the x-y tile
    (bx, by) and the z chunk bz, b = (bz * grid[1] + by) * grid[0] + bx."""

    shape: tuple          # (nx, ny, nz), x fastest
    apps: int
    residual: bool
    tile: tuple           # interior x-y extent (tx, ty)
    chunk: int            # z planes per block (tz)
    ring: int = 0         # slab floats a row staged in the shared ring
                          # (7 values + dinv); 0: the coefficient mode

    @property
    def steps(self) -> int:
        return self.apps - int(self.residual)

    @property
    def grid(self) -> tuple:
        (nx, ny, nz), (tx, ty) = self.shape, self.tile
        return (-(-nx // tx), -(-ny // ty), -(-nz // self.chunk))

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def threads(self) -> int:
        w, h = self.region(0)
        return -(-w * h // 32) * 32

    def region(self, t: int) -> tuple:
        """(width, height) of time level t's region in a block: the tile
        grown by apps - t points on each side (unclipped)."""
        g = self.apps - t
        return self.tile[0] + 2 * g, self.tile[1] + 2 * g

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.tile, self.apps, self.residual, self.ring)

    def origin(self, block: int) -> tuple:
        """(x0, y0, z0) of a block's interior."""
        gx, gy, _ = self.grid
        bx, rest = block % gx, block // gx
        by, bz = rest % gy, rest // gy
        return bx * self.tile[0], by * self.tile[1], bz * self.chunk

    def z_range(self, t: int, z0: int) -> tuple:
        """[lo, hi) of the planes time level t covers in the block whose
        chunk starts at z0 (clipped to the grid)."""
        nz, g = self.shape[2], self.apps - t
        return max(0, z0 - g), min(nz, min(nz, z0 + self.chunk) + g)


def smem_bytes(tile, apps, residual, ring=0) -> int:
    """Dynamic shared memory of one block: for each time level that feeds
    another application (0 .. apps - 1) a ring of 3 float32 planes of
    every column, 9 float32 planes of b for every column, B3's three
    residual planes of the interior, and for a slab launch apps + 1
    planes of `ring` floats (the row's values and dinv) of every
    column."""
    tx, ty = tile
    cols = (tx + 2 * apps) * (ty + 2 * apps)
    nbytes = apps * 3 * cols * 4 + 9 * cols * 4 \
        + (3 * tx * ty * 4 if residual else 0) \
        + (apps + 1) * ring * cols * 4
    return -(-nbytes // 16) * 16


def _cost(shape, apps, tile, chunk, smem, sms, slab=False):
    """Modelled time of one launch, in thread instructions of the busiest
    SM over its issue rate: every thread pays a step's load, barrier and
    level tests and the shift of its register windows (~20 + 10 apps
    instructions, + 16 for a slab's ring loads and stores) on each of the
    block's chunk + 3 apps steps, and each point update of level t (~25,
    + 8 for a slab's value reads) on the tile grown by apps - t points
    over its planes; ceil(blocks / SMs) blocks run on the busiest SM, at
    a rate that grows with its resident threads up to half an SM's
    (latency hiding across the per-step barriers)."""
    (nx, ny, nz), (tx, ty) = shape, tile
    blocks = -(-nx // tx) * -(-ny // ty) * -(-nz // chunk)
    threads = -(-(tx + 2 * apps) * (ty + 2 * apps) // 32) * 32
    per_sm = min(SMEM_SM // (smem + SMEM_STATIC + 1024),
                 SM_THREADS // threads, SM_REGS // (64 * threads))
    if per_sm < 1:
        return math.inf
    steps = min(nz, chunk) + 3 * apps
    work = steps * threads * (20 + 10 * apps + (16 if slab else 0))
    for t in range(1, apps + 1):
        g = apps - t
        work += (33 if slab else 25) * (
            min(nx, tx + 2 * g) * min(ny, ty + 2 * g)
            * min(nz, chunk + 2 * g))
    on_sm = -(-blocks // sms)
    rate = min(1.0, min(per_sm, on_sm) * threads / (SM_THREADS / 2))
    return on_sm * work / rate


def _axis_tiles(extent, options):
    """Even tile extents below the axis's extent, and the whole axis
    (even extents keep GEO's 2x2x2 aggregates inside one tile)."""
    return sorted({extent} | {e for e in options if e < extent})


def star_fits(shifts, shape, apps) -> bool:
    """Whether the tiled kernel takes a level and a schedule: the 7-point
    star's shifts in its order on a grid of at least two planes, at most
    STAR_MAX_APPS applications."""
    return tuple(tuple(s) for s in shifts) == STAR and shape[2] >= 2 \
        and apps <= STAR_MAX_APPS


@functools.lru_cache(maxsize=512)
def plan_tiles(shape, apps, residual=False, sms=SMS, tile=None,
               chunk=None, ring=0) -> TilePlan:
    """The fastest tiling by the cost model that fits a block's shared
    memory and threads (`tile` / `chunk` pin the x-y tile or the z
    chunk); with `ring`, a slab launch staging that many floats a row.
    Raises ValueError, naming the shape, where the kernel does not take
    the schedule or no tile fits."""
    shape = tuple(int(e) for e in shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"plan_tiles: grid {shape} is not an nx x ny x nz "
                         f"grid")
    if not 1 <= apps <= STAR_MAX_APPS or shape[2] < 2:
        raise ValueError(f"plan_tiles: the tiled kernel does not take "
                         f"{apps} applications on the grid {shape} (1.."
                         f"{STAR_MAX_APPS}, at least two planes)")
    if residual and apps < 2:
        raise ValueError("plan_tiles: the residual follows at least one "
                         "step")
    if ring and apps > SLAB_MAX_APPS:
        raise ValueError(f"plan_tiles: a slab launch takes at most "
                         f"{SLAB_MAX_APPS} applications, not {apps}")
    nx, ny, nz = shape
    tiles = [tile] if tile is not None else [
        (a, b) for a in _axis_tiles(nx, _TILES)
        for b in _axis_tiles(ny, _TILES)]
    chunks = [chunk] if chunk is not None else sorted(
        {nz} | set(range(2, nz, 2)))
    best = None
    for t in tiles:
        smem = smem_bytes(t, apps, residual, ring)
        cols = (t[0] + 2 * apps) * (t[1] + 2 * apps)
        if smem > SMEM_BLOCK_MAX - SMEM_STATIC or cols > MAX_THREADS:
            continue
        for z in chunks:
            cost = _cost(shape, apps, t, z, smem, sms, ring > 0)
            key = (cost, -t[0] * t[1], -z)
            if best is None or key < best[0]:
                best = (key, t, z)
    if best is None or best[0][0] == math.inf:
        raise ValueError(
            f"plan_tiles: no tile of the grid {shape} fits a block's "
            f"{SMEM_BLOCK_MAX - SMEM_STATIC} bytes of shared memory and "
            f"{MAX_THREADS} columns with {apps} applications")
    return TilePlan(shape, apps, bool(residual), best[1], best[2], ring)


def _parts(apps, k):
    """`apps` applications in k launches, as even as may be, the larger
    ones first."""
    q, r = divmod(apps, k)
    return tuple(q + (i < r) for i in range(k))


def split_plans(shape, parts, residual=False, sms=SMS, ring=7) -> tuple:
    """One tile plan a launch of a slab call split as `parts` (each
    launch's applications; the residual, when `residual`, in the last),
    each staging `ring` floats a row. Raises ValueError, naming the
    shape, where the kernel does not take a launch."""
    shape = tuple(int(e) for e in shape)
    return tuple(plan_tiles(shape, a, residual and i == len(parts) - 1,
                            sms, ring=ring) for i, a in enumerate(parts))


@functools.lru_cache(maxsize=512)
def plan_calls(shape, apps, residual=False, sms=SMS, dinv=False,
               coef=False) -> tuple:
    """The launches of a slab call of `apps` applications (the last one
    the residual when `residual`): the fewest launches of at most
    SLAB_MAX_APPS applications, as even as may be, the larger first
    (`split_plans`); `dinv` sizes the ring. With `coef`, a B2-mf call
    from the coefficients (no ring): launches of at most COEF_MAX_APPS.
    Any number of applications: a launch takes at most STAR_MAX_APPS, a
    call is split. Raises ValueError, naming the shape, where no tile
    fits."""
    most = COEF_MAX_APPS if coef else SLAB_MAX_APPS
    return split_plans(shape, _parts(apps, -(-apps // most)), residual, sms,
                       0 if coef else 7 + int(dinv))


# ---------------------------------------------------------------------------
# B3-mf's in-tile restriction
# ---------------------------------------------------------------------------

_LISTS = WeakIdKeyDictionary()


def _child_blocks(plan: TilePlan, ctab: torch.Tensor):
    """(valid, block, z) of every entry of ctab (m, nc)."""
    nx, ny, _ = plan.shape
    (tx, ty), tz = plan.tile, plan.chunk
    gx, gy, _ = plan.grid
    f = ctab.long()
    valid = f >= 0
    f = f.clamp(min=0)
    x, y, z = f % nx, (f // nx) % ny, f // (nx * ny)
    return valid, ((z // tz) * gy + y // ty) * gx + x // tx, z


def restrict_lists(plan: TilePlan, ctab: torch.Tensor):
    """(rows, offsets) on ctab's device when every coarse row of ctab lies
    in one block -- at most MAX_KIDS children, all in one tile and one z
    chunk, on at most two adjacent planes -- else None. rows (nc,) int32
    holds the coarse rows ordered by (block, zmax - z0), zmax the plane of
    the row's last child; those of block b and chunk plane l are
    rows[offsets[b * tz + l] : offsets[b * tz + l + 1]]. Cached per ctab
    (one host read of the verdict when built)."""
    key = (plan.shape, plan.tile, plan.chunk)
    per = _LISTS.get(ctab)
    if per is None:
        per = _LISTS[ctab] = {}
    if key in per:
        return per[key]
    if ctab.shape[0] > MAX_KIDS:
        per[key] = None
        return None
    valid, blk, z = _child_blocks(plan, ctab)
    first = blk[0]
    big = torch.iinfo(torch.int64).max
    zmax = torch.where(valid, z, -1).amax(0)
    zmin = torch.where(valid, z, big).amin(0)
    ok = (valid[0].all() & (~valid | (blk == first)).all()
          & (zmax - zmin <= 1).all())
    out = None
    if bool(ok):
        tz = plan.chunk
        k = first * tz + zmax % tz
        order = torch.argsort(k, stable=True)
        counts = torch.bincount(k, minlength=plan.blocks * tz)
        offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        out = (order.to(torch.int32), offsets.to(torch.int32))
    per[key] = out
    return out


# ---------------------------------------------------------------------------
# the tile-by-tile emulation (tests only)
# ---------------------------------------------------------------------------


def _grid3(v, shape):
    nx, ny, nz = shape
    return v.reshape(nz, ny, nx)


def emulate(plan: TilePlan, spec, coeffs, taus, b, x, xc=None, agg=None,
            ctab=None, with_dot=False, vals=None, dinv=None, state=False):
    """What the tiled kernel computes, block by block, in plain PyTorch.

    Each block loads x (+ xc[agg], summed in the compute dtype) on its
    level-0 region and chunk planes grown by the halo, computes time
    level t on the region and planes grown by apps - t points from level
    t - 1 alone (values outside the block's previous level are NaN, so a
    halo too small shows in the output), writes x' on its interior and,
    with `plan.residual`, sums each of its coarse rows' residuals in
    ctab order (`restrict_lists`), or without ctab keeps the residual of
    its interior rows (B3w's launch, which stores r for the restriction
    over R's rows; B2's and B2-mf's, which return it). With the dot,
    x'.b is summed per block over its interior and the blocks' partials
    added in block order (the kernel adds within a block in another
    order).

    The rows' values are the coefficients of `spec` (its dinv mode
    synthesizes the diagonal inverse), or with `vals` the (7, n) slab
    and the `dinv` vector (or none) of a slab level, read at the row
    being updated; either way an off-grid neighbour is skipped.

    Returns x', (x', bc) with the residual (or (x', r), r in the compute
    dtype, without ctab), or (x', dot); x' in x's dtype, or with `state`
    its float32 state unrounded (what a split call's next launch
    reads)."""
    from . import cuda_spmv
    from .stencil import _dinv_vec, _vec_masks
    from ..precision import compute_dtype
    nx, ny, nz = plan.shape
    if tuple(tuple(d) for d in spec.shifts) != STAR:
        raise ValueError("emulate: the tiled kernel takes the 7-point star")
    cdt = compute_dtype(x.dtype)
    taus = taus.to(cdt)
    x0 = x.to(cdt)
    if xc is not None:
        x0 = cuda_spmv.prolong_plain(x0, xc.to(cdt), agg)
    X0 = _grid3(x0, plan.shape)
    B = _grid3(b.to(cdt), plan.shape)
    masks = _vec_masks(spec, x.device)
    if vals is None:
        c = coeffs.to(cdt)
        V = [c[d].expand(nz, ny, nx) for d in range(len(spec.shifts))]
        dinv = _dinv_vec(spec, c, cdt, x.device, masks)
    else:
        V = [_grid3(v.to(cdt), plan.shape) for v in vals]
        dinv = None if dinv is None else dinv.to(cdt)
    D = None if dinv is None else _grid3(dinv, plan.shape)
    M = [None if mk is None else _grid3(mk, plan.shape) for mk in masks]
    nan = float("nan")
    out = torch.full((nz, ny, nx), nan, dtype=cdt)
    lists = restrict_lists(plan, ctab) \
        if plan.residual and ctab is not None else None
    if plan.residual and ctab is not None and lists is None:
        raise ValueError("emulate: the children table leaves the tiles")
    bc = None if ctab is None else torch.full((ctab.shape[1],), nan,
                                              dtype=cdt)
    rout = torch.full((nz, ny, nx), nan, dtype=cdt) \
        if plan.residual and ctab is None else None
    partials = []
    for blk in range(plan.blocks):
        xo, yo, zo = plan.origin(blk)
        x1, y1 = min(nx, xo + plan.tile[0]), min(ny, yo + plan.tile[1])

        def box(t):
            g = plan.apps - t
            lo, hi = plan.z_range(t, zo)
            return (slice(lo, hi), slice(max(0, yo - g), min(ny, y1 + g)),
                    slice(max(0, xo - g), min(nx, x1 + g)))

        prev = torch.full((nz, ny, nx), nan, dtype=cdt)
        prev[box(0)] = X0[box(0)]
        res = None
        for t in range(1, plan.apps + 1):
            bz, by, bx = box(t)
            P = torch.nn.functional.pad(prev, (1, 1, 1, 1, 1, 1))
            acc = torch.zeros(X0[bz, by, bx].shape, dtype=cdt)
            for d, (dx, dy, dz) in enumerate(spec.shifts):
                nb = P[bz.start + dz + 1:bz.stop + dz + 1,
                       by.start + dy + 1:by.stop + dy + 1,
                       bx.start + dx + 1:bx.stop + dx + 1]
                cd = V[d][bz, by, bx]
                if M[d] is not None:
                    cd = torch.where(M[d][bz, by, bx], cd,
                                     torch.zeros_like(cd))
                acc = torch.addcmul(acc, cd, nb)
            if plan.residual and t == plan.apps:
                res = torch.full((nz, ny, nx), nan, dtype=cdt)
                res[bz, by, bx] = B[bz, by, bx] - acc
                break
            cur = torch.full((nz, ny, nx), nan, dtype=cdt)
            cur[bz, by, bx] = cuda_spmv.damped_update(
                prev[bz, by, bx], taus[t - 1], B[bz, by, bx] - acc,
                None if D is None else D[bz, by, bx])
            prev = cur
        zs = slice(zo, min(nz, zo + plan.chunk))
        inner = (zs, slice(yo, y1), slice(xo, x1))
        out[inner] = prev[inner]
        if with_dot:
            partials.append((prev[inner] * B[inner]).sum())
        if rout is not None:
            rout[inner] = res[inner]
        elif res is not None:
            rows, offs = lists
            k0 = blk * plan.chunk
            mine = rows[int(offs[k0]):int(offs[k0 + plan.chunk])].long()
            r = res.reshape(-1)
            acc = torch.zeros(mine.shape[0], dtype=cdt)
            for j in range(ctab.shape[0]):
                f = ctab[j, mine].long()
                acc = acc + torch.where(f >= 0, r[f.clamp(min=0)],
                                        torch.zeros_like(acc))
            bc[mine] = acc
    xout = out.reshape(-1) if state else out.reshape(-1).to(x.dtype)
    if rout is not None:
        return xout, rout.reshape(-1)
    if plan.residual:
        return xout, bc.to(x.dtype)
    if with_dot:
        dot = torch.zeros((), dtype=cdt)
        for p in partials:
            dot = dot + p
        return xout, dot
    return xout


def emulate_calls(plans, spec, coeffs, taus, b, x, xc=None, agg=None,
                  ctab=None, with_dot=False, vals=None, dinv=None,
                  resid_io=False):
    """A call split over the launches `plans` (`plan_calls`): each launch
    runs its share of the steps from the state the one before left
    (float32, unrounded), the first adds the correction xc[agg], the
    last writes x' in x's dtype (and the residual's bc, or without ctab
    the residual itself: unrounded for B3w, rounded once to x's dtype
    with `resid_io` for B2 / B2-mf; or the dot)."""
    at, state = 0, x
    for i, plan in enumerate(plans):
        last = i == len(plans) - 1
        got = emulate(plan, spec, coeffs, taus[at:at + plan.steps], b,
                      state, xc if i == 0 else None,
                      agg if i == 0 else None, ctab if last else None,
                      with_dot and last, vals, dinv, state=not last)
        at += plan.steps
        if last:
            # x' and bc round once, at the end (bf16 has no dot); B2's r
            # (`resid_io`) too, B3w's stays float32
            if not isinstance(got, tuple):
                return got.to(x.dtype)
            if ctab is None and not resid_io:
                return got[0].to(x.dtype), got[1]
            return got[0].to(x.dtype), got[1].to(x.dtype)
        state = got
