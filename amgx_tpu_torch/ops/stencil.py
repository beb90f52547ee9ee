"""Matrix-free stencil operators for constant-coefficient GEO levels (the
port of amgx_tpu/ops/stencil.py).

A GEO hierarchy built from a constant-coefficient grid operator (the
gallery's Poisson stencils and every level the structured Galerkin
product derives from them) stores a DIA value slab that holds one
scalar per diagonal, repeated on its in-grid rows, and zeros where the
grid shift leaves the grid. The smoother kernels stream that slab on
every step; from k coefficients they stream only the vectors.

- `StencilOperator`: the solve-data payload -- a (k,) coefficient tensor
  on the level's device, the same k values as host floats (the CUDA
  kernels take them by value), and the static geometry (offsets, grid
  shifts, grid shape) with the smoother's diagonal-inverse mode.
- `detect_stencil`: the setup-time check -- one compare per level (every
  in-grid entry equals its diagonal's anchor value, every off-grid entry
  is zero) and one host read of a flag and the k coefficients.
- The plain masked forms (`_apply_vec`, `_dinv_vec`, `_xla_smooth`,
  `_xla_restrict`, `_xla_corr`): the CPU route and the kernels' plain
  versions. They apply each diagonal as the slab forms of
  `ops/cuda_spmv.py` do, with the masked coefficient in place of the
  stored row, so the two agree bit for bit on the same level.
  `_apply_vec` and `_xla_smooth` also take a batch: x (B, n) and the
  coefficients (k,) shared or (B, k) (a multi-matrix batch's per-system
  stencils; K2's plain version, ops/cuda_batched.py).
- The dispatch (`stencil_fused_smooth`, `stencil_smooth_restrict`,
  `stencil_corr_smooth`): float32 and bfloat16 (`SMOOTH_DTYPES`) through
  the coefficient-mode kernels of `ops/cuda_spmv.py` (B2-mf, B3-mf,
  B4-mf; their plain versions on the CPU), every other dtype through the
  plain forms on any device, as the JAX package sends everything but its
  kernel dtypes to XLA. The Hopper kernels run any number of steps, so
  the TPU's plan chunking is gone. Damping factors travel in the compute
  dtype (float32 for bf16 operands).
- bfloat16 (a reduced-precision cycle): the coefficients are the level's
  bf16 values; the plain forms widen them, b and x to float32, keep the
  state float32 from step to step and round only x', r and bc, as the
  TPU's Pallas kernels do (B4-mf's x + xc[agg] is summed in float32 and
  not rounded before the first step; the JAX package's XLA twin rounds
  it).
- `stencil_dia_vals` / `stencil_matrix` / `level_operator`: the
  equivalent (k, n) slab, rebuilt per use for the consumers that need a
  matrix (the cycle's residual on a level without pre-sweeps).

Routing policy lives in amg/hierarchy.py (`matrix_free=auto|0|1`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..precision import SMOOTH_DTYPES, compute_dtype
from . import cuda_spmv

# Hashable static twin of a StencilOperator (everything but the
# coefficients). `dinv` is None | "jacobi" | "l1"; `diag_rank` is the
# index of offset 0 (-1 when absent).
StencilSpec = collections.namedtuple(
    "StencilSpec", "offsets shifts shape n dinv diag_rank")

DINV_MODES = (None, "jacobi", "l1")


@dataclasses.dataclass(frozen=True, eq=False)
class StencilOperator:
    """Constant-coefficient grid operator: A[i, i+offsets[t]] = coeffs[t]
    wherever the grid shift stays in-grid, 0 elsewhere."""

    coeffs: torch.Tensor               # (k,) on the level's device
    host: tuple                        # the same k values, Python floats
    offsets: tuple                     # linear DIA offsets, ascending
    shifts: tuple                      # ((dx, dy, dz),) per offset
    shape: tuple                       # (nx, ny, nz), x fastest
    num_rows: int
    dinv_mode: Optional[str] = None    # None | "jacobi" | "l1"
    diag_rank: int = -1

    @property
    def k(self) -> int:
        return len(self.offsets)

    def spec(self) -> StencilSpec:
        return StencilSpec(self.offsets, self.shifts, self.shape,
                           self.num_rows, self.dinv_mode, self.diag_rank)


def _anchor_index(shift, shape) -> int:
    """First linear row index where `shift` stays in-grid -- the row the
    detector reads each diagonal's candidate coefficient from."""
    nx, ny, _nz = shape
    dx, dy, dz = shift
    return (max(0, -dz) * ny + max(0, -dy)) * nx + max(0, -dx)


def _grid_coords(n, shape, device):
    nx, ny, _nz = shape
    ix = torch.arange(n, device=device)
    return ix % nx, (ix // nx) % ny, ix // (nx * ny)


def _in_grid(shifts, shape, n, device):
    """Per-shift (n,) masks: where row i's grid shift stays in-grid."""
    nx, ny, nz = shape
    gx, gy, gz = _grid_coords(n, shape, device)
    return [((gx + dx >= 0) & (gx + dx < nx) & (gy + dy >= 0)
             & (gy + dy < ny) & (gz + dz >= 0) & (gz + dz < nz))
            for dx, dy, dz in shifts]


def stencil_candidate(vals2d, shifts, shape):
    """(is_const, coeffs) for a (k, n) DIA value table, both on its
    device: coeffs[t] is diagonal t's anchor-row value; is_const holds
    iff every in-grid entry equals it and every off-grid entry is zero
    (which subsumes the GEO wrap check)."""
    n = vals2d.shape[1]
    coeffs, flags = [], []
    for t, ok in enumerate(_in_grid(shifts, shape, n, vals2d.device)):
        # a shift that is in-grid nowhere reads the last row (0 there),
        # as the JAX package's clamped index does
        c = vals2d[t, min(_anchor_index(shifts[t], shape), n - 1)]
        coeffs.append(c)
        flags.append(torch.where(ok, vals2d[t] == c, vals2d[t] == 0).all())
    return torch.stack(flags).all(), torch.stack(coeffs)


def off_grid_zero(vals2d, shifts, shape):
    """Whether a (k, n) DIA value table stores 0 at every entry whose
    grid shift leaves the grid (the off-grid half of
    `stencil_candidate`): a 0-dim bool tensor on its device. A periodic
    coupling across the grid's edge fails it."""
    n = vals2d.shape[1]
    return torch.stack([(ok | (vals2d[t] == 0)).all() for t, ok in
                        enumerate(_in_grid(shifts, shape, n,
                                           vals2d.device))]).all()


def stencil_shifts(offsets, shape):
    """Per-offset (dx, dy, dz) grid shifts, or None when any offset is
    not a small stencil shift of `shape`."""
    from ..amg.aggregation.galerkin import _decompose
    nx, ny, nz = shape
    shifts = []
    for d in offsets:
        g = _decompose(int(d), nx, ny, nz)
        if g is None:
            return None
        shifts.append(g)
    return tuple(shifts)


def detect_stencil(A, dinv_mode: Optional[str] = None):
    """StencilOperator for a constant-coefficient DIA grid operator, or
    None (variable coefficients, no DIA view or grid annotation, a
    non-square matrix, non-stencil offsets). One compare on the
    operator's device and one host read of the flag and the k
    coefficients."""
    if dinv_mode not in DINV_MODES:
        raise ValueError(f"detect_stencil: dinv_mode {dinv_mode!r} is not "
                         f"one of {DINV_MODES}")
    if A.dia_offsets is None or A.dia_vals is None or A.grid_shape is None \
            or A.num_rows != A.num_cols:
        return None
    shape = tuple(int(s) for s in A.grid_shape)
    if len(shape) != 3 or shape[0] * shape[1] * shape[2] != A.num_rows:
        return None
    shifts = stencil_shifts(A.dia_offsets, shape)
    if shifts is None:
        return None
    ok, coeffs = stencil_candidate(A.dia_vals, shifts, shape)
    host = torch.cat([ok.to(coeffs.dtype)[None], coeffs]).cpu().tolist()
    if not host[0]:
        return None
    offsets = tuple(int(d) for d in A.dia_offsets)
    if dinv_mode is not None and 0 not in offsets:
        return None             # a dinv needs the diagonal
    return StencilOperator(
        coeffs=coeffs, host=tuple(host[1:]), offsets=offsets, shifts=shifts,
        shape=shape, num_rows=int(A.num_rows), dinv_mode=dinv_mode,
        diag_rank=offsets.index(0) if 0 in offsets else -1)


_SLIM = WeakIdKeyDictionary()


def mf_slim(A):
    """Solve-phase view of a matrix-free level's operator: A without its
    DIA value slab, so nothing streams it by accident (`kernel_ok`
    rejects it, a stray spmv fails). Memoized per operator: the cycle's
    plan caches key on the identity of each level's A."""
    if A.dia_vals is None:
        return A
    slim = _SLIM.get(A)
    if slim is None:
        slim = _SLIM[A] = dataclasses.replace(A, dia_vals=None)
    return slim


# ---------------------------------------------------------------------------
# plain masked-coefficient forms (the CPU route and the kernels' plain
# versions)
# ---------------------------------------------------------------------------


def _vec_masks(spec, device):
    """Per-offset in-grid masks on the (n,) vector layout (None where a
    shift stays in-grid on every row) -- the comparisons the kernels make
    per row."""
    nx, ny, nz = spec.shape
    gx, gy, gz = _grid_coords(spec.n, spec.shape, device)
    masks = []
    for (dx, dy, dz) in spec.shifts:
        ok = None
        for g, s, e in ((gx, dx, nx), (gy, dy, ny), (gz, dz, nz)):
            if s:
                m = g >= -s if s < 0 else g < e - s
                ok = m if ok is None else ok & m
        masks.append(ok)
    return masks


def _rows(spec, coeffs, masks, t):
    """Diagonal t's (n,) value row: the coefficient where its shift stays
    in-grid, 0 elsewhere -- the row the slab would store ((B, n) for a
    batch's per-system coefficients (B, k))."""
    c = coeffs[..., t, None].expand(coeffs.shape[:-1] + (spec.n,))
    return c if masks[t] is None else torch.where(masks[t], c,
                                                  torch.zeros_like(c))


def _apply_vec(spec, coeffs, x, masks=None):
    """y = A x from the coefficients, one shifted multiply-add per
    diagonal over a zero-padded x (ops/cuda_spmv.py `dia_spmv_plain` with
    each stored row synthesized)."""
    masks = _vec_masks(spec, x.device) if masks is None else masks
    coeffs = coeffs.to(x.dtype)
    n = x.shape[-1]
    offs = spec.offsets
    left = max(0, -min(offs))
    xp = torch.nn.functional.pad(x, (left, max(0, max(offs))))
    y = torch.zeros_like(x)
    for t, o in enumerate(offs):
        y = torch.addcmul(y, _rows(spec, coeffs, masks, t),
                          xp[..., left + o:left + o + n])
    return y


def _dinv_vec(spec, coeffs, dtype, device, masks=None):
    """The smoother's diagonal inverse synthesized from the coefficients:
    safe_recip of the diagonal ("jacobi") or of the L1-strengthened
    diagonal ("l1", the off-diagonal magnitudes added in offset order);
    None when the smoother has none (Chebyshev)."""
    if spec.dinv is None:
        return None
    coeffs = coeffs.to(dtype)
    c0 = coeffs[..., spec.diag_rank, None].expand(coeffs.shape[:-1]
                                                  + (spec.n,))
    den = c0
    if spec.dinv == "l1":
        masks = _vec_masks(spec, device) if masks is None else masks
        l1 = torch.zeros(c0.shape, dtype=dtype, device=device)
        for t in range(len(spec.offsets)):
            if t != spec.diag_rank:
                l1 = l1 + _rows(spec, coeffs, masks, t).abs()
        den = c0 + torch.sign(c0) * l1
    return torch.where(den == 0, torch.zeros_like(den),
                       1 / torch.where(den == 0, torch.ones_like(den), den))


def stencil_spmv(st: StencilOperator, x):
    """y = A x from coefficients only (any dtype, any device)."""
    return _apply_vec(st.spec(), st.coeffs, x)


def _state(spec, coeffs, taus, b, x, masks):
    """The damped steps in the compute dtype of x: (state, b, coeffs)
    widened, nothing rounded."""
    x, b, coeffs, taus = (t.to(compute_dtype(x.dtype))
                          for t in (x, b, coeffs, taus))
    dinv = _dinv_vec(spec, coeffs, x.dtype, x.device, masks)
    for t in range(taus.shape[0]):
        x = cuda_spmv.damped_update(
            x, taus[t], b - _apply_vec(spec, coeffs, x, masks), dinv)
    return x, b, coeffs


def _xla_smooth(spec, coeffs, taus, b, x, with_residual, x0=None):
    """len(taus) damped steps x += (tau_t (b - A x)) dinv, then
    optionally r = b - A x: ops/cuda_spmv.py `dia_smooth_plain` on the
    synthesized rows. `x0`, when given, is the first step's x in the
    compute dtype (B4-mf's unrounded x + xc[agg])."""
    masks = _vec_masks(spec, x.device)
    dt = x.dtype
    s, b, coeffs = _state(spec, coeffs, taus, b, x if x0 is None else x0,
                          masks)
    if with_residual:
        return s.to(dt), (b - _apply_vec(spec, coeffs, s, masks)).to(dt)
    return s.to(dt)


def _xla_restrict(spec, coeffs, taus, b, x, ctab):
    """Smooth + unit-weight child-gather restriction: (x', bc), r from the
    unrounded state and bc rounded once."""
    masks = _vec_masks(spec, x.device)
    s, b32, c = _state(spec, coeffs, taus, b, x, masks)
    r = b32 - _apply_vec(spec, c, s, masks)
    return s.to(x.dtype), cuda_spmv.restrict_plain(ctab, r).to(x.dtype)


def _xla_corr(spec, coeffs, taus, b, x, xc, agg, with_dot=False):
    """Correction prologue (x + xc[agg], in the compute dtype) + smooth,
    and x'.b with `with_dot`."""
    cdt = compute_dtype(x.dtype)
    x0 = cuda_spmv.prolong_plain(x.to(cdt), xc.to(cdt), agg)
    x = _xla_smooth(spec, coeffs, taus, b, x, False, x0=x0)
    return (x, torch.dot(x, b)) if with_dot else x


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _kernel_dtype(x) -> bool:
    return x.dtype in SMOOTH_DTYPES


def stencil_fused_smooth(st: StencilOperator, taus, b, x,
                         with_residual=True):
    """x' (and r) after len(taus) damped steps from the coefficients:
    B2-mf for float32 and bfloat16, the plain form otherwise; a batch
    (B, n) through K2's coefficient mode. Always produces a result: there
    is no slab to fall back to."""
    taus = taus.to(compute_dtype(x.dtype))
    if taus.shape[0] < 1:
        if with_residual:
            return x, _xla_smooth(st.spec(), st.coeffs, taus, b, x,
                                  True)[1]
        return x
    if _kernel_dtype(x):
        if x.dim() == 2:
            from .cuda_batched import dia_smooth_mf_multi
            return dia_smooth_mf_multi(st, taus, b, x, with_residual)
        return cuda_spmv.dia_smooth_mf(st, taus, b, x, with_residual)
    return _xla_smooth(st.spec(), st.coeffs, taus, b, x, with_residual)


def stencil_smooth_restrict(st: StencilOperator, taus, b, x, xfer):
    """Presmooth + restriction epilogue from the coefficients: (x', bc)
    through B3-mf, or None when the level has no unit-weight transfer
    tables (the caller composes stencil_fused_smooth + the level's
    restriction)."""
    if xfer is None or "cwt" in xfer or taus.shape[0] < 1:
        return None
    taus = taus.to(compute_dtype(x.dtype))
    if _kernel_dtype(x):
        return cuda_spmv.dia_smooth_restrict_mf(st, taus, b, x, xfer["ctab"])
    return _xla_restrict(st.spec(), st.coeffs, taus, b, x, xfer["ctab"])


def stencil_corr_smooth(st: StencilOperator, taus, b, x, xc, xfer,
                        want_dot: bool = False):
    """Prolongation/correction prologue + postsmooth from the
    coefficients: x' from x + P xc through B4-mf (with `want_dot`, (x',
    x'.b) from its last launch), or None when the level has no
    unit-weight transfer tables."""
    if xfer is None or "ptab" in xfer or taus.shape[0] < 1:
        return None
    taus = taus.to(compute_dtype(x.dtype))
    if _kernel_dtype(x):
        return cuda_spmv.dia_prolong_smooth_mf(st, taus, b, x, xc,
                                               xfer["agg"],
                                               with_dot=want_dot)
    return _xla_corr(st.spec(), st.coeffs, taus, b, x, xc, xfer["agg"],
                     with_dot=want_dot)


def _b6_not_ported(name):
    raise NotImplementedError(
        f"{name}: the coefficient mode of B6 (`_dia_spmv_dot_call`) is not "
        f"ported yet (ROADMAP.md Queue B, B6)")


def stencil_spmv_pdot(st: StencilOperator, p, z, beta):
    """The coefficient mode of `spmv_pdot` (B6): not ported yet; the
    Krylov shell runs B6 on the user's matrix."""
    _b6_not_ported("stencil_spmv_pdot")


def stencil_spmv_ddot(st: StencilOperator, p, d, self_dot: bool = False):
    """The coefficient mode of `spmv_ddot` (B6's d / self_dot form): not
    ported yet."""
    _b6_not_ported("stencil_spmv_ddot")


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------


def slab_of(spec, coeffs, masks=None):
    """The (k, n) DIA value slab of a stencil from its spec and
    coefficients."""
    masks = _vec_masks(spec, coeffs.device) if masks is None else masks
    return torch.stack([_rows(spec, coeffs, masks, t)
                        for t in range(len(spec.offsets))]).contiguous()


def stencil_dia_vals(st: StencilOperator, dtype=None):
    """The (k, n) DIA slab equivalent to the stencil, rebuilt per use."""
    return slab_of(st.spec(), st.coeffs if dtype is None
                   else st.coeffs.to(dtype))


def stencil_matrix(A_slim, st: StencilOperator):
    """A usable DIA matrix around materialized values (pairs with
    `mf_slim`)."""
    return dataclasses.replace(A_slim,
                               dia_vals=stencil_dia_vals(st, A_slim.dtype))


def level_operator(data):
    """The solve-phase operator of a level-data dict: a matrix-free level
    (slab dropped by `mf_slim`) rebuilds it from its stencil; everything
    else passes through."""
    A = data.get("A")
    st = data.get("stencil")
    if st is not None and A.dia_vals is None and A.dia_offsets is not None:
        return stencil_matrix(A, st)
    return A

