"""The coarse-tail kernel (B5) with its plain PyTorch twin.

Replaces `_dia_coarse_tail_call` (amgx_tpu/ops/pallas_spmv.py:1892; body
`_tail_compute`, :1769): the whole multigrid sub-cycle from an entry
level down -- per level the pre-sweeps, the residual, the child-gather
restriction, the V/W/F recursion, at the coarsest level a product with
DENSE_LU's explicit inverse (or nothing for NOSOLVER), the aggregate
gather and correction, the post-sweeps -- optionally with x'.b of the
entry level's result (PCG's r.z when the whole cycle is the tail).

Layout (the port's own; the TPU kernel's lane padding and quota slabs
are not carried over): `spec` is a TailSpec of per-level TailLevelSpecs
(offsets, n, n_pre, n_post, has_dinv, nc, m, mf) and the coarse kind
("inv" or "none", nz); `arrs` holds one dict per level -- "vals" (k, n),
"dinv" (n,) or None, "coeffs" None, "taus_pre" (n_pre,), "taus_post"
(n_post,), "ctab" (m, nc) int32, "agg" (n,) int32 -- and, for kind
"inv", a last dict {"inv": (nz, nz)}. Level l's coarse size nc is level
l + 1's n.

A matrix-free level (the coefficient mode: `mf` is the level's
ops/stencil.py StencilSpec, `_tail_compute`'s `level_vals` branch) has
"vals" and "dinv" None and "coeffs" its (k,) float32 coefficients; the
kernel and the plain twin synthesize its values and diagonal inverse
(`mf.dinv`) from them. Such launches count in "dia_coarse_tail_mf"
(+ "_dot") when any level of the tail is matrix-free.

bfloat16 (the reduced-precision cycle): "vals", "dinv", b and x are
bf16, "coeffs", the damping factors and "inv" float32. As
`_tail_compute` does, the whole sub-cycle runs in float32 (b and x
widened at entry, the slabs at use) and only the result is rounded back
to bf16; such launches count in "dia_coarse_tail_bf16" (or
"dia_coarse_tail_mf_bf16"). The x'.b form is float32 only.

The CUDA kernel (csrc/tail.cu) is one cooperative launch walking a phase
program that `tail_program` flattens from the recursion once per
(hierarchy, shape, dot); the program, the per-level pointer tables and
a workspace holding every tail level's b and x are built at the first
launch and cached with the arrays they point into. What bounds it is
the chain of dependent phases (one grid barrier each), not bytes:
`len(tail_program(spec))` is the count. Launches count in
`cuda_spmv.LAUNCHES["dia_coarse_tail"]`, those that return the dot in
"dia_coarse_tail_dot".
"""
from __future__ import annotations

import collections
import ctypes
import functools
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import cuda_spmv as _k
from . import stencil as _st
from .cuda_spmv import _check, _launch, _ptr, _stream

TailLevelSpec = collections.namedtuple(
    "TailLevelSpec", "offsets n n_pre n_post has_dinv nc m mf",
    defaults=(None,))
TailSpec = collections.namedtuple("TailSpec", "shape levels coarse")

# phase program (csrc/tail.cu): rows of (op, level, src slot, dst slot,
# tau index, next level's slot, flags)
OP_STEP, OP_RESTRICT, OP_COARSE, OP_CORRECT, OP_DOT = range(5)
S_A, S_B, S_IN, S_Z = range(4)
F_POST, F_CORRECTED, F_DOT, F_OUT = 1, 2, 4, 8
# per-level pointer table: these arrays, then the workspace's b, x_A, x_B
_PTR_FIELDS = ("vals", "dinv", "coeffs", "taus_pre", "taus_post", "ctab",
               "agg")

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("tail.cu")
    lib.amgx_tail_grid.argtypes = [_I, ctypes.POINTER(_I)]
    lib.amgx_dia_coarse_tail.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _P,
                                         _I, _P, _P, _P, _I, _P, _P, _I, _P]
    for fn in (lib.amgx_tail_grid, lib.amgx_dia_coarse_tail):
        fn.restype = _I
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch version (`_tail_compute`, step for step)
# ---------------------------------------------------------------------------


def level_vals(ls, ar):
    """(vals (k, n), dinv or None) of one tail level in float32 or wider:
    its slab (a bf16 one widened), or the rows and diagonal inverse
    synthesized from its stencil."""
    if ls.mf is None:
        return _k._up(ar["vals"], ar["dinv"])
    c = ar["coeffs"]
    masks = _st._vec_masks(ls.mf, c.device)
    return (_st.slab_of(ls.mf, c, masks),
            _st._dinv_vec(ls.mf, c, c.dtype, c.device, masks))


def dia_coarse_tail_plain(spec, arrs, b, x, with_dot=False):
    levels = spec.levels
    dt = x.dtype
    b, x = _k._up(b, x)

    def run(shape, i, bc, s):
        ls, ar = levels[i], arrs[i]
        vals, dinv = level_vals(ls, ar)
        s = _k.dia_smooth_plain(vals, ls.offsets, ar["taus_pre"], bc, s,
                                dinv, with_residual=False)
        r = bc - _k.dia_spmv_plain(vals, ls.offsets, s)
        coarse_b = _k.restrict_plain(ar["ctab"], r)
        if i + 1 < len(levels):
            xc = run(shape, i + 1, coarse_b, torch.zeros_like(coarse_b))
            if shape == "W":
                xc = run("W", i + 1, coarse_b, xc)
            elif shape == "F":
                xc = run("V", i + 1, coarse_b, xc)
        elif spec.coarse[0] == "inv":
            xc = arrs[-1]["inv"] @ coarse_b
        else:                       # NOSOLVER: no coarse correction
            xc = torch.zeros_like(coarse_b)
        s = s + xc[ar["agg"].long()]
        return _k.dia_smooth_plain(vals, ls.offsets, ar["taus_post"], bc, s,
                                   dinv, with_residual=False)

    out = run(spec.shape, 0, b, x).to(dt)
    return (out, torch.dot(out, b)) if with_dot else out


# ---------------------------------------------------------------------------
# the phase program
# ---------------------------------------------------------------------------


def tail_program(spec, with_dot=False, half=False):
    """The recursion of `dia_coarse_tail_plain` flattened into phases
    (lists of 7 ints), in the order the kernel runs them; a grid barrier
    separates each phase from the next. With `half` (bf16 operands) the
    entry level's last write also stores the bf16 result (F_OUT)."""
    levels = spec.levels
    cur = [S_IN] + [S_A] * (len(levels) - 1)     # slot holding each x
    prog = []

    def write(op, l, tau=0, nxt=0, flags=0):
        dst = S_B if cur[l] == S_A else S_A
        prog.append([op, l, cur[l], dst, tau, nxt, flags])
        cur[l] = dst

    def run(shape, l):
        ls = levels[l]
        for t in range(ls.n_pre):
            write(OP_STEP, l, t)
        prog.append([OP_RESTRICT, l, cur[l], 0, 0, 0, 0])
        if l + 1 < len(levels):
            cur[l + 1] = S_A                     # zeroed by the restriction
            run(shape, l + 1)
            if shape == "W":
                run("W", l + 1)
            elif shape == "F":
                run("V", l + 1)
            nxt = cur[l + 1]
        else:
            prog.append([OP_COARSE, l, 0, 0, 0, 0, 0])
            nxt = S_Z
        if ls.n_post == 0:
            write(OP_CORRECT, l, nxt=nxt, flags=F_CORRECTED)
        for t in range(ls.n_post):
            write(OP_STEP, l, t, nxt,
                  F_POST | (F_CORRECTED if t == 0 else 0))

    run(spec.shape, 0)
    if prog[-1][3] == S_B:
        # the entry level's last write must land in slot A (the output)
        swap = {S_A: S_B, S_B: S_A, S_IN: S_IN}
        for row in prog:
            if row[1] == 0 and row[0] != OP_COARSE:
                row[2], row[3] = swap[row[2]], swap[row[3]]
    if with_dot:
        prog[-1][6] |= F_DOT
        prog.append([OP_DOT, 0, 0, 0, 0, 0, 0])
    if half:
        prog[-1][6] |= F_OUT
    return prog


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

# per entry level's child table: {(spec, with_dot): _CardPlan}
_PLANS = WeakIdKeyDictionary()


def _held(arrs):
    return tuple(t for ar in arrs for _, t in sorted(ar.items()))


def _same(refs, held):
    """Do the weak references in `refs` point at exactly `held`?"""
    return len(refs) == len(held) and all(
        (r is None and t is None) or (r is not None and r() is t)
        for r, t in zip(refs, held))


class _CardPlan:
    """The program, pointer tables and workspace of one tail on the card.
    It refers to the arrays its tables point into weakly (the caller
    holds them while it launches), so a dropped hierarchy frees both."""

    def __init__(self, spec, arrs, with_dot, half, device):
        L = len(spec.levels)
        nz = spec.coarse[1]
        f32 = dict(dtype=torch.float32, device=device)
        self.refs = tuple(None if t is None else weakref.ref(t)
                          for t in _held(arrs))
        self.work = []
        ptrs, ints = [], []
        for l, (ls, ar) in enumerate(zip(spec.levels, arrs)):
            n, k = ls.n, len(ls.offsets)
            want_nc = spec.levels[l + 1].n if l + 1 < L else nz
            if ls.nc != want_nc or tuple(ar["ctab"].shape) != (ls.m, ls.nc):
                raise ValueError(f"dia_coarse_tail: level {l} restricts to "
                                 f"{ls.nc} rows, the next level has "
                                 f"{want_nc}")
            mf = ls.mf
            if (mf is None) != (ar["coeffs"] is None) or (
                    mf is None) == (ar["vals"] is None) or (
                    mf is not None and (ar["dinv"] is not None
                                        or mf.n != n or mf.shape[0]
                                        * mf.shape[1] * mf.shape[2] != n)):
                raise ValueError(f"dia_coarse_tail: level {l} needs a value "
                                 f"slab or (with its stencil) coefficients")
            _check("dia_coarse_tail", ls.offsets, n,
                   {"vals": (ar["vals"], (k, n)), "dinv": (ar["dinv"], (n,))},
                   {"ctab": (ar["ctab"], (ls.m, ls.nc)),
                    "agg": (ar["agg"], (n,))},
                   {"coeffs": (ar["coeffs"], (k,)),
                    "taus_pre": (ar["taus_pre"], (ls.n_pre,)),
                    "taus_post": (ar["taus_post"], (ls.n_post,))},
                   bf16_ok=True)
            for f in ("vals", "dinv"):
                if ar[f] is not None and (ar[f].dtype == torch.bfloat16) \
                        != half:
                    raise TypeError(f"dia_coarse_tail: level {l}'s {f} is "
                                    f"{ar[f].dtype}, the vectors are "
                                    f"{'bf16' if half else 'float32'}")
            ws = [torch.empty(n, **f32) if l > 0 else None,      # b
                  torch.empty(n, **f32) if l > 0 or half         # x_A
                  else None,
                  torch.empty(n, **f32)]                         # x_B
            self.work += [w for w in ws if w is not None]
            if l == 0:
                # half: level 0's slot A, the float32 state the program's
                # last write also rounds into the bf16 output
                self.xa0 = ws[1]
            ptrs.append([_ptr(ar[f]) or 0 for f in _PTR_FIELDS]
                        + [_ptr(w) or 0 for w in ws])
            pad = [0] * (_k.MAX_OFFSETS - k)
            geo = [0] * 9 if mf is None else [
                *mf.shape, mf.diag_rank, _k._DINV_MODE[mf.dinv],
                *_int32_div(mf.shape[0]), *_int32_div(mf.shape[1])]
            shifts = [[0] * k] * 3 if mf is None else [
                [sh[a] for sh in mf.shifts] for a in range(3)]
            ints.append([n, k, ls.m, ls.nc, *geo, *ls.offsets, *pad]
                        + [v for axis in shifts for v in axis + pad])
        self.inv = arrs[-1]["inv"] if spec.coarse[0] == "inv" else None
        if self.inv is not None:
            _check("dia_coarse_tail", None, nz,
                   {"inv": (self.inv, (nz, nz))})
        self.bz, self.xz = torch.empty(nz, **f32), torch.empty(nz, **f32)
        prog = tail_program(spec, with_dot, half)
        self.nops = len(prog)
        self.prog = torch.tensor(prog, dtype=torch.int32, device=device)
        self.ptrs = torch.tensor(ptrs, dtype=torch.int64, device=device)
        self.ints = torch.tensor(ints, dtype=torch.int32, device=device)
        grid = ctypes.c_int(0)
        rc = _lib().amgx_tail_grid(spec.levels[0].n, ctypes.byref(grid))
        if rc != 0:
            raise RuntimeError(
                f"dia_coarse_tail: no cooperative grid on {device} (code "
                f"{rc}; -2 = no cooperative launch, -3 = the kernel fits "
                f"no block on an SM, else a cudaError_t)")
        self.grid = grid.value
        self.partials = torch.empty(self.grid, **f32)


def _int32_div(d):
    """fast_div(d) as two int32 table entries (mul's bits, shr)."""
    mul, shr = _k.fast_div(d)
    return (mul - (1 << 32) if mul >= 1 << 31 else mul), shr


def _card_plan(spec, arrs, with_dot, half, device):
    plans = _PLANS.setdefault(arrs[0]["ctab"], {})
    key = (spec, with_dot, half)
    plan = plans.get(key)
    if plan is None or not _same(plan.refs, _held(arrs)):
        plan = plans[key] = _CardPlan(spec, arrs, with_dot, half, device)
    return plan


def dia_coarse_tail(spec, arrs, b, x, with_dot=False):
    """B5: the tail sub-cycle from the entry level's (b, x), float32 or
    bfloat16. Returns x', or (x', x'.b) with `with_dot` (a 0-dim float32
    tensor; float32 only)."""
    if x.device.type == "cpu":
        return dia_coarse_tail_plain(spec, arrs, b, x, with_dot)
    n = spec.levels[0].n
    half = x.dtype == torch.bfloat16
    if half and with_dot:
        _k.bf16_not_ported("dia_coarse_tail", "the x.b dot epilogue")
    _check("dia_coarse_tail", None, n, {"b": (b, (n,)), "x": (x, (n,))},
           bf16_ok=True)
    name = "dia_coarse_tail" + (
        "_mf" if any(ls.mf is not None for ls in spec.levels) else "") + (
        "_dot" if with_dot else "") + ("_bf16" if half else "")
    with torch.cuda.device(x.device):
        plan = _card_plan(spec, arrs, with_dot, half, x.device)
        out = torch.empty_like(x)
        dot = torch.empty((), dtype=torch.float32, device=x.device) \
            if with_dot else None
        _launch(name,
                _lib().amgx_dia_coarse_tail,
                _ptr(plan.prog), plan.nops, _ptr(plan.ptrs),
                _ptr(plan.ints), len(spec.levels), _ptr(b), _ptr(x),
                _ptr(plan.xa0 if half else out), _ptr(out) if half else None,
                int(half), _ptr(plan.bz), _ptr(plan.xz), _ptr(plan.inv),
                spec.coarse[1], _ptr(plan.partials), _ptr(dot), plan.grid,
                _stream())
    return (out, dot) if with_dot else out
