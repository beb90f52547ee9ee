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

The CUDA kernel (csrc/tail.cu) is one launch of a thread-block cluster
(up to MAX_CLUSTER blocks of 1024 threads, sized from what the card can
hold) walking a phase program that `tail_program` flattens from the
recursion once per (hierarchy, shape, dot), with the tail's vectors in
the cluster's distributed shared memory (`tail_layout`): a level wider
than BLOCK_ROWS is spread over the blocks, a narrower one held by block
0. The program and the per-level tables are built at the first launch
and cached with the arrays they point into. What bounds it is the chain
of dependent phases, not bytes: a phase on a wider level runs across the
cluster and ends at a cluster barrier, a phase on a narrower level runs
in block 0 alone and ends at a block barrier (`barrier_counts` gives the
two counts of a program). A tail whose vectors outgrow the cluster's
shared memory (`tail_fits`) is declined, as the JAX package declines a
tail that outgrows VMEM. Launches count in
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
# tau index, next level's slot, flags, the barrier after the phase)
OP_STEP, OP_RESTRICT, OP_COARSE, OP_CORRECT, OP_DOT = range(5)
S_A, S_B, S_IN, S_Z = range(4)
F_POST, F_CORRECTED, F_DOT, F_OUT, F_LOCAL = 1, 2, 4, 8, 16
BAR_NONE, BAR_BLOCK, BAR_CLUSTER = range(3)
# rows of a level that one 1024-thread block takes (one a thread): its
# phases run in block 0 alone
BLOCK_ROWS = 1024
TAIL_THREADS = 1024     # csrc/tail.cu kTailThreads
MAX_CLUSTER = 16        # csrc/tail.cu kMaxCluster
# per-level pointer table (csrc/tail.cu PtrField)
_PTR_FIELDS = ("vals", "dinv", "coeffs", "taus_pre", "taus_post", "ctab",
               "agg")
# the shared memory a block gives the tail's vectors (of its 227 KB, the
# rest for the level tables and the program)
VECTOR_BYTES = 192 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("tail.cu")
    _L = ctypes.c_longlong
    lib.amgx_tail_smem.argtypes = [_I, _I, _I]
    lib.amgx_tail_smem.restype = _L
    lib.amgx_tail_clusters.argtypes = [_I, _L, _I, ctypes.POINTER(_I)]
    lib.amgx_dia_coarse_tail.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _I,
                                         _P, _I, _I, _I, _I, _I, _P, _I, _L,
                                         _P, _P]
    lib.amgx_tail_barrier_probe.argtypes = [_I, _I, _I, _P]
    for fn in (lib.amgx_tail_clusters, lib.amgx_dia_coarse_tail,
               lib.amgx_tail_barrier_probe):
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


def tail_program(spec, with_dot=False, block_rows=BLOCK_ROWS):
    """The recursion of `dia_coarse_tail_plain` flattened into phases
    (lists of 8 ints), in the order the kernel runs them. A phase whose
    rows (its level's, the coarse size for COARSE) number at most
    `block_rows` is block-local (F_LOCAL: block 0 runs it alone), any
    other runs across the cluster; DOT is block-local. The entry level's
    last write also stores the result (F_OUT). The last column is the
    barrier after the phase: a block barrier between two block-local
    phases, a cluster barrier after every other phase but the last, and
    after the last one too when it runs across the cluster (no block may
    leave while another reads its shared memory)."""
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
    prog[-1][6] |= F_OUT
    if with_dot:
        prog[-1][6] |= F_DOT
        prog.append([OP_DOT, 0, 0, 0, 0, 0, 0])
    for row in prog:
        if row[0] == OP_DOT or _rows(spec, row) <= block_rows:
            row[6] |= F_LOCAL
    for row, after in zip(prog, prog[1:] + [None]):
        row.append(BAR_BLOCK if after is not None and row[6] & after[6]
                   & F_LOCAL
                   else BAR_NONE if after is None and row[6] & F_LOCAL
                   else BAR_CLUSTER)
    return prog


def _rows(spec, row):
    """The rows a phase covers: its level's, the coarse size for COARSE."""
    return spec.coarse[1] if row[0] == OP_COARSE else spec.levels[row[1]].n


def barrier_counts(prog):
    """(cluster barriers, block barriers) a launch of `prog` passes."""
    return (sum(row[7] == BAR_CLUSTER for row in prog),
            sum(row[7] == BAR_BLOCK for row in prog))


TailLayout = collections.namedtuple(
    "TailLayout", "levels coarse part floats")


def _span(n, local, cluster):
    """log2 of the rows a block holds of an n-row level: all of them
    (block-local), else a power-of-two share."""
    per = n if local else -(-n // cluster)
    return max(0, (per - 1).bit_length())


def tail_layout(spec, cluster, block_rows=BLOCK_ROWS):
    """Where a block keeps the tail's vectors in shared memory (offsets
    in floats, csrc/tail.cu): per level (rows a block holds as a shift,
    b, x_A, x_B; level 0 has no b there, -1), the coarse level's (shift,
    b_z, x_z), the dot's partials (one a block), and the floats in all."""
    off = 0

    def take(count):
        nonlocal off
        off += count
        return off - count

    levels = []
    for l, ls in enumerate(spec.levels):
        sh = _span(ls.n, ls.n <= block_rows, cluster)
        levels.append((sh, -1 if l == 0 else take(1 << sh), take(1 << sh),
                       take(1 << sh)))
    nz = spec.coarse[1]
    sh = _span(nz, nz <= block_rows, cluster)
    coarse = (sh, take(1 << sh), take(1 << sh))
    part = take(cluster)
    return TailLayout(tuple(levels), coarse, part, off)


def tail_fits(spec, cluster=MAX_CLUSTER):
    """Do the tail's vectors fit a cluster of `cluster` blocks' shared
    memory (VECTOR_BYTES a block)?"""
    return 4 * tail_layout(spec, cluster).floats <= VECTOR_BYTES


def cluster_rows(spec, prog):
    """The most rows any cluster-wide phase of `prog` covers (0: every
    phase is block-local)."""
    return max([_rows(spec, row) for row in prog if not row[6] & F_LOCAL],
               default=0)


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
    """The program and pointer and integer tables of one tail on the
    card, and its cluster. It refers to the arrays its tables point into
    weakly (the caller holds them while it launches), so a dropped
    hierarchy frees both."""

    def __init__(self, spec, arrs, with_dot, half, device):
        L = len(spec.levels)
        nz = spec.coarse[1]
        self.refs = tuple(None if t is None else weakref.ref(t)
                          for t in _held(arrs))
        prog = tail_program(spec, with_dot)
        self.nops = len(prog)
        self.barriers = barrier_counts(prog)
        self.cluster, self.smem, lay = _cluster(spec, prog, half, device)
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
            ptrs.append([_ptr(ar[f]) or 0 for f in _PTR_FIELDS])
            pad = [0] * (_k.MAX_OFFSETS - k)
            geo = [0] * 9 if mf is None else [
                *mf.shape, mf.diag_rank, _k._DINV_MODE[mf.dinv],
                *_int32_div(mf.shape[0]), *_int32_div(mf.shape[1])]
            shifts = [[0] * k] * 3 if mf is None else [
                [sh[a] for sh in mf.shifts] for a in range(3)]
            ints.append([n, k, ls.m, ls.nc, *geo, *lay.levels[l],
                         *ls.offsets, *pad]
                        + [v for axis in shifts for v in axis + pad])
        self.inv = arrs[-1]["inv"] if spec.coarse[0] == "inv" else None
        if self.inv is not None:
            _check("dia_coarse_tail", None, nz,
                   {"inv": (self.inv, (nz, nz))})
        self.coarse, self.part = lay.coarse, lay.part
        self.prog = torch.tensor(prog, dtype=torch.int32, device=device)
        self.ptrs = torch.tensor(ptrs, dtype=torch.int64, device=device)
        self.ints = torch.tensor(ints, dtype=torch.int32, device=device)


def _cluster(spec, prog, half, device):
    """(cluster blocks, dynamic shared memory bytes, layout) of a launch:
    the largest power of two of blocks, up to MAX_CLUSTER and no more
    than the cluster-wide phases have rows for (one a thread), whose
    layout fits VECTOR_BYTES a block and of which the card holds a whole
    cluster."""
    want = min(max(-(-cluster_rows(spec, prog) // TAIL_THREADS), 1),
               MAX_CLUSTER)
    c = 1 << (want.bit_length() - 1)
    lib = _lib()
    while c >= 1:
        lay = tail_layout(spec, c)
        smem = lib.amgx_tail_smem(len(spec.levels), len(prog), lay.floats)
        active = ctypes.c_int(0)
        rc = lib.amgx_tail_clusters(c, smem, int(half), ctypes.byref(active))
        if rc != 0:
            raise RuntimeError(f"dia_coarse_tail: cluster query failed "
                               f"(code {rc}; -1 = arguments the kernel does "
                               f"not take, else a cudaError_t)")
        if 4 * lay.floats <= VECTOR_BYTES and active.value >= 1:
            return c, smem, lay
        c //= 2
    raise RuntimeError(f"dia_coarse_tail: {device} holds no cluster of up "
                       f"to {want} blocks of {TAIL_THREADS} threads with "
                       f"the tail's vectors in shared memory")


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


def launch_shape(spec, arrs, x, with_dot=False):
    """(cluster blocks, cluster barriers, block barriers) of the launch
    that `dia_coarse_tail` makes for these operands on x's CUDA device."""
    with torch.cuda.device(x.device):
        plan = _card_plan(spec, arrs, with_dot, x.dtype == torch.bfloat16,
                          x.device)
    return (plan.cluster, *plan.barriers)


def dia_coarse_tail(spec, arrs, b, x, with_dot=False, clock=None):
    """B5: the tail sub-cycle from the entry level's (b, x), float32 or
    bfloat16. Returns x', or (x', x'.b) with `with_dot` (a 0-dim float32
    tensor; float32 only). `clock` (a measuring aid, CUDA only): an int64
    tensor of len(program) + 1 that receives block 0's SM clock before the
    first phase and after each phase's barrier."""
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
        if clock is not None and (clock.dtype != torch.int64
                                  or clock.device != x.device
                                  or tuple(clock.shape) != (plan.nops + 1,)):
            raise ValueError(f"dia_coarse_tail: clock must be int64 "
                             f"({plan.nops + 1},) on {x.device}")
        out = torch.empty_like(x)
        dot = torch.empty((), dtype=torch.float32, device=x.device) \
            if with_dot else None
        _launch(name,
                _lib().amgx_dia_coarse_tail,
                _ptr(plan.prog), plan.nops, _ptr(plan.ptrs),
                _ptr(plan.ints), len(spec.levels), _ptr(b), _ptr(x),
                _ptr(out), int(half), _ptr(plan.inv), spec.coarse[1],
                *plan.coarse, plan.part, _ptr(dot), plan.cluster, plan.smem,
                _ptr(clock), _stream(),
                detail=f" of a {plan.cluster}-block cluster")
    return (out, dot) if with_dot else out


def barrier_probe(cluster, iters, cluster_barriers, device=None):
    """Launch `iters` barriers in one `cluster`-block cluster of the
    kernel's 1024-thread blocks: cluster barriers, or block barriers
    (csrc/tail.cu `barrier_probe_kernel`). A measuring aid for the
    tail's phase-chain floor (the cost of one barrier of each kind), not
    a kernel of the solve: it is not counted in LAUNCHES."""
    with torch.cuda.device(device):
        rc = _lib().amgx_tail_barrier_probe(cluster, iters,
                                            int(cluster_barriers), _stream())
    if rc != 0:
        raise RuntimeError(f"barrier_probe: launch of a {cluster}-block "
                           f"cluster failed (code {rc})")
