"""CF-splitting selectors (the port of PMIS in
amgx_tpu/amg/classical/selectors.py).

PMIS is a data-parallel fixed point over the symmetrized strength graph:

    w_i = strong-degree(i) / 2 + hash(i)        (a deterministic "random")
    repeat: an undecided i whose weight beats every undecided strong
            neighbour's becomes COARSE; undecided neighbours of COARSE
            points become FINE.

The degree is a count of halves and the hash has 20 bits, so w is exact
in float64 and every comparison is strict: the split is identical on
the CPU, on the card and in the JAX package. The hash needs uint32
wrap-around multiplication; it runs in int64 masked to 32 bits after
each step. An `init` split seeds the fixed point: its FINE and COARSE
entries stay, its UNDECIDED ones are resolved.

RS is the classical serial first pass: a bucket queue on the host
(numpy arrays read into Python lists), for an operator on the card too,
as the JAX package runs it (`rs_split_python`, bit-identical to its
native `rs.cpp`): S and S^T adjacency, pushes in ascending node order,
the LIFO tie-break of each bucket. The split is the reference's bit for
bit. HMIS is that pass followed by PMIS seeded with it.

The device-parallel RS sweep (`rs_sweep`, `selector_device_sweep`): a
PMIS-style independent-set fixed point with the RS weight as priority,
key_i = lambda_i 2^20 + hash(i) in int64, lambda_i the live RS weight
(S^T in-degree plus one a strong neighbour turned FINE), on A's device
in integer arithmetic only, so its split is the same bits on the CPU, on
the card and in the JAX package. It is not the bucket queue's split (the
queue's LIFO tie-break is serial by nature). `1` always sweeps, `0`
always takes the queue, `auto` sweeps where the JAX package does: under
`setup_backend=device`, on levels of at least `setup_device_min_rows`
rows. A sweep counts `amg.selector.device_sweep` and runs in the span
`selector.device_sweep`.

The aggressive selectors run PMIS on the two-hop strength graph S S (a
sort-based product, ops/spgemm.py `csr_multiply`).

CR (compatible relaxation, the JAX package's `CRSelector`): rounds of
NU damped-Jacobi sweeps of A e = 0 with e zeroed on the C points (the
SpMVs through ops/spmv.py: B1 on a float32 DIA level, B8 on a float32
CSR one; a float64 CSR level adds each row in order, `_relax_product`,
which the plain product's `index_add_` does on the CPU and not on the
card); the points where the error stays large (mu >= THETA) join C
as an independent set weighted by mu, until the last sweep's rate is
below TARGET_RATE; then uncovered F points are promoted until every F
point has a strong C neighbour. The seeds (`default_rng(5)`, the index
hash) and constants are the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import registry
from ...matrix import CsrMatrix
from ...ops.segment import (ordered_sum, ordered_sum_plan, segment_any,
                             segment_max)
from ...ops.spgemm import csr_multiply
from ...ops.spmv import spmv
from ...profiling import trace_region
from ...telemetry import metrics as _tm

FINE, COARSE, UNDECIDED = 0, 1, -1
_MASK32 = 0xFFFFFFFF


def _hash_key(n: int, device) -> torch.Tensor:
    """The JAX package's `_hash_key`: an integer hash of the index (uint32
    arithmetic, carried in int64 masked to 32 bits), its low 20 bits."""
    h = torch.arange(n, dtype=torch.int64, device=device)
    h = (h * 2654435761) & _MASK32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK32
    h = h ^ (h >> 16)
    return h & 0xFFFFF


def _hash01(n: int, device) -> torch.Tensor:
    """The JAX package's `_hash01` in float64: `_hash_key` over 2^20."""
    return _hash_key(n, device).to(torch.float64) / float(1 << 20)


def _symmetrize(rows, cols, mask):
    """Edges of S | S^T grouped by row (duplicates kept: harmless for
    the max / any reductions, and they make deg = (out + in) / 2)."""
    r = torch.cat([rows[mask], cols[mask]])
    c = torch.cat([cols[mask], rows[mask]])
    order = torch.argsort(r, stable=True)
    return r[order], c[order]


def pmis_split(A: CsrMatrix, strong: torch.Tensor, max_iters: int = 30,
               init=None) -> torch.Tensor:
    """cf_map (n,) int32 in {FINE, COARSE}; `init`, when given, seeds
    the fixed point (its FINE / COARSE entries are kept)."""
    n = A.num_rows
    dev = A.device
    rows, cols, _ = A.coo()
    sr, sc = _symmetrize(rows, cols.long(), strong)
    deg = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, sr, torch.ones(sr.shape[0], dtype=torch.float64, device=dev))
    w = deg * 0.5 + _hash01(n, dev)
    state = torch.full((n,), UNDECIDED, dtype=torch.int32, device=dev) \
        if init is None else torch.as_tensor(init, device=dev).to(
            torch.int32)
    # isolated points (no strong connection) cannot interpolate: COARSE
    has_nbr = segment_any(torch.ones_like(sr, dtype=torch.bool), sr, n)
    state = torch.where((state == UNDECIDED) & ~has_nbr, COARSE,
                        state).to(torch.int32)
    for _ in range(max_iters):
        und = state == UNDECIDED
        if not bool(und.any()):
            break
        active = und[sr] & und[sc]
        nbr_max = segment_max(torch.where(active, w[sc], float("-inf")),
                              sr, n)
        state = torch.where(und & (w > nbr_max), COARSE, state)
        c_nbr = segment_any(state[sc] == COARSE, sr, n)
        state = torch.where((state == UNDECIDED) & c_nbr, FINE, state)
    return torch.where(state == UNDECIDED, FINE, state).to(torch.int32)


def rs_split(A: CsrMatrix, strong: torch.Tensor) -> np.ndarray:
    """The RS first pass as a host bucket queue (the JAX package's
    `rs_split_python`, bit-identical to its native rs.cpp): cf_map (n,)
    int32 numpy, in {FINE, COARSE}."""
    n = A.num_rows
    ro = A.row_offsets.cpu().numpy()
    ci = A.col_indices.cpu().numpy()
    st = strong.cpu().numpy().astype(bool)
    row_ids = np.repeat(np.arange(n), np.diff(ro))
    mask = st & (ci < n) & (ci != row_ids)
    # S (by row) and S^T (by column) adjacency
    s_r, s_c = row_ids[mask], ci[mask]
    order = np.argsort(s_c, kind="stable")
    st_r = s_r[order]
    st_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s_c, minlength=n), out=st_off[1:])
    s_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s_r, minlength=n), out=s_off[1:])
    lam = np.diff(st_off)
    in_q = lam > 0
    state = np.full(n, UNDECIDED, np.int32)
    # lam == 0: FINE, except fully isolated points (no edge either way),
    # which cannot interpolate: COARSE
    state[~in_q] = np.where(np.diff(s_off)[~in_q] == 0, COARSE, FINE)
    # the queue on Python lists: a bucket head per weight and a doubly
    # linked list of nodes; a weight is at most 2 |S^T_i|
    st_off, st_r = st_off.tolist(), st_r.tolist()
    s_off, s_c = s_off.tolist(), s_c.tolist()
    state, weight = state.tolist(), lam.tolist()
    head = [-1] * (2 * n + 2)
    prev = [-1] * n
    nxt = [-1] * n
    maxw = 0
    for i in np.nonzero(in_q)[0].tolist():     # ascending node order
        w = weight[i]
        h = head[w]
        nxt[i] = h
        if h >= 0:
            prev[h] = i
        head[w] = i
        if w > maxw:
            maxw = w
    und, coarse, fine = UNDECIDED, COARSE, FINE
    while True:
        while maxw >= 0 and head[maxw] < 0:
            maxw -= 1
        if maxw < 0:
            break
        i = head[maxw]
        # remove i: it heads its bucket
        j = nxt[i]
        head[maxw] = j
        if j >= 0:
            prev[j] = -1
        nxt[i] = -1
        if state[i] != und:
            continue
        state[i] = coarse
        for t in range(st_off[i], st_off[i + 1]):
            j = st_r[t]
            if state[j] != und:
                continue
            state[j] = fine
            # remove j from its bucket
            p, q = prev[j], nxt[j]
            if p >= 0:
                nxt[p] = q
            else:
                head[weight[j]] = q
            if q >= 0:
                prev[q] = p
            prev[j] = nxt[j] = -1
            for u in range(s_off[j], s_off[j + 1]):
                k = s_c[u]
                if state[k] != und:
                    continue
                # move k to the head of the next bucket up
                w = weight[k]
                p, q = prev[k], nxt[k]
                if p >= 0:
                    nxt[p] = q
                else:
                    head[w] = q
                if q >= 0:
                    prev[q] = p
                w += 1
                weight[k] = w
                prev[k] = -1
                h = head[w]
                nxt[k] = h
                if h >= 0:
                    prev[h] = k
                head[w] = k
                if w > maxw:
                    maxw = w
    return np.where(np.asarray(state) == COARSE, COARSE,
                    FINE).astype(np.int32)


def rs_sweep(A: CsrMatrix, strong: torch.Tensor,
             max_rounds: int = 200) -> torch.Tensor:
    """The device-parallel RS first pass: cf_map (n,) int32 in {FINE,
    COARSE} on A's device. Per round, over the UNDECIDED points: those
    whose key beats every undecided neighbour in S | S^T become COARSE,
    undecided points with a new COARSE point in S(j) become FINE, and
    each newly FINE j bumps the weight of its undecided k in S(j) by
    one. lambda = 0 points start FINE (COARSE when fully isolated);
    points still undecided after `max_rounds` turn FINE."""
    n = A.num_rows
    dev = A.device
    rows, cols, _ = A.coo()
    cols = cols.long()
    mask = strong.bool() & (cols < n) & (cols != rows)
    er, ec = rows[mask], cols[mask]
    lam = torch.bincount(ec, minlength=n)           # S^T in-degree
    out_deg = torch.bincount(er, minlength=n)
    key_base = _hash_key(n, dev)
    state = torch.full((n,), UNDECIDED, dtype=torch.int32, device=dev)
    no_in = lam == 0
    state = torch.where(no_in & (out_deg == 0), COARSE,
                        torch.where(no_in, FINE, state)).to(torch.int32)
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for _ in range(max_rounds):
        und = state == UNDECIDED
        if not bool(und.any()):                 # one host read a round
            break
        key = lam * (1 << 20) + key_base
        live = und[er] & und[ec]
        nbr = none.clone().scatter_reduce_(
            0, er, torch.where(live, key[ec], -1), "amax")
        nbr.scatter_reduce_(0, ec, torch.where(live, key[er], -1), "amax")
        new_c = und & (key > nbr)
        state = torch.where(new_c, COARSE, state).to(torch.int32)
        newly_f = und & ~new_c & segment_any(new_c[ec], er, n)
        state = torch.where(newly_f, FINE, state).to(torch.int32)
        bump = newly_f[er] & (state == UNDECIDED)[ec]
        lam = lam + torch.bincount(ec[bump], minlength=n)
    return (state == COARSE).to(torch.int32)


def _sweeps(cfg, scope, n: int) -> bool:
    """Does `selector_device_sweep` send an n-row level's RS pass to
    `rs_sweep`? 1 yes, 0 no, auto where the JAX package forces its
    device setup (setup_backend=device, n >= setup_device_min_rows)."""
    mode = str(cfg.get("selector_device_sweep", scope))
    if mode == "auto":
        return str(cfg.get("setup_backend", scope)).lower() == "device" \
            and n >= int(cfg.get("setup_device_min_rows", scope))
    return mode == "1"


def _rs_first_pass(cfg, scope, A: CsrMatrix, strong) -> torch.Tensor:
    """The RS pass, its split on A's device: the device sweep or the
    host queue (`_sweeps`)."""
    if _sweeps(cfg, scope, A.num_rows):
        _tm.inc("amg.selector.device_sweep")
        with trace_region("selector.device_sweep"):
            return rs_sweep(A, strong)
    return torch.from_numpy(rs_split(A, strong)).to(A.device)


def two_hop_strength(A: CsrMatrix, strong: torch.Tensor) -> CsrMatrix:
    """S S with S = 1.0 on A's strong entries, 0.0 elsewhere: the
    aggressive coarsening graph (every candidate entry kept)."""
    S = CsrMatrix(A.row_offsets, A.col_indices,
                  strong.to(torch.float64), A.num_rows, A.num_cols)
    return csr_multiply(S, S)


class ClassicalSelector:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope

    def mark_coarse_fine_points(self, A: CsrMatrix, strong):
        raise NotImplementedError


@registry.classical_selectors.register("PMIS")
class PMISSelector(ClassicalSelector):
    def mark_coarse_fine_points(self, A, strong):
        return pmis_split(A, strong)


@registry.classical_selectors.register("RS")
class RSSelector(ClassicalSelector):
    def mark_coarse_fine_points(self, A, strong):
        return _rs_first_pass(self.cfg, self.scope, A, strong)


@registry.classical_selectors.register("HMIS")
class HMISSelector(ClassicalSelector):
    """The RS pass, then PMIS seeded with it (on one device it keeps the
    pass's split: every point is decided)."""

    def mark_coarse_fine_points(self, A, strong):
        cf = _rs_first_pass(self.cfg, self.scope, A, strong)
        return pmis_split(A, strong, init=cf)


@registry.classical_selectors.register("AGGRESSIVE_PMIS")
@registry.classical_selectors.register("AGGRESSIVE_HMIS")
class AggressivePMISSelector(ClassicalSelector):
    """PMIS on the two-hop strength graph S S."""

    def mark_coarse_fine_points(self, A, strong):
        S2 = two_hop_strength(A, strong)
        r2, c2, v2 = S2.coo()
        return pmis_split(S2, (v2 > 0) & (r2 != c2.long()))


@registry.classical_selectors.register("DUMMY_CLASSICAL")
class DummyClassicalSelector(ClassicalSelector):
    """Every other point coarse."""

    def mark_coarse_fine_points(self, A, strong):
        return (torch.arange(A.num_rows, device=A.device) % 2 == 0).to(
            torch.int32)


def _relax_product(A: CsrMatrix):
    """x -> A x for CR's relaxation: ops/spmv.py, except a CSR operator
    outside the kernels' dtypes, whose rows are added in their stored
    order (ops/segment.py): the bits of the CPU's plain product, on the
    card too, run after run."""
    from ...precision import SMOOTH_DTYPES
    if A.dia_offsets is not None or A.dtype in SMOOTH_DTYPES:
        return lambda x: spmv(A, x)
    plan = ordered_sum_plan(A.row_offsets)
    cols = A.col_indices.long()
    return lambda x: ordered_sum(A.values * x[cols], plan, A.num_rows)


@registry.classical_selectors.register("CR")
class CRSelector(ClassicalSelector):
    """Compatible relaxation (cr.cu; the JAX package's `CRSelector`)."""

    NU = 4              # relaxation sweeps a round
    THETA = 0.5         # candidate threshold on the normalized error
    MAX_ROUNDS = 10
    TARGET_RATE = 0.7

    def mark_coarse_fine_points(self, A, strong):
        n = A.num_rows
        dev = A.device
        rows, cols, _ = A.coo()
        sr, sc = _symmetrize(rows, cols.long(), strong)
        diag = A.diagonal()
        dinv = torch.where(diag != 0, 1.0 / torch.where(
            diag == 0, torch.ones_like(diag), diag), torch.zeros_like(diag))
        state = torch.full((n,), UNDECIDED, dtype=torch.int32, device=dev)
        has_nbr = segment_any(torch.ones_like(sr, dtype=torch.bool), sr, n)
        state = torch.where(~has_nbr, COARSE, state).to(torch.int32)
        rng = np.random.default_rng(5)
        e0 = torch.tensor(rng.standard_normal(n), dtype=A.dtype, device=dev)
        h = _hash01(n, dev)
        neg = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
        Ax = _relax_product(A)
        for _ in range(self.MAX_ROUNDS):
            is_c = state == COARSE
            e = torch.where(is_c, torch.zeros_like(e0), e0)
            e = e / torch.clamp(torch.linalg.norm(e), min=1e-30)
            norm_prev = torch.linalg.norm(e)
            for _ in range(self.NU):
                norm_prev = torch.linalg.norm(e)
                e = e - 0.666 * dinv * Ax(e)
                e = torch.where(is_c, torch.zeros_like(e), e)
            # the asymptotic rate: the last sweep's
            rate = torch.linalg.norm(e) / torch.clamp(norm_prev, min=1e-30)
            if float(rate) < self.TARGET_RATE:
                break
            mu = e.abs() / torch.clamp(e.abs().max(), min=1e-30)
            cand = (state == UNDECIDED) & (mu >= self.THETA)
            if not bool(cand.any()):
                break
            # an independent set among the candidates, weighted by mu
            w = mu.to(torch.float64) + h * 1e-6
            active = cand[sr] & cand[sc]
            nbr_max = segment_max(torch.where(active, w[sc], neg), sr, n)
            state = torch.where(cand & (w > nbr_max), COARSE,
                                state).to(torch.int32)
        # coverage: promote independent sets of uncovered F points until
        # every F point has a strong C neighbour
        deg = torch.bincount(sr, minlength=n).to(torch.float64)
        wfix = deg + h
        for _ in range(30):
            is_c = state == COARSE
            unc = ~is_c & has_nbr & ~segment_any(is_c[sc], sr, n)
            if not bool(unc.any()):
                break
            active = unc[sr] & unc[sc]
            nbr_max = segment_max(torch.where(active, wfix[sc], neg), sr, n)
            state = torch.where(unc & (wfix > nbr_max), COARSE,
                                state).to(torch.int32)
        return (state == COARSE).to(torch.int32)
