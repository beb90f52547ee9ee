"""The coarse-tail kernel B5 (amgx_tpu_torch/ops/cuda_tail.py) against the
JAX package's, and the untouched FLAGSHIP, whose cycle runs through it.

A JAX hierarchy is set up with its Pallas kernels under the interpreter
(force_pallas_interpret: the route that builds its transfer slabs and
DENSE_LU's explicit inverse), carried into the port with
amgx_tpu_torch.interop, and one cycle from identical (b, x) is compared:
the port's plain B5 on the CPU against the JAX tail kernel in interpret
mode. The CUDA kernel itself is held against the plain B5 on the card by
chip_smoke.py; here its phase program (the host half of the kernel) is
run op by op and held against the plain recursion.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.amg.cycles import run_cycle_dot
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as ps
from amgx_tpu.presets import FLAGSHIP as JAX_FLAGSHIP

import amgx_tpu_torch as pt
from amgx_tpu_torch.interop import hierarchy_from_numpy
from amgx_tpu_torch.ops import cuda_spmv as K
from amgx_tpu_torch.ops import cuda_tail as T
from amgx_tpu_torch.presets import FLAGSHIP

from _torch_util import jax_hierarchy_arrays, rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

AMG_CFG = ("solver=AMG, algorithm=AGGREGATION, selector=GEO,"
           " smoother={smoother}, chebyshev_polynomial_order=2,"
           " relaxation_factor=0.75, presweeps=1, postsweeps=2,"
           " max_iters=1, cycle={cycle}, max_levels=10, min_coarse_rows=32"
           "{extra}")
# one cycle in float32 through two implementations of the same
# arithmetic: rounding of a few levels' dependent steps
TOL32 = 1e-5
# the flagship solve: as tests/test_torch_flagship.py
HIST_TOL = 1e-5
X_TOL = 1e-5


def _jax_amg(smoother, cycle, n, extra="", dtype=np.float32):
    cfg = AMG_CFG.format(smoother=smoother, cycle=cycle, extra=extra)
    with ps.force_pallas_interpret():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", n, n, n, dtype=dtype).init())
        levels, coarse = jax_hierarchy_arrays(js)
    amg = hierarchy_from_numpy(levels, coarse, pt.Config.from_string(cfg),
                               device="cpu")
    return js, amg


def _record_tail(monkeypatch):
    seen = []
    real = T.dia_coarse_tail

    def spy(spec, arrs, b, x, with_dot=False):
        seen.append(spec)
        return real(spec, arrs, b, x, with_dot)

    monkeypatch.setattr(T, "dia_coarse_tail", spy)
    return seen


CASES = [  # smoother, cycle, grid, extra config, entry level
    ("CHEBYSHEV_POLY", "V", 16, "", 0),
    ("JACOBI_L1", "V", 16, "", 0),
    ("CHEBYSHEV_POLY", "V", 16, ", cycle_fusion_tail_rows=600", 1),
    ("JACOBI_L1", "V", 16, ", cycle_fusion_tail_rows=600", 1),
    ("CHEBYSHEV_POLY", "W", 12, "", 0),
    ("JACOBI_L1", "W", 12, "", 0),
    ("CHEBYSHEV_POLY", "F", 12, "", 0),
    ("JACOBI_L1", "F", 12, "", 0),
]


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("smoother,cycle,n,extra,entry", CASES)
def test_tail_cycle_matches_jax(monkeypatch, smoother, cycle, n, extra,
                                entry, with_dot):
    js, amg = _jax_amg(smoother, cycle, n, extra)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n ** 3).astype(np.float32)
    x = rng.standard_normal(n ** 3).astype(np.float32)
    with ps.force_pallas_interpret():
        jd = js.solve_data()["amg"]
        js.amg._tail_entry_level = None
        if with_dot:
            xj, dj = run_cycle_dot(js.amg, cycle, jd, jnp.asarray(b),
                                   jnp.asarray(x))
        else:
            xj = js.amg.cycle(jd, jnp.asarray(b), jnp.asarray(x))
    assert js.amg._tail_entry_level == entry
    seen = _record_tail(monkeypatch)
    data = amg.solve_data()
    tb, tx = torch.from_numpy(b), torch.from_numpy(x)
    if with_dot:
        xp, dp = amg.cycle_dot(data, tb, tx)
        assert abs(float(dp) - float(dj)) <= TOL32 * abs(float(dj))
    else:
        xp = amg.cycle(data, tb, tx)
    assert [s.levels[0].n for s in seen] == [amg.levels[entry].A.num_rows]
    assert seen[0].coarse == ("inv", amg.coarsest_A.num_rows)
    assert seen[0].levels[0].has_dinv == (smoother == "JACOBI_L1")
    assert rel(xp, xj) < TOL32


# ---------------------------------------------------------------------------
# the phase program, run op by op on the CPU
# ---------------------------------------------------------------------------


class _Buffer:
    """One buffer of the kernel with, per row, which block last wrote it
    and the barrier counts at that write: a row reads as NaN to a block
    that no barrier has yet shown the write to."""

    def __init__(self, n, value=None):
        self.v = torch.full((n,), float("nan")) if value is None else value
        self.writer = torch.full((n,), -1, dtype=torch.int64)  # -1: input
        self.cep = torch.zeros(n, dtype=torch.int64)
        self.bep = torch.zeros(n, dtype=torch.int64)

    def view(self, reader, cep, bep):
        seen = (self.writer < 0) | (self.cep < cep) | (
            (self.writer == reader) & (self.bep < bep))
        return torch.where(seen, self.v, torch.full_like(self.v,
                                                         float("nan")))

    def write(self, rows, value, writer, cep, bep):
        self.v[rows] = value[rows]
        self.writer[rows], self.cep[rows], self.bep[rows] = writer, cep, bep


def _run_program(spec, arrs, b, x, with_dot, block_rows=T.BLOCK_ROWS,
                 cluster=T.MAX_CLUSTER):
    """Execute tail_program's phases as csrc/tail.cu does on a cluster of
    `cluster` blocks: a cluster-wide STEP or CORRECT on the rows each
    block holds (tail_layout's power-of-two slices), a RESTRICT or COARSE
    on warp-aligned chunks of its work items (a coarse row's lanes),
    a block-local phase on block 0; each block seeing another's writes
    only after a cluster barrier and its own after a block barrier
    (unwritten or unseen rows read as NaN). Returns what the OUT phase
    stores (and the dot)."""
    L = len(spec.levels)
    nz = spec.coarse[1]
    n0 = spec.levels[0].n
    lay = T.tail_layout(spec, cluster, block_rows)
    xs = [{T.S_A: _Buffer(n0), T.S_B: _Buffer(n0),
           T.S_IN: _Buffer(n0, x.clone())}]
    bs = [_Buffer(n0, b.clone())]
    for ls in spec.levels[1:]:
        xs.append({T.S_A: _Buffer(ls.n), T.S_B: _Buffer(ls.n)})
        bs.append(_Buffer(ls.n))
    bz, xz = _Buffer(nz), _Buffer(nz)
    partials = _Buffer(cluster)
    out = None
    cep = bep = 0
    parts, dot = 1, None
    for op, l, src, dst, tau, nxt, flags, bar in T.tail_program(
            spec, with_dot, block_rows=block_rows):
        local = bool(flags & T.F_LOCAL)

        def items(total, lanes=1):
            """the block of each row whose `lanes` items start it"""
            u = torch.arange(total // lanes) * lanes
            if local:
                return torch.zeros_like(u)
            per = (-(-total // cluster) + 31) // 32 * 32
            return u // per

        if op == T.OP_DOT:
            dot = partials.view(0, cep, bep)[:parts].sum()
        elif op == T.OP_COARSE:
            own = items(nz * 16, 16)
            for r in own.unique().tolist():
                bv = bz.view(r, cep, bep)
                val = (arrs[-1]["inv"] @ bv if spec.coarse[0] == "inv"
                       else torch.zeros(nz))
                xz.write(own == r, val, r, cep, bep)
        else:
            ls, ar = spec.levels[l], arrs[l]
            vals, dinv = T.level_vals(ls, ar)
            if op == T.OP_RESTRICT:
                g = 1 << max(0, (ls.m - 1).bit_length())
                own = items(ls.nc * g, g) if ls.m <= 32 else items(ls.nc)
            else:
                own = torch.zeros(ls.n, dtype=torch.int64) if local \
                    else torch.arange(ls.n) >> lay.levels[l][0]
            for r in own.unique().tolist():
                x_l = xs[l][src].view(r, cep, bep)
                b_l = bs[l].view(r, cep, bep)
                mine = own == r
                if op == T.OP_RESTRICT:
                    res = b_l - K.dia_spmv_plain(vals, ls.offsets, x_l)
                    bn = bz if l + 1 == L else bs[l + 1]
                    bn.write(mine, K.restrict_plain(ar["ctab"], res), r, cep,
                             bep)
                    if l + 1 < L:
                        xs[l + 1][T.S_A].write(mine, torch.zeros(ls.nc), r,
                                               cep, bep)
                    continue
                assert src != dst and dst != T.S_IN
                if flags & T.F_CORRECTED:
                    xc = xz if nxt == T.S_Z else xs[l + 1][nxt]
                    x_l = x_l + xc.view(r, cep, bep)[ar["agg"].long()]
                if op == T.OP_STEP:
                    taus = ar["taus_post"] if flags & T.F_POST \
                        else ar["taus_pre"]
                    x_l = K.dia_smooth_plain(vals, ls.offsets,
                                             taus[tau:tau + 1], b_l, x_l,
                                             dinv, with_residual=False)
                xs[l][dst].write(mine, x_l, r, cep, bep)
                if flags & T.F_DOT:
                    part = torch.zeros(cluster)
                    part[r] = torch.dot(x_l[mine], b_l[mine])
                    partials.write(torch.arange(cluster) == r, part, r, cep,
                                   bep)
            if flags & T.F_OUT:
                assert l == 0 and out is None
                out = xs[0][dst].v.clone()
        parts = 1 if local else cluster
        if bar == T.BAR_CLUSTER:
            cep, bep = cep + 1, bep + 1
        elif bar == T.BAR_BLOCK:
            bep += 1
    return (out, dot) if with_dot else out


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("case", ["V", "W", "F", "V-no-post", "V-no-pre",
                                  "V-nosolver"])
def test_phase_program_matches_plain_recursion(case, with_dot):
    """Every slot the program reads holds what the recursion computes
    there (unwritten slots, and rows no barrier has shown the reading
    block, hold NaN), and the entry level's last write lands in the
    output: the 12^3 entry level (1728 rows) across a cluster of four
    blocks, the coarser levels in block 0."""
    cycle = case[0]
    pre, post = {"V-no-post": (2, 0), "V-no-pre": (0, 2)}.get(case, (1, 2))
    js, amg = _jax_amg("JACOBI_L1", cycle, 12,
                       f", presweeps={pre}, postsweeps={post}")
    if case == "V-nosolver":
        amg.coarse_solver = pt.solvers.relaxation.NoSolver(
            amg.cfg, name="NOSOLVER", device="cpu")
        amg.coarse_solver.setup(amg.coarsest_A)
    from amgx_tpu_torch.ops.smooth import _tail_plan
    rng = np.random.default_rng(4)
    b = torch.from_numpy(rng.standard_normal(12 ** 3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(12 ** 3).astype(np.float32))
    spec, arrs = _tail_plan(amg, cycle, amg.solve_data(), 0, x)
    assert spec.coarse[0] == ("none" if case == "V-nosolver" else "inv")
    want = T.dia_coarse_tail_plain(spec, arrs, b, x, with_dot)
    got = _run_program(spec, arrs, b, x, with_dot, block_rows=256,
                       cluster=4)
    if with_dot:
        assert torch.equal(got[0], want[0])
        assert abs(float(got[1] - want[1])) <= 1e-6 * abs(float(want[1]))
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("smoother,cycle,with_dot", [
    ("CHEBYSHEV_POLY", "V", False), ("JACOBI_L1", "V", True),
    ("CHEBYSHEV_POLY", "F", False)])
def test_cluster_program_at_the_flagship_tail(smoother, cycle, with_dot):
    """The flagship 128^3's tail levels (a 32^3 hierarchy: 32768, 4096,
    512 rows, coarse 64) through the kernel's own launch shape: 16 blocks,
    the 32768- and 4096-row levels across the cluster, the others in
    block 0. The same bits as the plain recursion."""
    from amgx_tpu_torch.ops.smooth import _tail_plan
    cfg = AMG_CFG.format(smoother=smoother, cycle=cycle, extra="")
    slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    slv.setup(pt.gallery.poisson("7pt", 32, 32, 32, dtype=torch.float32,
                                 device="cpu"))
    rng = np.random.default_rng(5)
    b = torch.from_numpy(rng.standard_normal(32 ** 3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(32 ** 3).astype(np.float32))
    spec, arrs = _tail_plan(slv.amg, cycle, slv.amg.solve_data(), 0, x)
    assert [ls.n for ls in spec.levels] == [32768, 4096, 512]
    prog = T.tail_program(spec, with_dot)
    assert [bool(r[6] & T.F_LOCAL) for r in prog if r[1] == 0
            and r[0] != T.OP_DOT] == [False] * sum(
        r[1] == 0 and r[0] != T.OP_DOT for r in prog)
    want = T.dia_coarse_tail_plain(spec, arrs, b, x, with_dot)
    got = _run_program(spec, arrs, b, x, with_dot)
    if with_dot:
        assert torch.equal(got[0], want[0])
        assert abs(float(got[1] - want[1])) <= 1e-5 * abs(float(want[1]))
    else:
        assert torch.equal(got, want)


def _flagship_spec(shape="V", pre=5, post=5, sizes=(32, 16, 8)):
    lv = [T.TailLevelSpec((-n * n, -n, -1, 0, 1, n, n * n), n ** 3, pre,
                          post, False, (n // 2) ** 3, 8) for n in sizes]
    return T.TailSpec(shape, tuple(lv), ("inv", (sizes[-1] // 2) ** 3))


def _phase_buffers(spec, row):
    """(read, written) buffers of one program row: ("x", l, slot),
    ("b", l) (level L is the coarsest's), "xz", "partials", "dot"."""
    op, l, src, dst, _, nxt, flags = row[:7]
    L = len(spec.levels)
    if op == T.OP_COARSE:
        return {("b", L)}, {"xz"}
    if op == T.OP_DOT:
        return {"partials"}, {"dot"}
    reads = {("x", l, src), ("b", l)}
    if op == T.OP_RESTRICT:
        return reads, {("b", l + 1)} | ({("x", l + 1, T.S_A)}
                                        if l + 1 < L else set())
    if flags & T.F_CORRECTED:
        reads.add("xz" if nxt == T.S_Z else ("x", l + 1, nxt))
    return reads, {("x", l, dst)} | ({"partials"} if flags & T.F_DOT
                                     else set())


def _check_barriers(spec, prog, block_rows):
    """Scope marks and barriers of a program: a block-local phase covers
    at most `block_rows` rows, a cluster-wide one more; between two
    phases that touch one buffer (read after write, write after read or
    write), a block or cluster barrier when both are block-local (block
    0 ran both), else a cluster barrier."""
    for row in prog:
        rows = 0 if row[0] == T.OP_DOT else T._rows(spec, row)
        assert bool(row[6] & T.F_LOCAL) == (rows <= block_rows), row
    # no block leaves while a cluster-wide last phase reads its rows
    assert prog[-1][7] == (T.BAR_NONE if prog[-1][6] & T.F_LOCAL
                           else T.BAR_CLUSTER)
    assert sum(row[6] & T.F_OUT != 0 for row in prog) == 1
    access = [_phase_buffers(spec, row) for row in prog]
    for q, (rq, wq) in enumerate(access):
        for p in range(q):
            rp, wp = access[p]
            if not (wp & (rq | wq) or rp & wq):
                continue
            bars = [prog[i][7] for i in range(p, q)]
            both_local = prog[p][6] & prog[q][6] & T.F_LOCAL
            assert T.BAR_CLUSTER in bars or (
                both_local and T.BAR_BLOCK in bars), (p, q, prog[p], prog[q])


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("shape,pre,post", [
    ("V", 5, 5), ("W", 1, 2), ("F", 1, 2), ("V", 2, 0), ("V", 0, 2)])
@pytest.mark.parametrize("block_rows", [T.BLOCK_ROWS, 512, 0])
def test_program_barriers_order_every_dependence(shape, pre, post,
                                                 with_dot, block_rows):
    """V, W, F, no post-sweeps, no pre-sweeps, with and without the dot;
    the flagship's scope split (levels of 32768 rows across the cluster,
    4096 and 512 in block 0), another (512 rows in block 0 alone) and an
    all-cluster program."""
    spec = _flagship_spec(shape, pre, post)
    prog = T.tail_program(spec, with_dot, block_rows=block_rows)
    _check_barriers(spec, prog, block_rows)


def test_phase_count_of_the_flagship_tail():
    """The flagship's 128^3 tail (levels of 32768, 4096 and 512 rows, 5
    damping steps a sweep, one sweep each side): 11 phases per level and
    the coarse product -- the dependent chain. The 22 phases of the
    32768- and 4096-row levels run across the cluster (21 cluster
    barriers, the hand-over back from block 0 and the closing one), the
    512-row level's and the coarse product's 12 in block 0 (11 block
    barriers); with the dot, the last step's cluster barrier precedes the
    block-local DOT, which ends the launch. chip_smoke.py prints these
    counts for each launch."""
    spec = _flagship_spec()
    prog = T.tail_program(spec)
    assert len(prog) == 34
    assert T.barrier_counts(prog) == (23, 11)
    assert T.cluster_rows(spec, prog) == 32768
    dot = T.tail_program(spec, with_dot=True)
    assert len(dot) == 35
    assert T.barrier_counts(dot) == (23, 11)


@pytest.mark.parametrize("cluster", [16, 4, 1])
def test_tail_layout_gives_each_vector_its_own_floats(cluster):
    """tail_layout: every level's slices (b, x_A, x_B; level 0 without
    b), the coarse b_z and x_z and the partials disjoint, within the
    floats it counts; a cluster-wide level's slices cover its rows, a
    block-local one's (and the coarse level's) all of them. A tail whose
    vectors outgrow VECTOR_BYTES a block is declined."""
    spec = _flagship_spec()
    lay = T.tail_layout(spec, cluster)
    spans = []
    for l, (ls, (sh, ob, oxa, oxb)) in enumerate(zip(spec.levels,
                                                     lay.levels)):
        rows = ls.n if ls.n <= T.BLOCK_ROWS else -(-ls.n // cluster)
        assert (1 << sh) >= rows and (sh == 0 or (1 << (sh - 1)) < rows)
        assert (ob == -1) == (l == 0)
        spans += [(o, o + (1 << sh)) for o in (ob, oxa, oxb) if o >= 0]
    sh, obz, oxz = lay.coarse
    assert (1 << sh) >= spec.coarse[1]
    spans += [(obz, obz + (1 << sh)), (oxz, oxz + (1 << sh)),
              (lay.part, lay.part + cluster)]
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == lay.floats
    assert all(a[1] <= b_[0] for a, b_ in zip(spans, spans[1:]))
    assert T.tail_fits(spec)
    wide = T.TailSpec("V", (T.TailLevelSpec((-1, 0, 1), 1 << 21, 1, 1,
                                            False, 1 << 18, 8),),
                      ("inv", 1 << 18))
    assert not T.tail_fits(wide)


# ---------------------------------------------------------------------------
# DENSE_LU's explicit inverse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_dense_lu_inverse_matches_jax(dtype, tol):
    """The port's own setup (not the carried arrays) gives the JAX
    package's d["inv"] = R^-1 Q^T in the factors' dtype."""
    js, _ = _jax_amg("JACOBI_L1", "V", 16, dtype=dtype)
    with ps.force_pallas_interpret():
        jinv = np.asarray(js.solve_data()["amg"]["coarse"]["inv"])
    cfg = AMG_CFG.format(smoother="JACOBI_L1", cycle="V", extra="")
    pslv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    pslv.setup(pt.gallery.poisson("7pt", 16, 16, 16, dtype=getattr(
        torch, np.dtype(dtype).name), device="cpu"))
    pinv = pslv.amg.coarse_solver.solve_data()["inv"]
    assert pinv.dtype == getattr(torch, np.dtype(dtype).name)
    assert rel(pinv, jinv) <= tol


# ---------------------------------------------------------------------------
# the untouched FLAGSHIP: every inner cycle at 16^3 is one tail
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship_tail():
    cfg = FLAGSHIP + ", store_res_history=1"
    with ps.force_pallas_interpret():
        js = jx.create_solver(JaxConfig.from_string(cfg))
        js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
        rj = js.solve(np.ones(16 ** 3))
    ps_ = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
    ps_.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    rp = ps_.solve(torch.ones(16 ** 3, dtype=torch.float64))
    return rj, rp


def test_flagship_is_the_jax_preset():
    assert FLAGSHIP == JAX_FLAGSHIP


def test_flagship_status_and_iterations(flagship_tail):
    rj, rp = flagship_tail
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations


def test_flagship_residual_history(flagship_tail):
    rj, rp = flagship_tail
    hj, hp = np.asarray(rj.res_history), np.asarray(rp.res_history)
    assert hp.shape == hj.shape
    assert np.abs(hp - hj).max() <= HIST_TOL * hj[0]


def test_flagship_solution(flagship_tail):
    rj, rp = flagship_tail
    A = pt.gallery.poisson("7pt", 16, 16, 16, device="cpu").init()
    b = torch.ones(16 ** 3, dtype=torch.float64)
    from amgx_tpu_torch.ops.spmv import residual
    true_rel = float(torch.linalg.norm(residual(A, rp.x, b))
                     / torch.linalg.norm(b))
    assert true_rel <= 1e-8
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL
