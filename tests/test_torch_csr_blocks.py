"""B8's row blocks (amgx_tpu_torch/ops/cuda_csr.py `csr_row_blocks`) and
the order in which csrc/csr.cu's row-block kernel sums, on the CPU.

The table is checked on the port's own classical 16^3 hierarchy (its CSR
operators, P and R) and on a hand-made matrix with empty rows and rows
around and past the long-row and chunk sizes. A numpy emulation of the
kernel -- each product rounded to float32, a row's products added in its
stored order, a long row's strided shares added by block_sum's fixed
tree -- is held against the plain form (`csr_spmv_plain`) and against
the JAX package's B8 (`swell_spmv`, its Pallas kernel under the
interpreter). The kernel itself is held against the plain form on the
card by chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.ops import pallas_swell as psw

import amgx_tpu_torch as pt
from amgx_tpu_torch.ops import cuda_csr as C

from _torch_util import rel
from chip_smoke import CLASSICAL, amg_of

THREADS = 256               # csrc/common.cuh kThreads
# float32: one rounded product and one rounded add per entry, in another
# order than the plain form's only within a long row
TOL32 = 1e-6


@functools.lru_cache(maxsize=None)
def _classical16():
    """The port's classical hierarchy of the 7-pt 16^3 (float32): label
    -> CsrMatrix for every CSR operator, P and R."""
    A = pt.gallery.poisson("7pt", 16, 16, 16, dtype=torch.float32,
                           device="cpu")
    amg = amg_of(pt, CLASSICAL, A, "cpu").amg
    mats = {}
    for i, lv in enumerate(amg.levels):
        for name in ("A", "P", "R"):
            M = getattr(lv, name, None)
            if M is not None and M.dia_offsets is None:
                mats[f"{name}{i}"] = M.astype(torch.float32)
    return mats


def _handmade():
    """Rows of 0, 1, 7, 128, 129 and 5000 entries (the last longer than a
    chunk) among runs of short rows that cross the row-block windows."""
    rng = np.random.default_rng(11)
    lens = ([3] * 700 + [0, 0, 128, 129, 1, 5000, 0] + [7] * 400
            + [0] * 1500 + [60] * 90 + [127, 2, 4096, 0, 1])
    ncols = 6000
    ro = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ci = np.concatenate([np.sort(rng.choice(ncols, n, replace=False))
                         for n in lens]).astype(np.int32)
    vals = rng.standard_normal(ro[-1]).astype(np.float32)
    return pt.CsrMatrix(torch.from_numpy(ro), torch.from_numpy(ci),
                        torch.from_numpy(vals), len(lens), ncols)


def _matrices():
    return {**_classical16(), "handmade": _handmade()}


def _labels():
    return ["P0", "R0", "A1", "P1", "R1", "A2", "P2", "R2",
            "handmade"]


def _tree32(v):
    """Lane 0 of a warp's shuffle-down tree (offsets 16 .. 1), float32."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v[:32 - o] = v[:32 - o] + v[o:]
    return v[0]


def _block_sum(shares):
    """common.cuh block_sum over THREADS float32 shares: each warp's tree,
    then warp 0's tree over the warp sums (zeros past them)."""
    warps = np.array([_tree32(shares[w * 32:(w + 1) * 32])
                      for w in range(THREADS // 32)], np.float32)
    lane = np.zeros(32, np.float32)
    lane[:warps.shape[0]] = warps
    return _tree32(lane)


def _emulate(M, x):
    """y = A x as csr_block_kernel sums it, from the row-block table;
    values and x float32 or bfloat16, y in x's dtype."""
    ro = M.row_offsets.numpy().astype(np.int64)
    rb = C.csr_row_blocks(M.row_offsets).numpy()
    prod = (M.values.float().numpy()
            * x.float().numpy()[M.col_indices.numpy()]).astype(np.float32)
    y = np.zeros(M.num_rows, np.float32)
    for r0, r1 in zip(rb[:-1], rb[1:]):
        e0, e1 = ro[r0], ro[r1]
        if r1 - r0 == 1 and e1 - e0 > C.CSR_LONG_ROW:
            shares = np.array([
                np.add.accumulate(prod[e0 + t:e1:THREADS], dtype=np.float32)
                [-1] if e0 + t < e1 else 0.0 for t in range(THREADS)],
                np.float32)
            y[r0] = _block_sum(shares)
            continue
        for r in range(r0, r1):
            seg = prod[ro[r]:ro[r + 1]]
            y[r] = np.add.accumulate(seg, dtype=np.float32)[-1] \
                if seg.size else 0.0
    return torch.from_numpy(y).to(x.dtype)


@pytest.mark.parametrize("label", _labels())
def test_row_blocks_cover_each_row_once(label):
    M = _matrices()[label]
    rb = C.csr_row_blocks(M.row_offsets)
    assert rb.dtype == torch.int32
    rb = rb.long().numpy()
    ro = M.row_offsets.long().numpy()
    lens = np.diff(ro)
    assert rb[0] == 0 and rb[-1] == M.num_rows
    assert (np.diff(rb) >= 1).all()
    for r0, r1 in zip(rb[:-1], rb[1:]):
        nnz = ro[r1] - ro[r0]
        if r1 - r0 == 1:
            continue                     # one row, of any length
        assert nnz <= C.CSR_CHUNK, (r0, r1, nnz)
        assert r1 - r0 <= C.CSR_BLOCK_ROWS
        assert (lens[r0:r1] <= C.CSR_LONG_ROW).all()
    if label == "handmade":
        long_rows = np.flatnonzero(lens > C.CSR_LONG_ROW)
        assert lens.max() > C.CSR_CHUNK and (lens == 0).sum() > 1000
        assert set(long_rows) <= set(rb[:-1]) and set(long_rows + 1) <= \
            set(rb)


def test_row_blocks_built_once_per_structure():
    """The table is cached on the row offsets tensor: a second product
    and a value resetup (the same structure tensors) reuse it."""
    M = _handmade()
    first = C._row_blocks(M.row_offsets)
    assert C._row_blocks(M.row_offsets) is first
    again = M.with_values(M.values * 2)
    assert again.row_offsets is M.row_offsets
    assert C._row_blocks(again.row_offsets) is first


@pytest.mark.parametrize("label", _labels())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_order_matches_plain(label, dtype):
    """The emulated kernel against the plain form: within TOL32 of the
    largest |y| in float32; in bfloat16 (exact products, float32 sums,
    one rounding) within one bf16 rounding of each entry."""
    M = _matrices()[label]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        M.num_cols).astype(np.float32)).to(dtype)
    if dtype == torch.bfloat16:
        M = M.astype(torch.bfloat16)
    got = _emulate(M, x)
    want = C.csr_spmv_plain(M.row_offsets, M.col_indices, M.values, x)
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= TOL32 * scale
    else:
        g, w = got.double(), want.double()
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
            g.abs(), w.abs()).clamp_min(2.0 ** -126))) - 7)
        assert bool(((g - w).abs() <= ulp).all())


@pytest.mark.parametrize("label", ["A1", "P1", "R1"])
def test_kernel_order_matches_jax_b8(label):
    """The emulated kernel against the JAX package's B8 on the same
    matrix (its SWELL kernel under the interpreter)."""
    M = _classical16()[label]
    x = np.random.default_rng(5).standard_normal(M.num_cols).astype(
        np.float32)
    Aj = jx.CsrMatrix.from_scipy_like(
        M.row_offsets.numpy(), M.col_indices.numpy(), M.values.numpy(),
        M.num_rows, M.num_cols).init()
    assert Aj.swell_vals is not None
    yj = psw.swell_spmv(Aj, jnp.asarray(x), interpret=True)
    assert rel(_emulate(M, torch.from_numpy(x)), yj) < TOL32
