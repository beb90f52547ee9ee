"""The colorings and the multicolor smoothers of amgx_tpu_torch against
the JAX package's, on the CPU: the same matrices (made from numpy arrays
with a seed) go to both packages.

- every coloring scheme gives the JAX package's colors bit for bit, and
  a valid coloring (no edge, or at coloring_level 2 no path of two
  edges, joins two rows of one color), at two grid shapes;
- the uint32 hash, computed in int64, equals the JAX package's;
- MULTICOLOR_DILU's Einv within 1e-14 relative (float64) or 2 ulp
  (float32), on random-valued operators, one with an unsymmetric
  pattern;
- one MULTICOLOR_GS / symmetric GS / FIXCOLOR_GS / DILU sweep within
  1e-13 (float64) or 1e-6 (float32) relative, on the port's own setup
  and on the JAX package's (interop.py carries its colors and Einv);
- a block matrix raises (item 8.4), and GS, MULTICOLOR_ILU and
  CF_JACOBI, once refused, sweep as the JAX package does.

The stock configs/ files that name these smoothers are in
tests/test_torch_idr_scalers.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.ops import coloring as jcol
from amgx_tpu.solvers.base import make_solver as jx_make_solver

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch.ops import coloring as pcol
from amgx_tpu_torch.solvers.base import make_solver as pt_make_solver

from _torch_util import grid_operator, jax_hierarchy_arrays, rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

SHAPES = [(8, 8, 8), (7, 5, 9)]
SCHEMES = ["MIN_MAX", "PARALLEL_GREEDY", "LOCALLY_DOWNWIND",
           "GREEDY_RECOLOR", "MIN_MAX_2RING", "GREEDY_MIN_MAX_2RING",
           "MULTI_HASH", "ROUND_ROBIN", "UNIFORM", "SERIAL_GREEDY_BFS"]
# schemes whose coloring is a distance-2 one at this coloring_level
DISTANCE2 = {"MIN_MAX_2RING", "GREEDY_MIN_MAX_2RING"}
LEVEL2 = {"MIN_MAX", "PARALLEL_GREEDY", "LOCALLY_DOWNWIND",
          "GREEDY_RECOLOR"}
SWEEP_TOL = {np.float32: 1e-6, np.float64: 1e-13}


def _poisson_pair(shape):
    Aj = jx.gallery.poisson("7pt", *shape).init()
    Ap = pti.matrix_from_numpy(np.asarray(Aj.row_offsets),
                               np.asarray(Aj.col_indices),
                               np.asarray(Aj.values), Aj.num_rows,
                               Aj.num_cols, grid_shape=shape, device="cpu")
    return Aj, Ap


def _cfgs(text):
    return jx.Config.from_string(text), pt.Config.from_string(text)


def _edges(ro, ci, n):
    rows = np.repeat(np.arange(n), np.diff(ro))
    off = rows != ci
    return rows[off], ci[off]


@pytest.mark.parametrize("salts", [range(0, 16), range(16, 32),
                                   range(32, 48), range(48, 64)])
def test_hash_matches_jax(salts):
    for salt in salts:
        want = np.asarray(jcol._hash_w(1000, salt)).astype(np.int64)
        got = pcol._hash_w(1000, salt).numpy()
        assert np.array_equal(got, want), salt
        assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_coloring_matches_jax(scheme, shape, level):
    Aj, Ap = _poisson_pair(shape)
    jc, pc = _cfgs(f"matrix_coloring_scheme={scheme}, "
                   f"coloring_level={level}")
    cj = jcol.color_matrix(Aj, jc)
    cp = pcol.color_matrix(Ap, pc)
    assert cp.row_colors.dtype == torch.int32
    assert np.array_equal(cp.row_colors.numpy(), np.asarray(cj.row_colors))
    assert cp.num_colors == int(cj.num_colors)
    colors = cp.row_colors.numpy()
    assert colors.min() >= 0 and colors.max() == cp.num_colors - 1
    ro, ci = np.asarray(Aj.row_offsets), np.asarray(Aj.col_indices)
    r, c = _edges(ro, ci, Aj.num_rows)
    assert not np.any(colors[r] == colors[c]), "an edge joins one color"
    if scheme in DISTANCE2 or (level == 2 and scheme in LEVEL2):
        import scipy.sparse as sp
        S = sp.csr_matrix((np.ones(ci.shape[0]), ci, ro))
        S2 = (S @ S).tocsr()
        r2, c2 = _edges(S2.indptr, S2.indices, Aj.num_rows)
        assert not np.any(colors[r2] == colors[c2]), "distance 2"


def test_min_max_color_count():
    """The 7-point grid takes 11 MIN_MAX colors at 16^3 (as in the JAX
    package), and GREEDY_RECOLOR never takes more."""
    _, Ap = _poisson_pair((16, 16, 16))
    _, pc = _cfgs("matrix_coloring_scheme=MIN_MAX")
    assert pcol.color_matrix(Ap, pc).num_colors == 11
    _, pc = _cfgs("matrix_coloring_scheme=GREEDY_RECOLOR")
    assert pcol.color_matrix(Ap, pc).num_colors <= 11


def _unsym_pattern(dtype, seed=3):
    """A random-valued 7-point operator with a fifth of its off-diagonal
    entries dropped: a_ij stored without a_ji."""
    Aj, _ = grid_operator((6, 7, 5), dtype, seed)
    ro, ci = np.asarray(Aj.row_offsets), np.asarray(Aj.col_indices)
    vals = np.asarray(Aj.values)
    n = Aj.num_rows
    rows = np.repeat(np.arange(n), np.diff(ro))
    keep = (rows == ci) | (np.random.default_rng(seed).random(ci.shape[0])
                           > 0.2)
    ro2 = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=ro2[1:])
    Aj2 = jx.CsrMatrix.from_scipy_like(ro2, ci[keep], vals[keep], n,
                                       n).init()
    Ap2 = pti.matrix_from_numpy(ro2, ci[keep], vals[keep], n, n,
                                device="cpu")
    return Aj2, Ap2


def _operators(case, dtype):
    if case == "unsym_pattern":
        return _unsym_pattern(dtype)
    shape = {"grid_8": (8, 8, 8), "grid_ragged": (7, 5, 9)}[case]
    return grid_operator(shape, dtype, seed=2)


def _smoothers(name, Aj, Ap, extra=""):
    text = f"{name.lower()}:relaxation_factor=0.8{extra}"
    jc, pc = _cfgs(f"solver(s)={name}, " + text)
    sj = jx_make_solver(name, jc, "s")
    sj.setup(Aj)
    sp_ = pt_make_solver(name, pc, "s", "cpu")
    sp_.setup(Ap)
    return sj, sp_


def _ulps(got, want):
    return np.abs(got - want) / np.spacing(np.abs(want).astype(want.dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["grid_8", "grid_ragged", "unsym_pattern"])
def test_dilu_einv_matches_jax(case, dtype):
    Aj, Ap = _operators(case, dtype)
    sj, sp_ = _smoothers("MULTICOLOR_DILU", Aj, Ap)
    assert np.array_equal(sp_.row_colors.numpy(), np.asarray(sj.row_colors))
    want = np.asarray(sj._Einv)
    got = sp_._Einv.numpy()
    assert got.dtype == want.dtype
    if dtype == np.float64:
        assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    else:
        assert _ulps(got, want).max() <= 2


SWEEPS = [("MULTICOLOR_GS", ""), ("MULTICOLOR_GS", ", s:symmetric_GS=1"),
          ("FIXCOLOR_GS", ""), ("MULTICOLOR_DILU", "")]


def _sweep_pair(sj, sp_, dtype, seed=5):
    rng = np.random.default_rng(seed)
    n = sp_.A.num_rows
    b = rng.standard_normal(n).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    xj = sj.solve_iteration(sj.solve_data(), b, {"x": x})["x"]
    xp = sp_.solve_iteration(sp_.solve_data(), torch.from_numpy(b),
                             {"x": torch.from_numpy(x)})["x"]
    return np.asarray(xj), xp


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["grid_ragged", "unsym_pattern"])
@pytest.mark.parametrize("name,extra", SWEEPS,
                         ids=["gs", "sym_gs", "fixcolor_gs", "dilu"])
def test_sweep_matches_jax(name, extra, case, dtype):
    Aj, Ap = _operators(case, dtype)
    sj, sp_ = _smoothers(name, Aj, Ap, extra)
    xj, xp = _sweep_pair(sj, sp_, dtype)
    assert xp.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert rel(xp, xj) <= SWEEP_TOL[dtype]


@pytest.mark.parametrize("name", ["MULTICOLOR_GS", "MULTICOLOR_DILU"])
def test_sweep_on_jax_setup(name):
    """The port's sweep on the JAX package's exact coloring and Einv /
    dinv, carried in through interop.hierarchy_from_numpy: one V-cycle of
    a two-level aggregation hierarchy equals the JAX package's."""
    cfg = (f"solver(amg)=AMG, amg:algorithm=AGGREGATION, amg:selector=SIZE_2,"
           f" amg:smoother={name}, amg:presweeps=1, amg:postsweeps=2,"
           f" amg:max_iters=1, amg:max_levels=2, amg:relaxation_factor=0.9,"
           f" amg:cycle_fusion=0")
    Aj, Ap = grid_operator((7, 5, 9), np.float64, seed=4)
    js = jx.create_solver(jx.Config.from_string(cfg))
    js.setup(Aj)
    levels, coarse = jax_hierarchy_arrays(js)
    assert levels[0]["row_colors"] is not None
    pc = pt.Config.from_string(cfg)
    amg = pti.hierarchy_from_numpy(levels, coarse, pc, "amg", device="cpu")
    sm = amg.levels[0].smoother
    assert sm.row_colors is not None and sm.num_colors == \
        levels[0]["num_colors"]
    b = np.random.default_rng(6).standard_normal(Ap.num_rows)
    xj = js.solve(b).x
    xp = amg.cycle(amg.solve_data(), torch.from_numpy(b),
                   torch.zeros(Ap.num_rows, dtype=torch.float64))
    assert rel(xp, np.asarray(xj)) <= 1e-13


def test_smoother_data_and_routes():
    """The color masks partition the rows and are made once per coloring;
    a DILU level has no fused hooks (the cycle composes its sweeps) and
    the matrix-free detector leaves it its value slab."""
    _, Ap = grid_operator((8, 8, 8), np.float32, seed=2)
    pc = pt.Config.from_string("solver(s)=MULTICOLOR_DILU")
    s = pt_make_solver("MULTICOLOR_DILU", pc, "s", "cpu")
    s.setup(Ap)
    masks = s.color_masks()
    assert len(masks) == s.num_colors
    assert int(sum(m.int() for m in masks).min()) == 1
    assert s.color_masks() is masks
    for hook in ("smooth_restrict", "smooth_corr", "fused_tail_spec"):
        assert not hasattr(s, hook)
    cfg = pt.Config.from_string(
        "solver(amg)=AMG, amg:algorithm=AGGREGATION, amg:selector=SIZE_2,"
        " amg:smoother=MULTICOLOR_DILU, amg:max_levels=3,"
        " amg:matrix_free=1")
    slv = pt.create_solver(cfg, device="cpu")
    slv.setup(Ap)
    for lv, ld in zip(slv.amg.levels, slv.amg.solve_data()["levels"]):
        assert lv.smoother._mf_stencil is None and "stencil" not in ld


def test_block_matrix_and_unported_solvers_raise():
    """A block matrix still raises in every solver of the module, naming
    item 8.4; GS, MULTICOLOR_ILU and CF_JACOBI, which raised before they
    were ported, now take one sweep within 1e-13 of the JAX package's."""
    Aj, Ap = grid_operator((4, 4, 4), np.float64)
    block = dataclasses.replace(Ap, values=Ap.values[:, None, None].repeat(
        1, 2, 2))
    pc = pt.Config.from_string("solver(s)=MULTICOLOR_DILU")
    for name in ("MULTICOLOR_DILU", "MULTICOLOR_GS", "GS", "MULTICOLOR_ILU",
                 "CF_JACOBI"):
        s = pt_make_solver(name, pc, "s", "cpu")
        with pytest.raises(NotImplementedError, match="Queue A item 8.4"):
            s.setup(block)
    jc = jx.Config.from_string("solver(s)=GS")
    cf = (np.arange(Ap.num_rows) % 3 == 0).astype(np.int32)
    rng = np.random.default_rng(3)
    x, b = rng.standard_normal(Ap.num_rows), rng.standard_normal(Ap.num_rows)
    for name in ("GS", "MULTICOLOR_ILU", "CF_JACOBI"):
        js = jx_make_solver(name, jc, "s")
        s = pt_make_solver(name, pc, "s", "cpu")
        if name == "CF_JACOBI":
            js.set_cf_map(cf)
            s.set_cf_map(torch.from_numpy(cf))
        js.setup(Aj)
        s.setup(Ap)
        data = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in js.solve_data().items()}
        want = js.solve_iteration(data, jnp.asarray(b),
                                  {"x": jnp.asarray(x)})["x"]
        got = s.solve_iteration(s.solve_data(), torch.from_numpy(b),
                                {"x": torch.from_numpy(x)})["x"]
        assert rel(got, np.asarray(want)) <= 1e-13, name
