"""GEO-aggregation hierarchy parity: amgx_tpu_torch's setup against the
JAX package's on the same Poisson operator (float64), at 16^3 and a
ragged 12x10x8 grid. Checks level count and sizes, aggregates (bit
equal), every coarse operator's diagonals and the Chebyshev taus."""
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig

import amgx_tpu_torch as pt
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

AMG_CFG = ("solver=AMG, algorithm=AGGREGATION, selector=GEO,"
           " smoother=CHEBYSHEV_POLY, chebyshev_polynomial_order=2,"
           " presweeps=1, postsweeps=1, max_iters=1, cycle=V,"
           " max_levels=50, min_coarse_rows=32, cycle_fusion_tail_rows=0")
GRIDS = [(16, 16, 16), (12, 10, 8)]
# f64 setup arithmetic: the same sums, at most reordered
TOL64 = 1e-12


@pytest.fixture(scope="module", params=GRIDS, ids=lambda s: "x".join(
    map(str, s)))
def pair(request):
    shape = request.param
    js = jx.create_solver(JaxConfig.from_string(AMG_CFG))
    js.setup(jx.gallery.poisson("7pt", *shape).init())
    ps = pt.create_solver(pt.Config.from_string(AMG_CFG), device="cpu")
    ps.setup(pt.gallery.poisson("7pt", *shape, device="cpu"))
    return shape, js, ps


def _dia(A):
    """(offsets, (k, n) diagonals) of a JAX or port matrix."""
    if isinstance(A.dia_vals, torch.Tensor):
        return A.dia_offsets, A.dia_vals.numpy()
    k = len(A.dia_offsets)
    return A.dia_offsets, np.asarray(A.dia_vals).reshape(k, -1)[
        :, :A.num_rows]


def test_gallery_csr_bitwise(pair):
    shape = pair[0]
    J = jx.gallery.poisson("7pt", *shape)
    P = pt.gallery.poisson("7pt", *shape, device="cpu")
    assert np.array_equal(np.asarray(J.row_offsets), P.row_offsets.numpy())
    assert np.array_equal(np.asarray(J.col_indices), P.col_indices.numpy())
    assert np.array_equal(np.asarray(J.values), P.values.numpy())
    assert P.grid_shape == J.grid_shape


def test_level_sizes(pair):
    _, js, ps = pair
    jrows = [lv.A.num_rows for lv in js.amg.levels] + [
        js.amg.coarsest_A.num_rows]
    assert ps.amg.level_rows() == jrows
    assert [lv.geo_coarse_shape for lv in ps.amg.levels] == [
        lv.geo_coarse_shape for lv in js.amg.levels]


def test_aggregates_bit_equal(pair):
    _, js, ps = pair
    for jl, pl in zip(js.amg.levels, ps.amg.levels):
        assert pl.coarse_size == jl.coarse_size
        assert np.array_equal(pl.aggregates.numpy(),
                              np.asarray(jl.aggregates))


def test_coarse_operators(pair):
    _, js, ps = pair
    jm = [lv.A for lv in js.amg.levels[1:]] + [js.amg.coarsest_A]
    pm = [lv.A for lv in ps.amg.levels[1:]] + [ps.amg.coarsest_A]
    assert len(jm) == len(pm)
    for J, P in zip(jm, pm):
        (jo, jd), (po, pd) = _dia(J), _dia(P)
        assert po == jo
        assert np.abs(pd - jd).max() <= TOL64 * np.abs(jd).max()
        # the CSR form holds the same entries as the JAX coarse operator
        assert np.array_equal(P.row_offsets.numpy(),
                              np.asarray(J.row_offsets))
        assert np.array_equal(P.col_indices.numpy(),
                              np.asarray(J.col_indices))


def test_chebyshev_taus(pair):
    _, js, ps = pair
    jdata = js.solve_data()["amg"]["levels"]
    for i, pl in enumerate(ps.amg.levels):
        jt = np.asarray(jdata[i]["smoother"]["taus"])
        assert np.abs(pl.smoother._taus.numpy() - jt).max() <= \
            TOL64 * np.abs(jt).max()


def test_dense_coarse_solve(pair):
    """The coarsest-level QR solve reproduces the JAX package's."""
    _, js, ps = pair
    n = js.amg.coarsest_A.num_rows
    b = np.random.default_rng(5).standard_normal(n)
    xj = np.asarray(js.amg.coarse_solver.apply(
        js.solve_data()["amg"]["coarse"], b))
    xp = ps.amg.coarse_solver.apply(ps.amg.coarse_solver.solve_data(),
                                    torch.from_numpy(b)).numpy()
    assert np.linalg.norm(xp - xj) <= TOL64 * np.linalg.norm(xj)
