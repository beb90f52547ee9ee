"""Pairwise-aggregation AMG in amgx_tpu_torch against the JAX package, on
the CPU: the matching selectors (SIZE_2/4/8, MULTI_PAIRWISE, DUMMY) and
their edge weights, the relabel Galerkin plan and its value phase (B10's
relabel form through its plain twin, against the JAX package's XLA
route, its numpy route and its Pallas kernel under the interpreter), the
ordered restriction, the transfer-table caps and `with_values`. AmgX's
stock aggregation files solved in both packages, with a structure-reuse
resetup, are in test_torch_aggregation_solve.py (a file of its own, so
that a run that hands out whole files to its workers runs the two
halves side by side).

The JAX side runs as its own tests run it: its default host setup, its
Pallas kernel under the interpreter where the kernel is compared. Its
native helpers do not build on every machine; its pure-Python routes
are then the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.amg.aggregation import selectors as jsel
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.matrix import forced_device_setup
from amgx_tpu.ops import pallas_spgemm as pk
from amgx_tpu.ops import spgemm as jsp
from amgx_tpu.ops import stencil as jst
from amgx_tpu.ops.pallas_spmv import force_pallas_interpret

import amgx_tpu_torch as pt
from amgx_tpu_torch import registry
from amgx_tpu_torch.amg.aggregation import selectors as psel
from amgx_tpu_torch.amg.hierarchy import AMG
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.errors import BadParametersError
from amgx_tpu_torch.ops import cuda_rap, cuda_spmv as K, spgemm
from amgx_tpu_torch.ops import stencil as mf
from amgx_tpu_torch.ops.smooth import (TRANSFER_MAX_CHILD,
                                       build_transfer_tables, children_index,
                                       children_table, restrict_children)
from amgx_tpu_torch.solvers.relaxation import safe_recip

from _torch_util import grid_operator, rel
from chip_smoke import scaled_values

ODD = (11, 9, 7)
# f64: the same relabel sums in another association (numpy's reduceat
# adds a run as a0 + (a1 + a2 + ...)): ulps
TOL64 = 1e-12
# f32: one rounding per addition
TOL32 = 1e-6
MATCHING = ["SIZE_2", "SIZE_4", "SIZE_8", "MULTI_PAIRWISE"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[np.float64, np.float32],
                ids=["f64", "f32"])
def odd(request):
    """The random-coefficient 7-pt operator on 11x9x7 (JAX, port)."""
    return grid_operator(ODD, request.param)


def _selector_cfg(sel, formula, merge):
    extra = ""
    if sel == "MULTI_PAIRWISE":
        # two passes; formula 1 through notay_weights, its own switch
        extra = ", aggregation_passes=2" + (
            ", notay_weights=1" if formula else "")
    elif formula:
        extra = ", weight_formula=1"
    return f"selector={sel}, merge_singletons={merge}{extra}"


@jax.jit
def _jax_weights(A):
    rows, cols, w = jsel._edge_weights(A, 0)
    return w, w * (1.0 + 1e-3 * jsel._edge_hash(rows, cols).astype(w.dtype))


@jax.jit
def _jax_weights_notay(A):
    rows, cols, w = jsel._edge_weights(A, 1)
    return w, w * (1.0 + 1e-3 * jsel._edge_hash(rows, cols).astype(w.dtype))


@pytest.mark.parametrize("merge", [0, 1])
@pytest.mark.parametrize("formula", [0, 1])
@pytest.mark.parametrize("sel", MATCHING)
def test_selector_matches_jax(odd, sel, formula, merge):
    """The edge weights (raw and hash-perturbed) bit-equal to the JAX
    package's compiled ones; the aggregates and the coarse size equal."""
    Aj, Ap = odd
    w_j, wp_j = (_jax_weights_notay if formula else _jax_weights)(Aj)
    rows, cols, w = psel._edge_weights(Ap, formula)
    wp = w * (1.0 + 1e-3 * psel._edge_hash(rows, cols).to(w.dtype))
    assert np.array_equal(w.numpy(), np.asarray(w_j))
    assert np.array_equal(wp.numpy(), np.asarray(wp_j))
    cs = _selector_cfg(sel, formula, merge)
    aj, ncj = jx.registry.aggregation_selectors.create(
        sel, JaxConfig.from_string(cs), "default").set_aggregates(Aj)
    ap, ncp = registry.aggregation_selectors.create(
        sel, Config.from_string(cs), "default").set_aggregates(Ap)
    assert ap.dtype == torch.int32 and ncp == int(ncj)
    assert np.array_equal(ap.numpy(), np.asarray(aj))


@pytest.mark.parametrize("sel", ["SIZE_4", "SIZE_8"])
def test_collapsed_graph_sums_coarse_edges_only(monkeypatch, sel):
    """A later matching pass sums each coarse edge's weights over that
    edge's entries only. The entries collapsed inside an aggregate (most
    of them after a pass) are left out of the ordered sum, whose steps
    follow the longest segment: with them in one segment, SIZE_8's
    128^3 setup took minutes on the card. The aggregates are the JAX
    package's (test_selector_matches_jax)."""
    longest = []
    real = psel.ordered_segment_sum

    def spy(values, starts):
        lengths = starts[1:] - starts[:-1]
        longest.append(int(lengths.max()) if lengths.numel() else 0)
        return real(values, starts)

    monkeypatch.setattr(psel, "ordered_segment_sum", spy)
    Ap = pt.gallery.poisson("7pt", 16, 16, 16, device="cpu")
    registry.aggregation_selectors.create(
        sel, Config.from_string(f"selector={sel}"),
        "default").set_aggregates(Ap)
    assert len(longest) == (1 if sel == "SIZE_4" else 2)
    # a coarse edge joins at most a few fine edges (8 at 16^3)
    assert max(longest) <= 16


def test_dummy_selector_matches_jax(odd):
    Aj, Ap = odd
    cs = "selector=DUMMY, aggregate_size=3"
    aj, ncj = jx.registry.aggregation_selectors.create(
        "DUMMY", JaxConfig.from_string(cs), "default").set_aggregates(Aj)
    ap, ncp = registry.aggregation_selectors.create(
        "DUMMY", Config.from_string(cs), "default").set_aggregates(Ap)
    assert ncp == ncj and np.array_equal(ap.numpy(), np.asarray(aj))


# -- the relabel Galerkin ---------------------------------------------------


@pytest.fixture(scope="module", params=[((16, 16, 16), "SIZE_2"),
                                        (ODD, "SIZE_4")],
                ids=["16^3_SIZE_2", "odd_SIZE_4"])
def relabel_case(request):
    """(JAX A f64, port A f64, JAX A f32, port A f32, aggregates, nc,
    external diagonal): one level's relabel inputs."""
    shape, sel = request.param
    Aj, Ap = grid_operator(shape, np.float64, seed=3)
    Aj32, Ap32 = grid_operator(shape, np.float32, seed=3)
    agg, nc = jx.registry.aggregation_selectors.create(
        sel, JaxConfig.from_string(f"selector={sel}"),
        "default").set_aggregates(Aj)
    diag = np.random.default_rng(7).uniform(0.5, 1.5, Aj.num_rows)
    return Aj, Ap, Aj32, Ap32, np.asarray(agg), int(nc), diag


def _with_diag(Aj, diag):
    """The JAX matrix with an external diagonal (folded by its plans)."""
    return dataclasses.replace(Aj, diag=jnp.asarray(diag.astype(
        np.asarray(Aj.values).dtype)))


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold_diag"])
def test_agg_plan_equals_jax(relabel_case, fold):
    Aj, Ap, _, _, agg, nc, diag = relabel_case
    jplan = jsp.build_agg_plan(_with_diag(Aj, diag) if fold else Aj, agg,
                               nc)
    plan = spgemm.build_agg_plan(Ap, _t(agg), nc, fold_diag=fold)
    assert jplan.fold_diag == plan.fold_diag == fold
    for mine, theirs in ((plan.st, jplan.st), (plan.starts2, jplan.starts2),
                         (plan.row_offsets, jplan.row_offsets),
                         (plan.col_indices, jplan.col_indices)):
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    assert (plan.nU, plan.num_rows) == (jplan.nU, jplan.num_rows)


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold_diag"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_relabel_values_match_jax(relabel_case, dtype, fold):
    """The coarse values bit-equal to the JAX package's planned XLA route
    (the route its device setups take: each run added left to right), and
    within a rounding of its host numpy route, whose reduceat adds a run
    as a0 + (a1 + a2 + ...)."""
    Aj, Ap, Aj32, Ap32, agg, nc, diag = relabel_case
    if dtype == "f32":
        Aj, Ap = Aj32, Ap32
    dt = np.asarray(Aj.values).dtype
    Ajd = _with_diag(Aj, diag) if fold else Aj
    jplan = jsp.build_agg_plan(Ajd, agg, nc)
    plan = spgemm.build_agg_plan(Ap, _t(agg), nc, fold_diag=fold)
    before = dict(K.LAUNCHES)
    got = spgemm.agg_values(plan, Ap.values,
                            _t(diag.astype(dt)) if fold else None)
    assert K.LAUNCHES == before                  # the CPU route launches none
    assert got.dtype == Ap.values.dtype
    with forced_device_setup(True):
        xla = np.asarray(jsp.rap_values(jplan, Ajd))
    host = np.asarray(jsp.rap_values(jplan, Ajd))
    assert np.array_equal(got.numpy(), xla)
    assert rel(got, host) <= (TOL64 if dtype == "f64" else TOL32)
    # the coarse operator keeps the plan's pattern, in A's dtype
    Ac = spgemm.plan_coarse_matrix(plan, Ap, _t(diag.astype(dt))
                                   if fold else None)
    assert Ac.row_offsets is plan.row_offsets and Ac.dtype == Ap.dtype


def test_relabel_matches_pallas_kernel(relabel_case):
    """B10's relabel form: the plain twin against the JAX package's
    Pallas kernel (has1=False, has_r=False) under the interpreter."""
    _, _, Aj, Ap, agg, nc, _ = relabel_case
    jplan = jsp.build_agg_plan(Aj, agg, nc)
    plan = spgemm.build_agg_plan(Ap, _t(agg), nc)
    with force_pallas_interpret():
        assert pk.rap_kernel_ready(jplan, jnp.float32)
        want = pk.rap_value_call(jplan, jnp.asarray(Aj.values), None, None)
    got = cuda_rap.rap_values_relabel(plan, Ap.values)
    assert got.dtype == torch.float32
    assert rel(got, want) <= TOL32


def test_relabel_wrapper_refuses_other_devices():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    the meta device, before any launch."""
    plan = spgemm.AggPlan(
        st=torch.zeros(4, dtype=torch.int32, device="meta"),
        starts2=torch.zeros(3, dtype=torch.int32, device="meta"),
        row_offsets=torch.zeros(3, dtype=torch.int32),
        col_indices=torch.zeros(2, dtype=torch.int32), num_rows=2,
        num_cols=2)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rap.rap_values_relabel(plan, torch.zeros(4, device="meta"))
    assert K.LAUNCHES == before


# -- transfers ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ordered_restriction_equals_index_add(odd, dtype):
    """The children-table restriction gives index_add_'s bits on the CPU
    (children added in ascending fine index), at the level's API too."""
    _, Ap = odd
    agg, nc = registry.aggregation_selectors.create(
        "SIZE_4", Config.from_string("selector=SIZE_4"),
        "default").set_aggregates(Ap)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        Ap.num_rows)).to(dtype)
    want = torch.zeros(nc, dtype=dtype).index_add_(0, agg.long(), r)
    got = restrict_children(children_index(children_table(agg, nc),
                                           Ap.num_rows), r)
    assert torch.equal(got, want)
    amg = AMG(Config.from_string(
        "algorithm=AGGREGATION, selector=SIZE_4, max_levels=2,"
        " smoother=BLOCK_JACOBI")).setup(Ap)
    lv = amg.levels[0]
    assert torch.equal(lv.restrict(lv.level_data(), r.to(Ap.dtype)),
                       torch.zeros(lv.coarse_size, dtype=Ap.dtype).index_add_(
                           0, lv.aggregates.long(), r.to(Ap.dtype)))


@pytest.mark.parametrize("case", ["16_children", "17_children", "csr_level"])
def test_transfer_table_caps(case):
    """Fused transfer tables only on a DIA level whose aggregates have at
    most TRANSFER_MAX_CHILD rows (the JAX package's caps)."""
    _, Ap = grid_operator((8, 8, 6), np.float32)
    n = Ap.num_rows
    size = 17 if case == "17_children" else TRANSFER_MAX_CHILD
    agg = torch.arange(n, dtype=torch.int32) // size
    nc = int(agg.max()) + 1
    if case == "csr_level":
        Ap = dataclasses.replace(Ap, dia_offsets=None, dia_vals=None)
    out = build_transfer_tables(Ap, agg, nc)
    if case == "16_children":
        assert out["ctab"].shape == (TRANSFER_MAX_CHILD, nc)
        assert torch.equal(out["ctab"], children_table(agg, nc))
    else:
        assert out is None


@pytest.mark.parametrize("kind", ["restrict", "corr", "corr_dot"])
def test_coefficient_forms_on_size2_tables(kind):
    """The coefficient-mode plain forms (B3-mf, B4-mf, B4-mf's dot) on a
    SIZE_2 level 0's irregular children table: bit-equal to the slab
    forms with BLOCK_JACOBI's dinv, and to the JAX package's XLA forms
    within float32 kernel math."""
    shape = (12, 10, 8)
    Ap = pt.gallery.poisson("7pt", *shape, dtype=torch.float32,
                            device="cpu").init()
    Aj = jx.gallery.poisson("7pt", *shape, dtype=np.float32).init()
    agg, nc = registry.aggregation_selectors.create(
        "SIZE_2", Config.from_string("selector=SIZE_2"),
        "default").set_aggregates(Ap)
    xfer = build_transfer_tables(Ap, agg, nc)
    assert 2 < xfer["ctab"].shape[0] <= TRANSFER_MAX_CHILD
    sp = mf.detect_stencil(Ap, dinv_mode="jacobi")
    sj = jst.detect_stencil(Aj, dinv_mode="jacobi")
    rng = np.random.default_rng(11)
    b, x = (rng.standard_normal(Ap.num_rows).astype(np.float32)
            for _ in range(2))
    xc = rng.standard_normal(nc).astype(np.float32)
    taus = np.full(3, 0.8, np.float32)
    tb, tx, txc, tt = (_t(v) for v in (b, x, xc, taus))
    vals, offs = Ap.dia_vals, Ap.dia_offsets
    dinv = safe_recip(Ap.diagonal())
    jt, jb, jx_ = jnp.asarray(taus), jnp.asarray(b), jnp.asarray(x)
    if kind == "restrict":
        got = K.dia_smooth_restrict_mf(sp, tt, tb, tx, xfer["ctab"])
        slab = K.dia_smooth_restrict_plain(vals, offs, tt, tb, tx,
                                           xfer["ctab"], dinv)
        want = jst._xla_restrict(sj.spec(), sj.coeffs, jt, jb, jx_,
                                 jnp.asarray(xfer["ctab"].numpy())[:, :, None],
                                 nc)
    else:
        dot = kind == "corr_dot"
        got = K.dia_prolong_smooth_mf(sp, tt, tb, tx, txc, xfer["agg"],
                                      with_dot=dot)
        slab = K.dia_prolong_smooth_plain(vals, offs, tt, tb, tx, txc,
                                          xfer["agg"], dinv, with_dot=dot)
        want = jst._xla_corr(sj.spec(), sj.coeffs, jt, jb, jx_,
                             jnp.asarray(xc), jnp.asarray(agg.numpy()))
        if dot:
            want = (want, jst._xb_dot(want, jb))
    got, slab, want = (v if isinstance(v, tuple) else (v,)
                       for v in (got, slab, want))
    for g, s, w in zip(got, slab, want):
        assert torch.equal(g, s)
        w = np.asarray(w)
        assert float(np.max(np.abs(g.numpy() - w))) <= \
            TOL32 * max(float(np.max(np.abs(w))), 1.0)


def test_with_values_keeps_structure():
    Ap = pt.gallery.poisson("7pt", 6, 5, 4, dtype=torch.float32,
                            device="cpu").init()
    v2 = _t(scaled_values(Ap.row_offsets, Ap.col_indices, Ap.values))
    A2 = Ap.with_values(v2)
    assert A2.row_offsets is Ap.row_offsets \
        and A2.col_indices is Ap.col_indices and A2.values is v2
    fresh = dataclasses.replace(Ap, values=v2, initialized=False,
                                dia_offsets=None, dia_vals=None).init()
    assert A2.dia_offsets == fresh.dia_offsets
    assert torch.equal(A2.dia_vals, fresh.dia_vals)
    with pytest.raises(BadParametersError):
        Ap.with_values(v2[:-1])
