"""Item 8's selectors, strength and IO of amgx_tpu_torch against the JAX
package's, on the CPU (float64 unless named): the same matrices go to
both packages, and every integer result must be equal.

- the device-parallel RS sweep's split (`rs_sweep`) and its dispatch
  (`selector_device_sweep` 1 / 0 / auto, auto sweeping under
  `setup_backend=device` as the JAX package does under its device
  setup), on the 5-pt 16^2 / 24^2 and 7-pt 8^3 / 12^3 Poisson;
- AFFINITY's strong mask (float64 and float32);
- the PARALLEL_GREEDY, SERIAL_GREEDY(_BFS) and ADAPTIVE aggregates, and
  the JAX tests' FGMRES solves with them (tests/test_amg.py
  `TestSelectorVariants`): the same status and iterations;
- `gallery.random_matrix` and ops/permute.py: equal arrays, the
  permutation round trip bit for bit; block values raise and name item
  8.4.
"""
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu import registry as jreg
from amgx_tpu.amg.classical import selectors as jsel
from amgx_tpu.matrix import forced_device_setup
from amgx_tpu.ops import permute as jperm

import amgx_tpu_torch as pt
from amgx_tpu_torch import registry as preg
from amgx_tpu_torch.amg.classical import selectors as psel
from amgx_tpu_torch.ops import permute as pperm
from amgx_tpu_torch.telemetry import metrics as pm

from _torch_util import rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

SHAPES = {"5pt_16^2": ("5pt", 16, 16, 1), "5pt_24^2": ("5pt", 24, 24, 1),
          "7pt_8^3": ("7pt", 8, 8, 8), "7pt_12^3": ("7pt", 12, 12, 12)}
STRENGTH = "strength_threshold=0.25"
AGG = ["PARALLEL_GREEDY", "SERIAL_GREEDY", "SERIAL_GREEDY_BFS", "ADAPTIVE"]
AGG_EXTRA = {"SERIAL_GREEDY": ", aggregate_size=4",
             "SERIAL_GREEDY_BFS": ", aggregate_size=3",
             "ADAPTIVE": ", determinism_flag=1", "PARALLEL_GREEDY": ""}


def _pair(key, dtype=np.float64):
    pts, nx, ny, nz = SHAPES[key]
    return (jx.gallery.poisson(pts, nx, ny, nz, dtype=dtype).init(),
            pt.gallery.poisson(pts, nx, ny, nz, device="cpu",
                               dtype=getattr(torch, np.dtype(dtype).name))
            .init())


def _strong(Aj, Ap, name="AHAT", text=STRENGTH):
    sj = jreg.strength.create(name, jx.Config.from_string(text),
                              "default").strong_mask(Aj)
    sp = preg.strength.create(name, pt.Config.from_string(text),
                              "default").strong_mask(Ap)
    return np.asarray(sj), sp


@pytest.mark.parametrize("key", list(SHAPES))
def test_rs_sweep_matches_jax(key):
    Aj, Ap = _pair(key)
    sj, sp = _strong(Aj, Ap)
    assert np.array_equal(sj, sp.numpy())
    cj = np.asarray(jsel.rs_sweep(Aj, sj))
    cp = psel.rs_sweep(Ap, sp)
    assert cp.dtype == torch.int32
    assert np.array_equal(cp.numpy(), cj)
    assert 0 < int(cp.sum()) < Ap.num_rows


@pytest.mark.parametrize("mode,backend,sweeps", [
    ("1", "auto", True), ("0", "device", False), ("auto", "device", True),
    ("auto", "auto", False)])
def test_device_sweep_dispatch(mode, backend, sweeps):
    """RS's first pass: the sweep where the JAX package sweeps (auto: its
    device setup, here `setup_backend=device`), else the host queue; a
    sweep counts amg.selector.device_sweep."""
    Aj, Ap = _pair("7pt_8^3")
    sj, sp = _strong(Aj, Ap)
    text = f"selector_device_sweep={mode}, setup_backend={backend}"
    before = pm.snapshot()["amg.selector.device_sweep"]
    cp = preg.classical_selectors.create(
        "RS", pt.Config.from_string(text), "default"
    ).mark_coarse_fine_points(Ap, sp)
    with forced_device_setup(backend == "device"):
        cj = jreg.classical_selectors.create(
            "RS", jx.Config.from_string(text), "default"
        ).mark_coarse_fine_points(Aj, sj)
    assert np.array_equal(cp.numpy(), np.asarray(cj))
    want = np.asarray(jsel.rs_sweep(Aj, sj)) if sweeps \
        else psel.rs_split(Ap, sp)
    assert np.array_equal(cp.numpy(), want)
    assert pm.snapshot()["amg.selector.device_sweep"] == before + sweeps


def test_device_sweep_auto_respects_min_rows():
    cfg = pt.Config.from_string("setup_backend=device, "
                                "setup_device_min_rows=1000")
    assert not psel._sweeps(cfg, "default", 999)
    assert psel._sweeps(cfg, "default", 1000)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("key", list(SHAPES))
def test_affinity_strength_matches_jax(key, dtype):
    Aj, Ap = _pair(key, dtype)
    sj, sp = _strong(Aj, Ap, "AFFINITY")
    assert np.array_equal(sp.numpy(), sj)
    assert 0 < int(sp.sum()) < sp.numel()


@pytest.mark.parametrize("key", ["7pt_8^3", "7pt_12^3", "5pt_16^2"])
@pytest.mark.parametrize("name", AGG)
def test_aggregates_match_jax(name, key):
    Aj, Ap = _pair(key)
    text = "selector=" + name + AGG_EXTRA[name]
    aj, ncj = jreg.aggregation_selectors.create(
        name, jx.Config.from_string(text), "default").set_aggregates(Aj)
    ap, ncp = preg.aggregation_selectors.create(
        name, pt.Config.from_string(text), "default").set_aggregates(Ap)
    assert ap.dtype == torch.int32 and ncp == int(ncj)
    assert np.array_equal(ap.numpy(), np.asarray(aj))
    assert 1 < ncp < Ap.num_rows


@pytest.mark.parametrize("name", AGG)
def test_selector_solves_match_jax(name):
    """tests/test_amg.py TestSelectorVariants' FGMRES + AGGREGATION +
    JACOBI_L1 on the 7-pt 8^3 (ADAPTIVE seeded)."""
    text = ("solver(s)=FGMRES, s:max_iters=80, s:tolerance=1e-8,"
            " s:monitor_residual=1, s:preconditioner(amg)=AMG,"
            " amg:algorithm=AGGREGATION, amg:smoother=JACOBI_L1,"
            " amg:max_iters=1, amg:min_coarse_rows=16,"
            f" amg:selector={name}"
            + AGG_EXTRA[name].replace(", ", ", amg:"))
    Aj, Ap = _pair("7pt_8^3")
    js = jx.create_solver(jx.Config.from_string(text))
    js.setup(Aj)
    rj = js.solve(np.ones(Aj.num_rows))
    ps = pt.create_solver(pt.Config.from_string(text), device="cpu")
    ps.setup(Ap)
    rp = ps.solve(torch.ones(Ap.num_rows, dtype=torch.float64))
    assert rp.status == rj.status == "success"
    assert rp.iterations == int(rj.iterations)
    assert ps.preconditioner.amg.level_rows() == [
        lv.A.num_rows for lv in js.preconditioner.amg.levels] + [
        js.preconditioner.amg.coarsest_A.num_rows]


RANDOM = [dict(n=120, max_nnz_per_row=9, seed=3),
          dict(n=40, max_nnz_per_row=5, seed=4, symmetric=True),
          dict(n=50, max_nnz_per_row=6, seed=9, diag_dominant=False),
          dict(n=30, max_nnz_per_row=4, seed=10, dtype="float32")]


def _random_pair(kw):
    dt = kw.get("dtype", "float64")
    kj = dict(kw, dtype=np.dtype(dt))
    kp = dict(kw, dtype=getattr(torch, dt), device="cpu")
    return jx.gallery.random_matrix(**kj), pt.gallery.random_matrix(**kp)


def _same_csr(Mp, Mj):
    assert (Mp.num_rows, Mp.num_cols) == (Mj.num_rows, Mj.num_cols)
    for a, b in ((Mp.row_offsets, Mj.row_offsets),
                 (Mp.col_indices, Mj.col_indices), (Mp.values, Mj.values)):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


@pytest.mark.parametrize("kw", RANDOM, ids=lambda k: f"seed{k['seed']}")
def test_random_matrix_matches_jax(kw):
    Aj, Ap = _random_pair(kw)
    _same_csr(Ap, Aj)


def test_random_matrix_block_values_raise():
    with pytest.raises(NotImplementedError, match="item 8.4"):
        pt.gallery.random_matrix(10, 4, seed=1, block_dims=(2, 2),
                                 device="cpu")


@pytest.mark.parametrize("kw", RANDOM[:2], ids=lambda k: f"seed{k['seed']}")
def test_permute_matches_jax(kw):
    Aj, Ap = _random_pair(kw)
    n = Ap.num_rows
    rng = np.random.default_rng(kw["seed"])
    p, q = rng.permutation(n).astype(np.int32), \
        rng.permutation(n).astype(np.int32)
    _same_csr(pperm.permute_matrix(Ap, p, p), jperm.permute_matrix(Aj, p, p))
    _same_csr(pperm.permute_matrix(Ap, p, q), jperm.permute_matrix(Aj, p, q))
    _same_csr(pperm.permute_matrix(Ap, None, q),
              jperm.permute_matrix(Aj, None, q))
    x = rng.standard_normal(n)
    assert np.array_equal(
        pperm.permute_vector(torch.from_numpy(x), p).numpy(),
        np.asarray(jperm.permute_vector(x, p)))
    key = rng.standard_normal(n)
    Bp, permp = pperm.sort_rows_by(Ap, key)
    Bj, permj = jperm.sort_rows_by(Aj, key)
    _same_csr(Bp, Bj)
    assert np.array_equal(permp.numpy(), np.asarray(permj))
    assert pperm.analyze_matrix(Ap) == jperm.analyze_matrix(Aj)
    assert pperm.analyze_matrix(Bp)._asdict() == \
        jperm.analyze_matrix(Bj)._asdict()
    # P^T (P A P^T) P = A, bit for bit
    ip = np.argsort(p).astype(np.int32)
    _same_csr(pperm.permute_matrix(pperm.permute_matrix(Ap, p, p), ip, ip),
              Aj)


def test_permute_round_trip_on_poisson():
    A = pt.gallery.poisson("7pt", 8, 8, 8, device="cpu")
    p = np.random.default_rng(1).permutation(A.num_rows)
    B = pperm.permute_matrix(pperm.permute_matrix(A, p, p), np.argsort(p),
                             np.argsort(p))
    for a, b in ((A.row_offsets, B.row_offsets), (A.col_indices,
                                                  B.col_indices),
                 (A.values, B.values)):
        assert torch.equal(a, b)
    assert rel(B.values, A.values.numpy()) == 0.0
