"""The port's eigensolvers (amgx_tpu_torch/eigen/) against the JAX
package's (amgx_tpu/eigen/) on the CPU: the same numpy operator goes
through both, and each registered eigensolver must give the JAX
package's eigenvalues (within 1e-10 in float64, 1e-5 in float32), its
iteration count and its `converged`. The inputs are the JAX tests'
(tests/test_eigen.py): the 5-point Poisson on a 10 x 7 grid (a
rectangle: a square's spectrum has pairs that single-vector Krylov
cannot resolve), the stock files of configs/eigen_configs/ on a 6x5x4
box, and PageRank on the JAX test's 6-node graph and on a seeded graph
(chip_smoke.pagerank_graph) held also to a float64 scipy reference.
The JAX results are computed once per module (`_JAX`)."""
import glob
import os

import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.eigen import create_eigensolver as jax_eigensolver

import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti
from amgx_tpu_torch import registry
from amgx_tpu_torch.eigen import create_eigensolver
from _torch_util import ROOT, single_torch_thread  # noqa: F401  (autouse)
from chip_smoke import box_eigenvalues, pagerank_graph, pagerank_reference

jx.initialize()

# the JAX tests' configurations (tests/test_eigen.py)
CASES = {
    "power": "eig_solver=POWER_ITERATION, eig_max_iters=2000, "
             "eig_tolerance=1e-8, eig_eigenvector=1",
    "power_shifted": "eig_solver=POWER_ITERATION, eig_shift=8.0, "
                     "eig_max_iters=4000, eig_tolerance=1e-8",
    "inverse": "eig_solver=INVERSE_ITERATION, eig_max_iters=50, "
               "eig_tolerance=1e-9, solver=CG, max_iters=200, "
               "tolerance=1e-12, monitor_residual=1",
    "lanczos": "eig_solver=LANCZOS, eig_wanted_count=3, eig_which=largest, "
               "eig_max_iters=40, eig_subspace_size=40, eig_tolerance=1e-8, "
               "eig_eigenvector=1",
    "lanczos_smallest": "eig_solver=LANCZOS, eig_wanted_count=2, "
                        "eig_which=smallest, eig_max_iters=60, "
                        "eig_subspace_size=50, eig_tolerance=1e-7",
    "lobpcg": "eig_solver=LOBPCG, eig_which=smallest, eig_wanted_count=3, "
              "eig_max_iters=200, eig_tolerance=1e-7, eig_eigenvector=1, "
              "preconditioner=BLOCK_JACOBI, max_iters=3",
    "subspace": "eig_solver=SUBSPACE_ITERATION, eig_wanted_count=2, "
                "eig_max_iters=500, eig_tolerance=1e-7, eig_subspace_size=6",
    "jacobi_davidson": "eig_solver=JACOBI_DAVIDSON, eig_max_iters=200, "
                       "eig_tolerance=1e-7, eig_subspace_size=12",
    "jacobi_davidson_smallest": "eig_solver=JACOBI_DAVIDSON, "
                                "eig_which=smallest, eig_max_iters=300, "
                                "eig_tolerance=1e-7, eig_subspace_size=12",
    "arnoldi": "eig_solver=ARNOLDI, eig_wanted_count=1, "
               "eig_subspace_size=40, eig_tolerance=1e-7",
}
# float32 runs (the card's dtype) at a tolerance float32 reaches (the
# float64 cases' 1e-7..1e-9 lie below float32's rounding, where the two
# packages' reductions decide convergence); JACOBI_DAVIDSON's is held
# apart below
F32_CASES = ("power", "lanczos", "lobpcg", "subspace", "arnoldi")
F32_TOLERANCE = ", eig_tolerance=1e-5"
CONFIG_DIR = os.path.join(ROOT, "configs", "eigen_configs")
STOCK = sorted(os.path.basename(f)
               for f in glob.glob(os.path.join(CONFIG_DIR, "*")))
# the stock files on a 6x5x4 box; the two with a nested AMG solve at
# every step have their inner solver's max_iters cut for the CPU budget
# (the same cut in both packages): INVERSE_FGMRES's FGMRES runs 10 of
# its 100 fixed iterations an application, LOBPCG's preconditioner (the
# default scope's CLASSICAL AMG) 5 of its 100, both on a 4x3x3 box
STOCK_BOX = {"INVERSE_FGMRES": (4, 3, 3), "LOBPCG": (4, 3, 3)}
STOCK_CUTS = {"INVERSE_FGMRES": ("max_iters", 10, "main"),
              "LOBPCG": ("max_iters", 5, "default")}

_JAX = {}


def _pair(Aj, dtype):
    """(JAX matrix, port matrix) with the values of Aj in `dtype`."""
    ro, ci = np.asarray(Aj.row_offsets), np.asarray(Aj.col_indices)
    vals = np.asarray(Aj.values).astype(dtype)
    n = Aj.num_rows
    return (jx.CsrMatrix.from_scipy_like(ro, ci, vals, n, n).init(),
            pti.matrix_from_numpy(ro, ci, vals, n, n, device="cpu"))


def _both(key, A_pair, cfg_jax, cfg_port):
    """(JAX result, port result); the JAX one cached under `key`."""
    Aj, Ap = A_pair
    if key not in _JAX:
        es = jax_eigensolver(cfg_jax)
        es.setup(Aj)
        _JAX[key] = es.solve()
    es = create_eigensolver(cfg_port, device="cpu")
    es.setup(Ap)
    return _JAX[key], es.solve()


def _same(rj, rp, tol):
    assert rp.iterations == rj.iterations
    assert rp.converged == rj.converged
    np.testing.assert_allclose(np.real(rp.eigenvalues),
                               np.real(rj.eigenvalues), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def poisson():
    return jx.gallery.poisson5pt(10, 7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eigensolver_matches_jax_f64(poisson, case):
    cfg = CASES[case]
    rj, rp = _both(("f64", case), _pair(poisson, np.float64),
                   jx.Config.from_string(cfg), pt.Config.from_string(cfg))
    _same(rj, rp, 1e-10)
    if rj.eigenvectors is not None:
        # the same eigenvectors up to sign
        vj, vp = np.asarray(rj.eigenvectors), rp.eigenvectors.numpy()
        sign = np.sign(np.sum(vj * vp, axis=0))
        np.testing.assert_allclose(vp * sign, vj, atol=1e-8)


@pytest.mark.parametrize("case", F32_CASES)
def test_eigensolver_matches_jax_f32(poisson, case):
    cfg = CASES[case] + F32_TOLERANCE
    rj, rp = _both(("f32", case), _pair(poisson, np.float32),
                   jx.Config.from_string(cfg), pt.Config.from_string(cfg))
    _same(rj, rp, 1e-5 * max(1.0, float(np.max(np.abs(rj.eigenvalues)))))


def test_jacobi_davidson_f32_finds_the_largest(poisson):
    """In float32 the port's JACOBI_DAVIDSON finds the largest eigenvalue
    to 1e-5, as the JAX package's float64 run does. The JAX package's
    float32 run is not the reference here: it pins the unused rows of its
    projected matrix at -1e30, and a float32 eigh of that matrix loses
    the active block to rounding (on this grid it returns the second
    largest eigenvalue); the port solves the active block alone."""
    cfg = CASES["jacobi_davidson"] + F32_TOLERANCE
    es = create_eigensolver(pt.Config.from_string(cfg), device="cpu")
    es.setup(_pair(poisson, np.float32)[1])
    res = es.solve()
    lam = np.linalg.eigvalsh(np.asarray(poisson.to_dense()))
    assert res.converged
    assert abs(res.eigenvalues[0] - lam[-1]) <= 1e-5 * lam[-1]


@pytest.mark.parametrize("name", STOCK)
def test_stock_eigen_config_matches_jax(name):
    path = os.path.join(CONFIG_DIR, name)
    cfgs = [jx.Config.from_file(path), pt.Config.from_file(path)]
    if name in STOCK_CUTS:
        param, value, scope = STOCK_CUTS[name]
        for c in cfgs:
            c.set(param, value, scope)
    if name == "PAGERANK":
        n = 1000
        rows, cols = pagerank_graph(n, seed=5)
        Aj = jx.CsrMatrix.from_coo(rows, cols, np.ones(rows.size), n, n)
    else:
        Aj = jx.gallery.poisson("7pt", *STOCK_BOX.get(name, (6, 5, 4)))
    rj, rp = _both(("stock", name), _pair(Aj, np.float64), *cfgs)
    _same(rj, rp, 1e-10)
    assert rp.converged


def test_pagerank_small_graph_matches_jax_and_reference():
    """The JAX test's graph: a ring with a chord and one dangling node."""
    n = 6
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (1, 3), (0, 2), (4, 5)]
    rows = np.array([e[0] for e in edges])
    cols = np.array([e[1] for e in edges])
    Aj = jx.CsrMatrix.from_coo(rows, cols, np.ones(len(edges)), n, n)
    cfg = ("eig_solver=PAGERANK, eig_damping_factor=0.85, "
           "eig_max_iters=500, eig_tolerance=1e-10")
    rj, rp = _both(("pagerank", "small"), _pair(Aj, np.float64),
                   jx.Config.from_string(cfg), pt.Config.from_string(cfg))
    _same(rj, rp, 1e-10)
    v = rp.eigenvectors[:, 0].numpy()
    np.testing.assert_allclose(v, np.asarray(rj.eigenvectors)[:, 0],
                               atol=1e-12)
    np.testing.assert_allclose(v / v.sum(),
                               pagerank_reference(rows, cols, n, 0.85),
                               atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pagerank_seeded_graph(dtype):
    """A seeded graph with dangling nodes: the port's vector equals the
    JAX package's and lies within the power iteration's L1 contraction
    bound (2 x 0.85^iterations) of scipy's float64 PageRank."""
    n = 600
    rows, cols = pagerank_graph(n, seed=9)
    Aj = jx.CsrMatrix.from_coo(rows, cols, np.ones(rows.size), n, n)
    cfg = ("eig_solver=PAGERANK, eig_damping_factor=0.85, "
           "eig_max_iters=200, eig_tolerance=1e-6")
    tol = 1e-10 if dtype == np.float64 else 1e-5
    rj, rp = _both(("pagerank", np.dtype(dtype).name), _pair(Aj, dtype),
                   jx.Config.from_string(cfg), pt.Config.from_string(cfg))
    _same(rj, rp, tol)
    v = rp.eigenvectors[:, 0].double().numpy()
    np.testing.assert_allclose(v, np.asarray(rj.eigenvectors)[:, 0],
                               atol=tol / n ** 0.5)
    pi = pagerank_reference(rows, cols, n, 0.85)
    assert np.abs(v / v.sum() - pi).sum() \
        <= 2 * 0.85 ** rp.iterations + 10 * tol


def test_box_spectrum_closed_form():
    """chip_smoke's closed-form spectrum equals the dense spectrum of the
    port's gallery operator on a box with three distinct sides."""
    A = pt.gallery.poisson("7pt", 5, 4, 3, dtype=torch.float64,
                           device="cpu")
    lam = np.linalg.eigvalsh(A.to_dense().numpy())
    np.testing.assert_allclose(box_eigenvalues((5, 4, 3)), lam, atol=1e-12)


def test_eigensolver_registry_and_errors(poisson):
    for name in ("POWER_ITERATION", "SINGLE_ITERATION", "PAGERANK",
                 "INVERSE_ITERATION", "SUBSPACE_ITERATION", "LANCZOS",
                 "ARNOLDI", "LOBPCG", "JACOBI_DAVIDSON"):
        assert registry.eigensolvers.has(name), name
    from amgx_tpu_torch.errors import BadParametersError
    Ap = _pair(poisson, np.float64)[1]
    for cfg in ("eig_solver=SUBSPACE_ITERATION, eig_which=smallest",
                "eig_solver=JACOBI_DAVIDSON, eig_wanted_count=2",
                "eig_solver=INVERSE_ITERATION, solver=NOSOLVER"):
        es = create_eigensolver(pt.Config.from_string(cfg), device="cpu")
        with pytest.raises(BadParametersError):
            es.setup(Ap)
    with pytest.raises(BadParametersError):
        create_eigensolver(pt.Config.from_string(
            "eig_solver=LANCZOS"), device="cpu").solve()
