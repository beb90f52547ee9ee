"""Shared inputs for the port's parity tests (tests/test_torch_*.py):
the same numpy arrays go to the JAX package and to amgx_tpu_torch."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import amgx_tpu as jx
import amgx_tpu_torch as pt
import amgx_tpu_torch.interop as pti

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One intra-op thread for PyTorch while a module runs (autouse in
    each module that imports it). The suite runs six workers at once,
    each beside the JAX package's own thread pool: PyTorch's default of
    one thread per core then oversubscribes the CPU, and the port's many
    small CPU ops wait on each other's threads (a 10^3 stock solve took
    ~60 s under the full suite against ~1 s alone). The tests it is used
    in compare against the JAX package at the same tolerances either
    way."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def grid_operator(shape, dtype=np.float32, seed=0):
    """A 7-point operator on `shape` with random coefficients (diagonal
    in [5.5, 6.5], neighbours in [-1.2, -0.8]): (JAX matrix, port
    matrix, csr arrays). Random values make every diagonal distinct, so
    a wrong shift or edge shows."""
    P = jx.gallery.poisson("7pt", *shape)
    ro = np.asarray(P.row_offsets)
    ci = np.asarray(P.col_indices)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(P.num_rows), np.diff(ro))
    vals = np.where(rows == ci, rng.uniform(5.5, 6.5, ci.shape[0]),
                    rng.uniform(-1.2, -0.8, ci.shape[0])).astype(dtype)
    n = P.num_rows
    Aj = dataclasses.replace(
        jx.CsrMatrix.from_scipy_like(ro, ci, vals, n, n),
        grid_shape=tuple(shape)).init()
    Ap = pti.matrix_from_numpy(ro, ci, vals, n, n, grid_shape=shape,
                               device="cpu")
    return Aj, Ap


def geo_agg(shape):
    """The GEO selector's 2x2x2 aggregates map and coarse size."""
    nx, ny, nz = shape
    i = np.arange(nx * ny * nz)
    x, t = i % nx, i // nx
    y, z = t % ny, t // ny
    cnx, cny, cnz = (nx + 1) // 2, (ny + 1) // 2, (nz + 1) // 2
    agg = ((z // 2) * cny + (y // 2)) * cnx + (x // 2)
    return agg.astype(np.int32), cnx * cny * cnz


def vectors(n, nc, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal(n).astype(dtype),
            (1.0 / rng.uniform(5, 7, n)).astype(dtype),
            rng.standard_normal(nc).astype(dtype))


def csr_arrays(A):
    return {"row_offsets": np.asarray(A.row_offsets),
            "col_indices": np.asarray(A.col_indices),
            "values": np.asarray(A.values), "num_rows": A.num_rows,
            "num_cols": A.num_cols,
            "grid_shape": getattr(A, "grid_shape", None)}


def _np_or_none(v):
    return None if v is None else np.asarray(v)


def jax_hierarchy_arrays(amg_solver):
    """(levels, coarse) numpy dicts of a set-up JAX AMG solver, in the
    layout amgx_tpu_torch.interop.hierarchy_from_numpy takes: the
    smoother's taus (CHEBYSHEV_POLY), dinv (Jacobi family, MULTICOLOR_GS,
    GS, CF_JACOBI), spectral bounds lmax / lmin (CHEBYSHEV, POLYNOMIAL),
    KPZ_POLYNOMIAL's l_inf, GS's gs_diag, KACZMARZ's inv_rn2 or coloring
    (row_colors, num_colors) and MULTICOLOR_DILU's Einv or
    MULTICOLOR_ILU's factors ilu_L / ilu_U and u_diag, the
    stencil of a matrix-free level, a classical level's cf_map, P and R,
    and DENSE_LU's explicit inverse when the JAX package built one."""
    amg = amg_solver.amg
    data = amg_solver.solve_data()["amg"]
    levels = []
    for i, lv in enumerate(amg.levels):
        d = csr_arrays(lv.A)
        smd = data["levels"][i]["smoother"]
        st = smd.get("stencil")
        cheb = hasattr(lv.smoother, "estimate_mode") \
            or lv.smoother.name == "POLYNOMIAL"
        ilu = smd.get("ilu_L")
        d.update(gs_diag=_np_or_none(smd.get("gs_diag")),
                 u_diag=_np_or_none(smd.get("u_diag")),
                 inv_rn2=_np_or_none(smd.get("inv_rn2")),
                 l_inf=None if smd.get("l_inf") is None
                 else float(smd["l_inf"]),
                 ilu_L=None if ilu is None else csr_arrays(ilu),
                 ilu_U=None if ilu is None else csr_arrays(smd["ilu_U"]))
        d.update(coarse_size=lv.coarse_size,
                 lmax=lv.smoother.lmax if cheb else None,
                 lmin=lv.smoother.lmin if cheb else None,
                 taus=_np_or_none(smd.get("taus")),
                 dinv=_np_or_none(smd.get("dinv")),
                 Einv=_np_or_none(smd.get("Einv")),
                 row_colors=_np_or_none(getattr(lv.smoother, "row_colors",
                                                None)),
                 num_colors=getattr(lv.smoother, "num_colors", None),
                 stencil=None if st is None else {
                     "coeffs": np.asarray(st.coeffs), "offsets": st.offsets,
                     "shifts": st.shifts, "shape": st.shape,
                     "dinv_mode": st.dinv_mode})
        if getattr(lv, "cf_map", None) is not None:
            d.update(cf_map=np.asarray(lv.cf_map), P=csr_arrays(lv.P),
                     R=csr_arrays(lv.R))
        else:
            d.update(aggregates=np.asarray(lv.aggregates),
                     geo_axes=lv.geo_axes, geo_fine_shape=lv.geo_fine_shape,
                     geo_coarse_shape=lv.geo_coarse_shape)
        levels.append(d)
    coarse = csr_arrays(amg.coarsest_A)
    cd = data["coarse"]
    coarse.update(qt=np.asarray(cd["qt"]), r=np.asarray(cd["r"]),
                  inv=_np_or_none(cd.get("inv")))
    return levels, coarse


def rel(a, b):
    a = np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.cpu() if torch.is_tensor(b) else b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def stock_pair(name, n, dtype):
    """AmgX's stock configs/<name>.json read verbatim by both packages
    (residual histories stored, the JAX package's printing off), set up
    on the 7-pt n^3 Poisson and solved with b = 1: (JAX result, port
    result, port solver)."""
    path = os.path.join(ROOT, "configs", name + ".json")
    jc = jx.Config.from_file(path)
    for key in ("print_solve_stats", "print_grid_stats"):
        jc.set(key, 0)
    jc.set("store_res_history", 1)
    pc = pt.Config.from_file(path)
    pc.set("store_res_history", 1)
    js = jx.create_solver(jc)
    js.setup(jx.gallery.poisson("7pt", n, n, n, dtype=dtype).init())
    ps = pt.create_solver(pc, device="cpu")
    ps.setup(pt.gallery.poisson("7pt", n, n, n, device="cpu",
                                dtype=getattr(torch, np.dtype(dtype).name)))
    b = np.ones(n ** 3, dtype)
    return js.solve(b), ps.solve(torch.from_numpy(b)), ps


def assert_same_solve(rj, rp, x_tol, hist_tol, iterations=True):
    """The same status (and iterations), x to `x_tol` in norm, and the
    residual histories to `hist_tol` of the initial residual over their
    common length."""
    assert rp.status == rj.status
    if iterations:
        assert rp.iterations == int(rj.iterations)
    assert rel(rp.x, np.asarray(rj.x)) < x_tol
    hj = np.asarray(rj.res_history, np.float64).ravel()
    hp = np.asarray(rp.res_history, np.float64).ravel()
    m = min(hj.shape[0], hp.shape[0])
    assert np.abs(hp[:m] - hj[:m]).max() <= hist_tol * hj[0]
