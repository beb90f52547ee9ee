"""The port's C API (amgx_tpu_torch/capi.py) and precision modes
(modes.py) against the JAX package's (amgx_tpu/capi.py, modes.py) on
the CPU, and the repaired `convergence_analysis` (amg/analysis.py).

Each flow of tests/test_capi.py and its TestCApiTail runs through both
packages on the same numpy inputs (the port's resources with
platform="cpu"): the RC of every call, the statuses, the iterations and
x (within 1e-12 in float64) agree. Beside them: the service, fleet,
batched and eigensolver calls, AMGX_vector_set_random bit for bit, the
refusals (block uploads name ROADMAP.md Queue A item 8.4, the
distributed calls item 13, a complex solve item 15), the complex read
with complex_conversion, attach_geometry, the bfloat16 modes, the
parameter description, and the per-level ratios of the analysis report
within 1e-10 of the JAX package's.
"""
import itertools
import os

import numpy as np
import pytest
import torch

import amgx_tpu as jx
import jax.numpy as jnp
from amgx_tpu import capi as jcapi
from amgx_tpu import modes as jmodes
from amgx_tpu.amg.analysis import _analyze as jax_analyze
from amgx_tpu.amg.hierarchy import AMG as JaxAMG
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.io import write_system as jax_write_system
from amgx_tpu.presets import BATCHED_CG

import amgx_tpu_torch as pt
from amgx_tpu_torch import capi as pcapi
from amgx_tpu_torch import modes as pmodes
from amgx_tpu_torch.amg.analysis import analysis_rows, convergence_analysis
from amgx_tpu_torch.amg.hierarchy import AMG
from amgx_tpu_torch.errors import RC
from amgx_tpu_torch.ops.coloring import color_matrix
from _torch_util import ROOT, single_torch_thread  # noqa: F401  (autouse)

jx.initialize()
BOTH = (jcapi, pcapi)
SERVE = BATCHED_CG + ", serving_bucket_slots=2, serving_chunk_iters=4"


@pytest.fixture(autouse=True)
def _init():
    for c in BOTH:
        assert c.AMGX_initialize() == c.RC.OK
    yield
    for c in BOTH:
        c.AMGX_finalize()


def _rs(c, cfg=None):
    """Simple resources: the port's on the CPU."""
    kw = {"platform": "cpu"} if c is pcapi else {}
    return c.AMGX_resources_create_simple(cfg, **kw)[1]


def _csr(points="5pt", *shape):
    A = jx.gallery.poisson(points, *(shape or (8, 8)))
    return (A.num_rows, A.nnz, np.asarray(A.row_offsets),
            np.asarray(A.col_indices), np.asarray(A.values))


def _same(out_j, out_p, atol=1e-12):
    """Equal dicts: RCs, ints and strings exactly, arrays within
    `atol`."""
    assert out_j.keys() == out_p.keys()
    for k in out_j:
        a, b = out_j[k], out_p[k]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64), rtol=0,
                                       atol=atol, err_msg=k)
        else:
            assert a == b, (k, a, b)


def _both(flow, *args):
    out = [flow(c, *args) for c in BOTH]
    _same(*out)
    return out


def test_every_amgx_name_is_there():
    """Every AMGX_* name of the JAX package's shim is in the port's."""
    names = {n for n in dir(jcapi) if n.startswith("AMGX_")}
    assert len(names) == 114
    assert names <= {n for n in dir(pcapi) if n.startswith("AMGX_")}


# ---------------------------------------------------------------------------
# the flows of tests/test_capi.py
# ---------------------------------------------------------------------------

_PCG = ("config_version=2, solver=PCG, preconditioner=BLOCK_JACOBI, "
        "max_iters=200, tolerance=1e-8, monitor_residual=1, "
        "convergence=RELATIVE_INI_CORE, store_res_history=1")


def _full_flow(c):
    """The amgx_capi.c call sequence end to end."""
    rcs = []
    rc, cfg = c.AMGX_config_create(_PCG)
    rcs.append(rc)
    rsrc = _rs(c, cfg)
    rc, A = c.AMGX_matrix_create(rsrc, "dDDI")
    rc2, b = c.AMGX_vector_create(rsrc, "dDDI")
    rc3, x = c.AMGX_vector_create(rsrc, "dDDI")
    rc4, slv = c.AMGX_solver_create(rsrc, "dDDI", cfg)
    rcs += [rc, rc2, rc3, rc4]
    n, nnz, ro, ci, vals = _csr()
    rcs.append(c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, vals))
    size = c.AMGX_matrix_get_size(A)
    rcs += [c.AMGX_vector_upload(b, n, 1, np.ones(n)),
            c.AMGX_vector_set_zero(x, n, 1),
            c.AMGX_solver_setup(slv, A), c.AMGX_solver_solve(slv, b, x)]
    status = c.AMGX_solver_get_status(slv)
    iters = c.AMGX_solver_get_iterations_number(slv)
    hist = np.array([c.AMGX_solver_get_iteration_residual(slv, i)[1]
                     for i in range(iters[1] + 1)])
    out_of_range = c.AMGX_solver_get_iteration_residual(slv, iters[1] + 5)
    rc, sol = c.AMGX_vector_download(x)
    rcs.append(rc)
    rcs += [c.AMGX_solver_get_grid_stats(slv)[0],
            c.AMGX_vector_get_size(x), c.AMGX_matrix_get_nnz(A)]
    for h, d in ((slv, c.AMGX_solver_destroy), (x, c.AMGX_vector_destroy),
                 (b, c.AMGX_vector_destroy), (A, c.AMGX_matrix_destroy),
                 (rsrc, c.AMGX_resources_destroy),
                 (cfg, c.AMGX_config_destroy)):
        rcs.append(d(h))
    return {"rcs": rcs, "size": size, "status": status, "iters": iters,
            "hist": hist, "out_of_range": out_of_range, "x": sol}


def test_full_capi_flow():
    out_j, out_p = _both(_full_flow)
    assert out_p["status"] == (RC.OK, 0) and out_p["iters"][1] > 0
    assert out_p["hist"][-1] < 1e-7 * out_p["hist"][0]


def _resetup_flow(c):
    rc, cfg = c.AMGX_config_create(
        "solver=CG, max_iters=300, tolerance=1e-8, monitor_residual=1, "
        "convergence=RELATIVE_INI_CORE")
    rsrc = _rs(c, cfg)
    A = c.AMGX_matrix_create(rsrc, "dDDI")[1]
    slv = c.AMGX_solver_create(rsrc, "dDDI", cfg)[1]
    b = c.AMGX_vector_create(rsrc, "dDDI")[1]
    x = c.AMGX_vector_create(rsrc, "dDDI")[1]
    n, nnz, ro, ci, vals = _csr()
    rcs = [c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, vals),
           c.AMGX_vector_upload(b, n, 1, np.ones(n)),
           c.AMGX_vector_set_zero(x, n, 1), c.AMGX_solver_setup(slv, A),
           c.AMGX_solver_solve(slv, b, x)]
    it1 = c.AMGX_solver_get_iterations_number(slv)
    rcs += [c.AMGX_matrix_replace_coefficients(A, n, nnz, 2.0 * vals),
            c.AMGX_solver_resetup(slv, A),
            c.AMGX_solver_solve_with_0_initial_guess(slv, b, x)]
    return {"rcs": rcs, "it1": it1,
            "it2": c.AMGX_solver_get_iterations_number(slv),
            "x": c.AMGX_vector_download(x)[1]}


def test_replace_coefficients_and_resetup():
    _, out_p = _both(_resetup_flow)
    n, _, ro, ci, vals = _csr()
    A = np.zeros((n, n))
    A[np.repeat(np.arange(n), np.diff(ro)), ci] = 2.0 * vals
    assert np.linalg.norm(A @ out_p["x"] - 1.0) < 1e-6


def _graceful_flow(c):
    """capi_graceful_failure.cu: bad calls return RCs, never raise."""
    out = {"setup_bad_handles": c.AMGX_solver_setup(99999, 99998),
           "download_bad": c.AMGX_vector_download(12345)[0]}
    rc, cfg = c.AMGX_config_create_from_file("/nonexistent/cfg.json")
    out["missing_file"] = (rc, cfg)
    rsrc = _rs(c)
    out["bad_mode"] = c.AMGX_matrix_create(rsrc, "zZZZ")
    c.AMGX_matrix_create(rsrc, "dDDI")
    cfg = c.AMGX_config_create("solver=CG, max_iters=10")[1]
    slv = c.AMGX_solver_create(rsrc, "dDDI", cfg)[1]
    b = c.AMGX_vector_create(rsrc, "dDDI")[1]
    x = c.AMGX_vector_create(rsrc, "dDDI")[1]
    c.AMGX_vector_upload(b, 4, 1, np.ones(4))
    out["solve_before_setup"] = c.AMGX_solver_solve(slv, b, x)
    out["status_before_solve"] = c.AMGX_solver_get_status(slv)
    out["bad_param"] = c.AMGX_config_create("no_such_param=1")
    out["batched_plain_rhs"] = c.AMGX_solver_solve_batched(slv, b, x)
    out["error_string"] = c.AMGX_get_error_string(c.RC.IO_ERROR)
    out["api_version"] = c.AMGX_get_api_version()
    return out


def test_graceful_failure():
    _, out_p = _both(_graceful_flow)
    assert out_p["missing_file"][0] in (RC.IO_ERROR, RC.BAD_CONFIGURATION)
    assert out_p["bad_mode"] == (RC.BAD_MODE, None)


def _io_flow(c, path, out):
    rsrc = _rs(c)
    A = c.AMGX_matrix_create(rsrc, "dDDI")[1]
    b = c.AMGX_vector_create(rsrc, "dDDI")[1]
    x = c.AMGX_vector_create(rsrc, "dDDI")[1]
    rcs = [c.AMGX_read_system(A, b, x, path)]
    size = c.AMGX_matrix_get_size(A)
    bv, xv = (c.AMGX_vector_download(h)[1] for h in (b, x))
    rcs.append(c.AMGX_write_system(A, b, None, out))
    rcs.append(c.AMGX_write_system(A, b, None, "/nonexistent/dir/o.mtx"))
    return {"rcs": rcs, "size": size, "b": bv, "x": xv,
            "file": open(out, "rb").read()}


def test_read_write_system_roundtrip(tmp_path):
    """AMGX_read_system of a file the JAX package wrote (b given, x
    defaulted to zeros), then AMGX_write_system: equal arrays and
    byte-identical files."""
    path = str(tmp_path / "sys.mtx")
    jax_write_system(path, jx.gallery.poisson("5pt", 6, 6),
                     b=np.arange(36, dtype=float))
    out = [_io_flow(c, path, str(tmp_path / f"out{i}.mtx"))
           for i, c in enumerate(BOTH)]
    _same(*out)
    assert out[1]["size"] == (RC.OK, 36, 1, 1)


def _callback_flow(c):
    lines = []
    c.AMGX_register_print_callback(lambda m, n: lines.append(m))
    cfg = c.AMGX_config_create(
        "solver=CG, max_iters=50, tolerance=1e-8, monitor_residual=1, "
        "print_solve_stats=1, convergence=RELATIVE_INI_CORE")[1]
    rsrc = _rs(c, cfg)
    A = c.AMGX_matrix_create(rsrc, "dDDI")[1]
    slv = c.AMGX_solver_create(rsrc, "dDDI", cfg)[1]
    b = c.AMGX_vector_create(rsrc, "dDDI")[1]
    x = c.AMGX_vector_create(rsrc, "dDDI")[1]
    n, nnz, ro, ci, vals = _csr("5pt", 6, 6)
    c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, vals)
    c.AMGX_vector_upload(b, n, 1, np.ones(n))
    c.AMGX_vector_set_zero(x, n, 1)
    c.AMGX_solver_setup(slv, A)
    c.AMGX_solver_solve(slv, b, x)
    c.AMGX_register_print_callback(None)
    text = "".join(lines)
    return {"has_table": "Total Iterations" in text
            and "Solve Status" in text,
            "total": [ln.strip() for ln in text.splitlines()
                      if "Total Iterations" in ln]}


def test_print_callback_captures_output():
    _, out_p = _both(_callback_flow)
    assert out_p["has_table"]


def _generate_flow(c):
    rsrc = _rs(c)
    A = c.AMGX_matrix_create(rsrc, "dDDI")[1]
    b = c.AMGX_vector_create(rsrc, "dDDI")[1]
    x = c.AMGX_vector_create(rsrc, "dDDI")[1]
    rc = c.AMGX_generate_distributed_poisson_7pt(A, b, x, 1, 1, 8, 8, 8)
    ro, ci, va = c.AMGX_matrix_download_all(A)[1:4]
    return {"rc": rc, "size": c.AMGX_matrix_get_size(A), "ro": ro,
            "ci": ci, "va": va, "b": c.AMGX_vector_download(b)[1],
            "x": c.AMGX_vector_download(x)[1]}


def test_generate_poisson_7pt():
    _, out_p = _both(_generate_flow)
    assert out_p["size"] == (RC.OK, 512, 1, 1)


def _eigen_flow(c):
    cfg = c.AMGX_config_create(
        "eig_solver=POWER_ITERATION, eig_max_iters=2000, "
        "eig_tolerance=1e-8, eig_eigenvector=1")[1]
    rsrc = _rs(c, cfg)
    A = c.AMGX_matrix_create(rsrc, "dDDI")[1]
    n, nnz, ro, ci, vals = _csr("5pt", 10, 7)
    c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, vals)
    rc, es = c.AMGX_eigensolver_create(rsrc, "dDDI", cfg)
    x = c.AMGX_vector_create(rsrc, "dDDI")[1]
    rcs = [rc, c.AMGX_eigensolver_setup(es, A),
           c.AMGX_eigensolver_pagerank_setup(es, x),
           c.AMGX_eigensolver_solve(es, x)]
    rc, eigs = c.AMGX_eigensolver_get_eigenvalues(es)
    rcs += [rc, c.AMGX_eigensolver_destroy(es)]
    return {"rcs": rcs, "eigs": eigs, "vec_size": c.AMGX_vector_get_size(x)}


def test_eigensolver_capi():
    out_j, out_p = _both(_eigen_flow)
    np.testing.assert_allclose(out_p["eigs"], out_j["eigs"], rtol=1e-10)
    Ad = np.asarray(jx.gallery.poisson("5pt", 10, 7).to_dense())
    np.testing.assert_allclose(out_p["eigs"][0], np.linalg.eigvalsh(Ad)[-1],
                               rtol=1e-6)


def test_write_parameters_description(tmp_path):
    """Every key both packages register prints the same name, type and
    default (the docs are each package's own prose); the JAX package's
    extra keys are the distributed layer's (item 13) and its SpMV
    implementation switch."""
    lines = []
    for i, c in enumerate(BOTH):
        path = str(tmp_path / f"params{i}.txt")
        assert c.AMGX_write_parameters_description(path) == RC.OK
        lines.append({ln.split(" ", 1)[0]: ln.split("):", 1)[0]
                      for ln in open(path).read().splitlines()})
    jax_lines, port_lines = lines
    assert set(jax_lines) - set(port_lines) == {
        "dist_cycle_fusion", "distributed_setup_mode", "spmv_impl"}
    assert set(port_lines) <= set(jax_lines)
    for key in port_lines:
        assert port_lines[key] == jax_lines[key], key
    assert "max_iters" in port_lines and "tolerance" in port_lines


def _cli_flow(c):
    """examples/amgx_capi.py's sequence on examples/matrix.mtx with
    configs/FGMRES_AGGREGATION.json."""
    cfg = c.AMGX_config_create_from_file(
        os.path.join(ROOT, "configs", "FGMRES_AGGREGATION.json"))[1]
    rsrc = _rs(c, cfg)
    A = c.AMGX_matrix_create(rsrc, "dDDI")[1]
    b = c.AMGX_vector_create(rsrc, "dDDI")[1]
    x = c.AMGX_vector_create(rsrc, "dDDI")[1]
    slv = c.AMGX_solver_create(rsrc, "dDDI", cfg)[1]
    c.AMGX_register_print_callback(lambda m, n: None)
    rcs = [c.AMGX_read_system(A, b, x, os.path.join(ROOT, "examples",
                                                     "matrix.mtx")),
           c.AMGX_solver_setup(slv, A), c.AMGX_solver_solve(slv, b, x)]
    c.AMGX_register_print_callback(None)
    return {"rcs": rcs, "status": c.AMGX_solver_get_status(slv),
            "iters": c.AMGX_solver_get_iterations_number(slv),
            "x": c.AMGX_vector_download(x)[1]}


def test_cli_example_sequence():
    _, out_p = _both(_cli_flow)
    assert out_p["status"] == (RC.OK, 0)


# ---------------------------------------------------------------------------
# the tail (TestCApiTail)
# ---------------------------------------------------------------------------


def _tail_system(c, mode="dDDI"):
    cfg = c.AMGX_config_create(
        "config_version=2, solver=PCG, max_iters=50, tolerance=1e-8,"
        " monitor_residual=1")[1]
    rs = _rs(c, cfg)
    mtx = c.AMGX_matrix_create(rs, mode)[1]
    n, nnz, ro, ci, va = _csr("7pt", 6, 6, 6)
    c.AMGX_matrix_upload_all(mtx, n, nnz, 1, 1, ro, ci, va)
    return cfg, rs, mtx, n


def _tail_flow(c):
    cfg, rs, mtx, n = _tail_system(c)
    out = {}
    rc, ro, ci, va, diag = c.AMGX_matrix_download_all(mtx)
    out.update(download=(rc, diag is None), ro=ro, ci=ci, va=va)
    x = c.AMGX_vector_create(rs, "dDDI")[1]
    y = c.AMGX_vector_create(rs, "dDDI")[1]
    c.AMGX_vector_upload(x, n, 1, np.random.default_rng(0).standard_normal(n))
    out["spmv_rc"] = c.AMGX_matrix_vector_multiply(mtx, x, y)
    out["y"] = c.AMGX_vector_download(y)[1]
    slv = c.AMGX_solver_create(rs, "dDDI", cfg)[1]
    c.AMGX_solver_setup(slv, mtx)
    b = c.AMGX_vector_create(rs, "dDDI")[1]
    c.AMGX_vector_upload(b, n, 1, np.ones(n))
    out["norm"] = c.AMGX_solver_calculate_residual_norm(slv, mtx, b, x)[1]
    out["sym"] = c.AMGX_matrix_check_symmetry(mtx)
    out["bsep"] = c.AMGX_matrix_set_boundary_separation(mtx, 1)
    out["rings"] = [c.AMGX_config_get_default_number_of_rings(
        c.AMGX_config_create(s)[1]) for s in (
        "solver=PCG, preconditioner(amg)=AMG, amg:algorithm=CLASSICAL",
        "solver=PCG, preconditioner(amg)=AMG, amg:algorithm=AGGREGATION")]
    nonsym = c.AMGX_matrix_create(rs, "dDDI")[1]
    c.AMGX_matrix_upload_all(nonsym, 2, 4, 1, 1, np.array([0, 2, 4]),
                             np.array([0, 1, 0, 1]),
                             np.array([2.0, -1.0, -0.5, 2.0]))
    out["nonsym"] = c.AMGX_matrix_check_symmetry(nonsym)
    colors = (np.arange(n) % 3).astype(np.int32)
    out["color_rcs"] = [c.AMGX_matrix_attach_coloring(mtx, colors, n, 3),
                        c.AMGX_matrix_attach_coloring(mtx, colors, n, 2),
                        c.AMGX_matrix_attach_coloring(mtx, colors[:5], 5,
                                                      3)]
    out["memory_rc"] = c.AMGX_resources_get_memory_usage(rs)[0]
    out["metrics_rc"] = c.AMGX_read_metrics()[0]
    out["openmetrics"] = c.AMGX_read_metrics_openmetrics()[1].rstrip(
        ).endswith("# EOF")
    out["timers_rc"] = c.AMGX_print_timers()
    return out


def test_tail():
    c0 = [0, 0]
    pcapi.AMGX_register_print_callback(lambda m, n: c0.__setitem__(0, 1))
    jcapi.AMGX_register_print_callback(lambda m, n: c0.__setitem__(1, 1))
    try:
        _, out_p = _both(_tail_flow)
    finally:
        for c in BOTH:
            c.AMGX_register_print_callback(None)
    assert out_p["sym"] == (RC.OK, 1, 1) and out_p["nonsym"] == (RC.OK, 1, 0)
    assert out_p["rings"] == [(RC.OK, 2), (RC.OK, 1)]
    assert out_p["color_rcs"] == [RC.OK, RC.BAD_PARAMETERS,
                                  RC.BAD_PARAMETERS]
    assert pcapi.AMGX_get_build_info_strings()[1].startswith("amgx_tpu")


def test_attach_coloring_overrides_scheme():
    """The attached colors reach color_matrix, whatever the configured
    scheme, and a multicolor smoother set up on the matrix uses them."""
    _, rs, mtx, n = _tail_system(pcapi)
    colors = (np.arange(n) % 3).astype(np.int32)
    assert pcapi.AMGX_matrix_attach_coloring(mtx, colors, n, 3) == RC.OK
    A = pcapi._get(mtx).A
    cl = color_matrix(A, pt.Config.from_string(""), "default")
    np.testing.assert_array_equal(cl.row_colors.numpy(), colors)
    assert cl.num_colors == 3
    slv = pt.create_solver(pt.Config.from_string(
        "solver=MULTICOLOR_DILU, max_iters=1"), device="cpu").setup(A)
    np.testing.assert_array_equal(slv.row_colors.numpy(), colors)


def test_vector_set_random_bit_for_bit():
    """The same draws as the JAX package's: numpy's generator seeded by
    the call counter (the counters aligned first: other files may have
    drawn in this process)."""
    nxt = int(repr(jcapi._random_seed).strip("count()"))
    pcapi._random_seed = itertools.count(nxt)
    for mode in ("dDDI", "dFFI", "dDDI"):
        got = []
        for c in BOTH:
            v = c.AMGX_vector_create(_rs(c), mode)[1]
            assert c.AMGX_vector_set_random(v, 100) == RC.OK
            got.append(c.AMGX_vector_download(v)[1])
        assert got[1].dtype == got[0].dtype
        np.testing.assert_array_equal(got[1], got[0])
        assert (got[1] >= 0).all() and (got[1] < 1).all()


# ---------------------------------------------------------------------------
# batched, service, fleet
# ---------------------------------------------------------------------------


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _batched_flow(c):
    cfg = c.AMGX_config_create(BATCHED_CG + ", s:store_res_history=1")[1]
    rs = _rs(c, cfg)
    A = c.AMGX_matrix_create(rs, "dDDI")[1]
    n, nnz, ro, ci, va = _csr("5pt", 12, 12)
    c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, va)
    b = c.AMGX_vector_create(rs, "dDDI")[1]
    x = c.AMGX_vector_create(rs, "dDDI")[1]
    slv = c.AMGX_solver_create(rs, "dDDI", cfg)[1]
    bs = np.stack([_rhs(n, s) for s in range(3)])
    rcs = [c.AMGX_vector_upload_batched(b, 3, n, 1, bs),
           c.AMGX_solver_setup(slv, A),
           c.AMGX_solver_solve_batched(slv, b, x)]
    return {"rcs": rcs, "status": c.AMGX_solver_get_status(slv),
            "batch_status": tuple(c.AMGX_solver_get_batch_status(slv)[1]),
            "iters": c.AMGX_solver_get_iterations_number(slv),
            "res_sys2": c.AMGX_solver_get_iteration_residual(slv, 2, 2),
            "size": c.AMGX_vector_get_size(x),
            "x": c.AMGX_vector_download(x)[1]}


def test_solve_batched():
    _, out_p = _both(_batched_flow)
    assert out_p["batch_status"] == (0, 0, 0)


def _service_flow(c, fleet: bool):
    cfg = c.AMGX_config_create(SERVE)[1]
    rs = _rs(c, cfg)
    if fleet:
        rc, svc = c.AMGX_fleet_create(rs, "dDDI", cfg, 2)
    else:
        rc, svc = c.AMGX_service_create(rs, "dDDI", cfg)
    rcs, tickets = [rc], []
    for i, shape in enumerate(((12, 12), (10, 10), (12, 12))):
        A = c.AMGX_matrix_create(rs, "dDDI")[1]
        n, nnz, ro, ci, va = _csr("5pt", *shape)
        c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, va)
        b = c.AMGX_vector_create(rs, "dDDI")[1]
        c.AMGX_vector_upload(b, n, 1, _rhs(n, i))
        submit = c.AMGX_fleet_submit if fleet else c.AMGX_service_submit
        rc, t = submit(svc, A, b)
        rcs.append(rc)
        tickets.append(t)
    drain = c.AMGX_fleet_drain if fleet else c.AMGX_service_drain
    out = {"drained": drain(svc, 300)}
    for i, t in enumerate(tickets):
        x = c.AMGX_vector_create(rs, "dDDI")[1]
        out[f"status{i}"] = c.AMGX_service_ticket_status(t)
        rcs.append(c.AMGX_service_ticket_download(t, x))
        out[f"x{i}"] = c.AMGX_vector_download(x)[1]
        out[f"trace{i}"] = c.AMGX_ticket_trace(t)[0]
        if fleet:
            out[f"replica{i}"] = c.AMGX_fleet_ticket_replica(t)[0]
        rcs.append(c.AMGX_service_ticket_destroy(t))
    if fleet:
        rc, health = c.AMGX_fleet_health(svc)
        out["health"] = (rc, sorted(health))
        out["stats_rc"] = c.AMGX_fleet_stats(svc)[0]
        out["step"] = c.AMGX_fleet_step(svc)
        rcs.append(c.AMGX_fleet_destroy(svc))
    else:
        out["autotune"] = c.AMGX_service_autotune(svc)
        out["stats_rc"] = c.AMGX_service_stats(svc)[0]
        out["step"] = c.AMGX_service_step(svc)
        rcs.append(c.AMGX_service_destroy(svc))
    out["rcs"] = rcs
    return out


@pytest.mark.parametrize("fleet", [False, True], ids=["service", "fleet"])
def test_service_and_fleet(fleet):
    """Three requests on two patterns: every ticket done with the JAX
    package's status and x (1e-12); a fleet's tickets with their
    replicas, the same two replica names in its health view."""
    _, out_p = _both(_service_flow, fleet)
    assert out_p["drained"] == (RC.OK, 3)
    assert all(out_p[f"status{i}"] == (RC.OK, 1, 0) for i in range(3))
    if fleet:
        assert out_p["replica0"] == out_p["replica2"]
        assert out_p["health"] == (RC.OK, ["r0", "r1"])


# ---------------------------------------------------------------------------
# refusals, complex systems, geometry, modes
# ---------------------------------------------------------------------------


def test_block_and_distributed_refusals():
    """Block and external-diagonal uploads return BAD_PARAMETERS naming
    ROADMAP item 8.4; every distributed call NOT_IMPLEMENTED naming item
    13. No solve runs."""
    c = pcapi
    rs = _rs(c)
    A = c.AMGX_matrix_create(rs, "dDDI")[1]
    n, nnz, ro, ci, va = _csr()
    assert c.AMGX_matrix_upload_all(A, n // 2, nnz, 2, 2, ro, ci,
                                    np.repeat(va, 4)) == RC.BAD_PARAMETERS
    assert "item 8.4" in c.last_error()
    assert c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, va,
                                    np.ones(n)) == RC.BAD_PARAMETERS
    assert "item 8.4" in c.last_error()
    assert c.AMGX_matrix_get_size(A)[0] == RC.BAD_PARAMETERS
    v = c.AMGX_vector_create(rs, "dDDI")[1]
    calls = [
        lambda: c.AMGX_distribution_create(None),
        lambda: c.AMGX_distribution_destroy(1),
        lambda: c.AMGX_distribution_set_partition_data(
            1, c.AMGX_DIST_PARTITION_OFFSETS, [0, n]),
        lambda: c.AMGX_distribution_set_32bit_colindices(1, 1),
        lambda: c.AMGX_matrix_upload_distributed(
            A, n, n, nnz, 1, 1, ro, ci, va, None, 1),
        lambda: c.AMGX_matrix_upload_all_global(A, n, n, nnz, 1, 1, ro, ci,
                                                va),
        lambda: c.AMGX_matrix_upload_all_global_32(A, n, n, nnz, 1, 1, ro,
                                                   ci, va),
        lambda: c.AMGX_vector_bind(v, A),
        lambda: c.AMGX_vector_upload_distributed(v, n, 1, np.ones(n)),
        lambda: c.AMGX_read_system_global(rs, "dDDI", "x.mtx"),
        lambda: c.AMGX_read_system_maps_one_ring(rs, "dDDI", "x.mtx"),
        lambda: c.AMGX_matrix_comm_from_maps_one_ring(A, 1, 0, [], [], [],
                                                      [], []),
        lambda: c.AMGX_matrix_comm_from_maps(A, 1, 0, [], [], [], [], []),
    ]
    for call in calls:
        out = call()
        rc = out if isinstance(out, RC) else out[0]
        assert rc == RC.NOT_IMPLEMENTED and "item 13" in c.last_error()
    assert c.AMGX_free_system_maps_one_ring() == RC.OK


def _complex_file(tmp_path):
    from amgx_tpu.matrix import CsrMatrix
    rng = np.random.default_rng(0)
    A5 = jx.gallery.poisson("5pt", 6, 4)
    rows, cols, _ = [np.asarray(v) for v in A5.init().coo()]
    vals = rng.standard_normal(rows.size) + 1j * rng.standard_normal(
        rows.size)
    vals[rows == cols] = 8 + 2j
    p = str(tmp_path / "c.mtx")
    jax_write_system(p, CsrMatrix.from_coo(rows, cols, vals, 24, 24),
                     b=np.ones(24) + 0j)
    return p


def _complex_flow(c, path, conv, mode, solve=True):
    cfg = c.AMGX_config_create(
        f"config_version=2, solver=FGMRES, max_iters=100, tolerance=1e-10,"
        f" monitor_residual=1, complex_conversion={conv}")[1]
    rs = _rs(c, cfg)
    A = c.AMGX_matrix_create(rs, mode)[1]
    b = c.AMGX_vector_create(rs, mode)[1]
    x = c.AMGX_vector_create(rs, mode)[1]
    slv = c.AMGX_solver_create(rs, mode, cfg)[1]
    out = {"read": c.AMGX_read_system(A, b, x, path),
           "size": c.AMGX_matrix_get_size(A),
           "setup": c.AMGX_solver_setup(slv, A)}
    if out["setup"] == RC.OK and solve:
        out.update(solve=c.AMGX_solver_solve(slv, b, x),
                   status=c.AMGX_solver_get_status(slv),
                   iters=c.AMGX_solver_get_iterations_number(slv),
                   x=c.AMGX_vector_download(x)[1])
    return out


def test_complex_read(tmp_path):
    """complex_conversion=1 reads the 2n real K1 system, which both
    packages solve alike; without it the JAX package sets up (and
    solves) the complex system, and the port's setup returns
    NOT_IMPLEMENTED naming ROADMAP item 15 (complex arithmetic)."""
    path = _complex_file(tmp_path)
    _, out_p = _both(_complex_flow, path, 1, "dDDI")
    assert out_p["size"] == (RC.OK, 48, 1, 1)
    assert out_p["status"] == (RC.OK, 0)
    out_j = _complex_flow(jcapi, path, 0, "dZZI", solve=False)
    out_p = _complex_flow(pcapi, path, 0, "dZZI")
    assert out_j["setup"] == RC.OK
    assert out_p["read"] == RC.OK and out_p["size"] == (RC.OK, 24, 1, 1)
    assert out_p["setup"] == RC.NOT_IMPLEMENTED
    assert "item 15" in pcapi.last_error()


def _geometry_flow(c, perm):
    preset = pt.presets if c is pcapi else jx.presets
    cfg = c.AMGX_config_create(preset.SERVING_CG)[1]
    rs = _rs(c, cfg)
    A = c.AMGX_matrix_create(rs, "dDDI")[1]
    n, nnz, ro, ci, va = _csr("7pt", 6, 5, 4)
    c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci, va)
    i = np.arange(n)
    gx, gy, gz = (i % 6) * 0.5, (i // 6) % 5, i // 30 + 2.0
    out = {"bad": c.AMGX_matrix_attach_geometry(A, gx[perm], gy, gz),
           "short": c.AMGX_matrix_attach_geometry(A, gx[:7], gy[:7]),
           "ok": c.AMGX_matrix_attach_geometry(A, gx, gy, gz, n)}
    out["shape"] = c._get(A).A.grid_shape
    b = c.AMGX_vector_create(rs, "dDDI")[1]
    x = c.AMGX_vector_create(rs, "dDDI")[1]
    slv = c.AMGX_solver_create(rs, "dDDI", cfg)[1]
    c.AMGX_vector_upload(b, n, 1, _rhs(n, 4))
    out["rcs"] = [c.AMGX_solver_setup(slv, A),
                  c.AMGX_solver_solve_with_0_initial_guess(slv, b, x)]
    out["iters"] = c.AMGX_solver_get_iterations_number(slv)
    out["x"] = c.AMGX_vector_download(x)[1]
    return out


def test_attach_geometry_drives_geo():
    """Coordinates of the 6x5x4 grid collapse to its grid_shape, and the
    GEO preset (SERVING_CG) then solves the uploaded matrix as the JAX
    package does; out-of-order and non-grid coordinates are refused."""
    perm = np.random.default_rng(2).permutation(120)
    _, out_p = _both(_geometry_flow, perm)
    assert out_p["shape"] == (6, 5, 4)
    assert out_p["bad"] == out_p["short"] == RC.BAD_PARAMETERS


def test_modes_parse_as_jax():
    """Every 4-letter string over the grammar's alphabets parses in both
    packages or in neither, to the same dtypes (bfloat16 and float16 the
    torch ones), with the same error code."""
    letters = "DFCZBHX"
    for name in ["".join(t) for t in itertools.product(
            "dhx", letters, letters, "ILX")] + ["dDD", "dDDIx", ""]:
        try:
            mj = jmodes.parse_mode(name)
        except jx.AMGXError as e:
            with pytest.raises(pt.errors.AMGXError) as ep:
                pmodes.parse_mode(name)
            assert ep.value.rc == e.rc == RC.BAD_MODE
            continue
        mp = pmodes.parse_mode(name)
        for f in ("vec_dtype", "mat_dtype", "ind_dtype"):
            assert str(getattr(mp, f)).replace("torch.", "") == \
                np.dtype(getattr(mj, f)).name
        assert (mp.mem_space, mp.is_complex) == (mj.mem_space, mj.is_complex)
        assert str(mp.real_dtype).replace("torch.", "") == \
            np.dtype(mj.real_dtype).name
    assert [m.name for m in pmodes.ALL_MODES] == \
        [m.name for m in jmodes.ALL_MODES]


def test_bfloat16_modes():
    """A dBBI vector downloads as float32 holding the JAX package's
    bfloat16 values bit for bit; a dDBI matrix keeps bfloat16 values."""
    data = np.random.default_rng(5).standard_normal(64)
    got = []
    for c in BOTH:
        v = c.AMGX_vector_create(_rs(c), "dBBI")[1]
        assert c.AMGX_vector_upload(v, 64, 1, data) == RC.OK
        got.append(c.AMGX_vector_download(v)[1])
    assert got[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], got[0].astype(np.float32))
    mats = []
    for c in BOTH:
        A = c.AMGX_matrix_create(_rs(c), "dDBI")[1]
        n, nnz, ro, ci, va = _csr()
        assert c.AMGX_matrix_upload_all(A, n, nnz, 1, 1, ro, ci,
                                        va * 1.01) == RC.OK
        mats.append(c._get(A).A.values)
    assert mats[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(mats[1].float().numpy(),
                                  np.asarray(mats[0]).astype(np.float32))


# ---------------------------------------------------------------------------
# convergence_analysis (the Queue C repair)
# ---------------------------------------------------------------------------

_ANALYSIS = ("algorithm=AGGREGATION, selector=SIZE_2, smoother=BLOCK_JACOBI,"
             " relaxation_factor=0.9, presweeps=1, postsweeps=1,"
             " coarse_solver=DENSE_LU_SOLVER, min_coarse_rows=16,"
             " convergence_analysis=2")


def test_convergence_analysis_matches_jax():
    """tests/test_aux_subsystems.py's configuration on the 7-pt 10^3:
    the port prints the report after setup, with two instrumented
    levels, and every phase norm equals the JAX package's within 1e-10
    (relative); each level's smoothing and total ratios are below 1."""
    ja = JaxAMG(JaxConfig.from_string(_ANALYSIS + ", print_grid_stats=0"))
    jout = []
    from amgx_tpu.output import register_print_callback as jax_callback
    jax_callback(lambda m, n: jout.append(m))
    try:
        ja.setup(jx.gallery.poisson("7pt", 10, 10, 10).init())
    finally:
        jax_callback(None)
    rows_j = []
    e = jnp.asarray(np.random.default_rng(0).standard_normal(1000))
    jax_analyze(ja, ja.solve_data(), 0, jnp.zeros_like(e), e, rows_j)
    printed = []
    pt.register_print_callback(lambda m, n: printed.append(m))
    try:
        amg = AMG(pt.Config.from_string(_ANALYSIS)).setup(
            pt.gallery.poisson("7pt", 10, 10, 10, device="cpu").init())
    finally:
        pt.register_print_callback(None)
    text = "".join(printed)
    assert "Convergence analysis" in text
    assert text.strip().splitlines()[-2:] == \
        "".join(jout).strip().splitlines()[-2:]
    rows_p = analysis_rows(amg)
    assert len(rows_p) == len(rows_j) == 2
    for rp, rj in zip(rows_p, sorted(rows_j, key=lambda r: r["level"])):
        assert rp["level"] == rj["level"] and rp["n"] == rj["n"]
        for k in ("pre_in", "pre_out", "coarse_out", "post_out"):
            assert abs(rp[k] - rj[k]) <= 1e-10 * rj[k], (k, rp[k], rj[k])
    for ln in convergence_analysis(amg).splitlines()[2:]:
        cols = ln.split()
        assert float(cols[2]) < 1.0 and float(cols[5]) < 1.0
