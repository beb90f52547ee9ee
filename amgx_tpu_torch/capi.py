"""The AmgX C API surface (the port of amgx_tpu/capi.py; the reference's
include/amgx_c.h, src/amgx_c.cu and the eigensolver API
include/amgx_eig_c.h, src/amgx_eig_c.cu).

Every function keeps its AMGX_* name, its arguments, its call order, its
handle-based object model and its RC return-code contract (exception ->
RC, src/amgx_c_common.cu AMGX_CHECK_API_ERROR), so a user porting from
`amgx_capi.c` maps each call 1:1. As in the JAX package, C
output-pointer parameters become return values after the RC:

    AMGX_RC AMGX_config_create(AMGX_config_handle *cfg, const char *opt)
       ->   rc, cfg = AMGX_config_create(options)

Handles are opaque integers into a process-global registry, touched only
from the caller's thread (the service and fleet calls drive their
schedulers in the caller's thread too). Objects land on the device of
their resources: `AMGX_resources_create_simple(cfg, platform="cpu")`
for the CPU, the card otherwise. Matrices and vectors live there as
torch tensors; an upload is one host-to-device copy per array and a
download one copy back, and a solve adds no host read of its own.

What waits: the distributed calls (`AMGX_distribution_*`, the per-rank
uploads, `AMGX_vector_bind`, the global and one-ring reads) raise
NOT_IMPLEMENTED naming ROADMAP.md Queue A item 13; block and
external-diagonal uploads return BAD_PARAMETERS naming item 8.4; a
complex matrix reads, and its setup returns NOT_IMPLEMENTED (item 15)
unless complex_conversion turned it into its real K-formulation.

A failed call's exception text is kept in `last_error()`, for a caller
that wants more than the RC.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import sys
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import initialize as _initialize_framework
from .config import Config
from .errors import (AMGXError, BadParametersError, NotImplementedError_, RC,
                     get_error_string)
from .io._common import host as _host
from .io._common import refuse_block as _refuse_block
from .matrix import CsrMatrix
from .modes import parse_mode
from .resilience.status import (  # noqa: F401  (the status codes' names)
    AMGX_SOLVE_DIVERGED, AMGX_SOLVE_FAILED, AMGX_SOLVE_NOT_CONVERGED,
    AMGX_SOLVE_SUCCESS, to_amgx_status)

# ---------------------------------------------------------------------------
# handle registry (CWrap analog, src/amgx_c_common.cu)
# ---------------------------------------------------------------------------

_handles: Dict[int, Any] = {}
_next_id = itertools.count(1)
_random_seed = itertools.count(1)    # AMGX_vector_set_random sequence
_last_error = [""]


def _new_handle(obj) -> int:
    h = next(_next_id)
    _handles[h] = obj
    return h


def _get(h, cls=None):
    obj = _handles.get(h)
    if obj is None or (cls is not None and not isinstance(obj, cls)):
        raise AMGXError("invalid handle", RC.BAD_PARAMETERS)
    return obj


def last_error() -> str:
    """The formatted exception of the last call that returned an RC
    other than OK ("" before any)."""
    return _last_error[0]


def _api(fn):
    """Exception -> RC translation (AMGX_CHECK_API_ERROR analog)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            rc = e.rc if isinstance(e, AMGXError) else \
                RC.IO_ERROR if isinstance(e, FileNotFoundError) \
                else RC.UNKNOWN
            _last_error[0] = f"{fn.__name__}: {traceback.format_exc()}"
        n = getattr(fn, "_n_outputs", 0)
        return rc if n == 0 else (rc,) + (None,) * n

    return wrapper


def _outputs(n):
    def deco(fn):
        fn._n_outputs = n
        return fn
    return deco


def _not_ported(what: str):
    raise NotImplementedError_(
        f"{what}: distributed solves are not ported to amgx_tpu_torch yet "
        "(ROADMAP.md Queue A item 13)")


def _tensor(data, dtype: torch.dtype, device) -> torch.Tensor:
    """`data` (an array, a sequence or a tensor) as a `dtype` tensor on
    `device`: one host-to-device copy."""
    if torch.is_tensor(data):
        return data.to(device=device, dtype=dtype)
    a = np.asarray(data)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


# ---------------------------------------------------------------------------
# library-level objects
# ---------------------------------------------------------------------------


class _CResources:
    def __init__(self, cfg: Optional[Config], device_num: int = 0,
                 devices=None, platform: str = "cuda"):
        from .resources import Resources
        self.cfg = cfg
        self.res = Resources(cfg, device_num=device_num, devices=devices,
                             platform=platform)

    @property
    def device(self) -> torch.device:
        return self.res.device


class _CMatrix:
    def __init__(self, resources: _CResources, mode):
        self.resources = resources
        self.mode = mode
        self.A: Optional[CsrMatrix] = None
        self.part_offsets = None
        self.row_perm = None

    def set_matrix(self, A, part_offsets=None, row_perm=None):
        """Replace the stored matrix; a distributed read's renumbering
        belongs to a specific matrix and is reset with it."""
        self.A = A
        self.part_offsets = part_offsets
        self.row_perm = row_perm


class _CVector:
    def __init__(self, resources: _CResources, mode):
        self.resources = resources
        self.mode = mode
        self.v: Optional[torch.Tensor] = None
        self.block_dim = 1
        # batched extension: None = plain vector; an int B means v is
        # (B, n*block_dim), one system per row
        self.batch: Optional[int] = None


class _CSolver:
    def __init__(self, resources: _CResources, mode, cfg: Config):
        from .solvers.base import create_solver
        self.resources = resources
        self.mode = mode
        self.cfg = cfg
        # create_solver owns the tree build and the ResilientSolver
        # wrapping rule (fallback_policy)
        self.solver = create_solver(cfg, device=resources.device)
        self.result = None


class _CEigenSolver:
    def __init__(self, resources: _CResources, mode, cfg: Config):
        from .eigen import create_eigensolver
        self.resources = resources
        self.mode = mode
        self.cfg = cfg
        self.solver = create_eigensolver(cfg, device=resources.device)
        self.result = None


# ---------------------------------------------------------------------------
# init / version / error API
# ---------------------------------------------------------------------------


@_api
def AMGX_initialize():
    """src/amgx_c.cu:2360."""
    _initialize_framework()
    return RC.OK


@_api
def AMGX_initialize_plugins():
    return RC.OK           # plugin system removed upstream (CHANGELOG:14)


@_api
def AMGX_finalize():
    _handles.clear()
    return RC.OK


@_api
def AMGX_finalize_plugins():
    return RC.OK


def AMGX_get_api_version():
    """rc, major, minor."""
    from . import API_VERSION
    return RC.OK, API_VERSION[0], API_VERSION[1]


def AMGX_get_error_string(rc):
    return get_error_string(rc)


@_api
def AMGX_register_print_callback(callback):
    from .output import register_print_callback
    register_print_callback(callback)
    return RC.OK


@_api
def AMGX_install_signal_handler():
    import faulthandler
    faulthandler.enable()
    return RC.OK


@_api
def AMGX_reset_signal_handler():
    import faulthandler
    faulthandler.disable()
    return RC.OK


def AMGX_pin_memory(*_args):     # no-op: PyTorch's copies own pinning
    return RC.OK


def AMGX_unpin_memory(*_args):
    return RC.OK


# ---------------------------------------------------------------------------
# config API
# ---------------------------------------------------------------------------


@_api
@_outputs(1)
def AMGX_config_create(options: str):
    return RC.OK, _new_handle(Config.from_string(options or ""))


@_api
@_outputs(1)
def AMGX_config_create_from_file(path: str):
    return RC.OK, _new_handle(Config.from_file(path))


@_api
@_outputs(1)
def AMGX_config_create_from_file_and_string(path: str, options: str):
    cfg = Config.from_file(path)
    cfg.parse_parameter_string(options or "")
    return RC.OK, _new_handle(cfg)


@_api
def AMGX_config_add_parameters(cfg_h, options: str):
    _get(cfg_h, Config).parse_parameter_string(options)
    return RC.OK


@_api
def AMGX_config_destroy(cfg_h):
    _handles.pop(cfg_h, None)
    return RC.OK


# ---------------------------------------------------------------------------
# resources API
# ---------------------------------------------------------------------------


@_api
@_outputs(1)
def AMGX_resources_create_simple(cfg_h=None, platform: str = "cuda"):
    """rc, resources on the card (platform="cpu": the CPU)."""
    cfg = _get(cfg_h, Config) if cfg_h is not None else None
    return RC.OK, _new_handle(_CResources(cfg, platform=platform))


@_api
@_outputs(1)
def AMGX_resources_create(cfg_h, _comm=None, device_num=0, devices=None,
                          platform: str = "cuda"):
    cfg = _get(cfg_h, Config) if cfg_h is not None else None
    return RC.OK, _new_handle(_CResources(
        cfg, device_num=device_num, devices=devices, platform=platform))


@_api
def AMGX_resources_destroy(rsrc_h):
    _handles.pop(rsrc_h, None)
    return RC.OK


@_api
@_outputs(2)
def AMGX_resources_get_memory_usage(rsrc_h):
    """rc, bytes_in_use, peak high-water mark (MemoryInfo analog;
    include/memory_info.h:33) over the resources' cards; zeros on the
    CPU."""
    rs = _get(rsrc_h, _CResources)
    cur, peak = rs.res.update_memory_usage()
    return RC.OK, cur, peak


# ---------------------------------------------------------------------------
# matrix API
# ---------------------------------------------------------------------------


@_api
@_outputs(1)
def AMGX_matrix_create(rsrc_h, mode: str):
    rs = _get(rsrc_h, _CResources)
    return RC.OK, _new_handle(_CMatrix(rs, parse_mode(mode)))


@_api
def AMGX_matrix_destroy(mtx_h):
    _handles.pop(mtx_h, None)
    return RC.OK


@_api
def AMGX_matrix_upload_all(mtx_h, n, nnz, block_dimx, block_dimy,
                           row_ptrs, col_indices, data, diag_data=None):
    """AMGX_matrix_upload_all (src/amgx_c.cu:3039): a scalar CSR matrix
    in the mode's matrix precision, built on the resources' device with
    one copy per array."""
    m = _get(mtx_h, _CMatrix)
    if block_dimx * block_dimy > 1 or diag_data is not None:
        _refuse_block(f"AMGX_matrix_upload_all: block {block_dimx}x"
                      f"{block_dimy}, diag_data "
                      f"{'given' if diag_data is not None else 'none'}")
    dev = m.resources.device
    vals = _tensor(data, m.mode.mat_dtype, dev)
    if vals.numel() != nnz:
        raise BadParametersError(
            f"AMGX_matrix_upload_all: {vals.numel()} values for nnz {nnz}")
    with m.resources.res.device_context():
        m.set_matrix(CsrMatrix.from_scipy_like(
            row_ptrs, col_indices, vals, n, n, device=dev).init())
    return RC.OK


@_api
def AMGX_matrix_replace_coefficients(mtx_h, n, nnz, data, diag_data=None):
    """Keep the structure, replace the values (src/amgx_c.cu; pairs with
    AMGX_solver_resetup)."""
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    if diag_data is not None:
        _refuse_block("AMGX_matrix_replace_coefficients: diag_data")
    vals = _tensor(data, m.mode.mat_dtype, m.resources.device)
    with m.resources.res.device_context():
        m.A = m.A.with_values(vals.reshape(-1))
    return RC.OK


def AMGX_matrix_get_size(mtx_h):
    """rc, n, block_dimx, block_dimy."""
    try:
        m = _get(mtx_h, _CMatrix)
        if m.A is None:
            return RC.BAD_PARAMETERS, None, None, None
        return RC.OK, m.A.num_rows, 1, 1
    except AMGXError as e:
        return e.rc, None, None, None


@_api
@_outputs(1)
def AMGX_matrix_get_nnz(mtx_h):
    m = _get(mtx_h, _CMatrix)
    return RC.OK, (m.A.nnz if m.A is not None else 0)


@_api
def AMGX_matrix_attach_geometry(mtx_h, geox, geoy, geoz=None, n=None):
    """AMGX_matrix_attach_geometry (src/amgx_c.cu:3143): per-row
    coordinates of a lexicographically ordered grid (x fastest) collapse
    to the (nx, ny, nz) annotation `CsrMatrix.grid_shape` that the GEO
    selector reads. Other coordinates are rejected. One sort per axis,
    no Python loop over the rows."""
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    gx = np.asarray(geox, np.float64)
    gy = np.asarray(geoy, np.float64)
    gz = (np.asarray(geoz, np.float64) if geoz is not None
          else np.zeros_like(gx))
    if n is not None and n != m.A.num_rows:
        raise AMGXError("attach_geometry: n mismatch", RC.BAD_PARAMETERS)
    (ux, rx), (uy, ry), (uz, rz) = (np.unique(g, return_inverse=True)
                                    for g in (gx, gy, gz))
    nx, ny, nz = ux.size, uy.size, uz.size
    if nx * ny * nz != m.A.num_rows:
        raise AMGXError(
            "attach_geometry: coordinates do not form a structured "
            "nx*ny*nz grid", RC.BAD_PARAMETERS)
    lin = (rz.reshape(-1) * ny + ry.reshape(-1)) * nx + rx.reshape(-1)
    if not np.array_equal(lin, np.arange(m.A.num_rows)):
        raise AMGXError(
            "attach_geometry: rows are not in lexicographic grid order "
            "(x fastest); renumber the system first", RC.BAD_PARAMETERS)
    m.A = dataclasses.replace(m.A, grid_shape=(int(nx), int(ny), int(nz)))
    return RC.OK


# ---------------------------------------------------------------------------
# vector API
# ---------------------------------------------------------------------------


@_api
@_outputs(1)
def AMGX_vector_create(rsrc_h, mode: str):
    rs = _get(rsrc_h, _CResources)
    return RC.OK, _new_handle(_CVector(rs, parse_mode(mode)))


@_api
def AMGX_vector_destroy(vec_h):
    _handles.pop(vec_h, None)
    return RC.OK


@_api
def AMGX_vector_upload(vec_h, n, block_dim, data):
    v = _get(vec_h, _CVector)
    v.v = _tensor(data, v.mode.vec_dtype, v.resources.device).reshape(
        n * block_dim)
    v.block_dim = block_dim
    v.batch = None
    return RC.OK


@_api
def AMGX_vector_upload_batched(vec_h, n_batch, n, block_dim, data):
    """Batched extension (no reference analog): `n_batch` systems'
    vectors at once, one per row of a (n_batch, n*block_dim) array. A
    batched vector pairs with AMGX_solver_solve_batched."""
    v = _get(vec_h, _CVector)
    v.v = _tensor(data, v.mode.vec_dtype, v.resources.device).reshape(
        n_batch, n * block_dim)
    v.block_dim = block_dim
    v.batch = int(n_batch)
    return RC.OK


@_api
def AMGX_vector_set_zero(vec_h, n, block_dim):
    v = _get(vec_h, _CVector)
    v.v = torch.zeros(n * block_dim, dtype=v.mode.vec_dtype,
                      device=v.resources.device)
    v.block_dim = block_dim
    v.batch = None
    return RC.OK


@_api
@_outputs(1)
def AMGX_vector_download(vec_h):
    """rc, the vector as a numpy array (one device-to-host copy). A
    bfloat16 vector (mode letter B) comes back as float32 holding the
    exact bfloat16 values: numpy has no bfloat16 of its own."""
    v = _get(vec_h, _CVector)
    if v.v is None:
        raise AMGXError("vector not uploaded", RC.BAD_PARAMETERS)
    return RC.OK, _host(v.v)


def AMGX_vector_get_size(vec_h):
    """rc, n, block_dim (n is per system for batched vectors)."""
    try:
        v = _get(vec_h, _CVector)
        if v.v is None:
            return RC.OK, 0, v.block_dim
        return RC.OK, int(v.v.shape[-1]) // v.block_dim, v.block_dim
    except AMGXError as e:
        return e.rc, None, None


# ---------------------------------------------------------------------------
# solver API
# ---------------------------------------------------------------------------


@_api
@_outputs(1)
def AMGX_solver_create(rsrc_h, mode: str, cfg_h):
    rs = _get(rsrc_h, _CResources)
    cfg = _get(cfg_h, Config)
    return RC.OK, _new_handle(_CSolver(rs, parse_mode(mode), cfg))


@_api
def AMGX_solver_destroy(slv_h):
    _handles.pop(slv_h, None)
    return RC.OK


@_api
def AMGX_solver_setup(slv_h, mtx_h):
    """src/amgx_c.cu:2745."""
    s = _get(slv_h, _CSolver)
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    with s.resources.res.device_context():
        s.solver.setup(m.A)
    return RC.OK


@_api
def AMGX_solver_resetup(slv_h, mtx_h):
    s = _get(slv_h, _CSolver)
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    with s.resources.res.device_context():
        s.solver.resetup(m.A)
    return RC.OK


def _do_solve(s, b_h, x_h, zero_guess):
    b = _get(b_h, _CVector)
    x = _get(x_h, _CVector)
    if getattr(s.solver, "A", None) is None:
        raise AMGXError("solver not set up", RC.BAD_PARAMETERS)
    if b.v is None:
        raise AMGXError("rhs not uploaded", RC.BAD_PARAMETERS)
    x0 = x.v if (x.v is not None and not zero_guess) else None
    with s.resources.res.device_context():
        s.result = s.solver.solve(b.v, x0=x0, zero_initial_guess=zero_guess)
    x.v = s.result.x
    x.block_dim = b.block_dim
    x.batch = None
    return RC.OK


@_api
def AMGX_solver_solve(slv_h, b_h, x_h):
    """src/amgx_c.cu:2813 (x holds the initial guess)."""
    return _do_solve(_get(slv_h, _CSolver), b_h, x_h, zero_guess=False)


@_api
def AMGX_solver_solve_with_0_initial_guess(slv_h, b_h, x_h):
    return _do_solve(_get(slv_h, _CSolver), b_h, x_h, zero_guess=True)


@_api
def AMGX_solver_solve_batched(slv_h, b_h, x_h):
    """Batched extension (no reference analog): solve every system of a
    batched rhs (AMGX_vector_upload_batched) against the set-up matrix
    in one batched loop (batch/). x may hold batched initial guesses; on
    return it holds the batched solutions. get_status reports success
    only when every system converged, get_iterations_number the batch
    max, get_batch_status each system's."""
    s = _get(slv_h, _CSolver)
    b = _get(b_h, _CVector)
    x = _get(x_h, _CVector)
    if getattr(s.solver, "A", None) is None:
        raise AMGXError("batched solve needs a set-up solver",
                        RC.BAD_PARAMETERS)
    if b.v is None or b.batch is None:
        raise AMGXError("rhs is not a batched vector (use "
                        "AMGX_vector_upload_batched)", RC.BAD_PARAMETERS)
    if x.v is not None and x.batch != b.batch:
        raise AMGXError(
            f"initial-guess vector batch ({x.batch}) does not match the "
            f"rhs batch ({b.batch}); upload it with "
            f"AMGX_vector_upload_batched or leave it empty",
            RC.BAD_PARAMETERS)
    x0s = x.v
    with s.resources.res.device_context():
        s.result = s.solver.solve_many(b.v, x0s=x0s,
                                       zero_initial_guess=x0s is None)
    x.v = s.result.x
    x.block_dim = b.block_dim
    x.batch = b.batch
    return RC.OK


def _result_status_codes(result) -> np.ndarray:
    """Per-system SolveStatus codes of a solve result (length 1 for a
    plain solve)."""
    codes = getattr(result, "status_code", None)
    if codes is None:
        codes = getattr(result, "status", None)       # batched results
    if codes is None or isinstance(codes, str):
        conv = np.atleast_1d(np.asarray(result.converged))
        return np.where(conv, 0, 1).astype(np.int32)
    return np.atleast_1d(np.asarray(codes)).astype(np.int32)


def _last_result(s):
    if s.result is None:
        raise AMGXError("no solve performed", RC.BAD_PARAMETERS)
    return s.result


@_api
@_outputs(1)
def AMGX_solver_get_status(slv_h):
    """rc, status: AMGX_SOLVE_SUCCESS(0) / FAILED(1) / DIVERGED(2) /
    NOT_CONVERGED(3) (include/amgx_c.h), from the SolveStatus
    classification (resilience/status.py). A batched solve reports the
    worst system."""
    res = _last_result(_get(slv_h, _CSolver))
    return RC.OK, to_amgx_status(int(np.max(_result_status_codes(res))))


@_api
@_outputs(1)
def AMGX_solver_get_batch_status(slv_h):
    """rc, per-system AMGX_SOLVE_* statuses as an int array (batched
    extension; a plain solve reports a length-1 array)."""
    res = _last_result(_get(slv_h, _CSolver))
    return RC.OK, np.asarray(
        [to_amgx_status(c) for c in _result_status_codes(res)], np.int32)


@_api
@_outputs(1)
def AMGX_solver_get_report(slv_h):
    """rc, the last solve's SolveReport as a plain dict
    (telemetry/report.py; a list of dicts for a batched solve).
    BAD_PARAMETERS when no solve ran or telemetry=0 disabled reports."""
    res = _last_result(_get(slv_h, _CSolver))
    reports = getattr(res, "reports", None)      # batched result
    if reports is not None:
        return RC.OK, [r.to_dict() for r in reports]
    report = getattr(res, "report", None)
    if report is None:
        raise AMGXError("no report on the last solve (telemetry=0?)",
                        RC.BAD_PARAMETERS)
    return RC.OK, report.to_dict()


@_api
@_outputs(1)
def AMGX_solver_get_grid_stats(slv_h):
    """rc, the solver tree's AMG grid statistics as a dict
    (AMG.grid_stats_dict(), the data of print_grid_stats' table).
    BAD_PARAMETERS when the tree owns no set-up AMG hierarchy."""
    from .telemetry.report import _amg_of
    s = _get(slv_h, _CSolver)
    amg = _amg_of(s.solver)
    if amg is None or not getattr(amg, "levels", None):
        raise AMGXError("no set-up AMG hierarchy in the solver tree",
                        RC.BAD_PARAMETERS)
    return RC.OK, amg.grid_stats_dict()


@_api
@_outputs(1)
def AMGX_read_metrics():
    """rc, a snapshot of the process-wide telemetry registry
    (telemetry/metrics.py)."""
    from .telemetry import metrics
    return RC.OK, metrics.snapshot()


@_api
@_outputs(1)
def AMGX_read_metrics_openmetrics():
    """rc, the metrics registry as OpenMetrics text (`# EOF`
    terminated)."""
    from .telemetry import metrics
    return RC.OK, metrics.to_openmetrics()


@_api
def AMGX_print_timers():
    """Print the trace-region timer table through the print callback
    (profiling.format_timers)."""
    from .output import amgx_output
    from .profiling import format_timers
    amgx_output(format_timers())
    return RC.OK


@_api
@_outputs(1)
def AMGX_solver_get_iterations_number(slv_h):
    res = _last_result(_get(slv_h, _CSolver))
    return RC.OK, int(np.max(res.iterations))


@_api
@_outputs(1)
def AMGX_solver_get_iteration_residual(slv_h, it: int, idx: int = 0):
    s = _get(slv_h, _CSolver)
    if s.result is None or s.result.res_history is None:
        raise AMGXError("no residual history (set store_res_history=1)",
                        RC.BAD_PARAMETERS)
    hist = np.asarray(s.result.res_history)   # (iters+1,) or (iters+1, b)
    if hasattr(s.result, "batch_size"):       # batched: (B, hist_len)
        hist = np.moveaxis(hist, 0, 1)        # idx then selects the system
        sysi = min(idx, hist.shape[1] - 1)
        # rows past a system's own stopping iteration are NaN padding
        if not (0 <= it <= int(np.asarray(s.result.iterations)[sysi])):
            raise AMGXError("iteration out of range for this system",
                            RC.BAD_PARAMETERS)
    if not (0 <= it < hist.shape[0]):
        raise AMGXError("iteration out of range", RC.BAD_PARAMETERS)
    row = np.atleast_1d(hist[it])
    return RC.OK, float(row[min(idx, len(row) - 1)])


# ---------------------------------------------------------------------------
# serving API (serving/; no reference analog): the service loop behind
# handles -- continuous batching, the hierarchy cache, warm starts and
# per-tenant deadlines. step and drain run the scheduler in the
# caller's thread.
# ---------------------------------------------------------------------------


class _CService:
    def __init__(self, resources: _CResources, mode, cfg: Config):
        from .serving import SolveService
        self.resources = resources
        self.mode = mode
        self.cfg = cfg
        self.service = SolveService(cfg, device=resources.device)


def _ticket(tkt_h):
    from .serving import ServiceTicket
    return _get(tkt_h, ServiceTicket)


def _system(mtx_h, rhs_h):
    m = _get(mtx_h, _CMatrix)
    b = _get(rhs_h, _CVector)
    if m.A is None or b.v is None:
        raise AMGXError("matrix/rhs not uploaded", RC.BAD_PARAMETERS)
    return m.A, b.v


@_api
@_outputs(1)
def AMGX_service_create(rsrc_h, mode: str, cfg_h):
    """rc, service handle. The config's serving_* parameters size the
    buckets, cache, AOT store and deadline semantics."""
    rs = _get(rsrc_h, _CResources)
    cfg = _get(cfg_h, Config)
    return RC.OK, _new_handle(_CService(rs, parse_mode(mode), cfg))


@_api
def AMGX_service_destroy(svc_h):
    svc = _handles.pop(svc_h, None)
    if isinstance(svc, _CService):
        svc.service.stop()
    return RC.OK


@_api
@_outputs(1)
def AMGX_service_submit(svc_h, mtx_h, rhs_h, tenant: str = "default",
                        deadline_s=None, request_key=None):
    """rc, ticket handle. Enqueues one system and issues no device work
    of its own. `deadline_s` is a relative latency budget (expiry
    completes the ticket with DEADLINE_EXCEEDED); `request_key` makes
    the submit idempotent."""
    svc = _get(svc_h, _CService)
    A, b = _system(mtx_h, rhs_h)
    ticket = svc.service.submit(A, b, tenant=tenant, deadline_s=deadline_s,
                                request_key=request_key)
    return RC.OK, _new_handle(ticket)


@_api
@_outputs(1)
def AMGX_service_step(svc_h):
    """rc, completed count: one scheduler cycle (expire / admit /
    advance every bucket by serving_chunk_iters / finalize)."""
    svc = _get(svc_h, _CService)
    with svc.resources.res.device_context():
        return RC.OK, len(svc.service.step())


@_api
@_outputs(1)
def AMGX_service_drain(svc_h, timeout_s=None):
    """rc, completed count: step until every queued and in-flight
    request completed (or timeout)."""
    svc = _get(svc_h, _CService)
    before = svc.service.completed_total
    with svc.resources.res.device_context():
        svc.service.drain(timeout_s=timeout_s)
    return RC.OK, svc.service.completed_total - before


@_api
@_outputs(2)
def AMGX_service_ticket_status(tkt_h):
    """rc, done (0/1), AMGX_SOLVE_* status (None while pending)."""
    t = _ticket(tkt_h)
    if not t.done:
        return RC.OK, 0, None
    return RC.OK, 1, to_amgx_status(t.result.status_code)


@_api
def AMGX_service_ticket_download(tkt_h, sol_h):
    """A completed ticket's solution into a vector handle (on the
    device; AMGX_vector_download brings it to the host)."""
    t = _ticket(tkt_h)
    x = _get(sol_h, _CVector)
    if not t.done:
        raise AMGXError("ticket not completed (drain or step the "
                        "service first)", RC.BAD_PARAMETERS)
    x.v = t.result.x
    x.batch = None
    return RC.OK


@_api
@_outputs(1)
def AMGX_ticket_trace(tkt_h):
    """rc, the ticket's request trace id (None when serving_tracing=0):
    the key of its span chain, flight-recorder events and journal
    record."""
    return RC.OK, _ticket(tkt_h).trace_id


@_api
def AMGX_service_ticket_destroy(tkt_h):
    _handles.pop(tkt_h, None)
    return RC.OK


@_api
@_outputs(1)
def AMGX_service_stats(svc_h):
    """rc, stats dict: queue depth, in-flight count, live buckets, cache
    bytes and evictions, per-tenant tallies."""
    return RC.OK, _get(svc_h, _CService).service.stats()


@_api
@_outputs(1)
def AMGX_service_autotune(svc_h):
    """rc, the online tuner's state ({'enabled': False} with
    autotune=0)."""
    t = _get(svc_h, _CService).service._tuner
    return RC.OK, ({"enabled": False} if t is None else t.snapshot())


# ---------------------------------------------------------------------------
# fleet API (serving/fleet.py): N service replicas behind one
# fingerprint-affine submit / step / drain surface. Tickets are service
# tickets (AMGX_service_ticket_* applies) with their replica.
# ---------------------------------------------------------------------------


class _CFleet:
    def __init__(self, resources: _CResources, mode, cfg: Config,
                 n_replicas):
        from .serving import FleetRouter
        self.resources = resources
        self.mode = mode
        self.cfg = cfg
        self.fleet = FleetRouter.build(cfg, n_replicas,
                                       device=resources.device)


@_api
@_outputs(1)
def AMGX_fleet_create(rsrc_h, mode: str, cfg_h, n_replicas=None):
    """rc, fleet handle: `n_replicas` SolveService replicas (default:
    the config's fleet_replicas) on the resources' device, fronted by
    the FleetRouter."""
    rs = _get(rsrc_h, _CResources)
    cfg = _get(cfg_h, Config)
    return RC.OK, _new_handle(
        _CFleet(rs, parse_mode(mode), cfg, n_replicas))


@_api
def AMGX_fleet_destroy(fleet_h):
    fl = _handles.pop(fleet_h, None)
    if isinstance(fl, _CFleet):
        fl.fleet.stop()
    return RC.OK


@_api
@_outputs(1)
def AMGX_fleet_submit(fleet_h, mtx_h, rhs_h, tenant: str = "default",
                      deadline_s=None, request_key=None):
    """rc, ticket handle: route one system to its affine replica and
    enqueue it there (AMGX_service_submit otherwise)."""
    fl = _get(fleet_h, _CFleet)
    A, b = _system(mtx_h, rhs_h)
    ticket = fl.fleet.submit(A, b, tenant=tenant, deadline_s=deadline_s,
                             request_key=request_key)
    return RC.OK, _new_handle(ticket)


@_api
@_outputs(1)
def AMGX_fleet_step(fleet_h):
    """rc, completed count: one scheduler cycle on every replica."""
    fl = _get(fleet_h, _CFleet)
    with fl.resources.res.device_context():
        return RC.OK, len(fl.fleet.step())


@_api
@_outputs(1)
def AMGX_fleet_drain(fleet_h, timeout_s=None):
    """rc, completed count: step the fleet until every replica is idle
    (or timeout)."""
    fl = _get(fleet_h, _CFleet)
    before = fl.fleet.completed_total
    with fl.resources.res.device_context():
        fl.fleet.drain(timeout_s=timeout_s)
    return RC.OK, fl.fleet.completed_total - before


@_api
@_outputs(1)
def AMGX_fleet_ticket_replica(tkt_h):
    """rc, id of the replica that served this ticket, or None for a
    ticket submitted to a bare service."""
    return RC.OK, getattr(_ticket(tkt_h), "replica", None)


@_api
@_outputs(1)
def AMGX_fleet_stats(fleet_h):
    """rc, per-replica service stats plus the warm|cold|spill route
    counters and placed-fingerprint counts."""
    return RC.OK, _get(fleet_h, _CFleet).fleet.stats()


@_api
@_outputs(1)
def AMGX_fleet_drain_replica(fleet_h, replica: str):
    """rc, handed-off queue count: drain one replica for a rolling
    restart (its queued tickets move to survivors)."""
    return RC.OK, _get(fleet_h, _CFleet).fleet.drain_replica(str(replica))


@_api
def AMGX_fleet_restore_replica(fleet_h, replica: str):
    """rc: re-enter a drained or down replica into the rendezvous."""
    _get(fleet_h, _CFleet).fleet.restore_replica(str(replica))
    return RC.OK


@_api
@_outputs(1)
def AMGX_fleet_health(fleet_h):
    """rc, health dict per replica: breaker state, down / draining
    flags, consecutive failures, last health event, scheduler facts."""
    return RC.OK, _get(fleet_h, _CFleet).fleet.health_snapshot()


# ---------------------------------------------------------------------------
# system IO API
# ---------------------------------------------------------------------------


def _io_device(m, *vec_handles):
    """The device a read lands on: the matrix's resources', else the
    first vector's."""
    if m is not None:
        return m.resources.device
    for h in vec_handles:
        if h is not None:
            return _get(h, _CVector).resources.device
    raise AMGXError("read_system: no matrix or vector handle",
                    RC.BAD_PARAMETERS)


def _fill_vectors(m, rhs_h, sol_h, A, b, x):
    """The rhs / solution handles from a read (b = ones and x = zeros
    where the file has none, as in the reference reader)."""
    for h, vec, fill in ((rhs_h, b, torch.ones), (sol_h, x, torch.zeros)):
        if h is None:
            continue
        v = _get(h, _CVector)
        dt = m.mode.vec_dtype if m is not None else torch.float64
        v.v = vec if vec is not None else fill(
            A.num_rows, dtype=dt, device=v.resources.device)
        v.block_dim = 1
        v.batch = None


@_api
def AMGX_read_system(mtx_h, rhs_h, sol_h, path: str):
    """src/amgx_c.cu read_system: the matrix and the rhs and solution
    (b = ones and x = zeros where the file has none). MatrixMarket or
    binary, sniffed. A complex file becomes its K-formulation real
    system when the resources' config sets complex_conversion
    (readers.cu:221)."""
    from .io import read_system as _read
    m = _get(mtx_h, _CMatrix) if mtx_h is not None else None
    dev = _io_device(m, rhs_h, sol_h)
    A, b, x = _read(path, dtype=m.mode.mat_dtype if m else None,
                    device=dev)
    if A.dtype.is_complex:
        cfg = m.resources.cfg if m is not None else None
        conv = int(cfg.get("complex_conversion", "default")) \
            if cfg is not None else 0
        if conv:
            from .io.complex import complex_system_to_real
            A, b, x = complex_system_to_real(A, b, x, mode=conv)
    if m is not None:
        m.set_matrix(A.init())
    _fill_vectors(m, rhs_h, sol_h, A, b, x)
    return RC.OK


def _stored_vectors(rhs_h, sol_h):
    return tuple(None if h is None else _get(h, _CVector).v
                 for h in (rhs_h, sol_h))


@_api
def AMGX_write_system(mtx_h, rhs_h, sol_h, path: str):
    """Write the system in MatrixMarket (src/amgx_c.cu write_system)."""
    from .io import write_system as _write
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    b, x = _stored_vectors(rhs_h, sol_h)
    _write(path, m.A, b, x)
    return RC.OK


@_api
def AMGX_read_system_distributed(mtx_h, rhs_h, sol_h, path: str,
                                 allocated_halo_depth=1, num_partitions=None,
                                 partition_sizes=None, partition_vector=None):
    """src/amgx_c.cu read_system_distributed on one device: the global
    system and a partition vector (an array or a file path) give the
    partition-contiguous renumbered system; its part_offsets and
    row_perm stay on the matrix handle."""
    from .io.distributed import read_system_distributed
    m = _get(mtx_h, _CMatrix)
    kw = {}
    if isinstance(partition_vector, str):
        kw["partition_path"] = partition_vector
    elif partition_vector is not None:
        kw["partition_vector"] = np.asarray(partition_vector)
    elif partition_sizes is not None:
        kw["partition_sizes"] = partition_sizes
    if num_partitions is not None:
        kw["num_ranks"] = int(num_partitions)
    A, b, x, part_offsets, perm = read_system_distributed(
        path, dtype=m.mode.mat_dtype, device=m.resources.device, **kw)
    m.set_matrix(A, part_offsets=part_offsets, row_perm=perm)
    _fill_vectors(m, rhs_h, sol_h, A, b, x)
    return RC.OK


@_api
def AMGX_write_system_distributed(mtx_h, rhs_h, sol_h, path: str,
                                  allocated_halo_depth=1,
                                  num_partitions=None, partition_sizes=None,
                                  partition_vector=None):
    """The global system plus its partition vector as the sidecar
    `<path>.partition`, aligned with the written row order."""
    from .io.distributed import (sizes_to_partition_vector,
                                 write_system_distributed)
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    b, x = _stored_vectors(rhs_h, sol_h)
    pv = partition_vector
    if pv is None and partition_sizes is not None:
        pv = sizes_to_partition_vector(partition_sizes, m.A.num_rows)
    if pv is not None and m.row_perm is not None:
        # the stored matrix is renumbered (row_perm: new -> old) and the
        # caller's vector is in the original order
        pv = np.asarray(pv)[np.asarray(m.row_perm)]
    write_system_distributed(path, m.A, b, x, partition_vector=pv)
    return RC.OK


@_api
def AMGX_write_parameters_description(path: str):
    """Every registered parameter, one line each (include/amgx_c.h)."""
    from .config import describe_parameters
    with open(path, "w") as f:
        f.write(describe_parameters())
    return RC.OK


# ---------------------------------------------------------------------------
# generators (AMGX_generate_distributed_poisson_7pt, src/amgx_c.cu:4731)
# ---------------------------------------------------------------------------


@_api
def AMGX_generate_distributed_poisson_7pt(mtx_h, rhs_h, sol_h,
                                          allocated_halo_depth,
                                          num_import_rings,
                                          nx, ny, nz, px=1, py=1, pz=1):
    """The global 7-pt Poisson of the px*nx x py*ny x pz*nz grid
    (gallery.poisson, with its grid annotation) on the resources'
    device; rhs = ones, solution = zeros."""
    from .gallery import poisson
    m = _get(mtx_h, _CMatrix)
    dev = m.resources.device
    A = poisson("7pt", nx * px, ny * py, nz * pz, dtype=m.mode.mat_dtype,
                device=dev)
    m.set_matrix(A.init())
    n = m.A.num_rows
    for h, fill in ((rhs_h, torch.ones), (sol_h, torch.zeros)):
        if h is not None:
            v = _get(h, _CVector)
            v.v = fill(n, dtype=m.mode.vec_dtype, device=v.resources.device)
            v.block_dim = 1
            v.batch = None
    return RC.OK


# ---------------------------------------------------------------------------
# eigensolver API (include/amgx_eig_c.h:18-26, src/amgx_eig_c.cu)
# ---------------------------------------------------------------------------


@_api
@_outputs(1)
def AMGX_eigensolver_create(rsrc_h, mode: str, cfg_h):
    rs = _get(rsrc_h, _CResources)
    cfg = _get(cfg_h, Config)
    return RC.OK, _new_handle(_CEigenSolver(rs, parse_mode(mode), cfg))


@_api
def AMGX_eigensolver_destroy(es_h):
    _handles.pop(es_h, None)
    return RC.OK


@_api
def AMGX_eigensolver_setup(es_h, mtx_h):
    es = _get(es_h, _CEigenSolver)
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    with es.resources.res.device_context():
        es.solver.setup(m.A)
    return RC.OK


@_api
def AMGX_eigensolver_pagerank_setup(es_h, a_vec_h):
    return RC.OK          # dangling/teleport vectors built internally


@_api
def AMGX_eigensolver_solve(es_h, x_h):
    """Solve from x's vector (a random start where x is empty); x then
    holds the first eigenvector when the config asks for
    eigenvectors."""
    es = _get(es_h, _CEigenSolver)
    x = _get(x_h, _CVector)
    with es.resources.res.device_context():
        es.result = es.solver.solve(x.v)
    if es.result.eigenvectors is not None:
        x.v = es.result.eigenvectors[:, 0]
    return RC.OK


@_api
@_outputs(1)
def AMGX_eigensolver_get_eigenvalues(es_h):
    es = _get(es_h, _CEigenSolver)
    if es.result is None:
        raise AMGXError("no solve performed", RC.BAD_PARAMETERS)
    return RC.OK, np.array(es.result.eigenvalues)


# ---------------------------------------------------------------------------
# distributed API (include/amgx_c.h:235-586, src/amgx_c.cu:1805-4753):
# per-rank pieces, partition descriptors and one-ring maps wait for the
# distributed solves (ROADMAP.md Queue A item 13); each call raises
# NOT_IMPLEMENTED naming that item.
# ---------------------------------------------------------------------------

AMGX_DIST_PARTITION_VECTOR = 0
AMGX_DIST_PARTITION_OFFSETS = 1


@_api
@_outputs(1)
def AMGX_distribution_create(cfg_h=None, n_ranks=None):
    _not_ported("AMGX_distribution_create")


@_api
def AMGX_distribution_destroy(dist_h):
    _not_ported("AMGX_distribution_destroy")


@_api
def AMGX_distribution_set_partition_data(dist_h, info, partition_data):
    _not_ported("AMGX_distribution_set_partition_data")


@_api
def AMGX_distribution_set_32bit_colindices(dist_h, use32):
    _not_ported("AMGX_distribution_set_32bit_colindices")


@_api
def AMGX_matrix_upload_distributed(mtx_h, n_global, n, nnz, block_dimx,
                                   block_dimy, row_ptrs,
                                   col_indices_global, data,
                                   diag_data, dist_h):
    _not_ported("AMGX_matrix_upload_distributed")


@_api
def AMGX_matrix_upload_all_global(mtx_h, n_global, n, nnz, block_dimx,
                                  block_dimy, row_ptrs,
                                  col_indices_global, data,
                                  diag_data=None, allocated_halo_depth=1,
                                  num_import_rings=1,
                                  partition_vector=None):
    _not_ported("AMGX_matrix_upload_all_global")


AMGX_matrix_upload_all_global_32 = AMGX_matrix_upload_all_global


@_api
def AMGX_vector_bind(vec_h, mtx_h):
    _not_ported("AMGX_vector_bind")


@_api
def AMGX_vector_upload_distributed(vec_h, n, block_dim, data):
    _not_ported("AMGX_vector_upload_distributed")


@_api
@_outputs(1)
def AMGX_read_system_global(rsrc_h, mode: str, filename: str,
                            allocated_halo_depth=1, num_partitions=None,
                            partition_sizes=None,
                            partition_vector=None):
    _not_ported("AMGX_read_system_global")


@_api
@_outputs(1)
def AMGX_read_system_maps_one_ring(rsrc_h, mode: str, filename: str,
                                   allocated_halo_depth=1,
                                   num_partitions=None,
                                   partition_sizes=None,
                                   partition_vector=None):
    _not_ported("AMGX_read_system_maps_one_ring")


@_api
def AMGX_free_system_maps_one_ring(*_args):
    """include/amgx_c.h:478: frees the buffers of
    AMGX_read_system_maps_one_ring; Python's are garbage-collected."""
    return RC.OK


@_api
def AMGX_solver_register_print_callback(callback):
    """include/amgx_c.h:600 (deprecated): routes to the global
    callback, as the reference's implementation does."""
    from .output import register_print_callback
    register_print_callback(callback)
    return RC.OK


@_api
def AMGX_matrix_comm_from_maps_one_ring(mtx_h, allocated_halo_depth,
                                        num_neighbors, neighbors,
                                        send_sizes, send_maps,
                                        recv_sizes, recv_maps):
    _not_ported("AMGX_matrix_comm_from_maps_one_ring")


AMGX_matrix_comm_from_maps = AMGX_matrix_comm_from_maps_one_ring


# ---------------------------------------------------------------------------
# C API tail (include/amgx_c.h misc functions)
# ---------------------------------------------------------------------------


@_api
@_outputs(4)
def AMGX_matrix_download_all(mtx_h):
    """include/amgx_c.h:294: rc, row_ptrs, col_indices, data, diag
    (None: the port holds no external diagonal), as numpy copies."""
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    return (RC.OK, _host(m.A.row_offsets), _host(m.A.col_indices),
            _host(m.A.values).reshape(-1), None)


@_api
def AMGX_matrix_vector_multiply(mtx_h, x_h, y_h):
    """include/amgx_c.h:306: y = A x, on the device (B1 on a DIA
    matrix on the card)."""
    from .ops.spmv import spmv
    m = _get(mtx_h, _CMatrix)
    x = _get(x_h, _CVector)
    y = _get(y_h, _CVector)
    if m.A is None or x.v is None:
        raise AMGXError("matrix/vector not uploaded", RC.BAD_PARAMETERS)
    with m.resources.res.device_context():
        y.v = spmv(m.A, x.v.to(device=m.A.device, dtype=m.mode.vec_dtype))
    y.block_dim = 1
    y.batch = None
    return RC.OK


@_api
@_outputs(1)
def AMGX_solver_calculate_residual_norm(slv_h, mtx_h, rhs_h, x_h):
    """include/amgx_c.h:410: rc, the solver's configured norm of
    b - A x as an array (one entry a block component)."""
    from .ops import blas
    from .ops.spmv import residual
    s = _get(slv_h, _CSolver)
    m = _get(mtx_h, _CMatrix)
    b = _get(rhs_h, _CVector)
    x = _get(x_h, _CVector)
    if m.A is None or b.v is None or x.v is None:
        raise AMGXError("system not uploaded", RC.BAD_PARAMETERS)
    dt, dev = m.mode.vec_dtype, m.A.device
    with m.resources.res.device_context():
        r = residual(m.A, x.v.to(device=dev, dtype=dt),
                     b.v.to(device=dev, dtype=dt))
        nrm = s.solver._norm(r) if s.solver is not None \
            else blas.norm(r, "L2")
    return RC.OK, np.atleast_1d(_host(nrm))


@_api
def AMGX_vector_set_random(vec_h, n):
    """include/amgx_c.h:355: uniform [0, 1) entries, the JAX package's
    numbers (numpy's generator seeded by a per-process call counter)."""
    v = _get(vec_h, _CVector)
    seed = next(_random_seed)
    v.batch = None
    v.v = _tensor(np.random.default_rng(seed).random(n), v.mode.vec_dtype,
                  v.resources.device)
    return RC.OK


@_api
@_outputs(2)
def AMGX_matrix_check_symmetry(mtx_h):
    """include/amgx_c.h:588: rc, structurally_symmetric, symmetric
    (values to a relative 1e-12), on host copies."""
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    A = m.A
    ro, ci, va = (_host(t) for t in (A.row_offsets, A.col_indices,
                                     A.values))
    rows = np.repeat(np.arange(A.num_rows), np.diff(ro))
    order_f = np.lexsort((ci, rows))
    order_t = np.lexsort((rows, ci))
    struct = bool(np.array_equal(rows[order_f], ci[order_t]) and
                  np.array_equal(ci[order_f], rows[order_t]))
    sym = struct and bool(np.allclose(va[order_f], va[order_t], rtol=1e-12,
                                      atol=0))
    return RC.OK, int(struct), int(sym)


@_api
def AMGX_matrix_attach_coloring(mtx_h, row_coloring, num_rows,
                                num_colors):
    """include/amgx_c.h:512: a row coloring that the multicolor
    smoothers use instead of a computed scheme."""
    m = _get(mtx_h, _CMatrix)
    if m.A is None:
        raise AMGXError("matrix not uploaded", RC.BAD_PARAMETERS)
    colors = np.asarray(row_coloring, np.int32)
    if colors.shape[0] != num_rows or num_rows != m.A.num_rows:
        raise AMGXError("coloring size mismatch", RC.BAD_PARAMETERS)
    if colors.size and (colors.min() < 0 or colors.max() >= num_colors):
        raise AMGXError(
            f"coloring values must lie in [0, {num_colors})",
            RC.BAD_PARAMETERS)
    m.A = dataclasses.replace(
        m.A, user_colors=torch.from_numpy(colors).to(m.A.device),
        user_num_colors=int(num_colors))
    return RC.OK


@_api
def AMGX_matrix_set_boundary_separation(mtx_h, boundary_separation):
    """include/amgx_c.h:310: accepted and inert, as in the JAX package
    (the owned / halo split of the distributed layer is structural)."""
    _get(mtx_h, _CMatrix)
    return RC.OK


def AMGX_abort(rsrc_h=None, err=1):
    """include/amgx_c.h:173: hard process abort (no cleanup), the
    MPI_Abort analog."""
    import os
    sys.stderr.write(f"AMGX_abort: err={err}\n")
    sys.stderr.flush()
    os._exit(int(err))


def AMGX_get_build_info_strings():
    """include/amgx_c.h:154: rc, version, build, backend."""
    from . import __version__
    backend = f"cuda {torch.version.cuda}" if torch.cuda.is_available() \
        else "cpu"
    return (RC.OK, f"amgx_tpu_torch {__version__}",
            f"torch {torch.__version__}", f"backend {backend}")


@_api
@_outputs(1)
def AMGX_config_get_default_number_of_rings(cfg_h):
    """include/amgx_c.h:210: the halo rings the configured stack needs
    (2 for classical AMG's distributed RAP, 1 otherwise)."""
    cfg = _get(cfg_h, Config)
    classical = any(
        name == "algorithm" and str(v).upper() == "CLASSICAL"
        for (scope, name), v in cfg.values.items())
    return RC.OK, (2 if classical else 1)
