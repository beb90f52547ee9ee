"""The Galerkin product of the port's classical setup (ops/spgemm.py) and
B10's plain twin (ops/cuda_rap.py) against the JAX package, on the CPU:
the RAP plan's arrays against the JAX package's `build_rap_plan` on the
same operators (exact), the value phase three ways (f64 plain against
`_rap_values_numpy`, f32 B10 twin against the Pallas kernel under the
interpreter, the eager product against the planned one). The slice's
second solve, CLASSICAL_REFINEMENT, whose setup runs in float32 and so
takes B10 for every Galerkin product, is in
test_torch_classical_refinement.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.ops import pallas_spgemm as pk
from amgx_tpu.ops import spgemm as jsp
from amgx_tpu.ops.pallas_spmv import force_pallas_interpret

import amgx_tpu_torch as pt
from amgx_tpu_torch.amg.hierarchy import AMG
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops import cuda_spmv, spgemm

from _torch_util import rel
from test_torch_classical import LEVEL_CFG

# f64: the same products, segments added left to right (the port) or by
# numpy's reduceat (pairwise for long runs): ulps
TOL64 = 1e-12
# f32: one rounding per product and per addition
TOL32 = 1e-6


def _jax(M, dtype=np.float64):
    return jx.CsrMatrix.from_scipy_like(
        M.row_offsets.numpy(), M.col_indices.numpy(),
        M.values.numpy().astype(dtype), M.num_rows, M.num_cols)


@pytest.fixture(scope="module")
def levels16():
    """The port's 7-pt 16^3 classical hierarchy (f64): (A, P, R) per
    level, 4096 -> 1395 -> 198 -> 39 rows."""
    amg = AMG(Config.from_string(LEVEL_CFG)).setup(
        pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    return [(lv.A, lv.P, lv.R) for lv in amg.levels]


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_plan_arrays_equal_jax(levels16, lvl):
    A, P, R = levels16[lvl]
    plan = spgemm.build_rap_plan(R, A, P)
    jplan = jsp.build_rap_plan(_jax(R), _jax(A), _jax(P))
    s1 = jplan.stage1
    for mine, theirs in ((plan.sa, s1["sa"]), (plan.sp, s1["sp"]),
                         (plan.starts1, s1["starts1"]),
                         (plan.sr, jplan.sr), (plan.st, jplan.st),
                         (plan.starts2, jplan.starts2),
                         (plan.row_offsets, jplan.row_offsets),
                         (plan.col_indices, jplan.col_indices)):
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    assert (plan.nT, plan.nU) == (s1["nT"], jplan.nU)


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_values_f64_against_numpy(levels16, lvl):
    A, P, R = levels16[lvl]
    plan = spgemm.build_rap_plan(R, A, P)
    jplan = jsp.build_rap_plan(_jax(R), _jax(A), _jax(P))
    want = jsp._rap_values_numpy(jplan, A.values.numpy(), R.values.numpy(),
                                 P.values.numpy())
    got = spgemm.rap_values(plan, A.values, R.values, P.values)
    assert got.dtype == torch.float64
    assert rel(got, want) < TOL64


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_eager_product_matches_planned(levels16, lvl):
    """spgemm_plan=0's (R A) P against the planned R (A P): the same
    pattern, values to rounding."""
    A, P, R = levels16[lvl]
    planned, _ = spgemm.planned_rap(R, A, P)
    eager = spgemm.galerkin_rap(R, A, P)
    assert torch.equal(planned.row_offsets, eager.row_offsets)
    assert torch.equal(planned.col_indices, eager.col_indices)
    assert rel(planned.values, eager.values) < TOL64


def test_b10_f32_against_pallas_kernel():
    """B10's plain twin against the JAX package's RAP value kernel under
    the interpreter, at 8^3's level 0 (the JAX package's own kernel test
    size)."""
    amg = AMG(Config.from_string(LEVEL_CFG)).setup(
        pt.gallery.poisson("7pt", 8, 8, 8, device="cpu"))
    A, P, R = (M.astype(torch.float32) for M in (
        amg.levels[0].A, amg.levels[0].P, amg.levels[0].R))
    plan = spgemm.build_rap_plan(R, A, P)
    jplan = jsp.build_rap_plan(_jax(R), _jax(A), _jax(P))
    with force_pallas_interpret():
        assert pk.rap_kernel_ready(jplan, jnp.float32)
        want = pk.rap_value_call(jplan, jnp.asarray(A.values.numpy()),
                                 jnp.asarray(R.values.numpy()),
                                 jnp.asarray(P.values.numpy()))
    before = dict(cuda_spmv.LAUNCHES)
    got = spgemm.rap_values(plan, A.values, R.values, P.values)
    assert cuda_spmv.LAUNCHES == before          # the CPU route launches none
    assert got.dtype == torch.float32
    assert rel(got, want) < TOL32


def test_planned_hierarchy_equals_eager_hierarchy():
    """spgemm_plan=0 builds the same hierarchy (levels, patterns) with
    operators equal to rounding."""
    A = pt.gallery.poisson("7pt", 12, 12, 12, device="cpu")
    planned = AMG(Config.from_string(LEVEL_CFG)).setup(A)
    eager = AMG(Config.from_string(LEVEL_CFG + ", spgemm_plan=0")).setup(A)
    assert planned.level_rows() == eager.level_rows()
    for a, b in zip(planned.levels, eager.levels):
        assert torch.equal(a.A.col_indices, b.A.col_indices)
        assert rel(a.A.values, b.A.values) < TOL64
    assert all(lv.rap_plan is None for lv in eager.levels)
    assert all(lv.rap_plan is not None for lv in planned.levels)
