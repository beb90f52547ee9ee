"""CLASSICAL_REFINEMENT (FLAGSHIP's REFINEMENT + FGMRES around the
classical PMIS + D2 AMG block, set up in float32, so every Galerkin
product takes B10) in amgx_tpu_torch against the JAX package at 16^3,
on the CPU: in float32, and with solve_precision=bfloat16, where the
classical hierarchy's cycle runs bf16 B3w / B4w on level 0 and bf16 B9
/ B8 on its CSR levels. Both solves share the JAX package's classical
setup (it compiles once per shape and configuration: ~50-100 s here),
which is why they sit in one file.
"""
import numpy as np
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops.pallas_spmv import force_pallas_interpret

import amgx_tpu_torch as pt
from amgx_tpu_torch.config import Config

from _torch_util import rel
from test_torch_classical import (CLASSICAL_REFINEMENT, X_TOL, _precond_amg,
                                  _true_rel_res)

# f32: one rounding per product and per addition
TOL32 = 1e-6
JAX_CR = CLASSICAL_REFINEMENT.replace(", amg:setup_backend=device", "")
BF16 = ", solve_precision=bfloat16"


def test_classical_refinement_matches_jax():
    """CLASSICAL_REFINEMENT at 16^3; the JAX side without
    `amg:setup_backend=device` (its own tests hold that build equal to the
    host one; the port's setup is the same either way)."""
    js = jx.create_solver(JaxConfig.from_string(
        CLASSICAL_REFINEMENT.replace(", amg:setup_backend=device", "")))
    js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
    rj = js.solve(np.ones(16 ** 3))
    ps_ = pt.create_solver(Config.from_string(CLASSICAL_REFINEMENT),
                           device="cpu")
    ps_.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    rp = ps_.solve(torch.ones(16 ** 3, dtype=torch.float64))
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    assert _true_rel_res(16, rp.x) <= 1e-8
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL
    # level 0 in float32: the same CF split and P pattern, P's values to
    # float32 rounding. The coarse operators are float32 Galerkin sums in
    # another order than the JAX host build's (ulps), and from level 1 on
    # one ulp can flip a strength or truncation tie, so deeper levels
    # are not compared entry by entry.
    lj, lp = _precond_amg(js).amg.levels[0], _precond_amg(ps_).amg.levels[0]
    assert lp.A.dtype == lp.P.values.dtype == torch.float32
    assert np.array_equal(np.asarray(lj.cf_map), lp.cf_map.numpy())
    assert np.array_equal(np.asarray(lj.P.row_offsets),
                          lp.P.row_offsets.numpy())
    assert np.array_equal(np.asarray(lj.P.col_indices),
                          lp.P.col_indices.numpy())
    assert rel(lp.P.values, np.asarray(lj.P.values)) < TOL32


def test_classical_refinement_bf16_matches_jax():
    """CLASSICAL_REFINEMENT + solve_precision=bfloat16 at 16^3 (the
    shape of the JAX package's `test_refinement_shell_bf16_classical`):
    the JAX Pallas route's status, outer and inner iterations and level
    rows, every CSR level of the reference in its SWELL layout (its bf16
    sweep kernel runs there, as the port's B9 form does), the solve data
    bf16 with a float32 coarse solve, and the float64 answer."""
    with force_pallas_interpret():
        js = jx.create_solver(JaxConfig.from_string(JAX_CR + BF16))
        js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
        rj = js.solve(np.ones(16 ** 3))
    ps_ = pt.create_solver(Config.from_string(CLASSICAL_REFINEMENT + BF16),
                           device="cpu")
    ps_.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    rp = ps_.solve(torch.ones(16 ** 3, dtype=torch.float64))
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    assert rp.extra_stats["inner_iters"] == rj.extra_stats["inner_iters"]
    ja, pa = _precond_amg(js).amg, _precond_amg(ps_).amg
    assert pa.level_rows() == [lv.A.num_rows for lv in ja.levels] + [
        ja.coarsest_A.num_rows]
    assert [ja._layout_of(lv.A) for lv in ja.levels[1:]] == \
        ["swell"] * (len(ja.levels) - 1)
    data = pa.solve_data()
    assert all(ld["A"].dtype == torch.bfloat16 for ld in data["levels"])
    assert data["levels"][0]["xfer"]["cwt"].dtype == torch.bfloat16
    assert data["coarse"]["A"].dtype == torch.float32
    assert _true_rel_res(16, rp.x) <= 1e-8
    assert rel(rp.x, np.asarray(rj.x)) <= X_TOL
