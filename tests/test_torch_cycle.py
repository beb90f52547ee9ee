"""One multigrid cycle of amgx_tpu_torch against the JAX package's
`AMG.cycle` on identical operators: the JAX hierarchy's per-level
arrays become a port hierarchy through amgx_tpu_torch.interop, so the
cycle is compared independently of setup.

float64 runs both packages' composed per-level paths; float32 runs the
port's smoother/transfer kernels B3/B4 (their plain twins on the CPU)
with cycle_fusion=1, and its B2 + pair-sum composition with
cycle_fusion=0.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig

import amgx_tpu_torch as pt
from amgx_tpu_torch.interop import hierarchy_from_numpy

from _torch_util import jax_hierarchy_arrays, rel
from _torch_util import single_torch_thread  # noqa: F401  (autouse)

AMG_CFG = ("solver=AMG, algorithm=AGGREGATION, selector=GEO,"
           " smoother=CHEBYSHEV_POLY, chebyshev_polynomial_order=2,"
           " presweeps=1, postsweeps=1, max_iters=1, cycle={cycle},"
           " max_levels=50, min_coarse_rows=32, cycle_fusion_tail_rows=0,"
           " cycle_fusion={fusion}")
# f64: identical arithmetic up to summation order
TOL64 = 1e-12
# f32: a whole cycle stacks several levels' float32 rounding
TOL32 = 1e-5


def _run(shape, dtype, cycle, fusion):
    cfg = AMG_CFG.format(cycle=cycle, fusion=fusion)
    js = jx.create_solver(JaxConfig.from_string(cfg))
    js.setup(jx.gallery.poisson("7pt", *shape, dtype=dtype).init())
    levels, coarse = jax_hierarchy_arrays(js)
    amg = hierarchy_from_numpy(levels, coarse, pt.Config.from_string(cfg),
                               device="cpu")
    n = js.A.num_rows
    rng = np.random.default_rng(11)
    b = rng.standard_normal(n).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    xj = js.amg.cycle(js.solve_data()["amg"], jnp.asarray(b),
                      jnp.asarray(x))
    xp = amg.cycle(amg.solve_data(), torch.from_numpy(b),
                   torch.from_numpy(x))
    return xj, xp, amg


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 10, 8)])
@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_cycle_f64(shape, cycle):
    xj, xp, amg = _run(shape, np.float64, cycle, 1)
    assert len(amg.levels) >= 1
    assert rel(xp, xj) < TOL64


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 10, 8)])
@pytest.mark.parametrize("fusion", [1, 0])
def test_v_cycle_f32(shape, fusion):
    xj, xp, _ = _run(shape, np.float32, "V", fusion)
    assert xp.dtype == torch.float32
    assert rel(xp, xj) < TOL32
