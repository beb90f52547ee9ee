"""The whole FLAGSHIP + solve_precision=bfloat16 at 16^3 in
amgx_tpu_torch against the JAX package's Pallas route (its kernels under
the interpreter), on the CPU: slab and matrix-free levels, the default
coarse tail (the whole cycle one B5 launch) and
cycle_fusion_tail_rows=600 (B3 / B4 on level 0, B5 below). The kernels
and one cycle of these hierarchies are held elementwise in
test_torch_bf16.py."""
import numpy as np
import pytest
import torch

import amgx_tpu as jx
from amgx_tpu.config import Config as JaxConfig
from amgx_tpu.ops import pallas_spmv as jps

import amgx_tpu_torch as pt
from amgx_tpu_torch.config import Config
from amgx_tpu_torch.ops.spmv import residual

from test_torch_bf16 import FLAG_BF16, SOLVES


@pytest.fixture(scope="module", params=sorted(SOLVES))
def solved16(request):
    """The solve with b = 1 in both packages: (JAX result, port
    result)."""
    cfg = FLAG_BF16 + SOLVES[request.param]
    js = jx.create_solver(JaxConfig.from_string(cfg))
    with jps.force_pallas_interpret():
        js.setup(jx.gallery.poisson("7pt", 16, 16, 16).init())
        rj = js.solve(np.ones(16 ** 3))
    ps = pt.create_solver(Config.from_string(cfg), device="cpu")
    ps.setup(pt.gallery.poisson("7pt", 16, 16, 16, device="cpu"))
    return rj, ps.solve(torch.ones(16 ** 3, dtype=torch.float64))


def _true_rel_res(x):
    A = pt.gallery.poisson("7pt", 16, 16, 16, device="cpu").init()
    b = torch.ones(A.num_rows, dtype=torch.float64)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    return float(torch.linalg.norm(residual(A, x, b)) / torch.linalg.norm(b))


def test_flagship_bf16_solve_matches_jax(solved16):
    """The same outer iterations as the JAX package's Pallas route, inner
    FGMRES iterations within one, and a true residual of 1e-8."""
    rj, rp = solved16
    assert rp.status == rj.status == "success"
    assert rp.iterations == rj.iterations
    assert abs(rp.extra_stats["inner_iters"]
               - rj.extra_stats["inner_iters"]) <= 1
    assert _true_rel_res(rp.x) <= 1e-8
