#!/usr/bin/env python3
"""Iteration anchors of the flagship at a chosen cycle precision, both
packages on the CPU.

    python3 tools/flagship_anchors.py --size 64 [--precision float bfloat16]
                                      [--extra ", amg:matrix_free=1"]
                                      [--xla]

FLAGSHIP + `solve_precision=P` (+ `--extra`) on the 7-pt n^3 Poisson
with b = 1, set up and solved by the JAX package under
`force_pallas_interpret()` (its Pallas kernels, the route a TPU runs),
with `--xla` also without it (its XLA route, which a CPU takes), and by
amgx_tpu_torch on `device="cpu"` (its kernels' plain forms). One JSON
line per run: outer and inner iterations, status, the true relative
residual in float64, seconds. `chip_smoke.py` keeps these counts
(BF16_PALLAS_ANCHORS, BF16_XLA_ANCHORS), holds the card's bf16 flagship
to the Pallas route's at 64^3 and bounds its bf16 / float32 ratio
between the two routes' ratios.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--precision", nargs="+", default=["float", "bfloat16"],
                    choices=("float", "bfloat16"))
    ap.add_argument("--extra", default="")
    ap.add_argument("--xla", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import scipy.sparse as sp
    import torch
    import amgx_tpu as jx
    import amgx_tpu_torch as pt
    from amgx_tpu.ops import pallas_spmv as jps
    from amgx_tpu.presets import FLAGSHIP
    n = args.size
    A = jx.gallery.poisson("7pt", n, n, n).init()
    A64 = sp.csr_matrix((np.asarray(A.values, np.float64),
                         np.asarray(A.col_indices),
                         np.asarray(A.row_offsets)))
    b = np.ones(n ** 3)

    def emit(pkg, route, prec, res, secs):
        x = np.asarray(res.x, np.float64)
        print(json.dumps({
            "package": pkg, "route": route, "precision": prec, "rows": n ** 3,
            "extra": args.extra, "status": str(res.status).lower(),
            "outer": int(res.iterations),
            "inner": int(res.extra_stats["inner_iters"]),
            "true_rel_res": float(np.linalg.norm(b - A64 @ x)
                                  / np.linalg.norm(b)),
            "seconds": secs}), flush=True)

    for prec in args.precision:
        cfg = FLAGSHIP + ", solve_precision=" + prec + args.extra
        routes = [("pallas", True)] + ([("xla", False)] if args.xla else [])
        for route, interpret in routes:
            t0 = time.perf_counter()
            slv = jx.create_solver(jx.Config.from_string(cfg))
            if interpret:
                with jps.force_pallas_interpret():
                    slv.setup(A)
                    res = slv.solve(b)
            else:
                slv.setup(A)
                res = slv.solve(b)
            emit("amgx_tpu", route, prec, res, time.perf_counter() - t0)
        t0 = time.perf_counter()
        slv = pt.create_solver(pt.Config.from_string(cfg), device="cpu")
        slv.setup(pt.gallery.poisson("7pt", n, n, n, device="cpu"))
        res = slv.solve(torch.ones(n ** 3, dtype=torch.float64))
        emit("amgx_tpu_torch", "cpu", prec, res, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
