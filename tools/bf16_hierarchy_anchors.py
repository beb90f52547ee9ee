#!/usr/bin/env python3
"""Iteration anchors of the aggregation and classical hierarchies with a
bfloat16 AMG cycle, both packages on the CPU.

    python3 tools/bf16_hierarchy_anchors.py --size 12
        [--config agg-pcg agg-fgmres classical classical-refinement]
        [--precision bfloat16 float] [--xla]

The stock configs/PCG_ / FGMRES_AGGREGATION_JACOBI.json with
`amg_precision` set in their AMG scope (on the float32 operator),
chip_smoke.py's CLASSICAL with its `amg:amg_precision` replaced (PCG in
float64), and CLASSICAL_REFINEMENT with `solve_precision`, on the 7-pt
n^3 Poisson with b = 1: set up and solved by the JAX package under
`force_pallas_interpret()` (its Pallas kernels, the route a TPU runs),
with `--xla` also without it (its XLA route, which rounds a bf16 sweep
at every operation), and by amgx_tpu_torch on `device="cpu"` (its
kernels' plain forms). One JSON line per run: status, iterations (outer
and inner for the REFINEMENT shell), the true relative residual in
float64, the level rows, the JAX package's level layouts (a CSR level
runs the bf16 sweep kernel only in its "swell" layout), seconds. The JAX
package compiles its classical setup once per shape: ~50-100 s for the
first classical run of a size on this kind of host.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = ("agg-pcg", "agg-fgmres", "classical", "classical-refinement")


def make_config(Config, name, precision):
    """(Config, operator dtype name) of one path at one cycle precision."""
    from chip_smoke import CLASSICAL, agg_config, classical_refinement
    if name.startswith("agg-"):
        cfg = agg_config(Config, name)
        cfg.set("amg_precision", precision, scope="amg")
        return cfg, "float32"
    if name == "classical":
        return Config.from_string(CLASSICAL.replace(
            "amg_precision=float", "amg_precision=" + precision)), "float64"
    return Config.from_string(classical_refinement().replace(
        ", amg:setup_backend=device", "")
        + ", solve_precision=" + precision), "float64"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=12)
    ap.add_argument("--config", nargs="+", default=list(CONFIGS),
                    choices=CONFIGS)
    ap.add_argument("--precision", nargs="+", default=["bfloat16"],
                    choices=("float", "bfloat16"))
    ap.add_argument("--xla", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import scipy.sparse as sp
    import torch
    import amgx_tpu as jx
    import amgx_tpu_torch as pt
    from amgx_tpu import output as jx_output
    from amgx_tpu.ops import pallas_spmv as jps
    # the stock files' solve and grid tables go to stderr: stdout holds
    # the JSON lines
    for pkg_output in (jx_output, pt):
        pkg_output.register_print_callback(
            lambda msg, _n: sys.stderr.write(msg))
    n = args.size
    P = jx.gallery.poisson("7pt", n, n, n).init()
    A64 = sp.csr_matrix((np.asarray(P.values, np.float64),
                         np.asarray(P.col_indices),
                         np.asarray(P.row_offsets)))
    b64 = np.ones(n ** 3)

    def amg_of(slv):
        s = slv
        while not hasattr(s, "amg"):
            s = s.preconditioner
        return s.amg

    def emit(pkg, route, name, prec, res, slv, secs):
        x = np.asarray(res.x, np.float64)
        amg = amg_of(slv)
        row = {"package": pkg, "route": route, "config": name,
               "precision": prec, "rows": n ** 3,
               "status": str(res.status).lower(),
               "iterations": int(res.iterations),
               "inner": None if not res.extra_stats
               else int(res.extra_stats["inner_iters"]),
               "true_rel_res": float(np.linalg.norm(b64 - A64 @ x)
                                     / np.linalg.norm(b64)),
               "seconds": secs}
        if pkg == "amgx_tpu":
            row["levels"] = [int(lv.A.num_rows) for lv in amg.levels] + [
                int(amg.coarsest_A.num_rows)]
            row["layouts"] = [amg._layout_of(lv.A) for lv in amg.levels]
        else:
            row["levels"] = amg.level_rows()
        print(json.dumps(row), flush=True)

    for name in args.config:
        for prec in args.precision:
            routes = [("pallas", True)] + ([("xla", False)]
                                           if args.xla else [])
            for route, interpret in routes:
                cfg, dt = make_config(jx.Config, name, prec)
                A = jx.gallery.poisson("7pt", n, n, n,
                                       dtype=getattr(np, dt)).init()
                b = np.ones(n ** 3, getattr(np, dt))
                t0 = time.perf_counter()
                slv = jx.create_solver(cfg)
                if interpret:
                    with jps.force_pallas_interpret():
                        slv.setup(A)
                        res = slv.solve(b)
                else:
                    slv.setup(A)
                    res = slv.solve(b)
                emit("amgx_tpu", route, name, prec, res, slv,
                     time.perf_counter() - t0)
            cfg, dt = make_config(pt.Config, name, prec)
            t0 = time.perf_counter()
            slv = pt.create_solver(cfg, device="cpu")
            slv.setup(pt.gallery.poisson("7pt", n, n, n,
                                         dtype=getattr(torch, dt),
                                         device="cpu"))
            res = slv.solve(torch.ones(n ** 3, dtype=getattr(torch, dt)))
            emit("amgx_tpu_torch", "cpu", name, prec, res, slv,
                 time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
