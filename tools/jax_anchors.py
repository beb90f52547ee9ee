#!/usr/bin/env python3
"""Anchors of the JAX package (the reference) for AmgX's stock config
files: each file read verbatim, set up and solved on the 7-pt n^3
Poisson with b = 1 in float32 (or --dtype float64) on the CPU. One JSON
line per file: the iterations, the status, the final monitored residual
relative to the initial one, the true relative residual of x in
float64, the level rows of an AMG preconditioner, and the process's
peak resident memory. The package's solve and grid tables (the files
set print_solve_stats / print_grid_stats, some in nested scopes) go to
stderr, so stdout holds only the JSON lines.

    python3 tools/jax_anchors.py --size 64 PBICGSTAB_AGGREGATION_W_JACOBI

A name `preset:NAME` runs the package's `presets.NAME` string instead of
a file (`preset:SERVING_CG`).

`chip_smoke.py` holds the PyTorch port's runs on the card to these
numbers. `--port` runs the same files through the port on the CPU
instead (`device="cpu"`), with the same line: the spread between the
two packages where a float32 run ends at max_iters. `--device-route`
runs the JAX package's setup through its device (jnp) formulation, the
route a TPU takes, instead of its host numpy route: the port follows
the device route (the host route's D2 truncation sums in float64). The JAX package's
128^3 classical setup needs more than 26 GB of host memory; 64^3 about
5 GB.
"""
import argparse
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--krylov-fusion", type=int, default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--port", action="store_true",
                    help="run amgx_tpu_torch on the CPU instead")
    ap.add_argument("--device-route", action="store_true",
                    help="the JAX package's device (jnp) setup route on "
                    "the CPU instead of its host numpy route")
    ap.add_argument("files", nargs="+", help="names under configs/, or "
                    "preset:NAME")
    args = ap.parse_args()
    import numpy as np
    import scipy.sparse as sp
    n = args.size
    dt = np.dtype(args.dtype)
    if args.port:
        import torch
        import amgx_tpu_torch as pkg
        from amgx_tpu_torch import output
        A = pkg.gallery.poisson("7pt", n, n, n, device="cpu",
                               dtype=getattr(torch, args.dtype)).init()
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import amgx_tpu as pkg
        from amgx_tpu import output
        if args.device_route:
            from amgx_tpu.ops import spgemm
            spgemm._on_host = lambda A: False
        A = pkg.gallery.poisson("7pt", n, n, n, dtype=dt).init()
    output.register_print_callback(
        lambda msg, _n: sys.stderr.write(msg))
    A64 = sp.csr_matrix((np.asarray(A.values, np.float64),
                         np.asarray(A.col_indices),
                         np.asarray(A.row_offsets)))
    b = np.ones(n ** 3, dt)
    for name in args.files:
        if name.startswith("preset:"):
            import importlib
            presets = importlib.import_module(pkg.__name__ + ".presets")
            cfg = pkg.Config.from_string(getattr(presets, name[7:]))
        else:
            cfg = pkg.Config.from_file(os.path.join(ROOT, "configs",
                                                   name + ".json"))
        cfg.set("store_res_history", 1)
        if args.krylov_fusion is not None:
            cfg.set("krylov_fusion", args.krylov_fusion)
        slv = pkg.create_solver(cfg, device="cpu") if args.port \
            else pkg.create_solver(cfg)
        t0 = time.perf_counter()
        slv.setup(A)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = slv.solve(torch.from_numpy(b) if args.port else b)
        solve_s = time.perf_counter() - t0
        x = np.asarray(res.x, np.float64)
        hist = np.asarray(res.res_history, np.float64).ravel()
        s, levels = slv, None
        while s is not None and levels is None:
            amg = getattr(s, "amg", None)
            if amg is not None:
                levels = [lv.A.num_rows for lv in amg.levels] + [
                    amg.coarsest_A.num_rows]
            s = getattr(s, "preconditioner", None)
        print(json.dumps({
            "file": name, "package": "amgx_tpu_torch" if args.port
            else "amgx_tpu", "device_route": args.device_route,
            "rows": n ** 3, "dtype": args.dtype,
            "krylov_fusion": args.krylov_fusion,
            "iterations": int(res.iterations), "status": str(res.status),
            "final_rel_res": float(hist[-1] / hist[0]),
            "true_rel_res": float(np.linalg.norm(1.0 - A64 @ x)
                                  / np.sqrt(n ** 3)),
            "levels": levels, "setup_s": setup_s, "solve_s": solve_s,
            "peak_rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}), flush=True)


if __name__ == "__main__":
    main()
