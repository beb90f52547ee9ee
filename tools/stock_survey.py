#!/usr/bin/env python3
"""How far the PyTorch port reaches: every AmgX stock file of configs/
(the top-level *.json), read verbatim, set up and solved on the 7-pt n^3
Poisson with b = 1 in float64 on the CPU, through the port and, where
the port runs the file, through the JAX package too. One JSON line per
file: the port's status and iterations or the first part it lacks (the
exception it raised), the JAX package's status and iterations, and x's
relative difference; then a summary line (files the port runs, files
where both agree on status and iterations with x within 1e-12).

    python3 tools/stock_survey.py [--size 10] [FILE ...]
"""
import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _cfg(mod, path):
    return mod.Config.from_file(path)


def _quiet(output):
    """Send a package's solve and grid tables away: the files set
    print_solve_stats / print_grid_stats in nested scopes too, and
    stdout carries only the JSON lines."""
    output.register_print_callback(lambda msg, n: None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=10)
    ap.add_argument("files", nargs="*", help="names under configs/ "
                    "(default: all)")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    import amgx_tpu as jx
    import amgx_tpu_torch as pt
    from amgx_tpu import output as jx_output
    from amgx_tpu_torch import output as pt_output
    _quiet(jx_output)
    _quiet(pt_output)
    n = args.size
    names = args.files or sorted(
        os.path.basename(p)[:-5]
        for p in glob.glob(os.path.join(ROOT, "configs", "*.json")))
    b = np.ones(n ** 3)
    runs = agree = 0
    for name in names:
        path = os.path.join(ROOT, "configs", name + ".json")
        out = {"file": name, "rows": n ** 3}
        t0 = time.perf_counter()
        try:
            ps = pt.create_solver(_cfg(pt, path), device="cpu")
            ps.setup(pt.gallery.poisson("7pt", n, n, n, device="cpu"))
            rp = ps.solve(torch.from_numpy(b))
        except Exception as e:           # the first part the port lacks
            out["port_gap"] = f"{type(e).__name__}: {e}"[:300]
            print(json.dumps(out), flush=True)
            continue
        runs += 1
        js = jx.create_solver(_cfg(jx, path))
        js.setup(jx.gallery.poisson("7pt", n, n, n).init())
        rj = js.solve(b)
        xj = np.asarray(rj.x, np.float64)
        xrel = float(np.linalg.norm(rp.x.numpy() - xj)
                     / max(np.linalg.norm(xj), 1e-300))
        same = (rp.status == str(rj.status)
                and rp.iterations == int(rj.iterations) and xrel <= 1e-12)
        agree += same
        out.update(port_status=rp.status, port_iterations=rp.iterations,
                   jax_status=str(rj.status),
                   jax_iterations=int(rj.iterations), x_rel_diff=xrel,
                   agree=same, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    print(json.dumps({"files": len(names), "port_runs": runs,
                      "agree": agree}), flush=True)


if __name__ == "__main__":
    main()
