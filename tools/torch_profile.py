#!/usr/bin/env python3
"""Where the time goes in one solve of the PyTorch/CUDA port.

    python3 tools/torch_profile.py [--config flagship|tail-off|pcg|classical
                                             |agg-pcg|agg-fgmres|batch]
                                   [--batch 8] [--multi-matrix]
                                   [--file NAME]
                                   [--size 128] [--cycle-fusion 1]
                                   [--krylov-fusion 1]
                                   [--matrix-free auto|0|1]
                                   [--precision float|bfloat16]
                                   [--operator poisson|dad]
                                   [--tree DIR] [--label NAME]

Configurations: `flagship` is the untouched FLAGSHIP preset (its inner
V-cycle enters the coarse-tail kernel B5 at the first level of at most
65536 rows), `tail-off` is FLAGSHIP_TAIL_OFF (every level through the
per-level kernels B3/B4), `pcg` is PCG + GEO aggregation + JACOBI_L1 in
float32 (the repo's PCG anchor, bench.py bench_krylov), `classical` is
bench.py's `_classical_cfg` (PCG in float64 around a float32 classical
PMIS + D2 AMG cycle with JACOBI_L1: B3w/B4w on level 0, B8/B9 on the
coarse levels), `agg-pcg` / `agg-fgmres` are AmgX's stock
configs/PCG_AGGREGATION_JACOBI.json / FGMRES_AGGREGATION_JACOBI.json in
float32 (SIZE_2 pairwise aggregation: B4-mf on level 0, B9 sweeps and B8
residuals on the CSR coarse levels). `--file NAME` takes AmgX's stock
configs/NAME.json instead, in float32 (e.g. PBICGSTAB_CLASSICAL_JACOBI,
GMRES_AMG_D2, agg_cheb4), with --krylov-fusion on top. `--matrix-free` sets
`amg:matrix_free`: auto (the
default) runs the GEO levels matrix-free on the card (B3-mf, B4-mf,
B5-mf), 0 pins the slab kernels, so the two routes profile side by
side. `--precision` sets `solve_precision` (the flagship's inner cycle in
float32 or in bfloat16, with the kernels' bf16 forms; on `classical`
and the aggregation files the AMG cycle's). Sets the solver
up on a 7-pt size^3 Poisson system on the CUDA card, runs one warm-up
solve, then profiles one solve with torch.profiler. Prints one JSON
line: the solve's wall time, the device's busy time (sum of kernel and
copy durations, one stream) and idle share, device ops and
device->host copies per inner iteration (FGMRES's for the flagship,
PCG's own), and the device time by kernel name, largest first. Needs a
CUDA card; imports no JAX. The solve and grid tables that a stock file
asks for go to stderr.

`--config batch` profiles one batched solve (amgx_tpu_torch.batch,
BATCHED_CG in float32) of `--batch` right-hand sides from numpy's
default_rng(17) (multi-RHS: K1-K4 and the composed Krylov and transfer
work), or with `--multi-matrix` of the systems A + c I of chip_smoke.py's
BATCH_SHIFTS (the per-system values stacked; the splice is not
profiled); the per-iteration numbers are over the batch's longest
system.

`--operator dad` solves A2 = D A D instead of the Poisson operator
(chip_smoke.py `scaled_values`: variable coefficients, so no level is a
constant stencil and every GEO level runs the slab kernels: the
flagship_dad path). `--tree DIR` profiles the `amgx_tpu_torch` of
another checkout (an unpacked `git archive` of a parent commit) with
this checkout's configurations, so parent and change run in one call,
in turns; `--label` names the tree in the output line.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the benched configuration strings, defined once in chip_smoke.py
from chip_smoke import (BATCH_SEED, BATCH_SHIFTS,  # noqa: E402
                        CLASSICAL, PCG, agg_config, scaled_values)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "tail-off", "pcg", "classical",
                             "agg-pcg", "agg-fgmres", "batch"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--multi-matrix", action="store_true")
    ap.add_argument("--file", default=None,
                    help="a stock configs/ file name (overrides --config)")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--cycle-fusion", type=int, default=1, choices=(0, 1))
    ap.add_argument("--krylov-fusion", type=int, default=1, choices=(0, 1))
    ap.add_argument("--matrix-free", default="auto",
                    choices=("auto", "0", "1"))
    ap.add_argument("--precision", default=None,
                    choices=("float", "bfloat16"),
                    help="solve_precision (unset: the configuration's)")
    ap.add_argument("--operator", default="poisson",
                    choices=("poisson", "dad"))
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_profile: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF
    if hasattr(amgx, "register_print_callback"):
        # a stock file's solve and grid tables go to stderr: stdout holds
        # the JSON line (a parent tree without output.py prints nothing)
        amgx.register_print_callback(lambda msg, _n: sys.stderr.write(msg))

    n = args.size
    dev = torch.device("cuda", 0)
    if args.config == "batch":
        return profile_batch(args, torch, amgx, profile, ProfilerActivity)
    if args.file:
        args.config = args.file
        cfg = amgx.Config.from_file(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "configs", args.file + ".json"))
        cfg.set("krylov_fusion", args.krylov_fusion)
    elif args.config.startswith("agg-"):
        cfg = agg_config(amgx.Config, args.config)
        cfg.set("krylov_fusion", args.krylov_fusion)
    else:
        # CLASSICAL names its cycle's precision (float): --precision
        # replaces it there
        cfg = amgx.Config.from_string({
            "flagship": FLAGSHIP, "tail-off": FLAGSHIP_TAIL_OFF,
            "pcg": PCG + str(args.krylov_fusion),
            "classical": CLASSICAL.replace(
                "amg_precision=float",
                "amg_precision=" + (args.precision or "float"))}[
                    args.config])
    # a stock file names its own AMG scope: set these where every scope
    # falls back
    scope = "default" if args.file else "amg"
    cfg.set("cycle_fusion", args.cycle_fusion, scope=scope)
    cfg.set("matrix_free", args.matrix_free, scope=scope)
    if args.precision:
        cfg.set("solve_precision", args.precision)
    dtype = torch.float32 if args.file or args.config in (
        "pcg", "agg-pcg", "agg-fgmres") else torch.float64
    slv = amgx.create_solver(cfg, device=dev)
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=dtype, device=dev).init()
    if args.operator == "dad":
        A = A.with_values(torch.from_numpy(scaled_values(
            A.row_offsets.cpu(), A.col_indices.cpu(), A.values.cpu())).to(
                device=dev, dtype=dtype))
    slv.setup(A)
    b = torch.ones(n ** 3, dtype=dtype, device=dev)
    slv.solve(b)                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = slv.solve(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    busy_us = 0.0
    launches = dtoh = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.elapsed_us()
        busy_us += dur
        if "Memcpy DtoH" in ev.name:
            dtoh += 1
        elif not ev.name.startswith("Memcpy") and \
                not ev.name.startswith("Memset"):
            launches += 1
        ent = by_name.setdefault(ev.name, [0.0, 0])
        ent[0] += dur
        ent[1] += 1
    inner = int(res.extra_stats["inner_iters"]) if res.extra_stats \
        else res.iterations
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({
        "phase": "profile", "config": args.config, "rows": n ** 3,
        "operator": args.operator, "tree": args.label or args.tree,
        "package": os.path.dirname(amgx.__file__),
        "cycle_fusion": args.cycle_fusion,
        "krylov_fusion": args.krylov_fusion
        if args.file or args.config in ("pcg", "agg-pcg") else None,
        "matrix_free": args.matrix_free, "precision": args.precision,
        "device": torch.cuda.get_device_name(0),
        "outer_iterations": res.iterations, "inner_iterations": inner,
        "wall_s": wall, "device_busy_s": busy_us * 1e-6,
        "idle_share": 1.0 - busy_us * 1e-6 / wall,
        "device_ops": launches, "dtoh_copies": dtoh,
        "device_ops_per_inner_iteration": launches / max(inner, 1),
        "dtoh_per_inner_iteration": dtoh / max(inner, 1),
        "top": [{"name": k[:140], "ms": v[0] * 1e-3, "count": v[1],
                 "share_of_busy": v[0] / max(busy_us, 1e-9)}
                for k, v in top]}), flush=True)
    return 0


def profile_batch(args, torch, amgx, profile, activity):
    """One warm batched solve under torch.profiler (device activity)."""
    import numpy as np
    from amgx_tpu_torch.batch import BatchedSolver, stack_solve_datas
    from amgx_tpu_torch.presets import BATCHED_CG
    n, nb = args.size, args.batch
    dev = torch.device("cuda", 0)
    cfg = amgx.Config.from_string(BATCHED_CG)
    cfg.set("matrix_free", args.matrix_free, scope="amg")
    bs = BatchedSolver(cfg, device=dev)
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                             device=dev).init()
    bs.setup(A)
    B = torch.from_numpy(np.random.default_rng(BATCH_SEED).standard_normal(
        (nb, n ** 3)).astype(np.float32)).to(dev)
    data = bs.solver.solve_data()
    if args.multi_matrix:
        rows = torch.repeat_interleave(torch.arange(n ** 3, device=dev),
                                       torch.diff(A.row_offsets.long()))
        diag = (rows == A.col_indices.long()).to(torch.float32)
        shifts = [BATCH_SHIFTS[i % len(BATCH_SHIFTS)] for i in range(nb)]
        data, _ = stack_solve_datas(bs._per_system_data(
            [A.with_values(A.values + c * diag) for c in shifts]))
    x0 = torch.zeros_like(B)
    bs.solver.run_loop_batched(data, B, x0)             # warm-up
    torch.cuda.synchronize()
    with profile(activities=[activity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = bs.solver.run_loop_batched(data, B, x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, launches, dtoh = 0.0, 0, 0
    by_name = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.elapsed_us()
        busy_us += dur
        if "Memcpy DtoH" in ev.name:
            dtoh += 1
        elif not ev.name.startswith(("Memcpy", "Memset")):
            launches += 1
        ent = by_name.setdefault(ev.name, [0.0, 0])
        ent[0] += dur
        ent[1] += 1
    it = int(st["iters"].max())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({
        "phase": "profile", "config": "batch", "rows": n ** 3,
        "systems": nb, "multi_matrix": args.multi_matrix,
        "matrix_free": args.matrix_free,
        "device": torch.cuda.get_device_name(0),
        "iterations": st["iters"].tolist(), "wall_s": wall,
        "device_busy_s": busy_us * 1e-6,
        "idle_share": 1.0 - busy_us * 1e-6 / wall,
        "device_ops": launches, "dtoh_copies": dtoh,
        "device_ops_per_iteration": launches / max(it, 1),
        "dtoh_per_iteration": dtoh / max(it, 1),
        "top": [{"name": k[:140], "ms": v[0] * 1e-3, "count": v[1],
                 "share_of_busy": v[0] / max(busy_us, 1e-9)}
                for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
