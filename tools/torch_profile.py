#!/usr/bin/env python3
"""Where the time goes in one solve of the PyTorch/CUDA port.

    python3 tools/torch_profile.py [--config flagship|tail-off|pcg|classical]
                                   [--size 128] [--cycle-fusion 1]
                                   [--krylov-fusion 1]

Configurations: `flagship` is the untouched FLAGSHIP preset (its inner
V-cycle enters the coarse-tail kernel B5 at the first level of at most
65536 rows), `tail-off` is FLAGSHIP_TAIL_OFF (every level through the
per-level kernels B3/B4), `pcg` is PCG + GEO aggregation + JACOBI_L1 in
float32 (the repo's PCG anchor, bench.py bench_krylov), `classical` is
bench.py's `_classical_cfg` (PCG in float64 around a float32 classical
PMIS + D2 AMG cycle with JACOBI_L1: B3w/B4w on level 0, B8/B9 on the
coarse levels). Sets the solver
up on a 7-pt size^3 Poisson system on the CUDA card, runs one warm-up
solve, then profiles one solve with torch.profiler. Prints one JSON
line: the solve's wall time, the device's busy time (sum of kernel and
copy durations, one stream) and idle share, device ops and
device->host copies per inner iteration (FGMRES's for the flagship,
PCG's own), and the device time by kernel name, largest first. Needs a
CUDA card; imports no JAX.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the benched configuration strings, defined once in chip_smoke.py
from chip_smoke import CLASSICAL, PCG  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "tail-off", "pcg", "classical"))
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--cycle-fusion", type=int, default=1, choices=(0, 1))
    ap.add_argument("--krylov-fusion", type=int, default=1, choices=(0, 1))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_profile: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF

    n = args.size
    dev = torch.device("cuda", 0)
    base = {"flagship": FLAGSHIP, "tail-off": FLAGSHIP_TAIL_OFF,
            "pcg": PCG + str(args.krylov_fusion),
            "classical": CLASSICAL}[args.config]
    cfg = base + f", amg:cycle_fusion={args.cycle_fusion}"
    dtype = torch.float32 if args.config == "pcg" else torch.float64
    slv = amgx.create_solver(amgx.Config.from_string(cfg), device=dev)
    slv.setup(amgx.gallery.poisson("7pt", n, n, n, dtype=dtype, device=dev))
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
        "cycle_fusion": args.cycle_fusion,
        "krylov_fusion": args.krylov_fusion if args.config == "pcg"
        else None,
        "device": torch.cuda.get_device_name(0),
        "outer_iterations": res.iterations, "inner_iterations": inner,
        "wall_s": wall, "device_busy_s": busy_us * 1e-6,
        "idle_share": 1.0 - busy_us * 1e-6 / wall,
        "device_ops": launches, "dtoh_copies": dtoh,
        "device_ops_per_inner_iteration": launches / max(inner, 1),
        "dtoh_per_inner_iteration": dtoh / max(inner, 1),
        "top": [{"name": k[:90], "ms": v[0] * 1e-3, "count": v[1],
                 "share_of_busy": v[0] / max(busy_us, 1e-9)}
                for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
