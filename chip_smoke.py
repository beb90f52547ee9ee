#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (amgx_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. build    -- compile the CUDA kernels from amgx_tpu_torch/csrc (nvcc).
2. kernels  -- each kernel (B1-B4) against its plain PyTorch version on
               the card at the flagship's finest-level shapes (7-pt
               128^3) and on a ragged 97x61x43 grid: max error, launches
               per call, kernel / plain / library times per call (CUDA
               events around BATCH back-to-back calls, median of REPS,
               after a warm-up) and the bound.
3. small    -- the flagship at 16^3 on the card against the same solve
               on the CPU (plain kernels): the end-to-end reference.
   tail_refused -- the untouched FLAGSHIP, which asks for the unported
               coarse-tail kernel (B5), must be refused on the card.
4. flagship -- FLAGSHIP with the coarse tail off (the fused tail kernel
               B5 is not ported) on 7-pt 128^3, 2,097,152 rows: true f64
               residual <= 1e-8 in <= 3 outer iterations, and B1, B3, B4
               launched on that run.
5. unfused  -- the same configuration at 64^3 with amg:cycle_fusion=0,
               which runs B2: residual <= 1e-8, B2 launched.

Then the card's name and power limit (nvidia-smi), the {"kernels": [...]}
summary, and as the last line {"ok": true, "device": {...}}. Any failed
check raises: the script exits non-zero without that line. It exits
non-zero at once when PyTorch sees no CUDA device.
"""
import json
import subprocess
import sys
import time

REPS = 25
BATCH = 10
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3, data sheet
PEAK_F32_S = 67e12          # H100 SXM float32 outside the tensor cores
# kernel vs plain PyTorch, max |diff| / max |plain| per output, float32.
# B1 is one rounded sum per row. B2-B4 run the flagship's five dependent
# damping steps (the last tau is 1.38 > 1, amplifying earlier rounding)
# and B2/B3 a residual that carries x's error through A (|A|_inf = 12);
# the kernel's fused multiply-adds round differently from PyTorch's
# separate multiply and add. The CPU tests measure ~4e-6 for the same
# chain between two float32 implementations.
LIMITS = {"dia_spmv": 1e-6, "dia_smooth": 5e-5, "dia_smooth_restrict": 5e-5,
          "dia_prolong_smooth": 5e-5}
REPLACES = {
    "dia_spmv": "amgx_tpu/ops/pallas_spmv.py:165",
    "dia_smooth": "amgx_tpu/ops/pallas_spmv.py:649",
    "dia_smooth_restrict": "amgx_tpu/ops/pallas_spmv.py:1245",
    "dia_prolong_smooth": "amgx_tpu/ops/pallas_spmv.py:1585",
}
SOURCE = "amgx_tpu_torch/csrc/dia.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def time_ms(torch, fn, reps=REPS, batch=BATCH):
    """Milliseconds per call: the median over `reps` CUDA-event timings,
    each around `batch` back-to-back calls (so the card's queue stays
    full and the host's launch cost is hidden where the card is the
    slower side), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for e0, e1 in ev:
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
    torch.cuda.synchronize()
    ts = sorted(e0.elapsed_time(e1) / batch for e0, e1 in ev)
    return ts[len(ts) // 2]


def bound(nbytes, flops):
    """(ms, what bounds it): the least time the card could take."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def grid_case(torch, amgx, shape, dev):
    """The flagship finest-level operands on an nx x ny x nz grid: the
    7-pt operator in float32, its GEO transfer tables, the taus of the
    smoother FLAGSHIP builds for it (its scoping gives CHEBYSHEV_POLY the
    default order 5: `amg:chebyshev_polynomial_order=2` is not in the
    smoother's scope), and seeded random vectors."""
    from amgx_tpu_torch.ops.smooth import build_transfer_tables
    from amgx_tpu_torch.presets import FLAGSHIP_TAIL_OFF
    from amgx_tpu_torch.solvers.base import make_solver
    A = amgx.gallery.poisson("7pt", *shape, dtype=torch.float32,
                             device=dev).init()
    n = A.num_rows
    cfg = amgx.Config.from_string(FLAGSHIP_TAIL_OFF)
    _, scope = cfg.get_solver("preconditioner")            # FGMRES
    _, scope = cfg.get_solver("preconditioner", scope)     # AMG
    sel = amgx.amg.aggregation.selectors.GeoSelector(cfg, scope)
    agg, nc = sel.set_aggregates(A)
    xfer = build_transfer_tables(agg, nc)
    name, sm_scope = cfg.get_solver("smoother", scope)
    smoother = make_solver(name, cfg, sm_scope, device=dev)
    taus = smoother.setup(A).solve_data()["taus"]
    g = torch.Generator(device=dev).manual_seed(1234)
    b, x = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    xc = torch.randn(nc, generator=g, device=dev)
    return A, xfer, taus, b, x, xc


def kernel_cases(torch, K, A, xfer, taus, b, x, xc):
    """name -> (kernel call, plain call, bytes, flops, launches per call,
    library call or None) at one shape."""
    vals, offs = A.dia_vals, A.dia_offsets
    n, k = A.num_rows, len(offs)
    m, nc = xfer["ctab"].shape
    s = taus.shape[0]
    app = (2 * k + 3) * n                  # flops of one damped step
    csr = torch.sparse_csr_tensor(A.row_offsets, A.col_indices, A.values,
                                  (n, n), check_invariants=True)
    return {
        "dia_spmv": (
            lambda: K.dia_spmv(vals, offs, x),
            lambda: K.dia_spmv_plain(vals, offs, x),
            (k + 2) * n * 4, 2 * k * n, 1, lambda: csr @ x),
        "dia_smooth": (
            lambda: K.dia_smooth(vals, offs, taus, b, x),
            lambda: K.dia_smooth_plain(vals, offs, taus, b, x),
            (k * n + 4 * n + s) * 4, s * app + 2 * k * n, s + 1, None),
        "dia_smooth_restrict": (
            lambda: K.dia_smooth_restrict(vals, offs, taus, b, x,
                                          xfer["ctab"]),
            lambda: K.dia_smooth_restrict_plain(vals, offs, taus, b, x,
                                                xfer["ctab"]),
            (k * n + 3 * n + s + m * nc + nc) * 4,
            s * app + (2 * k + 2) * n, s + 1, None),
        "dia_prolong_smooth": (
            lambda: K.dia_prolong_smooth(vals, offs, taus, b, x, xc,
                                         xfer["agg"]),
            lambda: K.dia_prolong_smooth_plain(vals, offs, taus, b, x, xc,
                                               xfer["agg"]),
            (k * n + 4 * n + s + nc) * 4, s * app + n, s, None),
    }


def max_err(torch, got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.abs().max()) for b in want)
    return abs_err, abs_err / max(scale, 1e-30)


def phase_kernels(torch, amgx, dev):
    from amgx_tpu_torch.ops import cuda_spmv as K
    summary = {}
    for label, shape in (("flagship_l0_128^3", (128, 128, 128)),
                         ("ragged_97x61x43", (97, 61, 43))):
        A, xfer, taus, b, x, xc = grid_case(torch, amgx, shape, dev)
        for name, (kern, plain, nbytes, flops, per_call, lib) in \
                kernel_cases(torch, K, A, xfer, taus, b, x, xc).items():
            before = K.LAUNCHES[name]
            got = kern()
            launched = K.LAUNCHES[name] - before
            want = plain()
            torch.cuda.synchronize()
            abs_err, rel_err = max_err(torch, got, want)
            check(launched == per_call,
                  f"{name} launched {launched} kernels, expected {per_call}")
            check(rel_err <= LIMITS[name],
                  f"{name} at {label}: error {rel_err} > {LIMITS[name]}")
            ms = time_ms(torch, kern)
            plain_ms = time_ms(torch, plain)
            lib_ms = time_ms(torch, lib) if lib is not None else None
            b_ms, b_by = bound(nbytes, flops)
            row = {"phase": "kernels", "shape": label, "name": name,
                   "rows": A.num_rows, "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "limit": LIMITS[name],
                   "launches_per_call": per_call, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_us": b_ms * 1e3, "bound_by": b_by,
                   "library_ms": lib_ms}
            emit(row)
            prev = summary.get(name)
            if prev is None:
                summary[name] = row       # the flagship shape's numbers
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"], abs_err)
                prev["max_rel_err"] = max(prev["max_rel_err"], rel_err)
    return summary


def solve(torch, amgx, cfg, n, dev):
    """Set up and solve the 7-pt n^3 system with b = 1; returns (result,
    solver, setup s, solve s, true f64 relative residual)."""
    from amgx_tpu_torch.ops.spmv import residual
    A = amgx.gallery.poisson("7pt", n, n, n, device=dev)
    slv = amgx.create_solver(amgx.Config.from_string(cfg), device=dev)
    t0 = time.perf_counter()
    slv.setup(A)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    res = slv.solve(b)
    solve_s = time.perf_counter() - t0
    true_rel = float(torch.linalg.norm(residual(slv.A, res.x, b))
                     / torch.linalg.norm(b))
    check(tuple(res.x.shape) == (n ** 3,) and bool(
        torch.isfinite(res.x).all()), "solution finite, right shape")
    return res, slv, setup_s, solve_s, true_rel


def levels_of(slv):
    return slv.preconditioner.preconditioner.amg.level_rows()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.ops import cuda_build
    from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF
    # float32 stays float32: no TF32 in matrix products (FGMRES's CGS2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(card, flush=True)
    emit({"phase": "env", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    rep = cuda_build.build_all()
    regs = [ln.split("Used ")[1].split(",")[0]
            for log in rep["ptxas"].values() for ln in log.splitlines()
            if "Used " in ln]
    emit({"phase": "build", "seconds": rep["seconds"],
          "built": rep["built"], "ptxas_registers": regs})

    summary = phase_kernels(torch, amgx, dev)

    # end-to-end reference on a small input: the card against the CPU
    rc, _, _, _, tc = solve(torch, amgx, FLAGSHIP_TAIL_OFF, 16, dev)
    rh, _, _, _, th = solve(torch, amgx, FLAGSHIP_TAIL_OFF, 16,
                            torch.device("cpu"))
    xdiff = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                  / torch.linalg.norm(rh.x))
    emit({"phase": "small", "rows": 16 ** 3, "outer_cuda": rc.iterations,
          "outer_cpu": rh.iterations, "true_rel_res_cuda": tc,
          "true_rel_res_cpu": th, "x_rel_diff": xdiff})
    check(rc.iterations == rh.iterations and xdiff <= 1e-5,
          "16^3 card solve agrees with the CPU solve")

    # the untouched FLAGSHIP asks for the fused coarse tail (B5, not
    # ported): a CUDA setup must refuse it rather than compose silently
    tail = amgx.create_solver(amgx.Config.from_string(FLAGSHIP), device=dev)
    try:
        tail.setup(amgx.gallery.poisson("7pt", 16, 16, 16, device=dev))
        refused = False
    except NotImplementedError as e:
        refused = "B5" in str(e)
    emit({"phase": "tail_refused", "ok": refused})
    check(refused, "FLAGSHIP (coarse tail on) refused on the card")

    per_path = {}
    amgx.reset_kernel_launches()
    res, slv, setup_s, solve_s, true_rel = solve(
        torch, amgx, FLAGSHIP_TAIL_OFF + ", store_res_history=1", 128, dev)
    per_path["flagship"] = amgx.kernel_launches()
    t0 = time.perf_counter()
    slv.solve(torch.ones(128 ** 3, dtype=torch.float64, device=dev))
    warm_s = time.perf_counter() - t0
    emit({"phase": "flagship", "rows": 128 ** 3, "setup_s": setup_s,
          "solve_s": solve_s, "solve_warm_s": warm_s,
          "levels": levels_of(slv), "outer_iterations": res.iterations,
          "inner_iterations": int(res.extra_stats["inner_iters"]),
          "status": res.status, "true_rel_res": true_rel,
          "res_history": [float(h) for h in res.res_history],
          "launches": per_path["flagship"]})
    check(res.status == "success" and true_rel <= 1e-8,
          f"128^3 flagship true relative residual {true_rel} <= 1e-8")
    check(res.iterations <= 3, f"{res.iterations} outer iterations <= 3")
    for name in ("dia_spmv", "dia_smooth_restrict", "dia_prolong_smooth"):
        check(per_path["flagship"][name] > 0, f"{name} ran in the flagship")

    fused, _, _, fused_s, _ = solve(torch, amgx, FLAGSHIP_TAIL_OFF, 64, dev)
    amgx.reset_kernel_launches()
    unf, _, setup_u, solve_u, rel_u = solve(
        torch, amgx, FLAGSHIP_TAIL_OFF + ", amg:cycle_fusion=0", 64, dev)
    per_path["unfused"] = amgx.kernel_launches()
    emit({"phase": "unfused", "rows": 64 ** 3, "setup_s": setup_u,
          "solve_s": solve_u, "outer_iterations": unf.iterations,
          "inner_iterations": int(unf.extra_stats["inner_iters"]),
          "true_rel_res": rel_u, "launches": per_path["unfused"],
          "fused_outer_iterations": fused.iterations,
          "fused_inner_iterations": int(fused.extra_stats["inner_iters"]),
          "fused_solve_s": fused_s})
    check(unf.status == "success" and rel_u <= 1e-8,
          f"64^3 unfused true relative residual {rel_u} <= 1e-8")
    check(per_path["unfused"]["dia_smooth"] > 0, "dia_smooth ran unfused")

    kernels = []
    for name, row in summary.items():
        launches = {p: c[name] for p, c in per_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": row["max_abs_err"],
            "max_rel_err": row["max_rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
