#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (amgx_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. build    -- compile the CUDA kernels from amgx_tpu_torch/csrc (nvcc,
               one process per source, all at once).
2. kernels  -- each kernel against its plain PyTorch version on the card:
               B1-B4 at the flagship's finest-level shapes (7-pt 128^3)
               and on a ragged 97x61x43 grid; B4's x'.b epilogue, B6 and
               B7 at the PCG path's 128^3 shapes; B5 on 32^3 hierarchies,
               whose whole cycle is the flagship 128^3's coarse tail
               (32768 -> 4096 -> 512 -> 64 rows): CHEBYSHEV_POLY order 5
               V, JACOBI_L1 V, each with and without the dot, and W and F.
               Max error with its limit, launches per call, kernel /
               plain / library times per call (CUDA events around BATCH
               back-to-back calls, median of REPS, after a warm-up), the
               bound, and for B5 the dependent-phase count. Then the
               classical kernels on the 128^3 CLASSICAL hierarchy's float32
               solve data: B8 on level 1's operator, P and R, B9 on that
               operator with JACOBI_L1's dinv, B3w/B4w (and B4w's dot) on
               level 0 with its weighted tables, with and without dinv;
               and B10 on level 0's plan of the 64^3 CLASSICAL_REFINEMENT
               hierarchy. B8 and B10 are timed against cuSPARSE.
3. small    -- end-to-end references on small inputs, the card against
               the CPU (plain kernels): the flagship at 16^3 with the
               tail off and untouched, and PCG at 32^3, where the whole
               cycle is the tail and B5 carries PCG's r.z.
4. flagship -- the untouched FLAGSHIP on 7-pt 128^3, 2,097,152 rows: true
               f64 residual <= 1e-8 in <= 3 outer iterations, one B5
               launch per V-cycle, B3/B4 only on the levels above the
               tail; then the same with the tail off.
5. unfused  -- the tail-off flagship at 64^3 with amg:cycle_fusion=0,
               which runs B2.
6. krylov   -- PCG + GEO aggregation + JACOBI_L1 at 128^3 in float32,
               krylov_fusion 1 (B6, B7, B4's dot) and 0 (B1): 54 +- 2
               iterations, the two within one of each other, and the
               host syncs per iteration.
7. classical -- bench.py's `_classical_cfg` (PCG f64 around an f32
               PMIS + D2 cycle) at 128^3 and 64^3: true f64 residual
               <= 1e-8 within 2 of the 20 / 17 iteration anchors, the level
               rows, whether level 0 took the weighted tables (m, mp), B8/B9
               on the coarse levels, B3w/B4w once per cycle, no B5, no B10;
               setup, first and warm solve times, setup's peak memory.
8. determinism -- the same at 32^3: two card setups bit-identical, CF
               splits and P patterns equal to the CPU's, the card's and
               the CPU's solves agree; then the same PCG + classical AMG
               on the float32 operator (no amg_precision), where B4w's
               x'.b epilogue carries PCG's r.z.
9. classical_refinement -- FLAGSHIP's REFINEMENT + FGMRES around the
               classical AMG block at 64^3, built in float32 on the card:
               <= 3 outer iterations to 1e-8, one B10 call (two launches)
               per Galerkin product of its setup.

Each path's launch counts are zeroed just before its run and read just
after; every kernel must have launched on some path. Then the card's
name and power limit (nvidia-smi), the {"kernels": [...]} summary, and
as the last line {"ok": true, "device": {...}}. Any failed check
raises: the script exits non-zero without that line. It exits non-zero
at once when PyTorch sees no CUDA device.
"""
import json
import subprocess
import sys
import time
import warnings

REPS = 25
BATCH = 10
PAIRS = 10                  # alternating warm solves per compared pair
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3, data sheet
PEAK_F32_S = 67e12          # H100 SXM float32 outside the tensor cores
# kernel vs plain PyTorch, max over outputs of max |diff| / max |plain|,
# float32. B1 is one rounded sum per row. B2-B5 run the flagship's five
# dependent damping steps (the last tau is 1.38 > 1, amplifying earlier
# rounding), B5 on three levels joined by the coarse correction, and
# B2/B3 a residual that carries x's error through A (|A|_inf = 12); the
# kernels' fused multiply-adds round differently from PyTorch's separate
# multiply and add. The CPU tests measure ~4e-6 for the same chains
# between two float32 implementations. B6/B7 and the dot epilogues add
# 2M products in another tree than PyTorch's reduction.
# B8 is one rounded sum per row, in another order than the plain
# version's index_add_; B9 one sweep on top of it; B3w/B4w one JACOBI_L1
# step plus the weighted transfer (R's rows of up to 32 residuals); B10
# rounds every product and sum as its plain version does, in the same
# order, so it should agree to the bit.
LIMITS = {"dia_spmv": 1e-6, "dia_smooth": 5e-5, "dia_smooth_restrict": 5e-5,
          "dia_prolong_smooth": 5e-5, "dia_prolong_smooth_dot": 5e-5,
          "dia_coarse_tail": 5e-5, "dia_coarse_tail_dot": 5e-5,
          "dia_spmv_dot": 1e-5, "cg_update": 1e-5,
          "dia_smooth_restrict_w": 5e-5, "dia_prolong_smooth_w": 5e-5,
          "dia_prolong_smooth_w_dot": 5e-5, "csr_spmv": 1e-6,
          "csr_smooth": 1e-5, "rap_values": 1e-6}
_PS = "amgx_tpu/ops/pallas_spmv.py:"
REPLACES = {
    "dia_spmv": _PS + "165", "dia_smooth": _PS + "649",
    "dia_smooth_restrict": _PS + "1245", "dia_prolong_smooth": _PS + "1585",
    "dia_prolong_smooth_dot": _PS + "1585",
    "dia_coarse_tail": _PS + "1892", "dia_coarse_tail_dot": _PS + "1892",
    "dia_spmv_dot": _PS + "2116", "cg_update": _PS + "2261",
    "dia_smooth_restrict_w": _PS + "1245",
    "dia_prolong_smooth_w": _PS + "1585",
    "dia_prolong_smooth_w_dot": _PS + "1585",
    "csr_spmv": "amgx_tpu/ops/pallas_swell.py:254",
    "csr_smooth": "amgx_tpu/ops/pallas_swell.py:412",
    "rap_values": "amgx_tpu/ops/pallas_spgemm.py:261",
}
_CSRC = "amgx_tpu_torch/csrc/"
SOURCES = {
    "dia_spmv": "dia.cu", "dia_smooth": "dia.cu",
    "dia_smooth_restrict": "dia.cu", "dia_prolong_smooth": "dia.cu",
    "dia_prolong_smooth_dot": "dia.cu", "dia_coarse_tail": "tail.cu",
    "dia_coarse_tail_dot": "tail.cu", "dia_spmv_dot": "krylov.cu",
    "cg_update": "krylov.cu", "dia_smooth_restrict_w": "dia.cu",
    "dia_prolong_smooth_w": "dia.cu", "dia_prolong_smooth_w_dot": "dia.cu",
    "csr_spmv": "csr.cu", "csr_smooth": "csr.cu", "rap_values": "rap.cu",
}
# the repo's PCG anchor (bench.py bench_krylov): PCG + GEO aggregation +
# JACOBI_L1, 54 iterations at 128^3 in float32 with either knob
PCG = ("solver=PCG, max_iters=80, monitor_residual=1, tolerance=1e-8,"
       " convergence=RELATIVE_INI, norm=L2, preconditioner(amg)=AMG,"
       " amg:algorithm=AGGREGATION, amg:selector=GEO,"
       " amg:smoother=JACOBI_L1, amg:relaxation_factor=0.75,"
       " amg:presweeps=1, amg:postsweeps=2, amg:max_iters=1, amg:cycle=V,"
       " amg:max_levels=10, amg:min_coarse_rows=32, krylov_fusion=")
PCG_ANCHOR = 54
# bench.py `_classical_cfg("JACOBI_L1")`, verbatim: PCG in float64 around
# a float32 classical PMIS + D2 cycle; its iteration anchors
# (BENCH_r04.json) by grid edge
CLASSICAL = (
    "config_version=2, solver(s)=PCG, s:max_iters=100,"
    " s:tolerance=1e-8, s:convergence=RELATIVE_INI,"
    " s:monitor_residual=1, s:preconditioner(amg)=AMG,"
    " amg:algorithm=CLASSICAL, amg:selector=PMIS,"
    " amg:interpolator=D2, amg:smoother=JACOBI_L1,"
    " amg:presweeps=1,"
    " amg:postsweeps=1, amg:max_iters=1,"
    " amg:coarse_solver=DENSE_LU_SOLVER, amg:min_coarse_rows=32,"
    " amg:max_levels=20, amg:strength_threshold=0.25,"
    " amg:interp_max_elements=4, amg:max_row_sum=0.9,"
    " amg:amg_precision=float")
CLASSICAL_ANCHORS = {128: 20, 64: 17}
# the same PCG + classical AMG block on a float32 operator without
# amg_precision: the hierarchy and the Krylov shell are float32, so the
# cycle carries PCG's r.z through B4w's x'.b epilogue on level 0
CLASSICAL_F32 = CLASSICAL.replace(", amg:amg_precision=float", "")


def classical_refinement():
    """FLAGSHIP's REFINEMENT + FGMRES with CLASSICAL's AMG block (without
    amg_precision: REFINEMENT hands the inner chain the float32 operator)
    and amg:setup_backend=device: every Galerkin product of its setup is
    float32 and goes through B10."""
    from amgx_tpu_torch.presets import FLAGSHIP
    block = CLASSICAL[CLASSICAL.index("amg:algorithm"):]
    return (FLAGSHIP[:FLAGSHIP.index("amg:algorithm")]
            + block.replace(", amg:amg_precision=float", "")
            + ", amg:setup_backend=device")


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


def amg_of(amgx, cfg_string, A, dev):
    """The AMG preconditioner of a configuration (its own scope), set up
    on A: the hierarchy the solve would build."""
    from amgx_tpu_torch.solvers.base import make_solver
    cfg = amgx.Config.from_string(cfg_string)
    name, scope = cfg.get_solver("solver")
    while name.upper() != "AMG":
        name, scope = cfg.get_solver("preconditioner", scope)
    return make_solver("AMG", cfg, scope, dev).setup(A)


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


def shell_cases(torch, amgx, K, KK, dev):
    """B4's x'.b epilogue, B6 and B7 at the PCG path's finest level
    (7-pt 128^3 float32): JACOBI_L1's dinv and two post-sweeps at 0.75,
    seeded random vectors and scalars."""
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    A, xfer, _, b, x, xc = grid_case(torch, amgx, (128, 128, 128), dev)
    vals, offs = A.dia_vals, A.dia_offsets
    n, k = A.num_rows, len(offs)
    nc = xc.shape[0]
    dinv = safe_recip(l1_strengthened_diag(A))
    taus = torch.full((2,), 0.75, device=dev)
    g = torch.Generator(device=dev).manual_seed(99)
    p, z, r, ap = (torch.randn(n, generator=g, device=dev)
                   for _ in range(4))
    beta = torch.tensor(0.37, device=dev)
    alpha = torch.tensor(0.21, device=dev)
    s = taus.shape[0]
    return A, {
        "dia_prolong_smooth_dot": (
            lambda: K.dia_prolong_smooth(vals, offs, taus, b, x, xc,
                                         xfer["agg"], dinv, with_dot=True),
            lambda: K.dia_prolong_smooth_plain(vals, offs, taus, b, x, xc,
                                               xfer["agg"], dinv,
                                               with_dot=True),
            (k * n + 5 * n + s + nc + 1) * 4, s * (2 * k + 4) * n + 3 * n,
            s, None),
        "dia_spmv_dot": (
            lambda: KK.dia_spmv_dot(vals, offs, p, z, beta),
            lambda: KK.dia_spmv_dot_plain(vals, offs, p, z, beta),
            ((k + 4) * n + 2) * 4, (2 * k + 4) * n, 1, None),
        "cg_update": (
            lambda: KK.cg_update(x, p, r, ap, alpha),
            lambda: KK.cg_update_plain(x, p, r, ap, alpha),
            (6 * n + 2) * 4, 6 * n, 1, None),
    }


def tail_work(T, spec, arrs, with_dot):
    """(bytes, flops, phases) of one B5 call: every array read once, b
    and x read and x' written once; the operations the phase program
    runs on these levels (a W or F cycle visits levels more often)."""
    nbytes = sum(t.numel() * t.element_size() for ar in arrs
                 for t in ar.values() if t is not None)
    n0 = spec.levels[0].n
    nbytes += 3 * n0 * 4 + (4 if with_dot else 0)
    prog = T.tail_program(spec, with_dot)
    flops = 0
    for op, l, _, _, _, _, flags in prog:
        if op == T.OP_COARSE:
            flops += 2 * spec.coarse[1] ** 2
            continue
        if op == T.OP_DOT:
            continue
        ls = spec.levels[l]
        k, n = len(ls.offsets), ls.n
        flops += {T.OP_STEP: (2 * k + 3 + ls.has_dinv) * n,
                  T.OP_RESTRICT: (2 * k + 2) * n, T.OP_CORRECT: n}[op]
        flops += n if flags & T.F_CORRECTED and op == T.OP_STEP else 0
        flops += 2 * n if flags & T.F_DOT else 0
    return nbytes, flops, len(prog)


def tail_cases(torch, amgx, T, dev):
    """B5 on the 32^3 hierarchies (the flagship 128^3's tail levels):
    label -> (spec, arrs, with_dot, b, x)."""
    from amgx_tpu_torch.ops.smooth import _tail_plan
    from amgx_tpu_torch.presets import FLAGSHIP
    A = amgx.gallery.poisson("7pt", 32, 32, 32, dtype=torch.float32,
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    b, x = (torch.randn(32 ** 3, generator=g, device=dev)
            for _ in range(2))
    amgs = {"cheb5": amg_of(amgx, FLAGSHIP, A, dev).amg,
            "jacobi_l1": amg_of(amgx, PCG + "1", A, dev).amg}
    cases = {}
    # each name's first case is its main-path shape: the flagship's tail
    # (CHEBYSHEV_POLY), PCG's whole-cycle tail with the dot (JACOBI_L1)
    for smoother, shape, with_dot in (
            ("cheb5", "V", False), ("jacobi_l1", "V", True),
            ("cheb5", "V", True), ("jacobi_l1", "V", False),
            ("cheb5", "W", False), ("cheb5", "F", False)):
        amg = amgs[smoother]
        spec, arrs = _tail_plan(amg, shape, amg.solve_data(), 0, x)
        check([ls.n for ls in spec.levels] == [32768, 4096, 512]
              and spec.coarse == ("inv", 64),
              f"32^3 tail levels {[ls.n for ls in spec.levels]}")
        label = f"{smoother} {shape}" + (" dot" if with_dot else "")
        cases[label] = (spec, arrs, with_dot, b, x)
    return cases


def csr_library(torch, M):
    """M as a PyTorch sparse CSR tensor (cuSPARSE's operand)."""
    return torch.sparse_csr_tensor(M.row_offsets, M.col_indices, M.values,
                                   (M.num_rows, M.num_cols),
                                   check_invariants=True)


def classical_cases(torch, amgx, K, C, dev):
    """B8, B9 and B3w/B4w at the shapes the 128^3 CLASSICAL path gives
    them, on its own hierarchy's float32 solve data: B8 on the largest
    unstructured operator (level 1) and the P and R that serve it, B9 on
    that operator with JACOBI_L1's dinv, B3w/B4w on level 0 (the 7-pt
    DIA operator, 2,097,152 rows) with its weighted tables, with and
    without dinv. label -> {name: case} as kernel_cases gives them, and
    the level rows."""
    A = amgx.gallery.poisson("7pt", 128, 128, 128, device=dev)
    amg = amg_of(amgx, CLASSICAL, A, dev).amg
    data = amg.solve_data()
    l0, l1 = data["levels"][0], data["levels"][1]
    check("xfer" in l0 and "xfer" not in l1
          and l1["A"].dia_vals is None,
          "128^3 classical: level 0 fuses, level 1 is unstructured")
    g = torch.Generator(device=dev).manual_seed(4321)
    cases = {}
    M1 = l1["A"]
    n1 = M1.num_rows
    x1, b1 = (torch.randn(n1, generator=g, device=dev) for _ in range(2))
    dinv1 = l1["smoother"]["dinv"]
    tau1 = amg.levels[1].smoother._fused_taus(1, x1)
    for label, M in (("A1", M1), ("P1", l1["P"]), ("R1", l1["R"])):
        x = torch.randn(M.num_cols, generator=g, device=dev)
        lib = csr_library(torch, M)
        cases[f"classical_128^3 {label} {M.num_rows}x{M.num_cols}"] = {
            "csr_spmv": (
                lambda M=M, x=x: C.csr_spmv(M.row_offsets, M.col_indices,
                                            M.values, x,
                                            lanes=M.csr_lanes),
                lambda M=M, x=x: C.csr_spmv_plain(M.row_offsets,
                                                  M.col_indices, M.values,
                                                  x),
                M.nnz * 8 + (M.num_rows + 1) * 4 + M.num_cols * 4
                + M.num_rows * 4, 2 * M.nnz, 1,
                lambda lib=lib, x=x: lib @ x)}
    # B8's lanes per row: the one CsrMatrix.init() chose (CSR_LANE_NNZ)
    # against every other choice, on the operators of levels 1 and 2
    for label, M in (("A1", M1), ("R1", l1["R"]),
                     ("A2", data["levels"][2]["A"])):
        x = torch.randn(M.num_cols, generator=g, device=dev)
        emit({"phase": "csr_lanes", "matrix": label, "rows": M.num_rows,
              "mean_row_nnz": M.nnz / M.num_rows, "chosen": M.csr_lanes,
              "ms_by_lanes": {lanes: time_ms(torch, lambda lanes=lanes, M=M,
                                             x=x: C.csr_spmv(
                  M.row_offsets, M.col_indices, M.values, x, lanes=lanes))
                  for lanes in (1, 2, 4, 8, 16, 32)}})
    cases[f"classical_128^3 A1 {n1}x{n1}"]["csr_smooth"] = (
        lambda: C.csr_smooth(M1.row_offsets, M1.col_indices, M1.values,
                             tau1, b1, x1, dinv1,
                             lanes=M1.csr_lanes),
        lambda: C.csr_smooth_plain(M1.row_offsets, M1.col_indices,
                                   M1.values, tau1, b1, x1, dinv1),
        M1.nnz * 8 + (n1 + 1) * 4 + 4 * n1 * 4 + 4, 2 * M1.nnz + 4 * n1, 1,
        None)
    A0, xf = l0["A"], l0["xfer"]
    vals, offs = A0.dia_vals, A0.dia_offsets
    n, k = A0.num_rows, len(offs)
    m, nc = xf["ctab"].shape
    mp = xf["ptab"].shape[0]
    nnz_r = int((xf["ctab"] >= 0).sum())
    nnz_p = int((xf["ptab"] >= 0).sum())
    # R and P as the function needs them: their stored entries (value and
    # column) and row offsets, not the kernel's padded (m, nc) / (mp, n)
    # tables
    r_bytes = nnz_r * 8 + (nc + 1) * 4
    p_bytes = nnz_p * 8 + (n + 1) * 4
    b, x = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    xc = torch.randn(nc, generator=g, device=dev)
    tau = amg.levels[0].smoother._fused_taus(1, x)
    app = (2 * k + 3) * n
    for tag, dinv in (("dinv", l0["smoother"]["dinv"]), ("no dinv", None)):
        dn = 0 if dinv is None else n
        cases[f"classical_l0_128^3 {tag}"] = {
            "dia_smooth_restrict_w": (
                lambda d=dinv: K.dia_smooth_restrict(
                    vals, offs, tau, b, x, xf["ctab"], d,
                    weights=xf["cwt"]),
                lambda d=dinv: K.dia_smooth_restrict_plain(
                    vals, offs, tau, b, x, xf["ctab"], d,
                    weights=xf["cwt"]),
                (k * n + 3 * n + dn + 1 + nc) * 4 + r_bytes,
                app + dn + nnz_r * (2 * k + 3), 2, None),
            "dia_prolong_smooth_w": (
                lambda d=dinv: K.dia_prolong_smooth(
                    vals, offs, tau, b, x, xc, dinv=d, ptab=xf["ptab"],
                    pwt=xf["pwt"]),
                lambda d=dinv: K.dia_prolong_smooth_plain(
                    vals, offs, tau, b, x, xc, None, d, ptab=xf["ptab"],
                    pwt=xf["pwt"]),
                (k * n + 3 * n + dn + 1 + nc) * 4 + p_bytes,
                app + dn + 2 * nnz_p, 1, None)}
        if dinv is not None:
            cases[f"classical_l0_128^3 {tag}"]["dia_prolong_smooth_w_dot"] = (
                lambda d=dinv: K.dia_prolong_smooth(
                    vals, offs, tau, b, x, xc, dinv=d, ptab=xf["ptab"],
                    pwt=xf["pwt"], with_dot=True),
                lambda d=dinv: K.dia_prolong_smooth_plain(
                    vals, offs, tau, b, x, xc, None, d, with_dot=True,
                    ptab=xf["ptab"], pwt=xf["pwt"]),
                (k * n + 3 * n + dn + 1 + nc + 1) * 4 + p_bytes,
                app + dn + 2 * nnz_p + 2 * n, 1, None)
    return cases, amg.level_rows(), {"m": m, "mp": mp}


def rap_case(torch, amgx, R_, dev):
    """B10 on level 0's float32 plan of the 64^3 CLASSICAL_REFINEMENT
    hierarchy (built as its setup builds it, on the float32 operator):
    (case, plan sizes). The library call is cuSPARSE's SpGEMM, which
    also redoes the symbolic phase the plan holds."""
    A = amgx.gallery.poisson("7pt", 64, 64, 64, dtype=torch.float32,
                             device=dev)
    amg = amg_of(amgx, classical_refinement(), A, dev).amg
    lv = amg.levels[0]
    plan = lv.rap_plan
    a, r, p = lv.A.values, lv.R.values, lv.P.values
    check(a.dtype == torch.float32, "CLASSICAL_REFINEMENT setup is f32")
    Rs, As, Ps = (csr_library(torch, M) for M in (lv.R, lv.A, lv.P))
    nidx = plan.sa.numel() + plan.sp.numel() + plan.sr.numel() \
        + plan.st.numel()
    nbytes = (nidx + plan.nT + 1 + plan.nU + 1 + a.numel() + p.numel()
              + r.numel() + plan.nT + plan.nU) * 4
    flops = 2 * (plan.sa.numel() + plan.sr.numel())
    case = (lambda: R_.rap_values(plan, a, r, p),
            lambda: R_.rap_values_plain(plan, a, r, p),
            nbytes, flops, 2,
            lambda: torch.sparse.mm(torch.sparse.mm(Rs, As), Ps))
    return case, {"rows": lv.A.num_rows, "nT": plan.nT, "nU": plan.nU,
                  "candidates_stage1": plan.sa.numel(),
                  "candidates_stage2": plan.sr.numel(),
                  "plan_bytes": plan.nbytes()}


def max_err(torch, got, want):
    """(max abs error, max over outputs of abs error / max |plain|)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    rel = max(e / max(float(b.abs().max()), 1e-30)
              for e, b in zip(abs_errs, want))
    return max(abs_errs), rel


def run_case(torch, K, label, name, kern, plain, nbytes, flops, per_call,
             lib, rows, summary, extra=None):
    before = sum(K.LAUNCHES.values())
    got = kern()
    launched = sum(K.LAUNCHES.values()) - before
    want = plain()
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(torch, got, want)
    check(launched == per_call,
          f"{name} launched {launched} kernels, expected {per_call}")
    check(rel_err <= LIMITS[name],
          f"{name} at {label}: error {rel_err} > {LIMITS[name]}")
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain)
    # a library call is only timed, never used; one that fails fails the run
    lib_ms = None if lib is None else time_ms(torch, lib)
    b_ms, b_by = bound(nbytes, flops)
    row = {"phase": "kernels", "shape": label, "name": name, "rows": rows,
           "max_abs_err": abs_err, "max_rel_err": rel_err,
           "limit": LIMITS[name], "launches_per_call": per_call, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_us": b_ms * 1e3,
           "bound_by": b_by, "library_ms": lib_ms, **(extra or {})}
    emit(row)
    prev = summary.get(name)
    if prev is None:
        summary[name] = row       # the first (main-path) shape's numbers
    else:
        prev["max_abs_err"] = max(prev["max_abs_err"], abs_err)
        prev["max_rel_err"] = max(prev["max_rel_err"], rel_err)


def phase_kernels(torch, amgx, dev):
    from amgx_tpu_torch.ops import cuda_csr as C
    from amgx_tpu_torch.ops import cuda_krylov as KK
    from amgx_tpu_torch.ops import cuda_rap as R_
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.ops import cuda_tail as T
    summary = {}
    for label, shape in (("flagship_l0_128^3", (128, 128, 128)),
                         ("ragged_97x61x43", (97, 61, 43))):
        A, xfer, taus, b, x, xc = grid_case(torch, amgx, shape, dev)
        for name, case in kernel_cases(torch, K, A, xfer, taus, b, x,
                                       xc).items():
            run_case(torch, K, label, name, *case, A.num_rows, summary)
    A, cases = shell_cases(torch, amgx, K, KK, dev)
    for name, case in cases.items():
        run_case(torch, K, "pcg_l0_128^3", name, *case, A.num_rows, summary)
    for label, (spec, arrs, with_dot, b, x) in tail_cases(torch, amgx, T,
                                                          dev).items():
        nbytes, flops, phases = tail_work(T, spec, arrs, with_dot)
        name = "dia_coarse_tail_dot" if with_dot else "dia_coarse_tail"
        run_case(torch, K, f"tail_32^3 {label}", name,
                 lambda s=spec, a=arrs, w=with_dot, b=b, x=x:
                 T.dia_coarse_tail(s, a, b, x, w),
                 lambda s=spec, a=arrs, w=with_dot, b=b, x=x:
                 T.dia_coarse_tail_plain(s, a, b, x, w),
                 nbytes, flops, 1, None, spec.levels[0].n, summary,
                 {"phases": phases,
                  "levels": [ls.n for ls in spec.levels]})
    cases, levels, mm = classical_cases(torch, amgx, K, C, dev)
    emit({"phase": "kernels_classical_hierarchy", "rows": 128 ** 3,
          "levels": levels, **mm})
    for label, named in cases.items():
        for name, case in named.items():
            run_case(torch, K, label, name, *case,
                     int(label.split()[-1].split("x")[0])
                     if label.startswith("classical_128^3") else 128 ** 3,
                     summary)
    case, sizes = rap_case(torch, amgx, R_, dev)
    run_case(torch, K, "classical_refinement_l0_64^3", "rap_values", *case,
             sizes["rows"], summary, sizes)
    return summary


def solve(torch, amgx, cfg, n, dev, dtype=None):
    """Set up and solve the 7-pt n^3 system with b = 1 (float64 unless
    `dtype`); returns (result, solver, setup s, solve s, true relative
    residual in float64)."""
    from amgx_tpu_torch.ops.spmv import residual
    dtype = dtype or torch.float64
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=dtype, device=dev)
    slv = amgx.create_solver(amgx.Config.from_string(cfg), device=dev)
    t0 = time.perf_counter()
    slv.setup(A)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=dtype, device=dev)
    t0 = time.perf_counter()
    res = slv.solve(b)
    solve_s = time.perf_counter() - t0
    A64 = amgx.gallery.poisson("7pt", n, n, n, device=dev).init()
    b64 = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    true_rel = float(torch.linalg.norm(residual(A64, res.x.double(), b64))
                     / torch.linalg.norm(b64))
    check(tuple(res.x.shape) == (n ** 3,) and bool(
        torch.isfinite(res.x).all()), "solution finite, right shape")
    return res, slv, setup_s, solve_s, true_rel


def warm_solve(torch, slv, n, dtype):
    b = torch.ones(n ** 3, dtype=dtype, device=slv.device)
    t0 = time.perf_counter()
    res = slv.solve(b)
    return res, time.perf_counter() - t0


def paired_warm(torch, solvers, n, dtype, pairs=PAIRS):
    """Warm-solve wall times of two solvers in alternating turns (A B,
    B A, ...): ({label: {"q1", "median", "q3", "all" in run order}}, the
    turns the first solver won)."""
    labels = list(solvers)
    times = {k: [] for k in labels}
    for i in range(pairs):
        for k in (labels if i % 2 == 0 else labels[::-1]):
            times[k].append(warm_solve(torch, solvers[k], n, dtype)[1])
    out = {}
    for k, v in times.items():
        srt = sorted(v)
        out[k] = {"q1": srt[len(v) // 4], "median": srt[len(v) // 2],
                  "q3": srt[(3 * len(v)) // 4], "all": v}
    first, second = labels
    return out, sum(a < b for a, b in zip(times[first], times[second]))


def levels_of(slv):
    s = slv
    while not hasattr(s, "amg"):
        s = s.preconditioner
    return s.amg.level_rows()


def run_path(amgx, per_path, name, fn):
    """Zero the launch counts, run one path, keep its counts."""
    amgx.reset_kernel_launches()
    out = fn()
    per_path[name] = amgx.kernel_launches()
    return out


def phase_small(torch, amgx, dev, per_path):
    from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF
    cpu = torch.device("cpu")
    for label, cfg in (("flagship_tail_off", FLAGSHIP_TAIL_OFF),
                       ("flagship", FLAGSHIP)):
        rc, _, _, _, tc = solve(torch, amgx, cfg, 16, dev)
        rh, _, _, _, th = solve(torch, amgx, cfg, 16, cpu)
        xdiff = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                      / torch.linalg.norm(rh.x))
        emit({"phase": "small", "config": label, "rows": 16 ** 3,
              "outer_cuda": rc.iterations, "outer_cpu": rh.iterations,
              "true_rel_res_cuda": tc, "true_rel_res_cpu": th,
              "x_rel_diff": xdiff})
        check(rc.iterations == rh.iterations and xdiff <= 1e-5
              and tc <= 1e-8, f"16^3 {label}: card agrees with the CPU")
    # whole cycle = one tail: B5 carries PCG's r.z (its dot variant)
    rc, _, _, _, _ = run_path(amgx, per_path, "pcg_32^3", lambda: solve(
        torch, amgx, PCG + "1", 32, dev, torch.float32))
    rh, _, _, _, _ = solve(torch, amgx, PCG + "1", 32, cpu, torch.float32)
    xdiff = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                  / torch.linalg.norm(rh.x))
    c = per_path["pcg_32^3"]
    emit({"phase": "small", "config": "pcg_krylov_fusion=1",
          "rows": 32 ** 3, "iterations_cuda": rc.iterations,
          "iterations_cpu": rh.iterations, "x_rel_diff": xdiff,
          "launches": c})
    check(rc.status == "success" and rc.iterations == rh.iterations
          and xdiff <= 1e-4, "32^3 PCG: card agrees with the CPU")
    check(c["dia_coarse_tail_dot"] == rc.iterations + 1
          and c["dia_prolong_smooth_dot"] == 0
          and c["dia_spmv_dot"] == c["cg_update"] == rc.iterations,
          f"32^3 PCG: r.z from B5 once per cycle, B6/B7 per iteration {c}")


def phase_flagship(torch, amgx, dev, per_path):
    from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF
    n = 128
    runs, slvs = {}, {}
    for label, cfg in (("flagship", FLAGSHIP),
                       ("flagship_tail_off", FLAGSHIP_TAIL_OFF)):
        res, slv, setup_s, solve_s, true_rel = run_path(
            amgx, per_path, label, lambda c=cfg: solve(
                torch, amgx, c + ", store_res_history=1", n, dev))
        slvs[label] = slv
        c = per_path[label]
        inner = int(res.extra_stats["inner_iters"])
        levels = levels_of(slv)
        runs[label] = {"setup_s": setup_s, "solve_s": solve_s,
                       "inner_iterations": inner}
        emit({"phase": "flagship", "config": label, "rows": n ** 3,
              "setup_s": setup_s, "solve_s": solve_s,
              "levels": levels, "outer_iterations": res.iterations,
              "inner_iterations": inner, "status": res.status,
              "true_rel_res": true_rel,
              "res_history": [float(h) for h in res.res_history],
              "launches": c})
        check(res.status == "success" and true_rel <= 1e-8,
              f"128^3 {label} true relative residual {true_rel} <= 1e-8")
        check(res.iterations <= 3, f"{res.iterations} outer iterations <= 3")
        check(c["dia_spmv"] > 0 and c["dia_smooth_restrict"] > 0
              and c["dia_prolong_smooth"] > 0, f"{label}: B1, B3, B4 ran")
        if label == "flagship":
            # every V-cycle: B3 (6 launches) and B4 (5) on each level
            # above the tail, then ONE B5 launch for the rest
            above = sum(r > 65536 for r in levels[:-1])
            check(above == 2 and c["dia_coarse_tail"] == inner,
                  f"one B5 launch per V-cycle: {c['dia_coarse_tail']} "
                  f"launches, {inner} cycles")
            check(c["dia_smooth_restrict"] == inner * above * 6
                  and c["dia_prolong_smooth"] == inner * above * 5,
                  f"B3/B4 only on the {above} levels above the tail: {c}")
        else:
            check(c["dia_coarse_tail"] == 0, "tail off: no B5 launch")
    warm, wins = paired_warm(torch, slvs, n, torch.float64)
    emit({"phase": "flagship_vs_tail_off", "rows": n ** 3,
          "warm_solve_s": warm, "pairs": PAIRS, "flagship_wins": wins,
          "warm_median_ratio": warm["flagship"]["median"]
          / warm["flagship_tail_off"]["median"], **{
              f"{k}_{c}": v for k, r in runs.items() for c, v in r.items()}})


def phase_unfused(torch, amgx, dev, per_path):
    from amgx_tpu_torch.presets import FLAGSHIP_TAIL_OFF
    unf, _, setup_u, solve_u, rel_u = run_path(
        amgx, per_path, "unfused", lambda: solve(
            torch, amgx, FLAGSHIP_TAIL_OFF + ", amg:cycle_fusion=0", 64,
            dev))
    emit({"phase": "unfused", "rows": 64 ** 3, "setup_s": setup_u,
          "solve_s": solve_u, "outer_iterations": unf.iterations,
          "inner_iterations": int(unf.extra_stats["inner_iters"]),
          "true_rel_res": rel_u, "launches": per_path["unfused"]})
    check(unf.status == "success" and rel_u <= 1e-8,
          f"64^3 unfused true relative residual {rel_u} <= 1e-8")
    check(per_path["unfused"]["dia_smooth"] > 0, "dia_smooth ran unfused")


def count_syncs(torch, fn):
    """(fn(), synchronizing CUDA operations it made), as PyTorch's sync
    debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_krylov(torch, amgx, dev, per_path):
    n = 128
    iters, slvs = {}, {}
    for kf in (1, 0):
        path = f"pcg_krylov_fusion={kf}"
        res, slv, setup_s, solve_s, true_rel = run_path(
            amgx, per_path, path, lambda k=kf: solve(
                torch, amgx, PCG + str(k), n, dev, torch.float32))
        slvs[path] = slv
        (warm, _), syncs = count_syncs(
            torch, lambda: warm_solve(torch, slv, n, torch.float32))
        c = per_path[path]
        iters[kf] = res.iterations
        emit({"phase": "krylov", "config": path, "rows": n ** 3,
              "levels": levels_of(slv), "setup_s": setup_s,
              "solve_s": solve_s,
              "iterations": res.iterations, "status": res.status,
              "true_rel_res": true_rel, "host_syncs_warm": syncs,
              "host_syncs_per_iteration": syncs / max(warm.iterations, 1),
              "launches": c})
        check(res.status == "success", f"128^3 PCG {path}: {res.status}")
        check(abs(res.iterations - PCG_ANCHOR) <= 2,
              f"128^3 PCG {path}: {res.iterations} iterations, anchor "
              f"{PCG_ANCHOR} +- 2")
        if kf:
            check(c["dia_spmv_dot"] == c["cg_update"] == res.iterations
                  and c["dia_prolong_smooth_dot"] == res.iterations + 1
                  and c["dia_coarse_tail"] == res.iterations + 1,
                  f"fused PCG: B6, B7 per iteration, B4's dot and one B5 "
                  f"per cycle {c}")
        else:
            check(c["dia_spmv"] > res.iterations and c["dia_spmv_dot"] == 0
                  and c["cg_update"] == 0, f"unfused PCG: B1 {c}")
    check(abs(iters[1] - iters[0]) <= 1,
          f"krylov_fusion 1 / 0: {iters[1]} / {iters[0]} iterations")
    warm, wins = paired_warm(torch, slvs, n, torch.float32)
    emit({"phase": "krylov_fused_vs_unfused", "rows": n ** 3,
          "warm_solve_s": warm, "pairs": PAIRS, "fused_wins": wins,
          "warm_median_ratio": warm["pcg_krylov_fusion=1"]["median"]
          / warm["pcg_krylov_fusion=0"]["median"]})


def precond_amg(slv):
    s = slv
    while not hasattr(s, "amg"):
        s = s.preconditioner
    return s.amg


def phase_classical(torch, amgx, dev, per_path):
    """CLASSICAL at 128^3 and 64^3: success at a true relative residual
    <= 1e-8 within +-2 of the anchors; B8/B9 on the coarse levels, no B5,
    no B10 (the setup is float64); B3w/B4w once per cycle each where
    level 0 took the weighted tables."""
    for n in (128, 64):
        path = f"classical_{n}^3"
        torch.cuda.reset_peak_memory_stats(dev)
        res, slv, setup_s, solve_s, true_rel = run_path(
            amgx, per_path, path, lambda n=n: solve(
                torch, amgx, CLASSICAL, n, dev))
        peak = torch.cuda.max_memory_allocated(dev)
        _, warm_s = warm_solve(torch, slv, n, torch.float64)
        amg = precond_amg(slv)
        xfer = amg.levels[0]._transfer_tables()
        c = per_path[path]
        cycles = res.iterations + 1       # PCG: one cycle per iteration + 1
        emit({"phase": "classical", "config": path, "rows": n ** 3,
              "levels": amg.level_rows(), "setup_s": setup_s,
              "solve_s": solve_s, "warm_solve_s": warm_s,
              "setup_peak_bytes": peak, "iterations": res.iterations,
              "anchor": CLASSICAL_ANCHORS[n], "status": res.status,
              "true_rel_res": true_rel, "level0_fused": xfer is not None,
              "level0_m": None if xfer is None else xfer["ctab"].shape[0],
              "level0_mp": None if xfer is None else xfer["ptab"].shape[0],
              "launches": c})
        check(res.status == "success" and true_rel <= 1e-8,
              f"{path}: {res.status}, true relative residual {true_rel}")
        check(abs(res.iterations - CLASSICAL_ANCHORS[n]) <= 2,
              f"{path}: {res.iterations} iterations, anchor "
              f"{CLASSICAL_ANCHORS[n]} +- 2")
        check(c["csr_spmv"] > 0 and c["csr_smooth"] > 0
              and c["dia_coarse_tail"] == 0 and c["rap_values"] == 0,
              f"{path}: B8/B9 ran, B5 and B10 did not {c}")
        if xfer is not None:
            check(c["dia_smooth_restrict_w"] == 2 * cycles
                  and c["dia_prolong_smooth_w"] == cycles,
                  f"{path}: B3w (2 launches) and B4w (1) once per cycle, "
                  f"{cycles} cycles {c}")
        else:
            check(c["dia_smooth_restrict_w"] == 0, f"{path}: level 0 "
                  f"composes its transfers {c}")


def hierarchy_bits(torch, amg):
    """Every tensor of a set-up classical hierarchy, moved to the CPU."""
    out = []
    for lv in amg.levels:
        out += [lv.cf_map, lv.strong, lv.smoother.solve_data()["dinv"]]
        for M in (lv.A, lv.P, lv.R):
            out += [M.row_offsets, M.col_indices, M.values]
    M = amg.coarsest_A
    return [t.cpu() for t in out + [M.row_offsets, M.col_indices,
                                    M.values]]


def phase_determinism(torch, amgx, dev, per_path):
    """CLASSICAL at 32^3: two setups on the card give the same bits; the
    card's CF splits and P patterns equal the CPU's; the card's and the
    CPU's solves take the same iterations, x within 1e-5."""
    cpu = torch.device("cpu")
    amgs = [amg_of(amgx, CLASSICAL, amgx.gallery.poisson(
        "7pt", 32, 32, 32, device=d), d).amg for d in (dev, dev, cpu)]
    bits = [hierarchy_bits(torch, a) for a in amgs[:2]]
    same = len(bits[0]) == len(bits[1]) and all(
        torch.equal(a, b) for a, b in zip(*bits))
    card, host = amgs[0], amgs[2]
    cf_equal = card.level_rows() == host.level_rows() and all(
        torch.equal(a.cf_map.cpu(), b.cf_map) for a, b in
        zip(card.levels, host.levels))
    p_equal = all(torch.equal(a.P.row_offsets.cpu(), b.P.row_offsets)
                  and torch.equal(a.P.col_indices.cpu(), b.P.col_indices)
                  for a, b in zip(card.levels, host.levels))
    p_diff = max(float((a.P.values.cpu() - b.P.values).abs().max())
                 for a, b in zip(card.levels, host.levels)) if p_equal \
        else None
    rc, _, _, _, tc = run_path(amgx, per_path, "classical_32^3",
                               lambda: solve(torch, amgx, CLASSICAL, 32,
                                             dev))
    rh, _, _, _, _ = solve(torch, amgx, CLASSICAL, 32, cpu)
    xdiff = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                  / torch.linalg.norm(rh.x))
    emit({"phase": "determinism", "config": "classical_32^3",
          "rows": 32 ** 3, "levels": card.level_rows(),
          "card_setups_bit_identical": same, "tensors_compared":
          len(bits[0]), "cf_maps_equal_cpu": cf_equal,
          "p_patterns_equal_cpu": p_equal, "p_values_max_diff_cpu": p_diff,
          "iterations_cuda": rc.iterations, "iterations_cpu": rh.iterations,
          "true_rel_res_cuda": tc, "x_rel_diff": xdiff})
    check(same, "32^3 classical: two card setups are bit-identical")
    check(cf_equal and p_equal, "32^3 classical: card CF splits and P "
          "patterns equal the CPU's")
    check(rc.iterations == rh.iterations and xdiff <= 1e-5,
          "32^3 classical: card and CPU solves agree")
    # float32 throughout: PCG's r.z rides B4w's epilogue once per cycle
    rc, _, _, _, _ = run_path(amgx, per_path, "classical_f32_32^3",
                              lambda: solve(torch, amgx, CLASSICAL_F32, 32,
                                            dev, torch.float32))
    rh, _, _, _, _ = solve(torch, amgx, CLASSICAL_F32, 32, cpu,
                           torch.float32)
    xdiff = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                  / torch.linalg.norm(rh.x))
    c = per_path["classical_f32_32^3"]
    emit({"phase": "determinism", "config": "classical_f32_32^3",
          "rows": 32 ** 3, "iterations_cuda": rc.iterations,
          "iterations_cpu": rh.iterations, "x_rel_diff": xdiff,
          "launches": c})
    check(rc.status == "success" and rc.iterations == rh.iterations
          and xdiff <= 1e-4, "32^3 float32 classical PCG: card agrees with "
          "the CPU")
    check(c["dia_prolong_smooth_w_dot"] == rc.iterations + 1
          and c["dia_spmv_dot"] == c["cg_update"] == rc.iterations,
          f"32^3 float32 classical PCG: r.z from B4w once per cycle, B6/B7 "
          f"per iteration {c}")


def phase_classical_refinement(torch, amgx, dev, per_path):
    """CLASSICAL_REFINEMENT at 64^3: success in <= 3 outer iterations at
    a true relative residual <= 1e-8; its float32 setup calls B10 once
    per Galerkin product (two launches each)."""
    from amgx_tpu_torch.ops.spmv import residual
    n = 64
    path = f"classical_refinement_{n}^3"
    A = amgx.gallery.poisson("7pt", n, n, n, device=dev)
    slv = amgx.create_solver(amgx.Config.from_string(classical_refinement()),
                             device=dev)
    b = torch.ones(n ** 3, dtype=torch.float64, device=dev)
    amgx.reset_kernel_launches()
    t0 = time.perf_counter()
    slv.setup(A)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    in_setup = amgx.kernel_launches()
    t0 = time.perf_counter()
    res = slv.solve(b)
    solve_s = time.perf_counter() - t0
    per_path[path] = c = amgx.kernel_launches()
    amg = precond_amg(slv)
    true_rel = float(torch.linalg.norm(residual(A.init(), res.x, b))
                     / torch.linalg.norm(b))
    products = len(amg.levels)
    emit({"phase": "classical_refinement", "config": path, "rows": n ** 3,
          "levels": amg.level_rows(), "setup_s": setup_s,
          "solve_s": solve_s, "outer_iterations": res.iterations,
          "inner_iterations": int(res.extra_stats["inner_iters"]),
          "status": res.status, "true_rel_res": true_rel,
          "galerkin_products": products,
          "rap_values_launches_in_setup": in_setup["rap_values"],
          "launches": c})
    check(res.status == "success" and true_rel <= 1e-8
          and res.iterations <= 3,
          f"{path}: {res.status}, {res.iterations} outer iterations, true "
          f"relative residual {true_rel}")
    check(in_setup["rap_values"] == 2 * products
          and c["rap_values"] == in_setup["rap_values"],
          f"{path}: one B10 call (2 launches) per Galerkin product, "
          f"{products} products {in_setup}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.ops import cuda_build
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
    regs = {src: [ln.split("Used ")[1].split(",")[0]
                  for ln in log.splitlines() if "Used " in ln]
            for src, log in rep["ptxas"].items()}
    emit({"phase": "build", "seconds": rep["seconds"],
          "built": rep["built"], "ptxas_registers": regs})

    summary = phase_kernels(torch, amgx, dev)
    per_path = {}
    phase_small(torch, amgx, dev, per_path)
    phase_flagship(torch, amgx, dev, per_path)
    phase_unfused(torch, amgx, dev, per_path)
    phase_krylov(torch, amgx, dev, per_path)
    phase_classical(torch, amgx, dev, per_path)
    phase_determinism(torch, amgx, dev, per_path)
    phase_classical_refinement(torch, amgx, dev, per_path)

    kernels = []
    for name, row in summary.items():
        launches = {p: c[name] for p, c in per_path.items()}
        check(sum(launches.values()) > 0, f"{name} ran on no path")
        entry = {
            "name": name, "route": "cuda", "source": _CSRC + SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": row["max_abs_err"],
            "max_rel_err": row["max_rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        if "phases" in row:
            entry["phases"] = row["phases"]
        kernels.append(entry)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
