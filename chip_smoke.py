#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (amgx_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. build    -- compile the CUDA kernels from amgx_tpu_torch/csrc (nvcc,
               one process per source, all at once).
2. kernels  -- each kernel against its plain PyTorch version on the card,
               B5 and B8 first (their device times from the run's first
               profiles): B5 on 32^3 hierarchies, whose whole cycle is the
               flagship 128^3's coarse tail (32768 -> 4096 -> 512 -> 64
               rows), with slab levels and with matrix-free ones (B5-mf,
               against B5 on the slab levels): CHEBYSHEV_POLY order 5 V,
               JACOBI_L1 V, each with and without the dot, and W and F,
               and B5 / B5-mf in bf16; each launch's cluster size and its
               cluster and block barriers, the card's cost of one of each
               (`barrier_costs`) and so the phase chain's floor; repeat
               calls bit-equal. Then B8 (row blocks) on the 128^3
               CLASSICAL hierarchy's level 1, P and R, f32 and bf16,
               repeat calls bit-equal, beside cuSPARSE in both (the bf16
               row says "none: <torch's error>" where torch.sparse refuses
               bf16), and B9's time by lanes per row (csr_lanes).
               The slab B3 and B4 (csrc/stencil_tb_slab.cu, the level's
               value slab: temporally blocked launches of at most three
               applications, the planner's split, `slab_cases`), f32 and
               bf16 and B4's
               x'.b, on random-valued slabs (D A D, `dad_operator`) at
               the flagship's 128^3 level 0, the D A D hierarchy's 64^3
               level 1 and the ragged 97x61x43 grid, with CHEBYSHEV_POLY's
               and PCG's JACOBI_L1 schedules: each against its plain form
               and the per-step route (`slab_step_route`, the same x' and
               bc), timed against it in turns; their per-step route (and
               B2's) on a 27-point level under its own counters.
               B1, B2 and the coefficient ("matrix-free") mode B2-mf,
               B3-mf, B4-mf, B4-mf's x'.b epilogue at the flagship's
               finest-level shapes (7-pt 128^3) and on a ragged 97x61x43
               grid, each coefficient kernel also against the slab kernel
               on the same level (the same bits; of a dot epilogue x'
               only), and the dinv B2-mf synthesizes ("jacobi", "l1")
               against the smoothers'. B2, B2-mf, B3-mf and B4-mf (and
               B4-mf's dot, and their bf16 forms) are the temporally
               blocked kernels of csrc/stencil_tb*.cu (B3-mf / B4-mf one
               launch a call, B2 / B2-mf the planner's split): each is
               also held to the per-step route on the same inputs (one
               launch a step, `smooth_step_route`, `step_route`; the same
               x' and r or bc) and timed against it in turns, old, new,
               new, old (step_route_ms, step_route_device_ms), at 128^3
               and on the flagship's level 1 (the Galerkin 7-pt stencil
               at 64^3, F's second level, another tile plan; there also
               B2 / B2-mf with 20 steps, split over more launches);
               B2-mf's candidate splits (one launch, two, three, the
               per-step route) timed in turns at both levels, with and
               without the residual (`b2mf_splits`); the per-step route
               that B2-mf, B3-mf and B4-mf take where the tiled kernel
               does not (a 27-point 48^3 level; B3-mf / B4-mf also with 20
               steps on level 1), with its launches under the "_step"
               counters; B6 and B7 at the PCG path's 128^3
               shapes, and B6's streamed-dot form
               (BiCGStab's: Ap with d.Ap and, with self_dot, Ap.Ap; d
               apart from p and d = p) there. The bf16
               forms (the reduced-precision cycle): B2-B4 and B2-mf..B4-mf
               at the 128^3 level-0 shapes with the flagship's
               CHEBYSHEV_POLY and a JACOBI_L1 (dinv) schedule, B5 and
               B5-mf on the bf16 32^3 hierarchies; each within 1 bf16 ulp
               of its plain version (`bf16_err`, with the share of entries
               bit-equal), every launch under its own "_bf16" counter.
               The bf16 hierarchies' forms: B9 and B8 on the 128^3
               CLASSICAL hierarchy's level 1 (and B8 on its P and R),
               B3w / B4w on its level 0, each beside the float32 form's
               times on the same level (`f32_ms`).
               Max error with its limit, launches per call, kernel /
               plain / library times per call (CUDA events around BATCH
               back-to-back calls, median of REPS, after a warm-up; the
               plain version PLAIN_BATCH calls, median of PLAIN_REPS), the
               kernel's device time per call under torch.profiler (host
               launch cost left out; a profile holding fewer kernel
               records than launches is taken again, up to three times,
               then none), the bound, and for B5 the dependent-phase
               count. The classical kernels on the 128^3
               CLASSICAL hierarchy's float32 solve data besides B8: B9 on
               level 1's operator with JACOBI_L1's dinv, B3w/B4w (and
               B4w's dot) on level 0 with its weighted tables, with and
               without dinv (`weighted_bits`: their x' to 0 ulp of the
               per-step kernels' arithmetic, and B3w's restriction alone
               beside cuSPARSE's R @ r); and B10 on level 0's plan of the
               64^3 CLASSICAL_REFINEMENT hierarchy. B8 and B10 are timed
               against cuSPARSE.
3. small    -- end-to-end references on small inputs, the card against
               the CPU (plain kernels): the flagship at 16^3 with the
               tail off, untouched and in bfloat16, the bfloat16 one at
               64^3 (its inner iterations within one of the CPU's and of
               the JAX package's Pallas route's 24), and PCG at 32^3,
               where the whole cycle is the tail and B5 carries PCG's
               r.z: slab levels (pinned) and matrix-free ones (B5-mf's
               dot).
4. flagship -- the untouched FLAGSHIP on 7-pt 128^3, 2,097,152 rows,
               matrix-free on the card: true f64 residual <= 1e-8 in <= 3
               outer iterations, one B5-mf launch per V-cycle, B3-mf/B4-mf
               only on the levels above the tail, one launch each a call
               (B3-mf restricting in the tile), no slab B3/B4/B5; the
               same with the slab route pinned (flagship_slab: the same
               iterations, B3/B4/B5, the slab B3 / B4 in the planned
               tiled launches a V-cycle, `slab_cycle_launches`) and with
               the tail off (the same on every level); warm solves in
               alternating pairs, matrix-free vs slab and slab vs tail-off.
   flagship_bf16 -- the same three with solve_precision=bfloat16 (f64
               REFINEMENT, f32 FGMRES, the AMG cycle in bf16): <= 1e-8 in
               <= 3 outer and <= BF16_INNER_RATIO (1.47) x the f32 run's
               inner iterations, the tail runs' within one of the same
               bf16 solve on the CPU (plain kernels), the planned tiled
               bf16 B3 and B4 launches per V-cycle on the levels above
               the tail (one each of bf16 B3-mf and B4-mf), one bf16
               B5 per V-cycle, no float32 smoother
               launch; the tail-off run's coarse solve in float32. Warm
               solves of the f32 and bf16 flagships in alternating pairs:
               mixed_precision_speedup (recorded, not checked).
   flagship_dad -- the untouched FLAGSHIP (matrix_free=auto) on A2 =
               D A D at 128^3: no level is a constant stencil, so every
               level runs the slab kernels (tiled B3 / B4 above the tail,
               one slab B5 a V-cycle, nothing matrix-free); the true
               relative residual of A2 <= 1e-8 in <= 3 outer iterations;
               at 32^3 the card's iterations equal the CPU route's.
5. unfused  -- the tail-off flagship at 128^3 with amg:cycle_fusion=0:
               B2 on slab levels (pinned), B2-mf on matrix-free ones,
               each temporally blocked on every level in the planned
               launches a V-cycle (`smooth_cycle_launches`), no per-step
               route; <= 1e-8 in 2 outer iterations and within one inner
               iteration of the fused tail-off flagship's; the same in
               bf16 at 64^3 (a depth cut; the bf16 B2 and B2-mf).
6. krylov   -- PCG + GEO aggregation + JACOBI_L1 at 128^3 in float32,
               krylov_fusion 1 (B6, B7, B4-mf's dot, B5-mf), the same with
               the slab route pinned (the tiled B3, B4's dot, B5), and
               krylov_fusion 0
               (B1): 54 +- 2 iterations, all within one of each other, the
               host syncs per iteration, warm solves in alternating pairs.
7. classical -- bench.py's `_classical_cfg` (PCG f64 around an f32
               PMIS + D2 cycle) at 128^3 and 64^3: true f64 residual
               <= 1e-8 within 2 of the 20 / 17 iteration anchors, the level
               rows, whether level 0 took the weighted tables (m, mp), B8/B9
               on the coarse levels, B3w/B4w once per cycle (by the
               launches a call their route makes), no B5, no B10;
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
10. aggregation -- AmgX's stock configs/PCG_AGGREGATION_JACOBI.json and
               FGMRES_AGGREGATION_JACOBI.json (SIZE_2 pairwise matching)
               on the 7-pt 128^3 in float32: 51 / 41 +- 2 iterations
               over the JAX package's 15 level rows, one B10-relabel
               launch per Galerkin product, B4-mf (PCG: its dot, B6, B7)
               on level 0, B8/B9 on the CSR levels, no B5; setup, first
               and warm solve times, setup's peak memory. The PCG's
               structure-reuse resetup on D A D (`scaled_values`): the
               aggregates kept, one B10-relabel launch per level, 63 +- 2
               iterations. At 32^3 two card setups bit-identical and
               equal to the CPU's, before and after the resetup. Then
               B10-relabel on the 128^3 level-0 plan and a middle level's
               (0 difference; cuSPARSE's P^T (A P) as the yardstick) and
               B3/B4 (slab and coefficient, with the dot) on the SIZE_2
               level 0's irregular children table (B3 and B3-mf there:
               the tiled steps, then the untiled restriction),
               B8 on its level 1 (962648 rows) against cuSPARSE, and B9's
               and B8's bf16 forms there.
11. bf16_hierarchies -- the same stock aggregation files with
               amg:amg_precision=bfloat16 and CLASSICAL with it at
               BF16_N^3 (96^3; 128^3 until the eigen phase needed the
               time), CLASSICAL_REFINEMENT with solve_precision=bfloat16
               at 64^3 (the AMG cycle in bf16: bf16 B9 / B8 on the CSR
               levels, bf16 B3w / B4w on the classical level 0, bf16
               B4-mf on the aggregation level 0, the coarsest level in
               float32): success (the classical paths to a true f64
               residual <= 1e-8), their bf16 kernels launched and no
               float32 smoother kernel; the float32 twin solved in the
               same run, warm solves of the two in alternating pairs
               (recorded), and for each CSR level whether the JAX
               package would run its bf16 sweep kernel there
               (`swell_fit`); each also at BF16_WITNESS^3 on the card and
               on the CPU route: the same status and level rows,
               iterations within one.
12. bicgstab -- AmgX's stock PBICGSTAB_CLASSICAL_JACOBI (64^3, where
               the JAX package's anchor is; 128^3 until the eigen phase
               needed the time) and PBICGSTAB_NOPREC (128^3) in float32
               with krylov_fusion 1 (B6's streamed-dot form exactly
               twice per iteration) and 0 (no B6, B1 for the SpMVs), the
               routes within one iteration of each other;
               PBICGSTAB_AGGREGATION_W_JACOBI (SIZE_2, W cycle) at 64^3;
               GMRES_AMG_D2 (128^3 and 64^3) and agg_cheb4 (SIZE_8,
               CHEBYSHEV smoothers, 128^3). Each anchored
               run within 2 iterations of the JAX package's CPU anchor
               and with its status (a run ending at max_iters: the final
               residual within 1 % of the anchor's); setup, first and
               warm solve times, peak memory, host syncs of a warm
               solve.
13. multicolor -- AmgX's stock files with the multicolor smoothers,
               IDR and a scaler, read verbatim from configs/:
               FGMRES_AGGREGATION_DILU (MULTICOLOR_DILU on 15 SIZE_2
               levels) at 128^3 in float32, the main path: success
               within 2 of the JAX package's iterations over its level
               rows, B1 and B8 in the solve, one B10-relabel launch per
               Galerkin product, no B2-B7 or B9; the colors of each
               level, a profiled warm solve (device ops, idle share,
               device->host copies an iteration), level 0's color step
               timed; at 32^3 two card setups bit-identical (aggregates,
               operators, row colors, Einv) and equal to the CPU route's,
               the same iterations. PCG_DILU at 128^3 (B6 / B7 once an
               iteration); AGGREGATION_DILU / _GS / _THRUST_GS at 64^3
               (max_iters in float32: status, level rows, final residual
               within MC_FINAL_TOL of the anchor's) and at 32^3 in
               float64 (the JAX package's iterations exactly);
               FGMRES_AGGREGATION at 64^3; IDR_DILU / IDRMSYNC_DILU at
               64^3 (success within IDR_ITER_TOL of the anchor, the true
               residual at most IDR_TRUE_MAX: float32 IDR's count moves
               with rounding alone); V-cheby-smoother (DIAGONAL_SYMMETRIC
               scaling) at 64^3 in float64 against its anchor (max_iters:
               the reference diverges there), and in float32 recorded
               beside the JAX package's nan_detected.
14. aggressive_kcycle -- AmgX's stock aggressive coarsening and K-cycle
               files, read verbatim: FGMRES_CLASSICAL_AGGRESSIVE_PMIS
               (aggressive PMIS + MULTIPASS on level 0, D2 below) at
               128^3 in float32, the main path: success, B10 in the
               setup, B8 and B9 in the solve, its level rows, setup
               seconds, peak memory and level 0's transfer route; at
               64^3 the JAX package's iterations +- 2 over the CPU
               route's level rows; FGMRES_CLASSICAL_AGGRESSIVE_HMIS at
               64^3 (the host RS queue's seconds a level);
               AMG_CLASSICAL_CG, AMG_CLASSICAL_CGF and
               AMG_AGGRREGATION_CG at 64^3 in float32 (max_iters, the
               final residual within KCYCLE_FINAL_TOL of the anchor's; B8
               in the coarse matvec, B5 never) and at 32^3 in float64
               (the JAX package's iterations exactly);
               PCG_CLASSICAL_V_JACOBI (aggressive_levels 2) at 64^3 (B6 /
               B7); two 32^3 card setups of the main file bit-identical
               and equal to the CPU route's. The package's solve and grid
               tables go to a registered callback (counted on the done
               line), never to stdout.
15. resetup  -- AMGX_solver_resetup at 128^3 (`phase_resetup`): the
               untouched FLAGSHIP with structure_reuse_levels=-1 (the
               value-only route on 2 A, coefficients exactly doubled,
               the solve of a fresh setup on 2 A; the generic loop on
               D A D, stencils dropped, 2 / 81 as flagship_dad) and
               FGMRES_CLASSICAL_AGGRESSIVE_PMIS with it (CF split, P, R
               and plan kept, B10 twice a level, no plan built; a second
               setup of the same content served by the plan cache, its
               level-0 lookup timed against a build); setup, resetup and
               warm-setup seconds, host syncs, peak memory; at 32^3 the
               card's classical resetup equal to the CPU's bit for bit.
16. batch    -- batched solves through amgx_tpu_torch.batch
               (`phase_batch`): BATCHED_CG at 8 x 128^3 in float32,
               multi-RHS (M), multi-matrix A + c I (MM: one resetup a
               system, B10-relabel in the splice, at least three distinct
               iteration counts) and the RequestBatcher (Q: dispatches
               (8, 8), (3, 4) and the fast path's (5, 8)), then the slab
               route at 64^3 (S); every system against its solo solve on
               the card (status, iterations +- 1, true residual within
               2x); only the batched kernels K1-K4 launch, exactly
               `batch_launches` (once a use an iteration, whatever B);
               K1-K4 at the path's shapes (K2's slab mode at (S)'s 64^3
               level 0, the row the kernels line reports, and at 128^3),
               shared and per system, row by row equal to their single
               kernels and within 1e-6 of their plain forms, timed beside
               8 single launches, their bound and cuSPARSE (K1, K3);
               warm batched wall against the 8 solo solves; one
               profiled batched solve. (BR) the (M) result carries one
               SolveReport a system, each valid against the schema.
17. resilience -- fault injection, fallback chains and telemetry on the
               card (`phase_resilience`), 7-pt Poisson: (RC)
               RESILIENT_CG at 128^3 f32, a clean solve (success, through
               the chain the preset's stall guard calls where it calls
               one: CG's residual with b = 1 grows before it falls), then
               spmv_nan at iteration 3 on the tree it left (the first
               attempt nan_detected after 4 iterations, `retry` that
               tree's clean status and iterations, true residual within
               2x), then clean again;
               (RS) the JAX stall drill (SIZE_2, JACOBI_L1, 0 + 0 sweeps,
               stall window 4, STALLED>escalate_sweeps, max_iters 200) at
               128^3: stalled first, the rebuilt tree's B10-relabel
               launches, every tensor of the adopted tree on the card;
               at 32^3 the card's chain and iterations = the CPU route's
               in float64 (its float32 statuses too: a float32 stall at
               the rounding floor ends at a rounding-dependent iteration);
               (RG) galerkin_perturb (level 0, scale -1) armed for
               RESILIENT_CG's setup: the card's chain = the CPU route's at
               32^3 as for (RS), recorded at 128^3 (a switch to GMRES
               launches B1);
               (FT) FLAGSHIP 128^3 with telemetry=1, diagnostics=1: 2 /
               31, <= 1e-8, a valid report, finite reduction factors and
               a bottleneck level, the probe's launches exactly one
               composed cycle's (no B5), one more host read; telemetry=1
               and 0 launch what the flagship phase launched, with the
               same host reads; a telemetry_sync=1 Chrome trace;
               memory.setup_peak_bytes = the allocator's peak; 4 warm
               pairs telemetry 1 / 0; (AS) setup_async of FLAGSHIP at
               64^3 bit-identical to setup, the same iterations.
18. serving  -- the serving core on SERVING_CG (`phase_serving`: SG the
               GEO batch with K5 and K2-mf with per-system taus, SV the
               service on 128^3 / 130^3, SR a second process on its
               stores, SJ / SC journal resume and a step crash).
19. fleet    -- FleetRouter over two SERVING_CG replicas sharing the card
               (`phase_fleet`): (FA) sticky placement on both replicas'
               background schedulers, route counts, latency p50 / p99,
               K2-mf / K5 launches; (FK) a replica_kill failover with no
               ticket lost, x bit-identical to (FA), the victim's
               journal settled; (FD) drain_replica / restore_replica;
               (FS) a load spill with its fleet.handoff note.
20. autotune -- the online autotuner on the JAX tests' mistuned
               BATCHED_CG at 96^3 (`phase_autotune`): the shadow search
               promotes within autotune_shadow_budget, the next request
               takes fewer iterations, a second process on the same
               hierarchy store serves the tuned config with 0 full
               setups, an armed shadow_crash fails no ticket.
21. eigen    -- the eight configs/eigen_configs files verbatim
               (`phase_eigen`): each eigenvalue against the box's
               closed-form spectrum (128 x 120 x 112; LOBPCG and
               INVERSE_FGMRES on smaller boxes), PAGERANK on a seeded
               10^6-node graph against scipy's float64 PageRank; the
               iterations, seconds, device ops an iteration and the B1 /
               B8 launches of each.
22. capi     -- the AmgX C API (amgx_tpu_torch/capi.py, `phase_capi`),
               every call's RC held to OK and each path to its direct
               twin: (CA) the amgx_capi.c sequence on FLAGSHIP at 128^3
               (dDDI): 2 outer / 31 inner, true residual below 1e-10, x
               bit-identical to create_solver's, the same kernel
               launches, no added host read in the solve; warm walls
               against the direct solve's and a profile of each; (CI)
               the system in binary read back with AMGX_read_system and
               AMGX_matrix_attach_geometry (x bit-identical to CA's), a
               32^3 MatrixMarket round trip and examples/matrix.mtx with
               FGMRES_AGGREGATION; (CT) matvec = spmv's bits,
               download_all round trip, convergence_analysis=2's report
               (every ratio below 1), replace_coefficients (D A D) +
               resetup = the direct resetup; (CB) the batched solve on
               BATCHED_CG, 8 x 64^3; (CS) the service on SERVING_CG, 4
               requests at 64^3; (CF) the fleet, 2 replicas, 4 requests;
               (CE) POWER_ITERATION on 64 x 60 x 56 and PAGERANK on 10^5
               nodes; (CC) PCG + MULTICOLOR_DILU at 64^3 with a
               red-black coloring attached by AMGX_matrix_attach_coloring;
               a block upload refused, with no launch.
23. item8    -- ROADMAP Queue A item 8 without block matrices
               (`phase_item8`, the paths of `ITEM8`): at 128^3 EM (the
               ENERGYMIN level with CR, K7 once a setup level, success at
               a true f64 residual <= 1e-8), AY (AFFINITY), RSW (the
               device RS sweep), PG (PARALLEL_GREEDY, agg-pcg's
               hierarchy and iterations) and AV (ADAPTIVE); at 64^3 EM64
               (float64: the JAX package's iterations exactly), EMp, the
               smoothers PY, KZ, KM, KMn, IL0, IL1 and CJ, each held to
               its JAX anchor (`ITEM8_ANCHORS`: status, iterations +- 2,
               level rows, the final residual within 5 % at max_iters);
               at 32^3 GS32 (K6 once a GS sweep) and GR (SERIAL_GREEDY);
               RSW's 32^3 split on two card setups and the CPU route's;
               K6, K7 (on EM64's level 0) and K8 (CR's product on EM's
               levels) against their plain versions at the driven
               shapes (and in the other dtype, K7's global route on wide
               patches); `random_matrix(250000, 9, seed=3)` through B8
               against its plain version; the 128^3 operator's
               permutation round trip P^T (P A P^T) P = A bit for bit.

Each path's launch counts are zeroed just before its run and read just
after; every kernel must have launched on some path. The kernels line
lists, beside each tiled kernel, its other routes' counters by path
(`ROUTE_COUNTERS`), and the build line nvcc's registers and spills of
each form of the tiled kernel (`tb_forms`). Every phase row carries the
script's seconds so far (`t_s`), and the done line the seconds of each
phase (`phase_seconds`). Then the card's name and power limit
(nvidia-smi), the {"kernels": [...]} summary, and
as the last line {"ok": true, "device": {...}}. Any failed check
raises: the script exits non-zero without that line. It exits non-zero
at once when PyTorch sees no CUDA device.
"""
import dataclasses
import faulthandler
import inspect
import itertools
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

REPS = 25
BATCH = 10
# the plain versions (PyTorch op sequences, slower than their kernels by
# up to 300x) are timed over PLAIN_BATCH calls, median of PLAIN_REPS: at
# REPS x BATCH they took a fifth of the script's time (PERF.md §6)
PLAIN_REPS = 5
PLAIN_BATCH = 2
PAIRS = 10                  # alternating warm solves per compared pair
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3, data sheet
PEAK_F32_S = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_F64_S = 34e12          # H100 SXM float64 outside the tensor cores
# kernel vs plain PyTorch, max over outputs of max |diff| / max |plain|,
# float32. B1 is one rounded sum per row. B2-B5 run the flagship's five
# dependent damping steps (the last tau is 1.38 > 1, amplifying earlier
# rounding), B5 on three levels joined by the coarse correction, and
# B2/B3 a residual that carries x's error through A (|A|_inf = 12); the
# kernels' fused multiply-adds round differently from PyTorch's separate
# multiply and add. The CPU tests measure ~4e-6 for the same chains
# between two float32 implementations. B6/B7 and the dot epilogues add
# 2M products in another tree than PyTorch's reduction; B6's d.Ap with a
# random d cancels, so its error is measured against sum |d_i Ap_i|, the
# scale of a dot's rounding, not against its value.
# B8 is one rounded sum per row, in another order than the plain
# version's index_add_; B9 one sweep on top of it; B3w/B4w one JACOBI_L1
# step plus the weighted transfer (R's rows of up to 32 residuals); B10
# rounds every product and sum as its plain version does, in the same
# order, so it should agree to the bit.
# The coefficient-mode kernels (_mf) run the slab kernels' arithmetic on
# synthesized values: the same limits against their plain versions, and
# the same bits as the slab kernel on the same level (reported as
# slab_max_abs_diff and checked to be 0).
LIMITS = {"dia_spmv": 1e-6, "dia_smooth": 5e-5, "dia_smooth_restrict": 5e-5,
          "dia_prolong_smooth": 5e-5, "dia_prolong_smooth_dot": 5e-5,
          "dia_coarse_tail": 5e-5, "dia_coarse_tail_dot": 5e-5,
          "dia_spmv_dot": 1e-5, "dia_spmv_ddot": 1e-5, "cg_update": 1e-5,
          "dia_smooth_restrict_w": 5e-5, "dia_prolong_smooth_w": 5e-5,
          "dia_prolong_smooth_w_dot": 5e-5, "csr_spmv": 1e-6,
          "csr_smooth": 1e-5, "rap_values": 1e-6, "rap_values_relabel": 0.0,
          "dia_smooth_mf": 5e-5, "dia_smooth_restrict_mf": 5e-5,
          "dia_prolong_smooth_mf": 5e-5, "dia_prolong_smooth_mf_dot": 5e-5,
          "dia_coarse_tail_mf": 5e-5, "dia_coarse_tail_mf_dot": 5e-5,
          # K7 (float64 on EM's setup) and K6 (float32 on GS32): a QR and
          # a row sweep summed in another order than the plain versions'
          "qr_solve": 1e-12, "gs_sweep": 1e-6,
          # K8 adds in the plain version's order: the same bits
          "ordered_sum": 0.0}
# The bfloat16 forms (the reduced-precision cycle) against their plain
# versions: max error in bf16 ulps (`bf16_err`: each entry's ulp, its
# scale floored at 2^-8 of the output's largest entry, where a sum that
# cancels leaves only the float32 rounding of its terms). Kernel and plain
# version sum in float32 and round once; the kernel's fused multiply-adds
# and its lanes' summation order can move a sum across a rounding
# boundary, by one bf16 ulp. B9's bf16 form rounds x' to bf16 after each
# sweep (the reference's per-sweep rounding), so a case runs one sweep.
BF16_FORMS = {"dia_smooth_bf16": "dia_smooth",
              "dia_smooth_restrict_bf16": "dia_smooth_restrict",
              "dia_prolong_smooth_bf16": "dia_prolong_smooth",
              "dia_smooth_mf_bf16": "dia_smooth_mf",
              "dia_smooth_restrict_mf_bf16": "dia_smooth_restrict_mf",
              "dia_prolong_smooth_mf_bf16": "dia_prolong_smooth_mf",
              "dia_coarse_tail_bf16": "dia_coarse_tail",
              "dia_coarse_tail_mf_bf16": "dia_coarse_tail_mf",
              "dia_smooth_restrict_w_bf16": "dia_smooth_restrict_w",
              "dia_prolong_smooth_w_bf16": "dia_prolong_smooth_w",
              "csr_smooth_bf16": "csr_smooth",
              "csr_spmv_bf16": "csr_spmv"}
LIMITS.update({name: 1.0 for name in BF16_FORMS})
_PS = "amgx_tpu/ops/pallas_spmv.py:"
REPLACES = {
    "dia_spmv": _PS + "165", "dia_smooth": _PS + "649",
    "dia_smooth_restrict": _PS + "1245", "dia_prolong_smooth": _PS + "1585",
    "dia_prolong_smooth_dot": _PS + "1585",
    "dia_coarse_tail": _PS + "1892", "dia_coarse_tail_dot": _PS + "1892",
    "dia_smooth_mf": _PS + "781", "dia_smooth_restrict_mf": _PS + "1379",
    "dia_prolong_smooth_mf": _PS + "1725",
    "dia_prolong_smooth_mf_dot": _PS + "1725",
    "dia_coarse_tail_mf": _PS + "1892", "dia_coarse_tail_mf_dot": _PS + "1892",
    "dia_spmv_dot": _PS + "2116", "dia_spmv_ddot": _PS + "2116",
    "cg_update": _PS + "2261",
    "dia_smooth_restrict_w": _PS + "1245",
    "dia_prolong_smooth_w": _PS + "1585",
    "dia_prolong_smooth_w_dot": _PS + "1585",
    "csr_spmv": "amgx_tpu/ops/pallas_swell.py:254",
    "csr_smooth": "amgx_tpu/ops/pallas_swell.py:412",
    "rap_values": "amgx_tpu/ops/pallas_spgemm.py:261",
    "rap_values_relabel": "amgx_tpu/ops/pallas_spgemm.py:261",
}
_CSRC = "amgx_tpu_torch/csrc/"
SOURCES = {
    "dia_spmv": "dia.cu", "dia_smooth": "stencil_tb_slab.cu",
    "dia_smooth_restrict": "stencil_tb_slab.cu",
    "dia_prolong_smooth": "stencil_tb_slab.cu",
    "dia_prolong_smooth_dot": "stencil_tb_slab.cu",
    "dia_coarse_tail": "tail.cu",
    "dia_coarse_tail_dot": "tail.cu", "dia_spmv_dot": "krylov.cu",
    "dia_spmv_ddot": "krylov.cu",
    "cg_update": "krylov.cu",
    # B3w's steps and r on a grid level; its restriction runs csr.cu's
    # kernel, and a level without a grid dia.cu's per-step kernels
    "dia_smooth_restrict_w": "stencil_tb_slab.cu",
    "dia_prolong_smooth_w": "dia.cu", "dia_prolong_smooth_w_dot": "dia.cu",
    "csr_spmv": "csr.cu", "csr_smooth": "csr.cu", "rap_values": "rap.cu",
    "rap_values_relabel": "rap.cu",
    "dia_smooth_mf": "stencil_tb.cu",
    "dia_smooth_restrict_mf": "stencil_tb.cu",
    "dia_prolong_smooth_mf": "stencil_tb.cu",
    "dia_prolong_smooth_mf_dot": "stencil_tb.cu",
    "dia_coarse_tail_mf": "tail.cu", "dia_coarse_tail_mf_dot": "tail.cu",
}
for _bf, _f32 in BF16_FORMS.items():
    REPLACES[_bf], SOURCES[_bf] = REPLACES[_f32], SOURCES[_f32]
# B8 is float32 only in the reference: on bf16 operands it runs the XLA
# form of the same product, which B8's bf16 form computes
REPLACES["csr_spmv_bf16"] = "amgx_tpu/ops/pallas_swell.py:493"
# the batched forms K1-K4 (ops/cuda_batched.py) are port-added: under
# `jax.vmap` the TPU route runs no Pallas kernel but the XLA multi form
# each replaces (`custom_vmap`: spmv_dia_multi, smooth_dia_multi, the
# vmapped matrix-free _xla_smooth, swell_spmv_xla, _xla_step)
# K5, the batched tail (csrc/tail.cu, one cluster a system): under
# `jax.vmap` B5 gives way to `tail_cycle_multi` (its `_tail_fn` rule)
REPLACES.update({"dia_coarse_tail_multi": "amgx_tpu/ops/batched.py:332",
                 "dia_coarse_tail_mf_multi":
                     "amgx_tpu/ops/batched.py:332"})
SOURCES.update({"dia_coarse_tail_multi": "tail.cu",
                "dia_coarse_tail_mf_multi": "tail.cu"})
# K6, K7 and K8 replace no Pallas kernel: the JAX package's GS sweep is
# a lax.fori_loop over rows, its EM patch solve a batched XLA QR, its
# sorted segment sums XLA's segment_sum (the CSR product's, as in CR)
REPLACES.update({"gs_sweep": "amgx_tpu/solvers/multicolor.py:223",
                 "qr_solve": "amgx_tpu/ops/dense.py:22",
                 "ordered_sum": "amgx_tpu/ops/spmv.py:49"})
SOURCES.update({"gs_sweep": "gs.cu", "qr_solve": "dense.cu",
                "ordered_sum": "segment.cu"})
REPLACES.update({"dia_spmv_multi": "amgx_tpu/ops/batched.py:35",
                 "dia_step_multi": "amgx_tpu/ops/batched.py:79",
                 "dia_step_mf_multi": "amgx_tpu/ops/stencil.py:268",
                 "csr_spmv_multi": "amgx_tpu/ops/spmv.py:118",
                 "csr_step_multi": "amgx_tpu/ops/smooth.py:292"})
SOURCES.update({"dia_spmv_multi": "dia.cu", "dia_step_multi": "dia.cu",
                "dia_step_mf_multi": "dia.cu", "csr_spmv_multi": "csr.cu",
                "csr_step_multi": "csr.cu"})
# the counters of each tiled kernel's other routes (the per-step route
# where the tiled kernel does not take a level, the untiled restriction
# after tiled steps): the kernels line lists their launches by path
ROUTE_COUNTERS = {
    "dia_smooth": ("dia_smooth_step",),
    "dia_smooth_bf16": ("dia_smooth_step_bf16",),
    "dia_smooth_mf": ("dia_smooth_mf_step",),
    "dia_smooth_mf_bf16": ("dia_smooth_mf_step_bf16",),
    "dia_smooth_restrict": ("dia_smooth_restrict_step",
                            "dia_smooth_restrict_epilogue"),
    "dia_prolong_smooth": ("dia_prolong_smooth_step",),
    "dia_prolong_smooth_dot": ("dia_prolong_smooth_step_dot",),
    "dia_smooth_restrict_bf16": ("dia_smooth_restrict_step_bf16",
                                 "dia_smooth_restrict_epilogue_bf16"),
    "dia_prolong_smooth_bf16": ("dia_prolong_smooth_step_bf16",),
    "dia_smooth_restrict_mf": ("dia_smooth_restrict_mf_step",
                               "dia_smooth_restrict_mf_epilogue"),
    "dia_prolong_smooth_mf": ("dia_prolong_smooth_mf_step",),
    "dia_prolong_smooth_mf_dot": ("dia_prolong_smooth_mf_step_dot",),
}
# pins the slab route on a path that exists to drive the slab kernels
# (the card's default, matrix_free=auto, is matrix-free)
SLAB = ", amg:matrix_free=0"
# the reduced-precision flagship: the inner AMG cycle in bfloat16 (the
# JAX package's bench_precision pairs it with the float flagship)
BF16 = ", solve_precision=bfloat16"
# Its inner FGMRES iterations, n -> (float32, bf16), on the 7-pt n^3
# Poisson with b = 1 (tools/flagship_anchors.py, both packages on the
# CPU): the JAX package's Pallas route (its kernels under the
# interpreter), whose float32 counts the port's CPU route equals at
# every size (and its bf16 ones at 16^3; 14 and 23 at 32^3 and 64^3, one
# fewer: the bf16 pass-2 count turns on a defect at float32 rounding),
# and its XLA route, which rounds the state to bf16 at every step.
BF16_PALLAS_ANCHORS = {16: (10, 10), 32: (14, 15), 64: (21, 24),
                       96: (27, 30), 112: (30, 34)}
BF16_XLA_ANCHORS = {16: (10, 19), 32: (14, 42), 64: (21, 97)}
# The card's bf16 run is held to the Pallas route's count at 64^3 and to
# the port's CPU route on the same input at 128^3, which the anchors do
# not reach (+-1 each: fused multiply-adds). Its bf16 / float32 inner
# ratio is bounded between the two rounding semantics, at the geometric
# mean of the Pallas route's largest ratio and the per-step route's
# smallest.
BF16_INNER_RATIO = float(np.sqrt(
    max(b / f for f, b in BF16_PALLAS_ANCHORS.values())
    * min(b / f for f, b in BF16_XLA_ANCHORS.values())))
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
# the same with the AMG cycle in bfloat16 (the hierarchy set up in
# float64, its solve data cast: bf16 B3w / B4w on level 0, bf16 B9 and
# B8 on the CSR levels, the coarsest level float32)
CLASSICAL_BF16 = CLASSICAL.replace(", amg:amg_precision=float",
                                   ", amg:amg_precision=bfloat16")
# the same PCG + classical AMG block on a float32 operator without
# amg_precision: the hierarchy and the Krylov shell are float32, so the
# cycle carries PCG's r.z through B4w's x'.b epilogue on level 0
CLASSICAL_F32 = CLASSICAL.replace(", amg:amg_precision=float", "")


# Queue A item 8's paths (phase_item8): label -> (configuration, grid
# edge, dtype). A configuration is a string, or "file:NAME:k=v,..." for
# configs/NAME.json with the keys set in its AMG scope. At 128^3 the
# classical block of CLASSICAL with the ENERGYMIN level and CR (EM),
# AFFINITY strength (AY) or the device RS sweep (RSW), and the stock
# PCG_AGGREGATION_JACOBI with PARALLEL_GREEDY (PG: SIZE_2's matching, so
# agg-pcg's hierarchy) or ADAPTIVE (AV); at 64^3, each with the JAX
# package's anchor (`ITEM8_ANCHORS`), EM in float64 (EM64) and with PMIS
# (EMp), PCG in float32 around the AMG block of
# tests/test_smoothers_extra.py (AGGREGATION, SIZE_2, 2 + 2 sweeps) with
# each new smoother (PY, KZ, KM / KMn colored / naive KACZMARZ, IL0 / IL1
# MULTICOLOR_ILU at sparsity 0 / 1 on a distance-2 coloring; a smoother
# named without a scope reads its options in the default scope), and
# CF_JACOBI as CLASSICAL's smoother (CJ); at 32^3, serial by design, GS
# as that smoother (GS32) and SERIAL_GREEDY (GR).
ITEM8_EM = CLASSICAL.replace("amg:algorithm=CLASSICAL",
                             "amg:algorithm=ENERGYMIN,"
                             " amg:energymin_selector=CR")
ITEM8_SMOOTHED = (
    "config_version=2, solver(s)=PCG, s:max_iters=200,"
    " s:tolerance=1e-6, s:convergence=RELATIVE_INI_CORE,"
    " s:monitor_residual=1, s:preconditioner(amg)=AMG,"
    " amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:presweeps=2,"
    " amg:postsweeps=2, amg:max_iters=1, amg:smoother=")
ITEM8 = {
    "EM": (ITEM8_EM, 128, "float64"),
    "AY": (CLASSICAL + ", amg:strength=AFFINITY", 128, "float64"),
    "RSW": (CLASSICAL.replace("amg:selector=PMIS", "amg:selector=RS,"
                              " amg:selector_device_sweep=1"), 128,
            "float64"),
    "PG": ("file:PCG_AGGREGATION_JACOBI:selector=PARALLEL_GREEDY", 128,
           "float32"),
    "AV": ("file:PCG_AGGREGATION_JACOBI:selector=ADAPTIVE", 128, "float32"),
    "EM64": (ITEM8_EM.replace(", amg:amg_precision=float", ""), 64,
             "float64"),
    "EMp": (ITEM8_EM.replace("energymin_selector=CR",
                             "energymin_selector=PMIS"), 64, "float64"),
    "PY": (ITEM8_SMOOTHED + "POLYNOMIAL", 64, "float32"),
    "KZ": (ITEM8_SMOOTHED + "KPZ_POLYNOMIAL", 64, "float32"),
    "KM": (ITEM8_SMOOTHED + "KACZMARZ", 64, "float32"),
    "KMn": (ITEM8_SMOOTHED + "KACZMARZ, kaczmarz_coloring_needed=0", 64,
            "float32"),
    "IL0": (ITEM8_SMOOTHED + "MULTICOLOR_ILU, coloring_level=2", 64,
            "float32"),
    "IL1": (ITEM8_SMOOTHED + "MULTICOLOR_ILU, coloring_level=2,"
            " ilu_sparsity_level=1", 64, "float32"),
    "CJ": (CLASSICAL.replace("amg:smoother=JACOBI_L1",
                             "amg:smoother=CF_JACOBI"), 64, "float64"),
    "GS32": (ITEM8_SMOOTHED + "GS", 32, "float32"),
    "GR": ("file:PCG_AGGREGATION_JACOBI:selector=SERIAL_GREEDY,"
           "aggregate_size=4", 32, "float32"),
}


def item8_config(Config, label):
    """ITEM8[label]'s configuration as a `Config` (the port's or the JAX
    package's class)."""
    text = ITEM8[label][0]
    if not text.startswith("file:"):
        return Config.from_string(text)
    _, name, sets = text.split(":", 2)
    cfg = Config.from_file(os.path.join(ROOT, "configs", name + ".json"))
    for kv in sets.split(","):
        key, value = kv.split("=")
        cfg.set(key, value, scope="amg")
    return cfg


# AmgX's stock pairwise-aggregation configurations, read verbatim from
# configs/ (SIZE_2 matching, BLOCK_JACOBI post-smoothing, NOSOLVER at
# the coarsest level), and their anchors: the JAX package on the CPU on
# the 7-pt 128^3 Poisson in float32 with b = 1 (iterations; the levels'
# rows, finest first, the coarsest operator last); the PCG run again
# after a structure-reuse resetup on `scaled_values` (63 iterations)
AGG_CONFIGS = {"agg-pcg": "configs/PCG_AGGREGATION_JACOBI.json",
               "agg-fgmres": "configs/FGMRES_AGGREGATION_JACOBI.json"}
AGG_ANCHORS = {"agg-pcg": 51, "agg-fgmres": 41}
AGG_RESETUP_ANCHOR = 63
AGG_ROWS_128 = [2097152, 962648, 454882, 216790, 103697, 49611, 23775,
                11411, 5469, 2622, 1257, 602, 288, 136, 65]
AGG_ROWS_64 = [262144, 120263, 56799, 27033, 12901, 6171, 2947, 1418, 678,
               324, 157, 75]


# The standalone AMG multicolor files end at max_iters in float32 at 32^3
# and beyond; their final monitored residual is held to the anchor's
# within MC_FINAL_TOL, set before the first card run from the port's CPU
# route against the JAX package (tools/jax_anchors.py with and without
# --port): AGGREGATION_DILU / _GS / _THRUST_GS differ by +2.1 / -2.0 /
# +0.8 % at 32^3 and -0.2 / -0.8 / -0.7 % at 64^3, so 5 % is more than
# twice the largest spread.
MC_FINAL_TOL = 0.05
# their float32 size: 64^3 (at 128^3 they took ~55 s of the script at
# max_iters, which its later phases need)
MC_SIZE = 64
# the JAX package's float32 V-cheby-smoother at 64^3 (tools/jax_anchors.py),
# recorded beside the card's run and not held: it diverges
VCHEBY_F32_64 = dict(iterations=63, status="nan_detected",
                     levels=[262144, 81948, 10432, 1241, 208, 65])
# IDR(1) with one DILU sweep is chaotic in rounding at 64^3: the two
# packages' float64 histories agree to 1e-10 for 4 iterations, then part
# (2.5e-6 at the 7th, 2 % at the 10th), and the counts move with the
# reduction order alone -- the JAX package 49 (f32) / 52 (f64), the
# port's CPU route 48 or 52 with 4 or 3 threads (its (n, s) products'
# split) and 51 in f64 (tools/jax_anchors.py [--port]). The count is
# held within IDR_ITER_TOL of the anchor's, and the true residual, where
# float32 IDR stagnates (the anchor's 1.51e-4), to at most twice it.
IDR_ITER_TOL = 6
IDR_TRUE_MAX = 2 * 1.512773200610368e-04

# AmgX's stock BiCGStab / GMRES / Chebyshev files, read verbatim from
# configs/, and their anchors: the JAX package on the CPU
# (tools/jax_anchors.py) on the 7-pt n^3 Poisson with b = 1 in float32,
# (file, n) -> iterations, status, the final monitored residual relative
# to the initial one, the level rows (finest first, the coarsest operator
# last); its krylov_fusion 1 and 0 give the same bits there. A run that
# ends at max_iters holds its final residual to the anchor's to 1 %,
# unless the anchor records `final_f64`, the reference's own float64 run,
# beyond 1 % of it: then the value is not the algorithm's
# (unpreconditioned BiCGStab on 2M rows: rounding differences grow by
# orders of magnitude over 100 iterations, in float64 too) and the run
# holds its monitored residual to its own true one instead. The classical
# files anchor at 64^3: the JAX package's 128^3 classical setup outgrows
# the host. GMRES_AMG_D2's levels are not held: the anchors come from the
# JAX package's host route, whose D2 truncation sums in float64 (the port
# has the bits of its device route, the one a TPU runs, 1-2 ulps apart),
# and at a strength-threshold tie an ulp flips a connection, so from level
# 2 its 64^3 hierarchy differs (10435 against 10443 rows) while the
# iterations agree. The W cycle runs
# at 64^3 only: at 128^3 SIZE_2 builds 14 levels and one W cycle visits
# the coarsest 2^13 times, ~19 host launches a CSR level visit.
KRYLOV_ANCHORS = {
    ("PBICGSTAB_CLASSICAL_JACOBI", 64): dict(
        iterations=6, status="success", final=1.450827653570741e-07,
        levels=[262144, 81948, 9371, 758, 83]),
    ("PBICGSTAB_NOPREC", 128): dict(
        iterations=100, status="max_iters", final=0.0672610872133793,
        levels=None, final_f64=0.0032465820828293237),
    ("PBICGSTAB_AGGREGATION_W_JACOBI", 64): dict(
        iterations=7, status="success", final=6.986053904256551e-07,
        levels=[262144, 120263, 56799, 27033, 12901, 6171, 2947, 1418,
                678, 324, 157, 75]),
    ("GMRES_AMG_D2", 64): dict(
        iterations=12, status="success", final=4.38199577956766e-07,
        levels=None),
    ("agg_cheb4", 128): dict(
        iterations=100, status="max_iters", final=0.27869380676495703,
        levels=[2097152, 213833, 23363, 2561, 286, 31]),
    # the multicolor files (phase_multicolor); FGMRES_AGGREGATION is
    # FGMRES_AGGREGATION_DILU in content
    ("FGMRES_AGGREGATION_DILU", 128): dict(
        iterations=26, status="success", final=6.395664270216877e-07,
        levels=AGG_ROWS_128),
    ("FGMRES_AGGREGATION", 64): dict(
        iterations=15, status="success", final=7.719532959526987e-07,
        levels=AGG_ROWS_64),
    ("IDR_DILU", 64): dict(iterations=49, status="success",
                           final=9.229181614500703e-07, levels=None,
                           iter_tol=IDR_ITER_TOL, true_max=IDR_TRUE_MAX),
    ("IDRMSYNC_DILU", 64): dict(iterations=49, status="success",
                                final=9.229181614500703e-07, levels=None,
                                iter_tol=IDR_ITER_TOL,
                                true_max=IDR_TRUE_MAX),
    # run at MC_SIZE (64^3; the 128^3 anchors were 7.932e-4,
    # 6.006e-3, 6.198e-4 over AGG_ROWS_128)
    ("AGGREGATION_DILU", 64): dict(
        iterations=100, status="max_iters", final=1.6568810679018497e-05,
        levels=AGG_ROWS_64, final_tol=MC_FINAL_TOL),
    ("AGGREGATION_GS", 64): dict(
        iterations=100, status="max_iters", final=2.9411334253381938e-05,
        levels=AGG_ROWS_64, final_tol=MC_FINAL_TOL),
    ("AGGREGATION_THRUST_GS", 64): dict(
        iterations=100, status="max_iters", final=1.3010801012569573e-05,
        levels=AGG_ROWS_64, final_tol=MC_FINAL_TOL),
    ("PCG_DILU", 128): dict(iterations=16, status="success",
                            final=9.28464328639852e-07, levels=None),
    # DIAGONAL_SYMMETRIC + classical D2 + CHEBYSHEV diverges at 64^3 in the
    # JAX package, in float64 too (the port's CPU route gives the same
    # residual to 12 digits); 32^3 converges (32 iterations)
    ("V-cheby-smoother", 64, "float64"): dict(
        iterations=100, status="max_iters", final=15158839380.477266,
        levels=[262144, 81948, 10573, 1213, 194, 55]),
    ("AGGREGATION_DILU", 32, "float64"): dict(
        iterations=44, status="success", final=7.392525243955635e-07,
        levels=None),
    ("AGGREGATION_GS", 32, "float64"): dict(
        iterations=61, status="success", final=8.246370257572014e-07,
        levels=None),
    ("AGGREGATION_THRUST_GS", 32, "float64"): dict(
        iterations=42, status="success", final=8.25617522662711e-07,
        levels=None),
}


# The aggressive coarsening and K-cycle files (phase_aggressive_kcycle),
# read verbatim: the JAX package's anchors on the 7-pt n^3 Poisson with b
# = 1 (tools/jax_anchors.py; float32 unless keyed "float64"). The main
# path's level rows at 64^3 are the port's CPU route's
# (tools/jax_anchors.py --port; the JAX package's part from level 3,
# below). In
# float32 the K-cycle files end at max_iters on float32's rounding floor
# (the float64 runs converge: their iterations are held exactly); their
# final monitored residual is held to the anchor's within
# KCYCLE_FINAL_TOL, set before the first card run from the port's CPU
# route against the JAX package at 32^3 and 64^3 (PERF.md section 2).
# The spreads, port against JAX, AMG_CLASSICAL_CG / _CGF /
# AMG_AGGRREGATION_CG: -2.5 / +0.5 / +0.7 % at 32^3, +0.5 / -0.2 / -0.7 %
# at 64^3, so 6 % is more than twice the largest. (AMG_CLASSICAL_CG at
# 128^3 left the script as a depth cut: PERF.md section 6.)
# The JAX package's float32 aggressive hierarchies part from the port's
# from level 3 at 64^3: its host D2 route sums the truncation in float64
# (ROADMAP Queue C); its device route gives the port's rows.
KCYCLE_FINAL_TOL = 0.06
KRYLOV_ANCHORS.update({
    ("FGMRES_CLASSICAL_AGGRESSIVE_PMIS", 64): dict(
        iterations=15, status="success", final=8.269793738691078e-07,
        levels=[262144, 30216, 9647, 1363, 179, 41]),
    ("FGMRES_CLASSICAL_AGGRESSIVE_HMIS", 64): dict(
        iterations=15, status="success", final=8.563295637031842e-07,
        levels=None),
    ("PCG_CLASSICAL_V_JACOBI", 64): dict(
        iterations=22, status="success", final=8.029768423511996e-07,
        levels=None),
    ("AMG_CLASSICAL_CG", 64): dict(
        iterations=100, status="max_iters", final=2.5878904125420377e-05,
        levels=[262144, 81948, 9371, 758, 83], final_tol=KCYCLE_FINAL_TOL),
    ("AMG_CLASSICAL_CGF", 64): dict(
        iterations=100, status="max_iters", final=2.6005787731264718e-05,
        levels=[262144, 81948, 9371, 758, 83], final_tol=KCYCLE_FINAL_TOL),
    ("AMG_AGGRREGATION_CG", 64): dict(
        iterations=100, status="max_iters", final=2.5067731257877313e-05,
        levels=[262144, 56435, 12808, 2922, 677, 155, 35],
        final_tol=KCYCLE_FINAL_TOL),
    ("AMG_CLASSICAL_CG", 32, "float64"): dict(
        iterations=21, status="success", final=7.82e-07, levels=None),
    ("AMG_CLASSICAL_CGF", 32, "float64"): dict(
        iterations=21, status="success", final=7.82e-07, levels=None),
    ("AMG_AGGRREGATION_CG", 32, "float64"): dict(
        iterations=43, status="success", final=8.28e-07, levels=None),
})


def agg_config(Config, name, reuse=None):
    """One stock aggregation configuration as a `Config` (the port's or
    the JAX package's class), with structure_reuse_levels=`reuse` set on
    top in the AMG scope when given."""
    cfg = Config.from_file(os.path.join(ROOT, AGG_CONFIGS[name]))
    if reuse is not None:
        cfg.set("structure_reuse_levels", reuse, scope="amg")
    return cfg


def agg_bf16_config(Config, name):
    """A stock aggregation file with amg_precision=bfloat16 set in its
    AMG scope (the Krylov shell stays float32)."""
    cfg = agg_config(Config, name)
    cfg.set("amg_precision", "bfloat16", scope="amg")
    return cfg


def scaled_values(row_offsets, col_indices, values):
    """The values of A2 = D A D for the resetup checks, numpy float32:
    the same pattern, symmetrically scaled (SPD when A is), with D = 1 +
    0.5 U[0, 1) from numpy's default_rng(0)."""
    ro, ci = np.asarray(row_offsets), np.asarray(col_indices)
    n = ro.shape[0] - 1
    rng = np.random.default_rng(0)
    d = (1 + 0.5 * rng.random(n)).astype(np.float32)
    rows = np.repeat(np.arange(n), np.diff(ro))
    return ((d[rows] * np.asarray(values, np.float32)) * d[ci]).astype(
        np.float32)


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


def tb_forms(lines):
    """nvcc's resource lines of csrc/stencil_tb.cu and stencil_tb_slab.cu
    (the kernels of csrc/stencil_tb.cuh) by kernel form: the
    demangled template arguments of tb_star_kernel (storage type, x's
    type, dinv, applications, in-tile residual, value source: 0
    coefficients, 1 the slab's ring) -> "N registers, spills". The
    mangled name where c++filt is missing."""
    names = [ln.split(":", 1)[0] for ln in lines]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = names
    forms = {}
    for name, ln in zip(out, lines):
        key, at = name, name.find("tb_star_kernel<")
        if at >= 0:            # the first template argument list
            depth, i = 0, at + len("tb_star_kernel")
            for i in range(i, len(name)):
                depth += {"<": 1, ">": -1}.get(name[i], 0)
                if depth == 0:
                    break
            key = name[at + len("tb_star_kernel<"):i]
        regs = ln.split(":", 1)[1].split(",")[0].strip()
        spill = [p.strip() for p in ln.split(",") if "spill stores" in p]
        forms[key.replace("__nv_bfloat16", "bf16")] = \
            regs + (", " + spill[0] if spill else "")
    return forms


T_START = time.perf_counter()
# seconds by phase: the time from one phase row to the next goes to the
# later row's phase (a row is emitted when its work is done)
PHASE_SECONDS = {}
_LAST_ROW = [T_START]


def emit(obj):
    """One JSON line on stdout; a phase's row also gets the seconds since
    the script started (`t_s`: where a run's time goes), which
    PHASE_SECONDS sums by phase for the done line."""
    if "phase" in obj:
        now = time.perf_counter()
        PHASE_SECONDS[obj["phase"]] = PHASE_SECONDS.get(obj["phase"], 0.0) \
            + now - _LAST_ROW[0]
        _LAST_ROW[0] = now
        obj = {**obj, "t_s": round(now - T_START, 3)}
    print(json.dumps(obj), flush=True)


# wall seconds of each phase function (`timed_phase`), and when the
# script dumps its threads' stacks to stderr (its limit is 1200 s)
FUNCTION_SECONDS = {}
WATCHDOG_S = 1100


def timed_phase(fn, *args):
    """Run one phase function: its start goes to stderr (the progress of
    a run whose stdout is not seen), its wall seconds to
    FUNCTION_SECONDS."""
    t0 = time.perf_counter()
    print(f"chip_smoke: {fn.__name__} at {t0 - T_START:.1f} s",
          file=sys.stderr, flush=True)
    out = fn(*args)
    FUNCTION_SECONDS[fn.__name__] = time.perf_counter() - t0
    return out


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


def device_ms(torch, fn, launches, batch=BATCH):
    """(milliseconds of device time per call, device records seen): the
    kernels' and copies' durations under torch.profiler (CUPTI) over
    `batch` calls, so the host's launch cost is left out even where it
    is the slower side (`time_ms` then measures the host). The time is
    None when the profiler records no device activity or fewer kernel
    records than the `launches` per call the wrappers counted: a
    profile that lost records would understate the time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(batch):
            fn()
        torch.cuda.synchronize()
    recs = [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(ev.time_range.elapsed_us() for ev in recs)
    kernels = sum(not ev.name.startswith(("Memcpy", "Memset"))
                  for ev in recs)
    if us <= 0 or kernels < launches * batch:
        return None, len(recs)
    return us * 1e-3 / batch, len(recs)


def bound(nbytes, flops, peak=PEAK_F32_S):
    """(ms, what bounds it): the least time the card could take, its
    operations at `peak` per second."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak
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
    """The flagship finest-level operands on an nx x ny x nz grid
    (level_case on the 7-pt operator in float32)."""
    return level_case(torch, amgx, amgx.gallery.poisson(
        "7pt", *shape, dtype=torch.float32, device=dev).init(), dev, 1234)


def level_case(torch, amgx, A, dev, seed):
    """(A, xfer, taus, b, x, xc) on a grid operator A: its GEO transfer
    tables, the taus of the smoother FLAGSHIP builds for it (its scoping
    gives CHEBYSHEV_POLY the default order 5:
    `amg:chebyshev_polynomial_order=2` is not in the smoother's scope),
    and seeded random vectors."""
    from amgx_tpu_torch.ops.smooth import build_transfer_tables
    from amgx_tpu_torch.presets import FLAGSHIP_TAIL_OFF
    from amgx_tpu_torch.solvers.base import make_solver
    n = A.num_rows
    cfg = amgx.Config.from_string(FLAGSHIP_TAIL_OFF)
    _, scope = cfg.get_solver("preconditioner")            # FGMRES
    _, scope = cfg.get_solver("preconditioner", scope)     # AMG
    sel = amgx.amg.aggregation.selectors.GeoSelector(cfg, scope)
    agg, nc = sel.set_aggregates(A)
    xfer = build_transfer_tables(A, agg, nc)
    name, sm_scope = cfg.get_solver("smoother", scope)
    smoother = make_solver(name, cfg, sm_scope, device=dev)
    taus = smoother.setup(A).solve_data()["taus"]
    g = torch.Generator(device=dev).manual_seed(seed)
    b, x = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    xc = torch.randn(nc, generator=g, device=dev)
    return A, xfer, taus, b, x, xc


def coarse_level(torch, amgx, n, dev, dad=False):
    """The flagship's GEO level 1 at n^3: the Galerkin 7-pt operator of
    (n/2)^3 from the card's setup (the slab route, so that the level
    keeps its value slab for the slab rows); of D A D with `dad`."""
    from amgx_tpu_torch.presets import FLAGSHIP_TAIL_OFF
    A0 = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                              device=dev).init()
    if dad:
        A0 = dad_operator(torch, A0)
    return amg_of(amgx, FLAGSHIP_TAIL_OFF + SLAB, A0, dev).amg.levels[1].A


def dad_operator(torch, A):
    """A2 = D A D (`scaled_values`) in A's dtype and on its device: the
    same grid and pattern, a distinct value in every stored entry (and 0
    off the grid), so no level of its hierarchy is a constant stencil."""
    return A.with_values(torch.from_numpy(scaled_values(
        A.row_offsets.cpu(), A.col_indices.cpu(), A.values.cpu())).to(
            device=A.device, dtype=A.values.dtype))


def slab_step_route(K, vals, offs, taus, b, x, dinv=None, ctab=None,
                    xc=None, agg=None, with_dot=False):
    """Slab B3 (with `ctab`) or B4 through the per-step route, to hold and
    time beside the tiled launches in one run: the wrappers without the
    level's grid (one dia.cu launch a step, "dia_smooth_restrict_step" /
    "dia_prolong_smooth_step(_dot)", and B3's untiled restriction,
    "dia_smooth_restrict_epilogue"). Every slab call took this route
    before the tiled kernel."""
    if ctab is not None:
        return K.dia_smooth_restrict(vals, offs, taus, b, x, ctab, dinv)
    return K.dia_prolong_smooth(vals, offs, taus, b, x, xc, agg, dinv,
                                with_dot=with_dot)


def slab_cases(torch, K, A, xfer, taus, b, x, xc, full=True):
    """The temporally blocked slab B3 and B4 on the level A (a
    random-valued slab: D A D or its Galerkin level), as the flagship
    (CHEBYSHEV_POLY's five steps) and PCG (JACOBI_L1's dinv: one
    presweep, two postsweeps at 0.75, B4 with its x'.b) call them, in
    float32 and bf16 (the level's slab, dinv and vectors rounded, taus
    float32): (label suffix, name) -> (kernel call, plain call, bytes,
    flops, launches per call, None, launches by counter, (the per-step
    route's call, its launches), extra). bytes: each input read once and
    each output written once (bf16 streams at 2 bytes); extra's
    bound_launches_ms: what the planned launches move at least (each
    streams the slab, dinv and b, the first reads x (xc, agg), each later
    one the float32 state the one before wrote, the last writes x' and
    bc). PCG's JACOBI_L1 schedule (with dinv) in bf16 on every level,
    in float32 for B4's dot on every level and for B3 / B4 with `full`
    only."""
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    bf = torch.bfloat16
    offs, grid = A.dia_offsets, A.grid_shape
    n, k = A.num_rows, len(offs)
    ctab, agg = xfer["ctab"], xfer["agg"]
    m, nc = ctab.shape
    dinv32 = safe_recip(l1_strengthened_diag(A))
    out = {}
    for dt in (torch.float32, bf):
        es = 2 if dt == bf else 4
        vals, b_, x_, xc_ = (v.to(dt) for v in (A.dia_vals, b, x, xc))
        tag = "_bf16" if dt == bf else ""
        for sched, t, dinv in (
                ("chebyshev", taus.to(dt).float(), None),
                ("jacobi_l1", torch.full((2,), 0.75, device=x.device),
                 dinv32.to(dt))):
            dn = 0 if dinv is None else n
            app = (2 * k + 3 + (dinv is not None)) * n
            forms = (("dia_smooth_restrict", t[:1] if dinv is not None
                      else t, ctab, False),
                     ("dia_prolong_smooth", t, None, False))
            if dinv is not None and dt == torch.float32 and not full:
                forms = ()          # PCG's float32 B3 / B4: with `full`
            if dt == torch.float32 and dinv is not None:
                forms += (("dia_prolong_smooth_dot", t, None, True),)
            for name, tt, ct, dot in forms:
                s = tt.shape[0]
                route, plans, _ = K.slab_route(vals, offs, grid, dinv, x_,
                                               s, ct)
                check(route == "tiled", f"{name}{tag}: the tiled route "
                      f"takes the level {grid}, not {route}")
                last = name + tag
                moved = {name + tag: len(plans)}
                if dot:
                    moved = {"dia_prolong_smooth": len(plans) - 1,
                             "dia_prolong_smooth_dot": 1}
                    moved = {kk: v for kk, v in moved.items() if v}
                streams = (k * n + dn) * es + n * es     # vals, dinv, b
                moves = len(plans) * streams + n * es + 4 * n * 2 * (
                    len(plans) - 1) + n * es
                if ct is not None:
                    kern = (lambda v=vals, tt=tt, d=dinv, b_=b_, x_=x_:
                            K.dia_smooth_restrict(v, offs, tt, b_, x_,
                                                  ctab, d, grid=grid))
                    plain = (lambda v=vals, tt=tt, d=dinv, b_=b_, x_=x_:
                             K.dia_smooth_restrict_plain(v, offs, tt, b_,
                                                         x_, ctab, d))
                    old = (lambda v=vals, tt=tt, d=dinv, b_=b_, x_=x_:
                           slab_step_route(K, v, offs, tt, b_, x_, d,
                                           ctab=ctab))
                    nbytes = (k * n + dn + 3 * n + nc) * es + s * 4 \
                        + m * nc * 4
                    flops = s * app + (2 * k + 2) * n
                    moves += m * nc * 4 + nc * es
                else:
                    kern = (lambda v=vals, tt=tt, d=dinv, b_=b_, x_=x_,
                            xc_=xc_, dot=dot:
                            K.dia_prolong_smooth(v, offs, tt, b_, x_, xc_,
                                                 agg, d, with_dot=dot,
                                                 grid=grid))
                    plain = (lambda v=vals, tt=tt, d=dinv, b_=b_, x_=x_,
                             xc_=xc_, dot=dot:
                             K.dia_prolong_smooth_plain(v, offs, tt, b_,
                                                        x_, xc_, agg, d,
                                                        with_dot=dot))
                    old = (lambda v=vals, tt=tt, d=dinv, b_=b_, x_=x_,
                           xc_=xc_, dot=dot:
                           slab_step_route(K, v, offs, tt, b_, x_, d,
                                           xc=xc_, agg=agg, with_dot=dot))
                    nbytes = (k * n + dn + 3 * n + nc) * es + s * 4 \
                        + n * 4 + (4 if dot else 0)
                    flops = s * app + n + (2 * n if dot else 0)
                    moves += nc * es + n * 4
                out[sched, last] = (
                    kern, plain, nbytes, flops, len(plans), None, moved,
                    (old, s + (ct is not None)),
                    {"bound_launches_ms": bound(moves, flops)[0],
                     "split": [p.apps for p in plans],
                     "tiles": [[*p.tile, p.chunk, p.blocks, p.threads,
                                p.smem_bytes] for p in plans],
                     "ring_floats": plans[0].ring})
    return out


def slab_cycle_launches(torch, K, slv, levels):
    """(B3 launches, B4 launches) of one V-cycle on the slab levels
    `levels` of a solver's hierarchy, each asked of `K.slab_route` on the
    cycle's own level data (its dtype, its smoother's schedule): checks
    that each is the tiled route and counts the planned launches."""
    amg = precond_amg(slv)
    data = amg.solve_data()["levels"]
    n3 = n4 = 0
    for i in levels:
        ld = data[i]
        A, smd = ld["A"], ld["smoother"]
        # CHEBYSHEV_POLY: its taus a sweep; the Jacobi family: one step
        # a sweep with its dinv
        per_sweep = smd["taus"].shape[0] if "taus" in smd else 1
        x = torch.zeros(A.num_rows, dtype=A.dia_vals.dtype, device=A.device)
        for pre in (True, False):
            s = per_sweep * amg._sweeps(i, pre=pre)
            route, plans, _ = K.slab_route(
                A.dia_vals, A.dia_offsets, A.grid_shape, smd.get("dinv"), x,
                s, ld["xfer"]["ctab"] if pre else None)
            check(route == "tiled", f"level {i} ({A.grid_shape}): the slab "
                  f"{'B3' if pre else 'B4'} takes the {route} route")
            if pre:
                n3 += len(plans)
            else:
                n4 += len(plans)
    return n3, n4


def kernel_cases(torch, K, A, xfer, taus, b, x, xc):
    """name -> (kernel call, plain call, bytes, flops, launches per call,
    library call or None) at one shape (B1, B2 and the coefficient mode;
    the slab B3 / B4 are `slab_cases`), name -> the slab kernel's call
    on the same level for each coefficient-mode kernel (B2-B4 tiled:
    the level's grid), and name -> (the per-step route's call, its
    launches per call) for the temporally blocked B2, B2-mf, B3-mf and
    B4-mf (`smooth_step_route`, `step_route`). The coefficient kernels
    take the level's stencil: CHEBYSHEV_POLY's (no dinv) for B2-B4-mf,
    JACOBI_L1's ("l1") with PCG's two steps for B4-mf's dot."""
    from amgx_tpu_torch.ops import stencil as mf
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    vals, offs = A.dia_vals, A.dia_offsets
    n, k = A.num_rows, len(offs)
    m, nc = xfer["ctab"].shape
    s = taus.shape[0]
    app = (2 * k + 3) * n                  # flops of one damped step
    csr = torch.sparse_csr_tensor(A.row_offsets, A.col_indices, A.values,
                                  (n, n), check_invariants=True)
    st = mf.detect_stencil(A)
    st_l1 = mf.detect_stencil(A, dinv_mode="l1")
    check(st is not None and st_l1 is not None, "the 7-pt level is a stencil")
    dinv = safe_recip(l1_strengthened_diag(A))
    t2 = torch.full((2,), 0.75, device=x.device)
    grid = A.grid_shape
    # B2's and B2-mf's tiled launches (the planner's split)
    n2 = len(K.smooth_plans(vals, offs, grid, None, x, s, True))
    n2mf = len(K.mf_smooth_plans(st, x, s, True))
    cases = {
        "dia_spmv": (
            lambda: K.dia_spmv(vals, offs, x),
            lambda: K.dia_spmv_plain(vals, offs, x),
            (k + 2) * n * 4, 2 * k * n, 1, lambda: csr @ x),
        "dia_smooth": (
            lambda: K.dia_smooth(vals, offs, taus, b, x, grid=grid),
            lambda: K.dia_smooth_plain(vals, offs, taus, b, x),
            (k * n + 4 * n + s) * 4, s * app + 2 * k * n, n2, None),
        # the coefficient mode moves no slab and no dinv: k coefficients
        "dia_smooth_mf": (
            lambda: K.dia_smooth_mf(st, taus, b, x),
            lambda: mf._xla_smooth(st.spec(), st.coeffs, taus, b, x, True),
            (k + 4 * n + s) * 4, s * app + 2 * k * n, n2mf, None),
        "dia_smooth_restrict_mf": (
            lambda: K.dia_smooth_restrict_mf(st, taus, b, x, xfer["ctab"]),
            lambda: mf._xla_restrict(st.spec(), st.coeffs, taus, b, x,
                                     xfer["ctab"]),
            (k + 3 * n + s + m * nc + nc) * 4,
            s * app + (2 * k + 2) * n, 1, None),
        "dia_prolong_smooth_mf": (
            lambda: K.dia_prolong_smooth_mf(st, taus, b, x, xc, xfer["agg"]),
            lambda: mf._xla_corr(st.spec(), st.coeffs, taus, b, x, xc,
                                 xfer["agg"]),
            (k + 4 * n + s + nc) * 4, s * app + n, 1, None),
        "dia_prolong_smooth_mf_dot": (
            lambda: K.dia_prolong_smooth_mf(st_l1, t2, b, x, xc, xfer["agg"],
                                            with_dot=True),
            lambda: mf._xla_corr(st_l1.spec(), st_l1.coeffs, t2, b, x, xc,
                                 xfer["agg"], with_dot=True),
            (k + 4 * n + 2 + nc + 1) * 4, 2 * (2 * k + 4) * n + 3 * n, 1,
            None),
    }
    slab = {
        "dia_smooth_mf": lambda: K.dia_smooth(vals, offs, taus, b, x,
                                              grid=grid),
        "dia_smooth_restrict_mf": lambda: K.dia_smooth_restrict(
            vals, offs, taus, b, x, xfer["ctab"], grid=grid),
        "dia_prolong_smooth_mf": lambda: K.dia_prolong_smooth(
            vals, offs, taus, b, x, xc, xfer["agg"], grid=grid),
        "dia_prolong_smooth_mf_dot": lambda: K.dia_prolong_smooth(
            vals, offs, t2, b, x, xc, xfer["agg"], dinv, with_dot=True,
            grid=grid),
    }
    step = {
        "dia_smooth": (
            lambda: smooth_step_route(K, taus, b, x, vals=vals, offs=offs),
            s + 1),
        "dia_smooth_mf": (
            lambda: smooth_step_route(K, taus, b, x, st=st), s + 1),
        "dia_smooth_restrict_mf": (
            lambda: step_route(torch, K, st, taus, b, x, ctab=xfer["ctab"]),
            s + 1),
        "dia_prolong_smooth_mf": (
            lambda: step_route(torch, K, st, taus, b, x, xc=xc,
                              agg=xfer["agg"]), s),
        "dia_prolong_smooth_mf_dot": (
            lambda: step_route(torch, K, st_l1, t2, b, x, xc=xc,
                              agg=xfer["agg"], with_dot=True), 2),
    }
    return cases, slab, step


def smooth_step_route(K, taus, b, x, vals=None, offs=None, st=None,
                      dinv=None, with_residual=True):
    """B2 (the slab `vals`) or B2-mf (the stencil `st`) through the
    per-step route, to hold and time beside the tiled launches in one
    run: one dia.cu launch a damped step and its residual kernel
    ("dia_smooth_step", "dia_smooth_mf_step"). Every B2 call took this
    route before the tiled kernel; the package keeps it for the levels
    the tiled kernel does not take."""
    if st is None:                          # no grid: the per-step route
        return K.dia_smooth(vals, offs, taus, b, x, dinv, with_residual)
    return K._mf_smooth_steps(K._name("dia_smooth_mf_step", x), st, taus,
                              b, x, with_residual)


def step_route(torch, K, st, taus, b, x, ctab=None, xc=None, agg=None,
               with_dot=False):
    """B3-mf (with `ctab`) or B4-mf (with `xc`, `agg`) through the
    per-step route, to time beside the tiled kernel in one run: one
    dia.cu `amgx_dia_step_mf` launch a damped step, the state passed
    through float32 scratch, then `amgx_dia_restrict_mf` from the last
    step's float32 state. Every call took this route before the tiled
    kernel; the package keeps it for the levels and schedules the tiled
    kernel does not take (its "_step" counters). Returns what the
    wrapper returns."""
    name = "dia_smooth_restrict_mf_step" if ctab is not None \
        else "dia_prolong_smooth_mf_step"
    dot = K.dot_scratch(x.shape[0], x.device) if with_dot else None
    got = K._mf_steps(K._name(name, x), st, taus, b, x, xc=xc, agg=agg,
                      dot=dot, keep=ctab is not None)
    if ctab is None:
        return (got, dot[1]) if with_dot else got
    out, state = got
    bc = torch.empty(ctab.shape[1], dtype=x.dtype, device=x.device)
    K._mf_restrict(st, b, state, ctab, bc)
    return out, bc


def step_route_cases(torch, K, A, xfer, taus, b, x, xc):
    """B3-mf, B4-mf and B4-mf's dot on a level or schedule the tiled
    kernel does not take, where the wrappers launch the per-step route
    (and B2-mf there on a stencil it does not take): name -> (kernel
    call, plain call, bytes, flops, launches per call, None, the
    launches per counter a call makes)."""
    from amgx_tpu_torch.ops import stencil as mf
    st = mf.detect_stencil(A)
    st_l1 = mf.detect_stencil(A, dinv_mode="l1")
    check(st is not None and st_l1 is not None, "the level is a stencil")
    ctab, agg = xfer["ctab"], xfer["agg"]
    n, k, s = A.num_rows, st.k, taus.shape[0]
    m, nc = ctab.shape
    app = (2 * k + 3) * n
    out = {} if K.mf_smooth_plans(st, x, s, True) is not None else {
        "dia_smooth_mf": (
            lambda: K.dia_smooth_mf(st, taus, b, x),
            lambda: mf._xla_smooth(st.spec(), st.coeffs, taus, b, x, True),
            (k + 4 * n + s) * 4, s * app + 2 * k * n, s + 1, None,
            {"dia_smooth_mf_step": s + 1})}
    return {
        **out,
        "dia_smooth_restrict_mf": (
            lambda: K.dia_smooth_restrict_mf(st, taus, b, x, ctab),
            lambda: mf._xla_restrict(st.spec(), st.coeffs, taus, b, x, ctab),
            (k + 3 * n + s + m * nc + nc) * 4, s * app + (2 * k + 2) * n,
            s + 1, None, {"dia_smooth_restrict_mf_step": s,
                          "dia_smooth_restrict_mf_epilogue": 1}),
        "dia_prolong_smooth_mf": (
            lambda: K.dia_prolong_smooth_mf(st, taus, b, x, xc, agg),
            lambda: mf._xla_corr(st.spec(), st.coeffs, taus, b, x, xc, agg),
            (k + 4 * n + s + nc) * 4, s * app + n, s, None,
            {"dia_prolong_smooth_mf_step": s}),
        "dia_prolong_smooth_mf_dot": (
            lambda: K.dia_prolong_smooth_mf(st_l1, taus, b, x, xc, agg,
                                            with_dot=True),
            lambda: mf._xla_corr(st_l1.spec(), st_l1.coeffs, taus, b, x, xc,
                                 agg, with_dot=True),
            (k + 4 * n + s + nc + 1) * 4, s * (app + n) + 3 * n, s, None,
            {"dia_prolong_smooth_mf_step": s - 1,
             "dia_prolong_smooth_mf_step_dot": 1}),
    }


def slab_step_cases(torch, K, A, xfer, taus, b, x, xc):
    """The slab B2, B3, B4 and B4's dot on a level the tiled kernel does
    not take (here a 27-point one), where the wrappers launch the
    per-step route under its own counters: name -> (kernel call, plain
    call, bytes, flops, launches per call, None, the launches per counter
    a call makes)."""
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    vals, offs, grid = A.dia_vals, A.dia_offsets, A.grid_shape
    ctab, agg = xfer["ctab"], xfer["agg"]
    n, k, s = A.num_rows, len(offs), taus.shape[0]
    m, nc = ctab.shape
    app = (2 * k + 3) * n
    dinv = safe_recip(l1_strengthened_diag(A))
    check(K.slab_route(vals, offs, grid, None, x, s, ctab)[0] == "step"
          and K.smooth_plans(vals, offs, grid, None, x, s, True) is None,
          "the 27-point level takes the per-step route")
    return {
        "dia_smooth": (
            lambda: K.dia_smooth(vals, offs, taus, b, x, grid=grid),
            lambda: K.dia_smooth_plain(vals, offs, taus, b, x),
            (k * n + 4 * n + s) * 4, s * app + 2 * k * n, s + 1, None,
            {"dia_smooth_step": s + 1}),
        "dia_smooth_restrict": (
            lambda: K.dia_smooth_restrict(vals, offs, taus, b, x, ctab,
                                          grid=grid),
            lambda: K.dia_smooth_restrict_plain(vals, offs, taus, b, x,
                                                ctab),
            (k * n + 3 * n + s + m * nc + nc) * 4,
            s * app + (2 * k + 2) * n, s + 1, None,
            {"dia_smooth_restrict_step": s,
             "dia_smooth_restrict_epilogue": 1}),
        "dia_prolong_smooth": (
            lambda: K.dia_prolong_smooth(vals, offs, taus, b, x, xc, agg,
                                         grid=grid),
            lambda: K.dia_prolong_smooth_plain(vals, offs, taus, b, x, xc,
                                               agg),
            (k * n + 4 * n + s + nc) * 4, s * app + n, s, None,
            {"dia_prolong_smooth_step": s}),
        "dia_prolong_smooth_dot": (
            lambda: K.dia_prolong_smooth(vals, offs, taus, b, x, xc, agg,
                                         dinv, with_dot=True, grid=grid),
            lambda: K.dia_prolong_smooth_plain(vals, offs, taus, b, x, xc,
                                               agg, dinv, with_dot=True),
            (k * n + 5 * n + s + nc + 1) * 4, s * (app + n) + 3 * n, s,
            None, {"dia_prolong_smooth_step": s - 1,
                   "dia_prolong_smooth_step_dot": 1}),
    }


def synthesized_dinv(torch, K, A):
    """The diagonal inverse B2-mf synthesizes on the card ("jacobi" and
    "l1"), read out as one step from x = 0 with b = 1 and tau = 1, against
    the smoothers' own dinv (safe_recip of the diagonal and of the ordered
    l1_strengthened_diag): {mode: max |diff|}, expected 0."""
    from amgx_tpu_torch.ops.stencil import detect_stencil
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    one = torch.ones(A.num_rows, device=A.device)
    out = {}
    for mode, want in (("jacobi", safe_recip(A.diagonal())),
                       ("l1", safe_recip(l1_strengthened_diag(A)))):
        st = detect_stencil(A, dinv_mode=mode)
        got = K.dia_smooth_mf(st, torch.ones(1, device=A.device), one,
                              torch.zeros_like(one), with_residual=False)
        out[mode] = float((got - want).abs().max())
    return out


def bf16_kernel_cases(torch, K, A, xfer, taus, b, x, xc):
    """The bf16 forms of B2 and B2-mf..B4-mf at one shape (the slab B3 /
    B4 are `slab_cases`), as the bf16 flagship calls them: the level's slab, dinv, stencil coefficients and
    vectors rounded to bf16, taus float32. Two schedules: CHEBYSHEV_POLY's
    (the flagship's: its taus rounded to bf16 as the hierarchy's cast
    does, no dinv) and JACOBI_L1's (two steps at 0.75, with dinv).
    schedule -> name -> (kernel call, plain call, bytes, flops, launches
    per call, library call, {"bound_launches_ms": ...}).

    bytes: each input read once and each output written once, bf16
    streams at 2 bytes (the one-pass bound the TPU's temporal blocking
    attains). bound_launches_ms: the bytes the port's launch sequence
    moves at least -- each tiled B2 (and B2-mf) launch reads the slab,
    dinv and b, the first x, each later one the float32 state the one
    before wrote, the last writes x' and r; the one launch of B3-mf /
    B4-mf reads b, x (xc and agg; ctab and its row lists) and writes x'
    (bc). Every row carries, as an eighth entry, the per-step route's
    call and launches (`smooth_step_route`, `step_route`)."""
    from amgx_tpu_torch.amg.hierarchy import _cast_leaf
    from amgx_tpu_torch.ops import stencil as mf
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    bf = torch.bfloat16
    vals, offs = A.dia_vals.to(bf), A.dia_offsets
    n, k = A.num_rows, len(offs)
    m, nc = xfer["ctab"].shape
    b16, x16, xc16 = b.to(bf), x.to(bf), xc.to(bf)
    out = {}
    for sched, t, dinv, mode in (
            ("chebyshev", taus.to(bf).float(), None, None),
            ("jacobi_l1", torch.full((2,), 0.75, device=x.device),
             safe_recip(l1_strengthened_diag(A)).to(bf), "l1")):
        s = t.shape[0]
        st = _cast_leaf(mf.detect_stencil(A, dinv_mode=mode), bf)
        dn = 0 if dinv is None else n              # dinv entries
        app = (2 * k + 3 + (dinv is not None)) * n

        grid = A.grid_shape
        n2 = len(K.smooth_plans(vals, offs, grid, dinv, x16, s, True))
        n2mf = len(K.mf_smooth_plans(st, x16, s, True))

        def launches(kind, slab, calls=1):
            """bytes the port's launches move at least"""
            if not slab and kind == "B3":             # one tiled launch
                return 3 * n * 2 + m * nc * 4 + nc * 4 + nc * 2
            if not slab and kind == "B4":
                return 3 * n * 2 + nc * 2 + n * 4
            per = (k * n * 2 if slab else 0) + (dn * 2 if slab else 0) \
                + 2 * n                               # vals, dinv, b
            # B2: x in, the float32 state between launches, x' and r out
            return calls * per + 2 * n + (calls - 1) * 8 * n + 4 * n
        ctab, agg = xfer["ctab"], xfer["agg"]
        cases = {
            "dia_smooth_bf16": (
                lambda t=t, d=dinv: K.dia_smooth(vals, offs, t, b16, x16,
                                                 d, grid=grid),
                lambda t=t, d=dinv: K.dia_smooth_plain(vals, offs, t, b16,
                                                       x16, d),
                (k * n + 4 * n + dn) * 2 + s * 4, s * app + 2 * k * n,
                n2, None, launches("B2", True, n2),
                (lambda t=t, d=dinv: smooth_step_route(
                    K, t, b16, x16, vals=vals, offs=offs, dinv=d), s + 1)),
            "dia_smooth_mf_bf16": (
                lambda t=t, st=st: K.dia_smooth_mf(st, t, b16, x16),
                lambda t=t, st=st: mf._xla_smooth(st.spec(), st.coeffs, t,
                                                  b16, x16, True),
                4 * n * 2 + (s + k) * 4, s * app + 2 * k * n, n2mf, None,
                launches("B2", False, n2mf),
                (lambda t=t, st=st: smooth_step_route(K, t, b16, x16,
                                                      st=st), s + 1)),
            "dia_smooth_restrict_mf_bf16": (
                lambda t=t, st=st: K.dia_smooth_restrict_mf(st, t, b16, x16,
                                                            ctab),
                lambda t=t, st=st: mf._xla_restrict(st.spec(), st.coeffs, t,
                                                    b16, x16, ctab),
                (3 * n + nc) * 2 + (s + k) * 4 + m * nc * 4,
                s * app + (2 * k + 2) * n, 1, None,
                launches("B3", False),
                (lambda t=t, st=st: step_route(torch, K, st, t, b16, x16,
                                              ctab=ctab), s + 1)),
            "dia_prolong_smooth_mf_bf16": (
                lambda t=t, st=st: K.dia_prolong_smooth_mf(st, t, b16, x16,
                                                           xc16, agg),
                lambda t=t, st=st: mf._xla_corr(st.spec(), st.coeffs, t,
                                                b16, x16, xc16, agg),
                (3 * n + nc) * 2 + (s + k) * 4 + n * 4, s * app + n, 1,
                None, launches("B4", False),
                (lambda t=t, st=st: step_route(torch, K, st, t, b16, x16,
                                              xc=xc16, agg=agg), s)),
        }
        out[sched] = {name: c[:6] + ({"bound_launches_ms":
                                      bound(c[6], c[3])[0]},) + c[7:]
                      for name, c in cases.items()}
    return out


def shell_cases(torch, amgx, K, KK, dev):
    """B6 and B7 at the PCG path's finest level (7-pt 128^3 float32),
    seeded random vectors and scalars (B4's x'.b epilogue at PCG's
    shapes is `slab_cases`)."""
    A, _, _, _, x, _ = grid_case(torch, amgx, (128, 128, 128), dev)
    vals, offs = A.dia_vals, A.dia_offsets
    n, k = A.num_rows, len(offs)
    g = torch.Generator(device=dev).manual_seed(99)
    p, z, r, ap = (torch.randn(n, generator=g, device=dev)
                   for _ in range(4))
    beta = torch.tensor(0.37, device=dev)
    alpha = torch.tensor(0.21, device=dev)
    return A, {
        "dia_spmv_dot": (
            lambda: KK.dia_spmv_dot(vals, offs, p, z, beta),
            lambda: KK.dia_spmv_dot_plain(vals, offs, p, z, beta),
            ((k + 4) * n + 2) * 4, (2 * k + 4) * n, 1, None),
        "cg_update": (
            lambda: KK.cg_update(x, p, r, ap, alpha),
            lambda: KK.cg_update_plain(x, p, r, ap, alpha),
            (6 * n + 2) * 4, 6 * n, 1, None),
    }


def ddot_cases(torch, KK, A, dev):
    """B6's streamed-dot form at the same 128^3 shapes: [(label, case,
    scales)] for d apart from p, the same with self_dot, and d = p with
    self_dot (BiCGStab's t.s / t.t, t = A s). Bytes: vals, p, d (unless
    it is p) and Ap once, and the dots. The error scales: max |Ap|, sum
    |d_i Ap_i| and sum Ap_i^2 of the plain version, in float64. The
    `torch.sparse` CSR SpMV of the same operator is timed beside it as a
    yardstick for the SpMV alone (no PyTorch call gives Ap with its
    dots)."""
    vals, offs = A.dia_vals, A.dia_offsets
    n, k = A.num_rows, len(offs)
    g = torch.Generator(device=dev).manual_seed(7)
    p, d = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    M = csr_library(torch, A)
    out = []
    for label, dd, self_dot in (("d", d, False), ("d_self_dot", d, True),
                                ("d_is_p_self_dot", p, True)):
        want = KK.dia_spmv_ddot_plain(vals, offs, p, dd, self_dot)
        ap = want[0].double()
        scales = [float(ap.abs().max()),
                  float((dd.double() * ap).abs().sum())]
        if self_dot:
            scales.append(float((ap * ap).sum()))
        dots = 2 if self_dot else 1
        streams = k + (2 if dd is p else 3)
        out.append((f"pcg_l0_128^3 {label}", (
            lambda dd=dd, sd=self_dot: KK.dia_spmv_dot(
                vals, offs, p, d=dd, self_dot=sd),
            lambda dd=dd, sd=self_dot: KK.dia_spmv_ddot_plain(
                vals, offs, p, dd, sd),
            streams * n * 4 + dots * 4, (2 * k + 2 * dots) * n, 1, None),
            scales, lambda: M @ p))
    return out


def tail_work(T, spec, arrs, with_dot, half=False):
    """(bytes, flops, phases) of one B5 call: every array read once, b
    and x read and x' written once (bf16 with `half`); the operations the
    phase program runs on these levels (a W or F cycle visits levels more
    often)."""
    nbytes = sum(t.numel() * t.element_size() for ar in arrs
                 for t in ar.values() if t is not None)
    n0 = spec.levels[0].n
    width = 2 if half else 4                  # b, x in, x' out
    nbytes += 3 * n0 * width + (4 if with_dot else 0)
    prog = T.tail_program(spec, with_dot)
    flops = 0
    for row in prog:
        op, l, flags = row[0], row[1], row[6]
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


def barrier_costs(torch, T, cluster, iters=1000):
    """(ms of one cluster barrier, ms of one block barrier) in a cluster
    of `cluster` 1024-thread blocks, the tail kernel's launch shape: a
    launch of `iters` barriers against a launch of none (CUDA events).
    With a program's barrier counts, the tail's phase-chain floor."""
    out = []
    for kind in (True, False):
        full, empty = (time_ms(torch, lambda k=kind, i=i: T.barrier_probe(
            cluster, i, k)) for i in (iters, 0))
        out.append((full - empty) / iters)
    return tuple(out)


def tail_cases(torch, amgx, T, dev, mode, bf16=False):
    """B5 on the 32^3 hierarchies (the flagship 128^3's tail levels),
    with slab levels (matrix_free=0) or matrix-free ones (mode "mf", the
    card's default): label -> (spec, arrs, with_dot, b, x). With `bf16`
    the hierarchies' solve data and the vectors are bfloat16
    (solve_precision=bfloat16: the float32 coarse inverse, damping
    factors and coefficients) and only the no-dot cases, the flagship's
    and JACOBI_L1's V, are built."""
    from amgx_tpu_torch.ops.smooth import _tail_plan
    from amgx_tpu_torch.presets import FLAGSHIP
    A = amgx.gallery.poisson("7pt", 32, 32, 32, dtype=torch.float32,
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    b, x = (torch.randn(32 ** 3, generator=g, device=dev)
            for _ in range(2))
    pin = (SLAB if mode == "slab" else "") + (BF16 if bf16 else "")
    if bf16:
        b, x = b.to(torch.bfloat16), x.to(torch.bfloat16)
    amgs = {"cheb5": amg_of(amgx, FLAGSHIP + pin, A, dev).amg,
            "jacobi_l1": amg_of(amgx, PCG + "1" + pin, A, dev).amg}
    cases = {}
    # each name's first case is its main-path shape: the flagship's tail
    # (CHEBYSHEV_POLY), PCG's whole-cycle tail with the dot (JACOBI_L1)
    for smoother, shape, with_dot in (
            (("cheb5", "V", False), ("jacobi_l1", "V", False)) if bf16 else (
            ("cheb5", "V", False), ("jacobi_l1", "V", True),
            ("cheb5", "V", True), ("jacobi_l1", "V", False),
            ("cheb5", "W", False), ("cheb5", "F", False))):
        amg = amgs[smoother]
        spec, arrs = _tail_plan(amg, shape, amg.solve_data(), 0, x)
        check([ls.n for ls in spec.levels] == [32768, 4096, 512]
              and spec.coarse == ("inv", 64)
              and all((ls.mf is not None) == (mode == "mf")
                      for ls in spec.levels),
              f"32^3 {mode} tail levels {spec.levels}")
        label = f"{smoother} {shape}" + (" dot" if with_dot else "")
        cases[label] = (spec, arrs, with_dot, b, x)
    return cases


def csr_library(torch, M):
    """M as a PyTorch sparse CSR tensor (cuSPARSE's operand)."""
    return torch.sparse_csr_tensor(M.row_offsets, M.col_indices, M.values,
                                   (M.num_rows, M.num_cols),
                                   check_invariants=True)


def csr_spmv_case(torch, C, M, x):
    """B8 on one float32 CSR matrix, with cuSPARSE's product as the
    yardstick (run_case's case tuple). Bound: each stored entry (value and
    column) and row offset read once, x read and y written once."""
    lib = csr_library(torch, M)
    return (lambda: C.csr_spmv(M.row_offsets, M.col_indices, M.values, x),
            lambda: C.csr_spmv_plain(M.row_offsets, M.col_indices, M.values,
                                     x),
            M.nnz * 8 + (M.num_rows + 1) * 4 + M.num_cols * 4
            + M.num_rows * 4, 2 * M.nnz, 1, lambda: lib @ x)


def weighted_launches(torch, K, vals, offs, grid, dinv, x, steps):
    """Launches of one B3w and one B4w call of `steps` steps on a level:
    B3w the tiled launches `slab_route` plans there and the restriction,
    or (route "step") the steps, the residual and the restriction; B4w
    the prologue and the steps, on every level."""
    ctab = torch.zeros((1, 1), dtype=torch.int32, device=x.device)
    p3 = K.slab_route(vals, offs, grid, dinv, x, steps, ctab, True)[1]
    return (steps + 2 if p3 is None else len(p3) + 1), steps + 1


def weighted_per_call(torch, amg):
    """(B3w, B4w) launches of one call on the classical level 0 of a
    set-up `amg` (its pre- and post-smoothing schedules) by the route
    its wrappers take there (`weighted_launches`)."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    ld = amg.solve_data()["levels"][0]
    A, dinv = ld["A"], ld["smoother"].get("dinv")
    x = torch.empty(A.num_rows, dtype=A.dia_vals.dtype,
                    device=A.dia_vals.device)
    args = (torch, K, A.dia_vals, A.dia_offsets, A.grid_shape, dinv, x)
    return (weighted_launches(*args, amg._sweeps(0, True))[0],
            weighted_launches(*args, amg._sweeps(0, False))[1])


def weighted_cycles(c, per_call, suffix=""):
    """The V-cycles a path's counts `c` show on a classical level 0 whose
    B3w / B4w calls launch `per_call` kernels each: B3w's and B4w's
    launches over their per-call counts, which must agree (None where
    they do not or nothing ran)."""
    w3 = c["dia_smooth_restrict_w" + suffix] / per_call[0]
    w4 = c["dia_prolong_smooth_w" + suffix] / per_call[1]
    return int(w3) if w3 == w4 == int(w3) and w3 > 0 else None


def weighted_kw(K, xf, dtype):
    """B3w's R rows argument (`rows`) where the package's wrapper takes
    it (a parent tree's may not), its values in `dtype`."""
    if "rows" not in inspect.signature(K.dia_smooth_restrict).parameters:
        return {}
    return {"rows": (xf["rro"], xf["rci"], xf["rwt"].to(dtype))}


def classical_cases(torch, amgx, K, C, dev, untiled=False):
    """B8, B9 and B3w/B4w at the shapes the 128^3 CLASSICAL path gives
    them, on its own hierarchy's float32 solve data: B8 on the largest
    unstructured operator (level 1) and the P and R that serve it, B9 on
    that operator with JACOBI_L1's dinv, B3w/B4w on level 0 (the 7-pt
    DIA operator, 2,097,152 rows, its grid given as the cycle gives it)
    with its weighted tables, with and without dinv; with `untiled` also
    B3w/B4w without the grid (labels "... untiled": the per-step and
    prologue routes, which a level without a grid takes). label ->
    {name: case} as kernel_cases gives them, and the level rows."""
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
        cases[f"classical_128^3 {label} {M.num_rows}x{M.num_cols}"] = {
            "csr_spmv": csr_spmv_case(torch, C, M, x)}
    # B9's lanes per row: the one CsrMatrix.init() chose (CSR_LANE_NNZ)
    # against every other choice, one sweep on the operators of levels 1
    # and 2 (B8 walks row blocks and takes no lanes)
    for label, M in (("A1", M1), ("A2", data["levels"][2]["A"])):
        x, b = (torch.randn(M.num_rows, generator=g, device=dev)
                for _ in range(2))
        emit({"phase": "csr_lanes", "kernel": "csr_smooth", "matrix": label,
              "rows": M.num_rows, "mean_row_nnz": M.nnz / M.num_rows,
              "chosen": M.csr_lanes,
              "ms_by_lanes": {lanes: time_ms(torch, lambda lanes=lanes, M=M,
                                             x=x, b=b: C.csr_smooth(
                  M.row_offsets, M.col_indices, M.values, tau1, b, x,
                  lanes=lanes)) for lanes in (1, 2, 4, 8, 16, 32)}})
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
    # one step, its residual once a row (B3w) and the transfer's products
    app = (2 * k + 3) * n
    ops3 = app + (2 * k + 1) * n + 2 * nnz_r
    routes = (("", A0.grid_shape),) + ((" untiled", None),) * untiled
    kw32 = weighted_kw(K, xf, torch.float32)
    for (tag, dinv), (rt, grid) in itertools.product(
            (("dinv", l0["smoother"]["dinv"]), ("no dinv", None)), routes):
        dn = 0 if dinv is None else n
        l3, l4 = weighted_launches(torch, K, vals, offs, grid, dinv, x, 1)
        cases[f"classical_l0_128^3 {tag}{rt}"] = {
            "dia_smooth_restrict_w": (
                lambda d=dinv, gr=grid: K.dia_smooth_restrict(
                    vals, offs, tau, b, x, xf["ctab"], d,
                    weights=xf["cwt"], grid=gr, **kw32),
                lambda d=dinv: K.dia_smooth_restrict_plain(
                    vals, offs, tau, b, x, xf["ctab"], d,
                    weights=xf["cwt"]),
                (k * n + 3 * n + dn + 1 + nc) * 4 + r_bytes,
                ops3 + dn, l3, None),
            "dia_prolong_smooth_w": (
                lambda d=dinv, gr=grid: K.dia_prolong_smooth(
                    vals, offs, tau, b, x, xc, dinv=d, ptab=xf["ptab"],
                    pwt=xf["pwt"], grid=gr),
                lambda d=dinv: K.dia_prolong_smooth_plain(
                    vals, offs, tau, b, x, xc, None, d, ptab=xf["ptab"],
                    pwt=xf["pwt"]),
                (k * n + 3 * n + dn + 1 + nc) * 4 + p_bytes,
                app + dn + 2 * nnz_p, l4, None)}
        if dinv is not None:
            cases[f"classical_l0_128^3 {tag}{rt}"][
                "dia_prolong_smooth_w_dot"] = (
                lambda d=dinv, gr=grid: K.dia_prolong_smooth(
                    vals, offs, tau, b, x, xc, dinv=d, ptab=xf["ptab"],
                    pwt=xf["pwt"], with_dot=True, grid=gr),
                lambda d=dinv: K.dia_prolong_smooth_plain(
                    vals, offs, tau, b, x, xc, None, d, with_dot=True,
                    ptab=xf["ptab"], pwt=xf["pwt"]),
                (k * n + 3 * n + dn + 1 + nc + 1) * 4 + p_bytes,
                app + dn + 2 * nnz_p + 2 * n, l4, None)
    # the bf16 forms on the same levels, as the hierarchy's bf16 cast
    # hands them over: B9 / B8 on level 1, B3w / B4w on level 0 (R's and
    # P's entries 6 bytes each: a bf16 weight and an int32 index)
    bf = torch.bfloat16
    bf16 = {"classical_128^3 " + k: v for k, v in csr_bf16_cases(
        torch, C, {"A1": M1, "P1": l1["P"], "R1": l1["R"]}, dinv1,
        tau1.to(bf), g).items()}
    v16, b16, x16, xc16 = vals.to(bf), b.to(bf), x.to(bf), xc.to(bf)
    cwt, pwt = xf["cwt"].to(bf), xf["pwt"].to(bf)
    t16 = tau.to(bf).float()
    r16 = nnz_r * 6 + (nc + 1) * 4
    p16 = nnz_p * 6 + (n + 1) * 4
    kw16 = weighted_kw(K, xf, bf)
    for (tag, dinv), (rt, grid) in itertools.product(
            (("dinv", l0["smoother"]["dinv"]), ("no dinv", None)), routes):
        dn = 0 if dinv is None else n
        d16 = None if dinv is None else dinv.to(bf)
        l3, l4 = weighted_launches(torch, K, v16, offs, grid, d16, x16, 1)
        bf16[f"classical_l0_128^3 {tag}{rt} bf16"] = {
            "dia_smooth_restrict_w_bf16": (
                lambda d=d16, gr=grid: K.dia_smooth_restrict(
                    v16, offs, t16, b16, x16, xf["ctab"], d, weights=cwt,
                    grid=gr, **kw16),
                lambda d=d16: K.dia_smooth_restrict_plain(
                    v16, offs, t16, b16, x16, xf["ctab"], d, weights=cwt),
                (k * n + 3 * n + dn + nc) * 2 + 4 + r16,
                ops3 + dn, l3, None, f32_twin_ms(
                    torch, lambda d=dinv, gr=grid: K.dia_smooth_restrict(
                        vals, offs, t16, b, x, xf["ctab"], d,
                        weights=xf["cwt"], grid=gr, **kw32), l3)),
            "dia_prolong_smooth_w_bf16": (
                lambda d=d16, gr=grid: K.dia_prolong_smooth(
                    v16, offs, t16, b16, x16, xc16, dinv=d, ptab=xf["ptab"],
                    pwt=pwt, grid=gr),
                lambda d=d16: K.dia_prolong_smooth_plain(
                    v16, offs, t16, b16, x16, xc16, None, d,
                    ptab=xf["ptab"], pwt=pwt),
                (k * n + 3 * n + dn + nc) * 2 + 4 + p16,
                app + dn + 2 * nnz_p, l4, None, f32_twin_ms(
                    torch, lambda d=dinv, gr=grid: K.dia_prolong_smooth(
                        vals, offs, t16, b, x, xc, dinv=d, ptab=xf["ptab"],
                        pwt=xf["pwt"], grid=gr), l4))}
    return cases, bf16, amg.level_rows(), {"m": m, "mp": mp}


def weighted_bits(torch, K, C, amgx, dev):
    """x' of B3w / B4w / B4w's dot at the 128^3 CLASSICAL level 0 (one
    JACOBI_L1 step, with and without dinv, f32 and bf16) against the
    per-step kernels' arithmetic that the earlier route ran, to the bit:
    B3w's x' = B2's steps (dia_smooth, the same step kernel); B4w's x'
    = the step kernel from x + P xc summed as `prolong_plain` sums it
    (the kernels' chain of fused multiply-adds, emulated in float64), a
    bf16 call's x0 read as the float32 state. Also B3w's restriction
    alone (bc = R r over R's rows, r float32) against cuSPARSE's R @ r,
    timed. Emits one row; checks 0 ulp."""
    A = amgx.gallery.poisson("7pt", 128, 128, 128, device=dev)
    amg = amg_of(amgx, CLASSICAL, A, dev).amg
    l0 = amg.solve_data()["levels"][0]
    A0, xf = l0["A"], l0["xfer"]
    vals, offs, n = A0.dia_vals, A0.dia_offsets, A0.num_rows
    nc = xf["ctab"].shape[1]
    g = torch.Generator(device=dev).manual_seed(8765)
    b, x = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    xc = torch.randn(nc, generator=g, device=dev)
    tau = amg.levels[0].smoother._fused_taus(1, x)
    grid, bf = A0.grid_shape, torch.bfloat16
    diffs = {}
    for half in (False, True):
        dt = bf if half else torch.float32
        v, bb, xx, xcc = (t.to(dt) for t in (vals, b, x, xc))
        tt = tau.to(dt).float()
        pw, kw = xf["pwt"].to(dt), weighted_kw(K, xf, dt)
        for dinv in (l0["smoother"]["dinv"], None):
            d = None if dinv is None else dinv.to(dt)
            tag = ("bf16 " if half else "") + ("dinv" if d is not None
                                                else "no dinv")
            got3 = K.dia_smooth_restrict(v, offs, tt, bb, xx, xf["ctab"], d,
                                         weights=xf["cwt"].to(dt), grid=grid,
                                         **kw)[0]
            ref3 = K.dia_smooth(v, offs, tt, bb, xx, d, with_residual=False)
            got4 = K.dia_prolong_smooth(v, offs, tt, bb, xx, xcc, dinv=d,
                                        ptab=xf["ptab"], pwt=pw, grid=grid)
            x0 = K.prolong_plain(xx.float(), xcc.float(), ptab=xf["ptab"],
                                 pwt=pw.float())
            ref4 = K._steps("dia_smooth_step" + "_bf16" * half,
                            K._lib().amgx_dia_step,
                            (K._ptr(v), K._ptr(d)), offs, tt, bb, x0,
                            torch.empty_like(xx), x_f32=True)
            diffs[f"B3w x' {tag}"] = max_err(torch, got3, ref3)[0]
            diffs[f"B4w x' {tag}"] = max_err(torch, got4, ref4)[0]
            if d is not None and not half:
                got5 = K.dia_prolong_smooth(v, offs, tt, bb, xx, xcc, dinv=d,
                                            ptab=xf["ptab"], pwt=pw,
                                            grid=grid, with_dot=True)[0]
                diffs[f"B4w-dot x' {tag}"] = max_err(torch, got5, ref4)[0]
    # the restriction alone, and cuSPARSE's R @ r on the same r
    r = torch.randn(n, generator=g, device=dev)
    R = l0["R"]
    bc = torch.empty(nc, device=dev)
    lib = csr_library(torch, R)
    row = {"phase": "weighted_bits", "x_max_abs_diff": diffs,
           "restrict_ms": time_ms(torch, lambda: C.spmv_into(
               "csr_spmv", xf["rro"], xf["rci"], xf["rwt"], r, bc)),
           "restrict_library_ms": time_ms(torch, lambda: lib @ r),
           "restrict_bound_ms": bound(
               R.nnz * 8 + (nc + 1) * 4 + n * 4 + nc * 4, 2 * R.nnz)[0]}
    emit(row)
    check(all(v == 0.0 for v in diffs.values()),
          f"B3w / B4w x' not the per-step kernels' bits: {diffs}")


def f32_twin_ms(torch, fn, launches):
    """The float32 form's times on the same level, in the same call: the
    bf16 row's yardstick ({"f32_ms", "f32_device_ms"})."""
    return {"f32_ms": time_ms(torch, fn),
            "f32_device_ms": device_ms(torch, fn, launches)[0]}


def bf16_library(torch, M, v):
    """(cuSPARSE's bf16 product as a call, None) where torch.sparse takes
    a bf16 CSR matrix times a bf16 vector, else (None, torch's error): the
    bf16 B8's yardstick, timed only."""
    lib = csr_library(torch, M)
    try:
        lib @ v
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return (lambda: lib @ v), None


def csr_bf16_cases(torch, C, mats, dinv, tau, g):
    """B9's and B8's bf16 forms on a bf16 hierarchy's CSR level: one sweep
    (JACOBI_L1's or BLOCK_JACOBI's tau and dinv, rounded to bf16 as the
    hierarchy's cast does) on the level's operator, and the products with
    each matrix in `mats` (label -> float32 CsrMatrix; the operator first,
    then P and R where the level has them), each beside its float32 form
    on the same matrix. label -> {name: (kernel, plain, bytes, flops,
    launches per call, library, extra)}; bf16 streams at 2 bytes, int32
    columns and row offsets at 4."""
    from amgx_tpu_torch.amg.hierarchy import _cast_leaf
    bf = torch.bfloat16
    cases = {}
    for i, (label, M32) in enumerate(mats.items()):
        M = _cast_leaf(M32, bf)
        v32 = torch.randn(M.num_cols, generator=g, device=M.values.device)
        v = v32.to(bf)
        lib, why = bf16_library(torch, M, v)
        named = {"csr_spmv_bf16": (
            lambda M=M, v=v: C.csr_spmv(M.row_offsets, M.col_indices,
                                        M.values, v),
            lambda M=M, v=v: C.csr_spmv_plain(M.row_offsets, M.col_indices,
                                              M.values, v),
            M.nnz * 6 + (M.num_rows + 1) * 4 + (M.num_cols + M.num_rows) * 2,
            2 * M.nnz, 1, lib, dict(f32_twin_ms(
                torch, lambda M=M32, v=v32: C.csr_spmv(
                    M.row_offsets, M.col_indices, M.values, v), 1),
                **({} if why is None else {"library": f"none: {why}"})))}
        if i == 0:
            n = M.num_rows
            b32 = torch.randn(n, generator=g, device=v.device)
            b, d16, d32, t = b32.to(bf), dinv.to(bf), dinv.float(), \
                tau.float()
            named["csr_smooth_bf16"] = (
                lambda M=M, v=v: C.csr_smooth(
                    M.row_offsets, M.col_indices, M.values, t, b, v, d16,
                    lanes=M.csr_lanes),
                lambda M=M, v=v: C.csr_smooth_plain(
                    M.row_offsets, M.col_indices, M.values, t, b, v, d16),
                M.nnz * 6 + (n + 1) * 4 + 4 * n * 2 + 4,
                2 * M.nnz + 4 * n, 1, None, f32_twin_ms(
                    torch, lambda M=M32, v=v32: C.csr_smooth(
                        M.row_offsets, M.col_indices, M.values, t, b32, v,
                        d32, lanes=M.csr_lanes), 1))
        cases[f"{label} {M.num_rows}x{M.num_cols} bf16"] = named
    return cases


# The reference sends a bf16 CSR level to its sweep kernel (B9) only where
# the level's windowed-ELL (SWELL) layout exists and fits the kernel's
# VMEM budget, and composes per-operation bf16 XLA sweeps elsewhere; its
# bf16 products take the SWELL or ELL gather form (float32 sums, one
# rounding) or, where neither layout exists, a bf16 scatter-add (a
# rounding at every add). A copy of its layout rules
# (amgx_tpu/ops/pallas_swell.py `swell_budget`, `build_swell_host`,
# `_swell_budget_ok`; amgx_tpu/matrix.py's ELL choice), so the card can
# say which of a 128^3 hierarchy's levels the reference would round
# another way than the port.
SWELL_LANES, SWELL_BLOCK_ROWS = 128, 1024
SWELL_MAX_K, SWELL_MAX_W = 256, 512 * 1024
SWELL_VMEM = 10 * 1024 * 1024
ELL_MAX_RATIO = 3.0


def swell_fit(torch, M, val_itemsize=2):
    """{"kmax", "w128", "kpad", "layout", "sweep", "ell"}: whether the
    reference builds M's SWELL layout, whether its bf16 sweep kernel
    takes it (`val_itemsize`-byte values, four pipeline blocks), and
    whether its ELL layout would (the product's fallback)."""
    ro = M.row_offsets.long()
    counts = torch.diff(ro)
    n = M.num_rows
    kmax = int(counts.max())
    mean = max(M.nnz / max(n, 1), 1e-30)
    out = {"kmax": kmax, "w128": None, "kpad": None, "layout": False,
           "sweep": False, "ell": kmax / mean <= ELL_MAX_RATIO}
    if kmax == 0 or kmax > SWELL_MAX_K:
        return out
    rows = torch.repeat_interleave(torch.arange(n, device=ro.device),
                                   counts, output_size=M.nnz)
    ci = M.col_indices.long()
    nb = -(-n // SWELL_BLOCK_ROWS)
    blk = rows // SWELL_BLOCK_ROWS
    big = torch.iinfo(torch.int64).max
    bmin = torch.full((nb,), big, device=ro.device).scatter_reduce(
        0, blk, ci, "amin")
    bmax = torch.full((nb,), -1, device=ro.device).scatter_reduce(
        0, blk, ci, "amax")
    empty = bmax < 0
    bmin = torch.where(empty, torch.zeros_like(bmin), bmin)
    bmax = torch.where(empty, torch.zeros_like(bmax), bmax)
    c0 = (bmin // SWELL_LANES) * SWELL_LANES
    span = int((bmax - c0 + 1).max())
    w128 = -(-(-(-span // SWELL_LANES)) // 8) * 8
    kpad = kmax if kmax <= 24 else -(-kmax // 8) * 8
    slots = nb * 8 * kpad * SWELL_LANES
    out.update(w128=w128, kpad=kpad)
    if w128 * SWELL_LANES > SWELL_MAX_W or (
            slots > 6 * max(M.nnz, 1) and slots > (1 << 20)):
        return out
    out["layout"] = True
    win = 2 * w128 * SWELL_LANES * 4
    ent = 2 * 8 * kpad * SWELL_LANES * (4 + val_itemsize)
    blocks = 2 * 4 * 8 * SWELL_LANES * 4
    out["sweep"] = M.num_rows == M.num_cols and \
        win + ent + blocks <= SWELL_VMEM
    return out


def rap_case(torch, amgx, R_, dev):
    """B10 on level 0's float32 plan of the 64^3 CLASSICAL_REFINEMENT
    hierarchy (built as its setup builds it, on the float32 operator):
    (case, plan sizes). The library call is cuSPARSE's SpGEMM, which
    also redoes the symbolic phase the plan holds."""
    from amgx_tpu_torch.ops.segment import ordered_segment_sum_plain
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
            lambda: R_.rap_values_plain(plan, a, r, p,
                                        ordered_segment_sum_plain),
            nbytes, flops, 2,
            lambda: torch.sparse.mm(torch.sparse.mm(Rs, As), Ps))
    return case, {"rows": lv.A.num_rows, "nT": plan.nT, "nU": plan.nU,
                  "candidates_stage1": plan.sa.numel(),
                  "candidates_stage2": plan.sr.numel(),
                  "plan_bytes": plan.nbytes()}


def max_err(torch, got, want, scales=None):
    """(max abs error, max over outputs of abs error / its scale): max
    |plain| unless `scales` gives one per output."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    scales = scales or [float(b.abs().max()) for b in want]
    rel = max(e / max(sc, 1e-30) for e, sc in zip(abs_errs, scales))
    return max(abs_errs), rel


def bf16_err(torch, got, want):
    """(max abs error, max error in bf16 ulps, share of entries
    bit-equal) over the outputs of a bf16 form: an entry's ulp is that of
    max(|got|, |want|) floored at 2^-8 of the output's largest entry."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err, ulps, equal, total = 0.0, 0.0, 0, 0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        d = (a - b).abs()
        floor = 2.0 ** -8 * float(b.abs().max())
        scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                              torch.full_like(a, floor))
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.where(scale > 0, scale, torch.ones_like(scale)))) - 7)
        abs_err = max(abs_err, float(d.max()))
        ulps = max(ulps, float((d / ulp).max()))
        equal += int((a == b).sum())
        total += a.numel()
    return abs_err, ulps, equal / total


def run_case(torch, K, label, name, kern, plain, nbytes, flops, per_call,
             lib, rows, summary, extra=None, slab=None, scales=None,
             old=None, moved_expect=None, repeat=False, peak=PEAK_F32_S,
             plain_reps=(PLAIN_REPS, PLAIN_BATCH)):
    """Check one kernel against its plain version (and, for a
    coefficient-mode kernel, against the slab kernel on the same level:
    `slab`), time both, emit the row and fold it into `summary`.
    `scales`: the error scale of each output (max_err). `old`: (call,
    launches per call) of the route the kernel replaced in this PR (the
    per-step route of B3-mf / B4-mf): its outputs must equal the kernel's
    (x' and bc; a dot sums in another order), and the two are timed in
    turns, old, new, new, old. `moved_expect`: the launches per counter
    one call must make (default: all under `name` for a bf16 form).
    `repeat`: a second call must give the first's bits (a dot too).
    `peak`: the operations' rate in the bound (float32's by default).
    `plain_reps`: (reps, batch) of the plain version's timing, or None:
    the one comparison call is timed. `lib` given as the string "plain":
    the plain version is the library call, its time reported as both."""
    before = dict(K.LAUNCHES)
    got = kern()
    moved = {k: v - before[k] for k, v in K.LAUNCHES.items()
             if v != before[k]}
    launched = sum(moved.values())
    if plain_reps is None:
        # a slow plain version runs once: the comparison call is timed
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
    want = plain()
    if plain_reps is None:
        ev[1].record()
    torch.cuda.synchronize()
    check(launched == per_call,
          f"{name} launched {launched} kernels, expected {per_call}")
    if moved_expect is not None:
        check(moved == moved_expect, f"{name} launches {moved}, expected "
              f"{moved_expect}")
    if name in BF16_FORMS:
        # every launch under the bf16 form's own counter, none under its
        # float32 twin's; the error in bf16 ulps
        check(moved_expect is not None or moved == {name: per_call},
              f"{name} launches {moved}")
        abs_err, rel_err, equal = bf16_err(torch, got, want)
        extra = dict(extra or {}, max_err_bf16_ulps=rel_err,
                     bit_equal_share=equal)
    else:
        abs_err, rel_err = max_err(torch, got, want, scales)
    check(rel_err <= LIMITS[name],
          f"{name} at {label}: error {rel_err} > {LIMITS[name]}")
    if repeat:
        again = kern()
        same = all(torch.equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,),
            again if isinstance(again, tuple) else (again,)))
        check(same, f"{name} at {label}: a repeat call gave other bits")
        extra = dict(extra or {}, repeat_bit_equal=same)
    # outputs held to the bit against another route: x' (and bc); a dot
    # is summed in another order by the temporally blocked kernel
    exact = 1 if name.endswith("_dot") else None
    if slab is not None:
        want_s = slab()
        extra = dict(extra or {}, slab_max_abs_diff=max_err(
            torch, got[:exact], want_s[:exact])[0]
            if exact else max_err(torch, got, want_s)[0])
        if exact:
            extra["slab_dot_abs_diff"] = float((got[1] - want_s[1]).abs())
        check(extra["slab_max_abs_diff"] == 0.0,
              f"{name} at {label}: {extra['slab_max_abs_diff']} from the "
              f"slab kernel on the same level")
    if old is not None:
        old_fn, old_launches = old
        want_o = old_fn()
        g_o = got if isinstance(got, tuple) else (got,)
        w_o = want_o if isinstance(want_o, tuple) else (want_o,)
        extra = dict(extra or {}, step_route_max_abs_diff=max_err(
            torch, g_o[:exact], w_o[:exact])[0])
        check(extra["step_route_max_abs_diff"] == 0.0,
              f"{name} at {label}: {extra['step_route_max_abs_diff']} from "
              f"the per-step route on the same inputs")
        # in turns: old, new, new, old
        turns = [time_ms(torch, old_fn), time_ms(torch, kern),
                 time_ms(torch, kern), time_ms(torch, old_fn)]
        ms = (turns[1] + turns[2]) / 2
        step_dev, step_recs = device_ms(torch, old_fn, old_launches)
        extra.update(step_route_ms=(turns[0] + turns[3]) / 2,
                     step_route_device_ms=step_dev,
                     step_route_device_records=step_recs,
                     step_route_launches_per_call=old_launches,
                     ms_turns_old_new_new_old=turns)
    else:
        ms = time_ms(torch, kern)
    # a profile that lost kernel records is taken again, up to 3 times
    for _ in range(3):
        dev_ms, dev_recs = device_ms(torch, kern, per_call)
        if dev_ms is not None:
            break
    plain_ms = ev[0].elapsed_time(ev[1]) if plain_reps is None \
        else time_ms(torch, plain, reps=plain_reps[0], batch=plain_reps[1])
    # a library call is only timed, never used; one that fails fails the run
    lib_ms = None if lib is None else plain_ms if lib == "plain" \
        else time_ms(torch, lib)
    b_ms, b_by = bound(nbytes, flops, peak)
    row = {"phase": "kernels", "shape": label, "name": name, "rows": rows,
           "max_abs_err": abs_err, "max_rel_err": rel_err,
           "limit": LIMITS[name], "launches_per_call": per_call, "ms": ms,
           "device_ms": dev_ms, "device_records": dev_recs,
           "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_us": b_ms * 1e3,
           "bound_by": b_by, "library_ms": lib_ms, **(extra or {})}
    emit(row)
    prev = summary.get(name)
    if prev is None:
        summary[name] = row       # the first (main-path) shape's numbers
    else:
        for key in ("max_abs_err", "max_rel_err", "slab_max_abs_diff",
                    "max_err_bf16_ulps", "step_route_max_abs_diff"):
            if key in row:
                prev[key] = max(prev[key], row[key])
        if "bit_equal_share" in row:
            prev["bit_equal_share"] = min(prev["bit_equal_share"],
                                          row["bit_equal_share"])


def run_slab_cases(torch, K, label, A, xfer, taus, b, x, xc, summary,
                   full=True):
    """`slab_cases` on the level A, each through `run_case`: against its
    plain form, its launches by counter, the per-step route's bits and
    times in turns."""
    for (sched, name), c in slab_cases(torch, K, A, xfer, taus, b, x,
                                       xc, full).items():
        run_case(torch, K, f"{label} {sched}", name, *c[:6], A.num_rows,
                 summary, c[8], moved_expect=c[6], old=c[7])


def b2_split_call(torch, K, plans, taus, b, x, with_residual, vals=None,
                  st=None):
    """B2 (the slab `vals`, no dinv) or B2-mf (the stencil `st`) through
    the tiled launches `plans` (a split other than the planner's, to time
    beside it): x', or (x', r)."""
    r = torch.empty_like(x) if with_residual else None
    name = "dia_smooth" if st is None else "dia_smooth_mf"
    out = K._tb_calls(K._name(name, x), plans, vals, None, taus, b, x,
                      resid=r,
                      sarg=None if st is None else K.stencil_arg(st))
    return (out, r) if with_residual else out


def b2mf_splits(torch, K, levels):
    """B2-mf's candidate splits, measured where the unfused flagship
    runs them (`levels`: (label, level_case) of its 128^3 level 0 and 64^3
    level 1), CHEBYSHEV_POLY's five steps with and without the residual,
    float32 and bf16: the call's applications in one launch, split as
    evenly as may be over two or three launches, and the per-step route.
    Each tiled split must give the per-step route's bits (x' and r);
    times in turns (per-step, 1, 2, 3, 3, 2, 1, per-step launches: CUDA
    events and the profiler's device time). One row a case, naming the
    planner's split (`tiling.plan_calls(..., coef=True)`)."""
    from amgx_tpu_torch.amg.hierarchy import _cast_leaf
    from amgx_tpu_torch.ops import stencil as mf
    from amgx_tpu_torch.ops import tiling as TL
    for label, (A, _, taus, b, x, _) in levels:
        st32 = mf.detect_stencil(A)
        sms = K._sms(x.device)
        for dt in (torch.float32, torch.bfloat16):
            st = st32 if dt == torch.float32 else _cast_leaf(st32, dt)
            t = taus.to(dt).float()
            b_, x_ = b.to(dt), x.to(dt)
            s = t.shape[0]
            for wr in (True, False):
                apps = s + int(wr)
                cands = {"per-step": (
                    lambda wr=wr, st=st, t=t, b_=b_, x_=x_:
                    smooth_step_route(K, t, b_, x_, st=st,
                                      with_residual=wr), s + int(wr))}
                for k in (1, 2, 3):
                    try:
                        plans = TL.split_plans(A.grid_shape,
                                               TL._parts(apps, k), wr, sms,
                                               ring=0)
                    except ValueError:          # no such split
                        continue
                    cands["+".join(str(p.apps) for p in plans)] = (
                        lambda p=plans, wr=wr, st=st, t=t, b_=b_, x_=x_:
                        b2_split_call(torch, K, p, t, b_, x_, wr, st=st), k)
                ref = cands["per-step"][0]()
                for key, (fn, _) in cands.items():
                    got = fn()
                    got, want = (v if isinstance(v, tuple) else (v,)
                                 for v in (got, ref))
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"B2-mf split {key} at {label}: not the per-step "
                          f"route's bits")
                order = list(cands) + list(cands)[::-1]
                ms = {key: [] for key in cands}
                dev = {key: [] for key in cands}
                for key in order:
                    fn, launches = cands[key]
                    ms[key].append(time_ms(torch, fn))
                    dev[key].append(device_ms(torch, fn, launches)[0])
                planned = [p.apps for p in TL.plan_calls(
                    A.grid_shape, apps, wr, sms, coef=True)]
                emit({"phase": "kernels_b2mf_splits", "shape": label,
                      "dtype": str(dt).split(".")[-1], "residual": wr,
                      "applications": apps, "planned": planned,
                      "ms": ms, "device_ms": dev})


def tiled_level_setup(torch, amgx, dev):
    """The levels `tiled_level_cases` runs on, set up before the first
    profile: the flagship's level 1 (its `level_case`), the D A D
    hierarchy's level 1, and a 27-point level's case."""
    A27 = amgx.gallery.poisson("27pt", 48, 48, 48, dtype=torch.float32,
                               device=dev).init()
    return (level_case(torch, amgx, coarse_level(torch, amgx, 128, dev),
                       dev, 7),
            coarse_level(torch, amgx, 128, dev, dad=True),
            level_case(torch, amgx, A27, dev, 11))


def tiled_level_cases(torch, K, summary, levels):
    """B3-mf and B4-mf beyond the level-0 grids: the tiled kernels on the
    flagship's level 1 and the per-step route where the wrappers take it;
    the slab B3 / B4 on the D A D hierarchy's level 1 and their per-step
    route on a 27-point level (`tiled_level_setup`'s levels)."""
    # the flagship's level 1 (F's second level: the Galerkin 7-pt stencil
    # at 64^3, another tile plan): the tiled B3-mf / B4-mf in float32 and
    # bf16 against their plain forms, the slab kernels and the per-step
    # route
    label = "flagship_l1_64^3"
    (A1, xfer1, taus1, b1, x1, xc1), A1d, case27 = levels
    check(A1.num_rows == 64 ** 3, f"level 1 has {A1.num_rows} rows")
    cases, slab, steps = kernel_cases(torch, K, A1, xfer1, taus1, b1, x1,
                                      xc1)
    for name in TILED + B2_TILED:
        run_case(torch, K, label, name, *cases[name], A1.num_rows, summary,
                 slab=slab.get(name), old=steps.get(name))
    for sched, named in bf16_kernel_cases(torch, K, A1, xfer1, taus1, b1, x1,
                                          xc1).items():
        for name in TILED_BF16 + B2_TILED_BF16:
            run_case(torch, K, f"{label} {sched}", name, *named[name][:6],
                     A1.num_rows, summary, named[name][6],
                     old=named[name][7])
    # a schedule longer than one launch takes (20 steps and the residual
    # on level 1): B2 and B2-mf split it over the planner's launches
    t20 = taus1.repeat(4)
    cases, slab, steps = kernel_cases(torch, K, A1, xfer1, t20, b1, x1, xc1)
    for name in B2_TILED:
        run_case(torch, K, f"{label} 20 steps", name, *cases[name],
                 A1.num_rows, summary, slab=slab.get(name),
                 old=steps.get(name))
    # the slab B3 / B4 on the D A D hierarchy's level 1 (the Galerkin
    # product of a variable-coefficient 128^3 operator at 64^3)
    check(A1d.num_rows == 64 ** 3 and K.slab_grid(
        A1d.dia_vals, A1d.dia_offsets, A1d.grid_shape) is not None,
          f"the D A D level 1 ({A1d.num_rows} rows) is a star grid level")
    run_slab_cases(torch, K, "dad_l1_64^3", A1d, xfer1, taus1, b1, x1,
                   xc1, summary, full=False)
    # the per-step route of B3-mf / B4-mf: a 27-point level (CHEBYSHEV_
    # POLY's five steps) and a schedule of 20 steps on level 1 (its five
    # taus four times); of the slab B3 / B4 on the 27-point level
    for label, case in (
            ("27pt_48^3", case27),
            ("flagship_l1_64^3 20 steps",
             (A1, xfer1, taus1.repeat(4), b1, x1, xc1))):
        for name, c in step_route_cases(torch, K, *case).items():
            run_case(torch, K, label, name, *c[:6], case[0].num_rows,
                     summary, moved_expect=c[6])
    for name, c in slab_step_cases(torch, K, *case27).items():
        run_case(torch, K, "27pt_48^3", name, *c[:6], case27[0].num_rows,
                 summary, moved_expect=c[6])


# the temporally blocked kernels (csrc/stencil_tb.cu) and their bf16 forms
TILED = ("dia_smooth_restrict_mf", "dia_prolong_smooth_mf",
         "dia_prolong_smooth_mf_dot")
TILED_BF16 = ("dia_smooth_restrict_mf_bf16", "dia_prolong_smooth_mf_bf16")
# B2 and B2-mf, temporally blocked since the unfused paths moved to them
B2_TILED = ("dia_smooth", "dia_smooth_mf")
B2_TILED_BF16 = ("dia_smooth_bf16", "dia_smooth_mf_bf16")
# B2-mf's, B3-mf's and B4-mf's per-step route, never taken on the driven
# paths
MF_STEP_ROUTE = ("dia_smooth_restrict_mf_step", "dia_prolong_smooth_mf_step",
                 "dia_prolong_smooth_mf_step_dot",
                 "dia_smooth_restrict_mf_step_bf16",
                 "dia_prolong_smooth_mf_step_bf16", "dia_smooth_mf_step",
                 "dia_smooth_mf_step_bf16")
# the slab B2's, B3's and B4's per-step route and B3's untiled
# restriction after it (weighted tables keep their "_w" counters), never
# taken on the driven GEO paths
SLAB_STEP_ROUTE = ("dia_smooth_step", "dia_smooth_step_bf16",
                   "dia_smooth_restrict_step", "dia_prolong_smooth_step",
                   "dia_prolong_smooth_step_dot",
                   "dia_smooth_restrict_step_bf16",
                   "dia_prolong_smooth_step_bf16",
                   "dia_smooth_restrict_epilogue",
                   "dia_smooth_restrict_epilogue_bf16")


def phase_kernels(torch, amgx, dev):
    from amgx_tpu_torch.ops import cuda_csr as C
    from amgx_tpu_torch.ops import cuda_krylov as KK
    from amgx_tpu_torch.ops import cuda_rap as R_
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.ops import cuda_tail as T
    summary = {}
    # the 32^3 tail hierarchies, the classical 128^3 setup and every
    # level of the DIA rows first, then the profiles: a profile taken
    # before a large setup loses the kernel records of later ones (the
    # CSR rows' device times were lost that way)
    tails = {(mode, half): tail_cases(torch, amgx, T, dev, mode, half)
             for half in (False, True) for mode in ("slab", "mf")}
    grids = {}
    for label, shape in (("flagship_l0_128^3", (128, 128, 128)),
                         ("ragged_97x61x43", (97, 61, 43))):
        case = grid_case(torch, amgx, shape, dev)
        grids[label] = (case, dad_operator(torch, case[0]))
    tiled_levels = tiled_level_setup(torch, amgx, dev)
    cases, bf16, levels, mm = classical_cases(torch, amgx, K, C, dev)
    weighted_bits(torch, K, C, amgx, dev)
    emit({"phase": "kernels_classical_hierarchy", "rows": 128 ** 3,
          "levels": levels, **mm})
    for label, named in cases.items():
        for name, case in named.items():
            run_case(torch, K, label, name, *case,
                     int(label.split()[-1].split("x")[0])
                     if label.startswith("classical_128^3") else 128 ** 3,
                     summary, repeat=name == "csr_spmv")
    for label, named in bf16.items():
        for name, case in named.items():
            run_case(torch, K, label, name, *case[:6],
                     int(label.split()[-2].split("x")[0])
                     if label.startswith("classical_128^3") else 128 ** 3,
                     summary, case[6], repeat=name == "csr_spmv_bf16")
    costs = None
    for (mode, half), named in tails.items():
        for label, (spec, arrs, with_dot, b, x) in named.items():
            nbytes, flops, phases = tail_work(T, spec, arrs, with_dot, half)
            name = "dia_coarse_tail" + ("_mf" if mode == "mf" else "") + (
                "_dot" if with_dot else "") + ("_bf16" if half else "")
            cluster, cbars, bbars = T.launch_shape(spec, arrs, x, with_dot)
            if costs is None:
                costs = barrier_costs(torch, T, cluster)
                emit({"phase": "tail_barriers", "cluster": cluster,
                      "cluster_barrier_ms": costs[0],
                      "block_barrier_ms": costs[1]})
            slab = None
            # (bf16 JACOBI_L1: the slab level's dinv is the bf16-rounded
            # vector, the coefficient mode's float32, as in the JAX
            # package: no bit-equality to hold there)
            if mode == "mf" and not (half and label.startswith("jacobi")):
                s_spec, s_arrs = tails["slab", half][label][:2]
                slab = (lambda s=s_spec, a=s_arrs, w=with_dot, b=b, x=x:
                        T.dia_coarse_tail(s, a, b, x, w))
            run_case(torch, K, f"tail_32^3 {label}", name,
                     lambda s=spec, a=arrs, w=with_dot, b=b, x=x:
                     T.dia_coarse_tail(s, a, b, x, w),
                     lambda s=spec, a=arrs, w=with_dot, b=b, x=x:
                     T.dia_coarse_tail_plain(s, a, b, x, w),
                     nbytes, flops, 1, None, spec.levels[0].n, summary,
                     {"phases": phases,
                      "levels": [ls.n for ls in spec.levels],
                      "cluster": cluster, "cluster_barriers": cbars,
                      "block_barriers": bbars,
                      "phase_chain_floor_ms": cbars * costs[0]
                      + bbars * costs[1]},
                     slab=slab, repeat=True)
    for label, ((A, xfer, taus, b, x, xc), A2) in grids.items():
        # the slab B3 / B4 on the D A D operator of the same grid (its
        # random per-row values), tiled, against their plain forms and
        # the per-step route
        run_slab_cases(torch, K, label + " dad", A2, xfer, taus, b, x, xc,
                       summary, full=label.startswith("flagship"))
        cases, slab, steps = kernel_cases(torch, K, A, xfer, taus, b, x, xc)
        for name, case in cases.items():
            run_case(torch, K, label, name, *case, A.num_rows, summary,
                     slab=slab.get(name), old=steps.get(name))
        if label.startswith("flagship"):
            # the bf16 forms at the bf16 flagship's level-0 shapes; the
            # first schedule (CHEBYSHEV_POLY, the flagship's) is the
            # summary's row
            for sched, named in bf16_kernel_cases(
                    torch, K, A, xfer, taus, b, x, xc).items():
                for name, case in named.items():
                    run_case(torch, K, f"{label} {sched}", name, *case[:6],
                             A.num_rows, summary, case[6],
                             old=case[7] if len(case) > 7 else None)
        diffs = synthesized_dinv(torch, K, A)
        emit({"phase": "kernels_dinv_synthesized", "shape": label,
              "max_abs_diff_from_smoother_dinv": diffs})
        check(all(d == 0.0 for d in diffs.values()),
              f"{label}: synthesized dinv differs from the smoothers' {diffs}")
    b2mf_splits(torch, K, [("flagship_l0_128^3",
                            grids["flagship_l0_128^3"][0]),
                           ("flagship_l1_64^3", tiled_levels[0])])
    tiled_level_cases(torch, K, summary, tiled_levels)
    A, cases = shell_cases(torch, amgx, K, KK, dev)
    for name, case in cases.items():
        run_case(torch, K, "pcg_l0_128^3", name, *case, A.num_rows, summary)
    for label, case, scales, spmv_lib in ddot_cases(torch, KK, A, dev):
        run_case(torch, K, label, "dia_spmv_ddot", *case, A.num_rows,
                 summary, {"sparse_csr_spmv_ms": time_ms(torch, spmv_lib)},
                 scales=scales)
    case, sizes = rap_case(torch, amgx, R_, dev)
    run_case(torch, K, "classical_refinement_l0_64^3", "rap_values", *case,
             sizes["rows"], summary, sizes)
    return summary


def solve(torch, amgx, cfg, n, dev, dtype=None, op=None):
    """Set up and solve the 7-pt n^3 system with b = 1 (float64 unless
    `dtype`), or the system of `op(A)` (e.g. `dad_operator`); returns
    (result, solver, setup s, solve s, true relative residual in float64
    of the solved operator)."""
    from amgx_tpu_torch.ops.spmv import residual
    dtype = dtype or torch.float64
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=dtype, device=dev)
    if op is not None:
        A = op(torch, A.init())
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
    if op is not None:
        A64 = op(torch, A64)
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
    for label, cfg, n in (("flagship_tail_off", FLAGSHIP_TAIL_OFF, 16),
                          ("flagship", FLAGSHIP, 16),
                          ("flagship_bf16", FLAGSHIP + BF16, 16),
                          ("flagship_bf16", FLAGSHIP + BF16, 64)):
        rc, _, _, _, tc = solve(torch, amgx, cfg, n, dev)
        rh, _, _, _, th = solve(torch, amgx, cfg, n, cpu)
        xdiff = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                      / torch.linalg.norm(rh.x))
        inner = [int(r.extra_stats["inner_iters"]) for r in (rc, rh)]
        emit({"phase": "small", "config": label, "rows": n ** 3,
              "outer_cuda": rc.iterations, "outer_cpu": rh.iterations,
              "inner_cuda": inner[0], "inner_cpu": inner[1],
              "true_rel_res_cuda": tc, "true_rel_res_cpu": th,
              "x_rel_diff": xdiff})
        check(rc.iterations == rh.iterations and xdiff <= 1e-5
              and tc <= 1e-8, f"{n}^3 {label}: card agrees with the CPU")
        if n == 64:
            anchor = BF16_PALLAS_ANCHORS[n][1]
            check(abs(inner[0] - inner[1]) <= 1
                  and abs(inner[0] - anchor) <= 1,
                  f"64^3 {label}: inner iterations {inner} against the "
                  f"JAX package's Pallas route's {anchor}")
    # whole cycle = one tail: B5 carries PCG's r.z (its dot variant), on
    # slab levels and on matrix-free ones (the card's default)
    for path, pin, tail in (("pcg_32^3", SLAB, "dia_coarse_tail_dot"),
                            ("pcg_mf_32^3", "", "dia_coarse_tail_mf_dot")):
        rc, _, _, _, _ = run_path(amgx, per_path, path, lambda p=pin: solve(
            torch, amgx, PCG + "1" + p, 32, dev, torch.float32))
        rh, _, _, _, _ = solve(torch, amgx, PCG + "1", 32, cpu,
                               torch.float32)
        xdiff = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                      / torch.linalg.norm(rh.x))
        c = per_path[path]
        emit({"phase": "small", "config": path + " krylov_fusion=1",
              "rows": 32 ** 3, "iterations_cuda": rc.iterations,
              "iterations_cpu": rh.iterations, "x_rel_diff": xdiff,
              "launches": c})
        check(rc.status == "success" and rc.iterations == rh.iterations
              and xdiff <= 1e-4, f"32^3 {path}: card agrees with the CPU")
        check(c[tail] == rc.iterations + 1
              and c["dia_coarse_tail"] + c["dia_coarse_tail_mf"] == 0
              and c["dia_prolong_smooth_dot"] == 0
              and c["dia_spmv_dot"] == c["cg_update"] == rc.iterations,
              f"32^3 {path}: r.z from {tail} once per cycle, B6/B7 per "
              f"iteration {c}")


def phase_flagship(torch, amgx, dev, per_path):
    """The untouched FLAGSHIP at 128^3 (matrix-free on the card: B3-mf /
    B4-mf above the tail, one B5-mf per V-cycle), the same with the slab
    route pinned (flagship_slab), and the slab tail-off run; warm solves
    in alternating pairs: matrix-free against slab, slab against
    tail-off."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF
    n = 128
    runs, slvs = {}, {}
    for label, cfg in (("flagship", FLAGSHIP),
                       ("flagship_slab", FLAGSHIP + SLAB),
                       ("flagship_tail_off", FLAGSHIP_TAIL_OFF + SLAB)):
        res, slv, setup_s, solve_s, true_rel = run_path(
            amgx, per_path, label, lambda c=cfg: solve(
                torch, amgx, c + ", store_res_history=1", n, dev))
        slvs[label] = slv
        c = per_path[label]
        inner = int(res.extra_stats["inner_iters"])
        levels = levels_of(slv)
        _, warm_s = warm_solve(torch, slv, n, torch.float64)
        above = sum(r > 65536 for r in levels[:-1])
        mf = "_mf" if label == "flagship" else ""
        other = "" if mf else "_mf"
        # every V-cycle: B3 and B4 on each level above the tail (all
        # levels with the tail off) -- B3-mf and B4-mf one launch each,
        # the slab B3 / B4 the planned split of temporally blocked
        # launches (3 + 3 and 3 + 2 at 128^3 and 64^3), the GEO tables
        # restricting in the tile -- then ONE B5 launch for the rest
        smoothed = range(above if label != "flagship_tail_off"
                         else len(levels) - 1)
        per3, per4 = (len(smoothed), len(smoothed)) if mf \
            else slab_cycle_launches(torch, K, slv, smoothed)
        runs[label] = {"setup_s": setup_s, "solve_s": solve_s,
                       "warm_solve_s": warm_s, "inner_iterations": inner,
                       "outer_iterations": res.iterations,
                       "b3_b4_launches_per_cycle": [per3, per4]}
        emit({"phase": "flagship", "config": label, "rows": n ** 3,
              "setup_s": setup_s, "solve_s": solve_s, "warm_solve_s": warm_s,
              "levels": levels, "outer_iterations": res.iterations,
              "inner_iterations": inner, "status": res.status,
              "true_rel_res": true_rel,
              "res_history": [float(h) for h in res.res_history],
              "b3_b4_launches_per_cycle": [per3, per4], "launches": c})
        check(res.status == "success" and true_rel <= 1e-8,
              f"128^3 {label} true relative residual {true_rel} <= 1e-8")
        check(res.iterations <= 3, f"{res.iterations} outer iterations <= 3")
        check(c["dia_spmv"] > 0 and c["dia_smooth_restrict" + mf] > 0
              and c["dia_prolong_smooth" + mf] > 0
              and c["dia_smooth_restrict" + other] == 0
              and c["dia_prolong_smooth" + other] == 0
              and c["dia_coarse_tail" + other] == 0,
              f"{label}: B1, B3{mf}, B4{mf} ran, none of the other route {c}")
        check(c["dia_smooth_restrict" + mf] == inner * per3
              and c["dia_prolong_smooth" + mf] == inner * per4
              and c["dia_smooth_restrict_mf_epilogue"] == 0
              and sum(c[k] for k in MF_STEP_ROUTE + SLAB_STEP_ROUTE) == 0,
              f"{label}: B3{mf}/B4{mf} on levels {list(smoothed)}, "
              f"{per3} / {per4} launches a V-cycle: {c}")
        if label != "flagship_tail_off":
            check(above == 2 and c["dia_coarse_tail" + mf] == inner,
                  f"{label}: one B5{mf} launch per V-cycle: {c}, {inner} "
                  f"cycles")
        else:
            check(c["dia_coarse_tail"] == 0, "tail off: no B5 launch")
    check(runs["flagship"]["inner_iterations"]
          == runs["flagship_slab"]["inner_iterations"]
          and runs["flagship"]["outer_iterations"]
          == runs["flagship_slab"]["outer_iterations"],
          f"matrix-free and slab flagships: same iterations {runs}")
    for a, b_ in (("flagship", "flagship_slab"),
                  ("flagship_slab", "flagship_tail_off")):
        warm, wins = paired_warm(torch, {a: slvs[a], b_: slvs[b_]}, n,
                                 torch.float64)
        emit({"phase": f"{a}_vs_{b_}", "rows": n ** 3,
              "warm_solve_s": warm, "pairs": PAIRS, "first_wins": wins,
              "warm_median_ratio": warm[a]["median"] / warm[b_]["median"],
              **{f"{k}_{c}": v for k, r in runs.items() if k in (a, b_)
                 for c, v in r.items()}})
    return runs, slvs


def phase_flagship_dad(torch, amgx, dev, per_path):
    """The untouched FLAGSHIP (matrix_free=auto, the card's default) on
    A2 = D A D (`dad_operator`): variable coefficients, so the detector
    finds no constant stencil and every level keeps its value slab. At
    128^3: the true relative residual of A2 <= 1e-8 in <= 3 outer
    iterations, the slab B3 / B4 tiled on the levels above the tail (the
    planned launches a V-cycle, no per-step route, nothing matrix-free)
    and one slab B5 a V-cycle; at 32^3 the card's outer and inner
    iterations equal the CPU route's on the same input."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.presets import FLAGSHIP
    n = 128
    res, slv, setup_s, solve_s, true_rel = run_path(
        amgx, per_path, "flagship_dad", lambda: solve(
            torch, amgx, FLAGSHIP + ", store_res_history=1", n, dev,
            op=dad_operator))
    c = per_path["flagship_dad"]
    inner = int(res.extra_stats["inner_iters"])
    levels = levels_of(slv)
    above = sum(r > 65536 for r in levels[:-1])
    per3, per4 = slab_cycle_launches(torch, K, slv, range(above))
    amg = precond_amg(slv)
    b = torch.ones(n ** 3, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    slv.solve(b)
    warm_s = time.perf_counter() - t0
    emit({"phase": "flagship_dad", "config": "flagship_dad", "rows": n ** 3,
          "setup_s": setup_s, "solve_s": solve_s, "warm_solve_s": warm_s,
          "levels": levels, "outer_iterations": res.iterations,
          "inner_iterations": inner, "status": res.status,
          "true_rel_res": true_rel,
          "res_history": [float(h) for h in res.res_history],
          "b3_b4_launches_per_cycle": [per3, per4], "launches": c})
    check(res.status == "success" and true_rel <= 1e-8
          and res.iterations <= 3,
          f"128^3 flagship_dad: {res.status}, true relative residual of "
          f"A2 {true_rel} <= 1e-8 in {res.iterations} <= 3 outer")
    check(all(lv.smoother._mf_stencil is None for lv in amg.levels),
          "flagship_dad: no level is a constant stencil")
    check(above == 2 and c["dia_coarse_tail"] == inner
          and c["dia_smooth_restrict"] == inner * per3
          and c["dia_prolong_smooth"] == inner * per4
          and sum(c[k] for k in MF_STEP_ROUTE + SLAB_STEP_ROUTE) == 0
          and all(c[k] == 0 for k in c if "_mf" in k),
          f"flagship_dad: slab B3 / B4 tiled on the {above} levels above "
          f"the tail ({per3} / {per4} launches a V-cycle), one slab B5 a "
          f"V-cycle, nothing matrix-free: {c}, {inner} cycles")
    m3 = 32
    rc, _, _, _, tc = solve(torch, amgx, FLAGSHIP, m3, dev, op=dad_operator)
    rh, _, _, _, th = solve(torch, amgx, FLAGSHIP, m3, torch.device("cpu"),
                            op=dad_operator)
    inner_c, inner_h = (int(r.extra_stats["inner_iters"]) for r in (rc, rh))
    emit({"phase": "flagship_dad", "config": f"flagship_dad_{m3}^3",
          "rows": m3 ** 3, "outer_cuda": rc.iterations,
          "outer_cpu": rh.iterations, "inner_cuda": inner_c,
          "inner_cpu": inner_h, "true_rel_res_cuda": tc,
          "true_rel_res_cpu": th})
    check(rc.iterations == rh.iterations and inner_c == inner_h
          and tc <= 1e-8, f"{m3}^3 flagship_dad: the card's {rc.iterations}"
          f" / {inner_c} iterations against the CPU's {rh.iterations} / "
          f"{inner_h}")


# the float32 smoother forms a bf16 cycle must not launch on its levels
F32_SMOOTHERS = ("dia_smooth", "dia_smooth_restrict", "dia_prolong_smooth",
                 "dia_smooth_mf", "dia_smooth_restrict_mf",
                 "dia_prolong_smooth_mf", "dia_coarse_tail",
                 "dia_coarse_tail_mf", "dia_smooth_restrict_w",
                 "dia_prolong_smooth_w", "csr_smooth")


def phase_flagship_bf16(torch, amgx, dev, per_path, f32_runs, f32_slvs):
    """FLAGSHIP + solve_precision=bfloat16 at 128^3: matrix-free (the
    card's default), slab pinned, and the slab tail-off run (the coarse
    solve in float32 around the bf16 cycle). Each within 1e-8 in <= 3
    outer iterations and <= BF16_INNER_RATIO x the inner iterations of
    the float32 flagship of the same route (one bf16 store per call:
    rounding the state at every step costs 2-5x); the two tail runs in
    the outer and within one of the inner iterations of the same solve
    on the CPU (the kernels' plain forms); its bf16 kernels on every
    level above the coarsest, no float32 smoother launch. Then
    warm solves of the float32 and the bf16 flagship in alternating pairs:
    mixed_precision_speedup (bench.py's name) = warm f32 / warm bf16,
    recorded, not checked."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.presets import FLAGSHIP, FLAGSHIP_TAIL_OFF
    n = 128
    slvs = {}
    ref, _, _, ref_s, ref_rel = solve(torch, amgx, FLAGSHIP + BF16, n,
                                      torch.device("cpu"))
    ref_inner = int(ref.extra_stats["inner_iters"])
    emit({"phase": "flagship_bf16", "config": "flagship_bf16 cpu",
          "rows": n ** 3, "solve_s": ref_s,
          "outer_iterations": ref.iterations, "inner_iterations": ref_inner,
          "status": ref.status, "true_rel_res": ref_rel})
    check(ref.status == "success" and ref_rel <= 1e-8,
          f"128^3 bf16 flagship on the CPU: {ref_rel} <= 1e-8")
    for label, cfg, twin in (
            ("flagship_bf16", FLAGSHIP + BF16, "flagship"),
            ("flagship_bf16_slab", FLAGSHIP + SLAB + BF16, "flagship_slab"),
            ("flagship_bf16_tail_off", FLAGSHIP_TAIL_OFF + SLAB + BF16,
             "flagship_tail_off")):
        res, slv, setup_s, solve_s, true_rel = run_path(
            amgx, per_path, label, lambda c=cfg: solve(
                torch, amgx, c + ", store_res_history=1", n, dev))
        slvs[label] = slv
        c = per_path[label]
        inner = int(res.extra_stats["inner_iters"])
        f32_inner = f32_runs[twin]["inner_iterations"]
        levels = levels_of(slv)
        _, warm_s = warm_solve(torch, slv, n, torch.float64)
        emit({"phase": "flagship_bf16", "config": label, "rows": n ** 3,
              "setup_s": setup_s, "solve_s": solve_s, "warm_solve_s": warm_s,
              "levels": levels, "outer_iterations": res.iterations,
              "inner_iterations": inner, "f32_inner_iterations": f32_inner,
              "status": res.status, "true_rel_res": true_rel,
              "res_history": [float(h) for h in res.res_history],
              "launches": c})
        check(res.status == "success" and true_rel <= 1e-8,
              f"128^3 {label} true relative residual {true_rel} <= 1e-8")
        check(res.iterations <= 3, f"{res.iterations} outer iterations <= 3")
        check(inner <= BF16_INNER_RATIO * f32_inner,
              f"{label}: {inner} inner iterations > "
              f"{BF16_INNER_RATIO:.3f} x the float32 flagship's {f32_inner}")
        if label != "flagship_bf16_tail_off":
            check(res.iterations == ref.iterations
                  and abs(inner - ref_inner) <= 1,
                  f"{label}: {res.iterations} outer / {inner} inner "
                  f"iterations against the CPU's {ref.iterations} / "
                  f"{ref_inner}")
        mf = "_mf" if label == "flagship_bf16" else ""
        check(all(c[k] == 0 for k in F32_SMOOTHERS) and c["dia_spmv"] > 0,
              f"{label}: no float32 smoother launch, B1 in FGMRES {c}")
        check(sum(c[k] for k in MF_STEP_ROUTE + SLAB_STEP_ROUTE) == 0
              and c["dia_smooth_restrict_mf_epilogue_bf16"] == 0,
              f"{label}: no per-step route, no untiled restriction {c}")
        if label == "flagship_bf16_tail_off":
            lv = range(len(levels) - 1)
            per3, per4 = slab_cycle_launches(torch, K, slv, lv)
            check(c["dia_coarse_tail_bf16"] + c["dia_coarse_tail_mf_bf16"]
                  == 0 and c["dia_smooth_restrict_bf16"] == inner * per3
                  and c["dia_prolong_smooth_bf16"] == inner * per4,
                  f"{label}: bf16 B3/B4 on all {len(lv)} levels, {per3} / "
                  f"{per4} launches a V-cycle, no B5 {c}")
            continue
        above = sum(r > 65536 for r in levels[:-1])
        # every V-cycle: B3 and B4 on each level above the tail (B3-mf
        # and B4-mf: one launch each; the slab B3 / B4 their planned
        # split), then ONE B5 launch for the rest
        per3, per4 = (above, above) if mf \
            else slab_cycle_launches(torch, K, slv, range(above))
        check(above == 2 and c[f"dia_coarse_tail{mf}_bf16"] == inner
              and c[f"dia_smooth_restrict{mf}_bf16"] == inner * per3
              and c[f"dia_prolong_smooth{mf}_bf16"] == inner * per4,
              f"{label}: bf16 B3{mf}/B4{mf} on the {above} levels above the "
              f"tail ({per3} / {per4} launches a V-cycle), one bf16 B5{mf} "
              f"per V-cycle: {c}, {inner} cycles")
    warm, wins = paired_warm(torch, {"flagship": f32_slvs["flagship"],
                                     "flagship_bf16": slvs["flagship_bf16"]},
                             n, torch.float64)
    emit({"phase": "flagship_vs_flagship_bf16", "rows": n ** 3,
          "warm_solve_s": warm, "pairs": PAIRS, "first_wins": wins,
          "mixed_precision_speedup": warm["flagship"]["median"]
          / warm["flagship_bf16"]["median"]})


def smooth_cycle_launches(torch, K, slv, levels):
    """B2 (or B2-mf) launches of one unfused V-cycle on the levels
    `levels` of a solver's hierarchy: on each, the presmoother with the
    residual and the postsmoother without, asked of the dispatch
    (`K.smooth_plans` on a slab level, `K.mf_smooth_plans` on a
    matrix-free one) on the cycle's own level data (its dtype, its
    smoother's schedule): checks that each takes the tiled route and
    counts the planned launches."""
    amg = precond_amg(slv)
    data = amg.solve_data()["levels"]
    total = 0
    for i in levels:
        ld = data[i]
        A, smd = ld["A"], ld["smoother"]
        st = smd.get("stencil")
        per_sweep = smd["taus"].shape[0] if "taus" in smd else 1
        dt = (st.coeffs if st is not None else A.dia_vals).dtype
        x = torch.zeros(A.num_rows, dtype=dt, device=A.device)
        for pre in (True, False):
            s = per_sweep * amg._sweeps(i, pre=pre)
            plans = K.mf_smooth_plans(st, x, s, pre) if st is not None \
                else K.smooth_plans(A.dia_vals, A.dia_offsets, A.grid_shape,
                                    smd.get("dinv"), x, s, pre)
            check(plans is not None, f"level {i} ({A.num_rows} rows): B2"
                  f"{'-mf' if st is not None else ''} takes the per-step "
                  f"route")
            total += len(plans)
    return total


# every counter of B2 and B2-mf, each route and dtype
B2_COUNTERS = ("dia_smooth", "dia_smooth_mf", "dia_smooth_step",
               "dia_smooth_mf_step", "dia_smooth_bf16", "dia_smooth_mf_bf16",
               "dia_smooth_step_bf16", "dia_smooth_mf_step_bf16")


def phase_unfused_bf16(torch, amgx, dev, per_path):
    """The tail-off bf16 flagship at 64^3 with amg:cycle_fusion=0 (a
    depth cut that keeps the script within its time; the float32 unfused
    paths run at 128^3): bf16 B2 on slab levels (pinned), bf16 B2-mf on
    matrix-free ones, tiled on every level, the planned launches a
    V-cycle."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.presets import FLAGSHIP_TAIL_OFF
    for path, pin, b2 in (("unfused_bf16", SLAB, "dia_smooth_bf16"),
                          ("unfused_mf_bf16", "", "dia_smooth_mf_bf16")):
        unf, slv, _, _, rel_u = run_path(
            amgx, per_path, path, lambda p=pin: solve(
                torch, amgx, FLAGSHIP_TAIL_OFF + ", amg:cycle_fusion=0" + p
                + BF16, 64, dev))
        c = per_path[path]
        inner = int(unf.extra_stats["inner_iters"])
        per_cycle = smooth_cycle_launches(
            torch, K, slv, range(len(levels_of(slv)) - 1))
        emit({"phase": "unfused_bf16", "config": path, "rows": 64 ** 3,
              "outer_iterations": unf.iterations, "inner_iterations": inner,
              "true_rel_res": rel_u, "b2_launches_per_cycle": per_cycle,
              "launches": c})
        check(unf.status == "success" and rel_u <= 1e-8,
              f"64^3 {path} true relative residual {rel_u} <= 1e-8")
        check(c[b2] > 0 and sum(c[k] for k in B2_COUNTERS) == c[b2]
              and all(c[k] == 0 for k in F32_SMOOTHERS),
              f"{b2} ran unfused, nothing else smoothed {c}")
        check(c[b2] == inner * per_cycle,
              f"{path}: {per_cycle} tiled {b2} launches a V-cycle, {inner} "
              f"cycles: {c}")


def phase_unfused(torch, amgx, dev, per_path, f32_runs):
    """The tail-off flagship at 128^3 with cycle_fusion=0: B2 on slab
    levels (pinned), B2-mf on matrix-free ones (the card's default),
    temporally blocked on every level (`smooth_cycle_launches`: the
    planned launches a V-cycle, none of the per-step route); <= 1e-8 in 2
    outer iterations, inner iterations within one of the fused tail-off
    flagship's on the same card."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.presets import FLAGSHIP_TAIL_OFF
    n = 128
    fused_inner = f32_runs["flagship_tail_off"]["inner_iterations"]
    for path, pin, b2 in (("unfused", SLAB, "dia_smooth"),
                          ("unfused_mf", "", "dia_smooth_mf")):
        unf, slv, setup_u, solve_u, rel_u = run_path(
            amgx, per_path, path, lambda p=pin: solve(
                torch, amgx, FLAGSHIP_TAIL_OFF + ", amg:cycle_fusion=0" + p,
                n, dev))
        _, warm_u = warm_solve(torch, slv, n, torch.float64)
        c = per_path[path]
        inner = int(unf.extra_stats["inner_iters"])
        levels = levels_of(slv)
        per_cycle = smooth_cycle_launches(torch, K, slv,
                                          range(len(levels) - 1))
        emit({"phase": "unfused", "config": path, "rows": n ** 3,
              "setup_s": setup_u, "solve_s": solve_u, "warm_solve_s": warm_u,
              "levels": levels, "outer_iterations": unf.iterations,
              "inner_iterations": inner,
              "flagship_tail_off_inner_iterations": fused_inner,
              "true_rel_res": rel_u, "b2_launches_per_cycle": per_cycle,
              "launches": c})
        check(unf.status == "success" and rel_u <= 1e-8
              and unf.iterations == 2,
              f"128^3 {path}: {unf.status}, true relative residual {rel_u} "
              f"<= 1e-8 in {unf.iterations} == 2 outer iterations")
        check(abs(inner - fused_inner) <= 1,
              f"{path}: {inner} inner iterations against the fused "
              f"tail-off flagship's {fused_inner}")
        check(c[b2] > 0 and sum(c[k] for k in B2_COUNTERS) == c[b2],
              f"{b2} ran unfused, the other route and the per-step route "
              f"did not {c}")
        check(c[b2] == inner * per_cycle and all(
            c[k] == 0 for k in ("dia_smooth_restrict", "dia_prolong_smooth",
                                "dia_smooth_restrict_mf",
                                "dia_prolong_smooth_mf", "dia_coarse_tail",
                                "dia_coarse_tail_mf")),
              f"{path}: {per_cycle} tiled {b2} launches a V-cycle, {inner} "
              f"cycles, no fused B3 / B4 / B5: {c}")


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
    """PCG + GEO + JACOBI_L1 at 128^3 in float32: krylov_fusion 1 and 0 on
    the card's default (matrix-free: B4-mf's dot carries r.z, B5-mf once
    per cycle), and krylov_fusion 1 with the slab route pinned (B4's dot,
    B5); warm solves in alternating pairs: fused against unfused,
    matrix-free against slab."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    n = 128
    iters, slvs = {}, {}
    for path, cfg in (("pcg_krylov_fusion=1", PCG + "1"),
                      ("pcg_krylov_fusion=1_slab", PCG + "1" + SLAB),
                      ("pcg_krylov_fusion=0", PCG + "0")):
        res, slv, setup_s, solve_s, true_rel = run_path(
            amgx, per_path, path, lambda c=cfg: solve(
                torch, amgx, c, n, dev, torch.float32))
        slvs[path] = slv
        (warm, warm_s), syncs = count_syncs(
            torch, lambda: warm_solve(torch, slv, n, torch.float32))
        c = per_path[path]
        iters[path] = res.iterations
        emit({"phase": "krylov", "config": path, "rows": n ** 3,
              "levels": levels_of(slv), "setup_s": setup_s,
              "solve_s": solve_s, "warm_solve_s": warm_s,
              "iterations": res.iterations, "status": res.status,
              "true_rel_res": true_rel, "host_syncs_warm": syncs,
              "host_syncs_per_iteration": syncs / max(warm.iterations, 1),
              "launches": c})
        check(res.status == "success", f"128^3 PCG {path}: {res.status}")
        check(abs(res.iterations - PCG_ANCHOR) <= 2,
              f"128^3 PCG {path}: {res.iterations} iterations, anchor "
              f"{PCG_ANCHOR} +- 2")
        cycles = res.iterations + 1
        mf, other = ("", "_mf") if path.endswith("_slab") else ("_mf", "")
        check(c["dia_coarse_tail" + mf] > 0
              and c["dia_smooth_restrict" + other] == 0
              and c["dia_prolong_smooth" + other] == 0
              and c["dia_coarse_tail" + other] == 0,
              f"PCG {path}: one B5{mf} per cycle, no {other or 'slab'} "
              f"route {c}")
        if path.startswith("pcg_krylov_fusion=1"):
            check(c["dia_spmv_dot"] == c["cg_update"] == res.iterations
                  and c["dia_prolong_smooth" + mf + "_dot"] == cycles
                  and c["dia_coarse_tail" + mf] == cycles,
                  f"fused PCG {path}: B6, B7 per iteration, B4{mf}'s dot "
                  f"once per cycle {c}")
        else:
            check(c["dia_spmv"] > res.iterations and c["dia_spmv_dot"] == 0
                  and c["cg_update"] == 0, f"unfused PCG: B1 {c}")
        if path.endswith("_slab"):
            # the slab B3 / B4 tiled on the levels above the tail (one
            # launch a call at PCG's one presweep and two postsweeps)
            amg = precond_amg(slv)
            above = range(sum(r > 65536 for r in amg.level_rows()[:-1]))
            per3, per4 = slab_cycle_launches(torch, K, slv, above)
            check(c["dia_smooth_restrict"] == cycles * per3
                  and c["dia_prolong_smooth"] + c["dia_prolong_smooth_dot"]
                  == cycles * per4
                  and sum(c[k] for k in SLAB_STEP_ROUTE) == 0,
                  f"PCG {path}: B3 / B4 tiled, {per3} / {per4} launches a "
                  f"cycle {c}")
    check(max(iters.values()) - min(iters.values()) <= 1,
          f"PCG fused / slab / unfused iterations {iters}")
    for a, b_ in (("pcg_krylov_fusion=1", "pcg_krylov_fusion=0"),
                  ("pcg_krylov_fusion=1", "pcg_krylov_fusion=1_slab")):
        warm, wins = paired_warm(torch, {a: slvs[a], b_: slvs[b_]}, n,
                                 torch.float32)
        emit({"phase": f"krylov_{a}_vs_{b_}", "rows": n ** 3,
              "warm_solve_s": warm, "pairs": PAIRS, "first_wins": wins,
              "warm_median_ratio": warm[a]["median"] / warm[b_]["median"]})


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
            per_call = weighted_per_call(torch, amg)
            emit({"phase": "classical_weighted_launches", "config": path,
                  "b3w_b4w_per_call": per_call})
            check(weighted_cycles(c, per_call) == cycles,
                  f"{path}: B3w ({per_call[0]} launches) and B4w "
                  f"({per_call[1]}) once per cycle, {cycles} cycles {c}")
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
    per_call = weighted_per_call(torch, amg)
    check(weighted_cycles(c, per_call) is not None,
          f"{path}: B3w ({per_call[0]} launches) and B4w ({per_call[1]}) "
          f"once per cycle {c}")

def agg_library(torch, A, agg, nc):
    """cuSPARSE's SpGEMM P^T (A P) with P the 0/1 aggregation matrix (n x
    nc), its symbolic phase included: the library yardstick of B10's
    relabel form."""
    dev = agg.device
    n = agg.shape[0]
    agg = agg.long()
    one = torch.ones(n, dtype=torch.float32, device=dev)
    P = torch.sparse_csr_tensor(
        torch.arange(n + 1, dtype=torch.int64, device=dev), agg, one,
        (n, nc), check_invariants=True)
    ro = torch.zeros(nc + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(agg, minlength=nc), 0, out=ro[1:])
    Pt = torch.sparse_csr_tensor(ro, torch.argsort(agg, stable=True), one,
                                 (nc, n), check_invariants=True)
    As = csr_library(torch, A)
    return lambda: torch.sparse.mm(Pt, torch.sparse.mm(As, P))


def relabel_case(torch, R_, lv):
    """B10's relabel form on one aggregation level's float32 plan:
    (case, sizes). Bound: st and the gathered value once per candidate,
    starts2 and the coarse value once per coarse entry."""
    from amgx_tpu_torch.ops.segment import ordered_segment_sum_plain
    plan = lv._rap_plan_memo[3]
    af = lv.A.values
    nnz, nU = plan.st.numel(), plan.nU
    case = (lambda: R_.rap_values_relabel(plan, af),
            lambda: R_.rap_values_relabel_plain(
                plan, af, ordered_segment_sum_plain),
            (2 * nnz + 2 * nU + 1) * 4, nnz, 1,
            agg_library(torch, lv.A, lv.aggregates, int(lv.coarse_size)))
    return case, {"candidates": nnz, "nU": nU,
                  "plan_bytes": plan.nbytes()}


def agg_transfer_cases(torch, K, lv, dev):
    """B3/B3-mf and B4/B4-mf (and their x'.b variants) on a SIZE_2 level 0
    with its irregular children table, with the path's smoother
    (BLOCK_JACOBI: the diagonal's inverse, three steps at 0.8): name ->
    case, name -> the slab kernel's call on the same level, and name ->
    the launches by counter one call makes. A SIZE_2 pair may cross a
    tile edge, so B3 and B3-mf take the temporally blocked steps there,
    then dia.cu's restriction ("dia_smooth_restrict_epilogue",
    "dia_smooth_restrict_mf_epilogue")."""
    from amgx_tpu_torch.ops import stencil as mf
    from amgx_tpu_torch.solvers.relaxation import safe_recip
    A = lv.A
    xfer = lv._transfer_tables()
    check(xfer is not None, "the SIZE_2 level 0 fuses its transfers")
    vals, offs = A.dia_vals, A.dia_offsets
    ctab, agg = xfer["ctab"], xfer["agg"]
    n, k = A.num_rows, len(offs)
    m, nc = ctab.shape
    st = mf.detect_stencil(A, dinv_mode="jacobi")
    check(st is not None, "the 7-pt level 0 is a stencil")
    dinv = safe_recip(A.diagonal())
    taus = torch.full((3,), 0.8, device=dev)
    s = taus.shape[0]
    g = torch.Generator(device=dev).manual_seed(2024)
    b, x = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    xc = torch.randn(nc, generator=g, device=dev)
    app = (2 * k + 4) * n                 # flops of one step with dinv
    rb = (m * nc + nc) * 4                # ctab read, bc written
    grid = A.grid_shape
    route, p3, _ = K.slab_route(vals, offs, grid, dinv, x, s, ctab)
    _, p4, _ = K.slab_route(vals, offs, grid, dinv, x, s)
    check(route == "tiled+epilogue" and p4 is not None,
          f"SIZE_2 level 0: B3's tiled steps and the untiled restriction "
          f"({route}), B4 tiled")
    cases = {
        "dia_smooth_restrict": (
            lambda: K.dia_smooth_restrict(vals, offs, taus, b, x, ctab, dinv,
                                          grid=grid),
            lambda: K.dia_smooth_restrict_plain(vals, offs, taus, b, x, ctab,
                                                dinv),
            (k * n + 4 * n + s) * 4 + rb, s * app + (2 * k + 2) * n,
            len(p3) + 1, None),
        "dia_smooth_restrict_mf": (
            lambda: K.dia_smooth_restrict_mf(st, taus, b, x, ctab),
            lambda: mf._xla_restrict(st.spec(), st.coeffs, taus, b, x, ctab),
            (k + 3 * n + s) * 4 + rb, s * app + (2 * k + 2) * n, 2,
            None),
        "dia_prolong_smooth": (
            lambda: K.dia_prolong_smooth(vals, offs, taus, b, x, xc, agg,
                                         dinv, grid=grid),
            lambda: K.dia_prolong_smooth_plain(vals, offs, taus, b, x, xc,
                                               agg, dinv),
            (k * n + 5 * n + s + nc) * 4, s * app + n, len(p4), None),
        "dia_prolong_smooth_mf": (
            lambda: K.dia_prolong_smooth_mf(st, taus, b, x, xc, agg),
            lambda: mf._xla_corr(st.spec(), st.coeffs, taus, b, x, xc, agg),
            (k + 4 * n + s + nc) * 4, s * app + n, 1, None),
        "dia_prolong_smooth_dot": (
            lambda: K.dia_prolong_smooth(vals, offs, taus, b, x, xc, agg,
                                         dinv, with_dot=True, grid=grid),
            lambda: K.dia_prolong_smooth_plain(vals, offs, taus, b, x, xc,
                                               agg, dinv, with_dot=True),
            (k * n + 5 * n + s + nc + 1) * 4, s * app + 3 * n, len(p4),
            None),
        "dia_prolong_smooth_mf_dot": (
            lambda: K.dia_prolong_smooth_mf(st, taus, b, x, xc, agg,
                                            with_dot=True),
            lambda: mf._xla_corr(st.spec(), st.coeffs, taus, b, x, xc, agg,
                                 with_dot=True),
            (k + 4 * n + s + nc + 1) * 4, s * app + 3 * n, 1, None),
    }
    slab = {"dia_smooth_restrict_mf": cases["dia_smooth_restrict"][0],
            "dia_prolong_smooth_mf": cases["dia_prolong_smooth"][0],
            "dia_prolong_smooth_mf_dot": cases["dia_prolong_smooth_dot"][0]}
    moved = {"dia_smooth_restrict_mf": {"dia_smooth_restrict_mf": 1,
                                        "dia_smooth_restrict_mf_epilogue": 1},
             "dia_smooth_restrict": {"dia_smooth_restrict": len(p3),
                                     "dia_smooth_restrict_epilogue": 1}}
    if len(p4) > 1:
        moved["dia_prolong_smooth_dot"] = {
            "dia_prolong_smooth": len(p4) - 1, "dia_prolong_smooth_dot": 1}
    return cases, slab, moved, {"m": m, "nc": nc, "b3_split": [
        p.apps for p in p3], "b4_split": [p.apps for p in p4]}


def agg_bits(torch, amg):
    """The aggregates and every operator tensor of a set-up aggregation
    hierarchy, on the CPU."""
    out = []
    for lv in amg.levels:
        out += [lv.aggregates, lv.A.row_offsets, lv.A.col_indices,
                lv.A.values]
    M = amg.coarsest_A
    return [t.cpu() for t in out + [M.row_offsets, M.col_indices,
                                    M.values]]


def true_rel_res(torch, A, x, b):
    """|b - A x| / |b| in float64."""
    from amgx_tpu_torch.ops.spmv import residual
    b64 = b.double()
    return float(torch.linalg.norm(residual(A.astype(torch.float64),
                                            x.double(), b64))
                 / torch.linalg.norm(b64))


def krylov_file_run(torch, amgx, dev, per_path, name, n, fusion=None,
                    dtype=None, extra=None, hold=True, warm=True,
                    phase="bicgstab"):
    """Set up and solve configs/<name>.json on the 7-pt n^3 in float32
    (or `dtype`; krylov_fusion set to `fusion` on top of the file when
    given), then a warm solve under the sync counter; where
    KRYLOV_ANCHORS has the anchor (keyed (name, n), with "float64" added
    for a float64 run), hold the run to it. `extra(slv, A, b, res)`, when
    given, returns more fields for the record; `hold=False` records the
    run without holding its status or iterations; `warm=False` skips the
    warm solve (its time and host syncs are then None); `phase` names the
    record's phase. Returns (the emitted record, launch counts in the
    solve, result)."""
    dtype = dtype or torch.float32
    f64 = dtype == torch.float64
    path = f"{name}_{n}^3" + ("" if fusion is None
                              else f"_krylov_fusion={fusion}") + (
        "_float64" if f64 else "")
    anchor = KRYLOV_ANCHORS.get((name, n, "float64") if f64 else (name, n))
    cfg = amgx.Config.from_file(os.path.join(ROOT, "configs",
                                             name + ".json"))
    if fusion is not None:
        cfg.set("krylov_fusion", fusion)
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=dtype, device=dev).init()
    b = torch.ones(n ** 3, dtype=dtype, device=dev)
    slv = amgx.create_solver(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    amgx.reset_kernel_launches()
    t0 = time.perf_counter()
    slv.setup(A)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    in_setup = amgx.kernel_launches()
    t0 = time.perf_counter()
    res = slv.solve(b)
    first_s = time.perf_counter() - t0
    per_path[path] = c = amgx.kernel_launches()
    in_solve = {k: v - in_setup[k] for k, v in c.items()}
    if warm:
        (warm_res, warm_s), syncs = count_syncs(
            torch, lambda: warm_solve(torch, slv, n, dtype))
    else:
        warm_res, warm_s, syncs = res, None, None
    final_rel = float(res.res_norm / res.norm0)
    amg = None
    s = slv
    while s is not None and amg is None:
        amg = getattr(s, "amg", None)
        s = s.preconditioner
    rec = {"phase": phase, "config": path,
           "file": f"configs/{name}.json", "rows": n ** 3,
           "levels": None if amg is None else amg.level_rows(),
           "iterations": res.iterations, "status": res.status,
           "final_rel_res": final_rel, "anchor": anchor,
           "true_rel_res": true_rel_res(torch, A, res.x, b),
           "setup_s": setup_s, "first_solve_s": first_s,
           "warm_solve_s": warm_s, "warm_iterations": warm_res.iterations,
           "setup_peak_bytes": peak, "host_syncs_warm": syncs,
           "host_syncs_per_iteration": None if syncs is None
           else syncs / max(warm_res.iterations, 1),
           "launches_in_solve": {k: v for k, v in in_solve.items() if v},
           "launches": c}
    if extra is not None:
        rec.update(extra(slv, A, b, res))
    emit(rec)
    check(warm_res.iterations == res.iterations,
          f"{path}: warm solve {warm_res.iterations} iterations, first "
          f"{res.iterations}")
    if not hold:
        return rec, in_solve, res
    if anchor is None:
        check(res.status == "success", f"{path}: {res.status}")
        return rec, in_solve, res
    it0, st0, rr0 = (anchor[k] for k in ("iterations", "status", "final"))
    itol = anchor.get("iter_tol", 2)
    check(res.status == st0 and abs(res.iterations - it0) <= itol,
          f"{path}: {res.status} in {res.iterations} iterations, anchor "
          f"{st0} in {it0} +- {itol}")
    true0 = anchor.get("true_max")
    check(true0 is None or rec["true_rel_res"] <= true0,
          f"{path}: true relative residual {rec['true_rel_res']}, at most "
          f"{true0}")
    check(anchor["levels"] is None or rec["levels"] == anchor["levels"],
          f"{path}: level rows {rec['levels']}, the JAX package's "
          f"{anchor['levels']}")
    if res.status != "max_iters":
        return rec, in_solve, res
    rr64 = anchor.get("final_f64")
    tol = anchor.get("final_tol", 0.01)
    if rr64 is None or abs(rr0 - rr64) <= 0.01 * rr0:
        check(abs(final_rel - rr0) <= tol * rr0,
              f"{path}: final relative residual {final_rel}, anchor {rr0} "
              f"+- {tol:.0%}")
    else:
        check(abs(rec["true_rel_res"] - final_rel) <= 0.01 * final_rel,
              f"{path}: monitored relative residual {final_rel}, true "
              f"{rec['true_rel_res']}: not within 1 %")
    return rec, in_solve, res


def phase_bicgstab(torch, amgx, dev, per_path):
    """AmgX's stock PBICGSTAB_CLASSICAL_JACOBI (64^3, against its
    anchor; its 128^3 pair gave its time to phase_eigen) and
    PBICGSTAB_NOPREC (128^3) in float32 with
    krylov_fusion 1 (the files' default: B6's streamed-dot form twice
    per iteration) and 0 (none; B1 carries the SpMVs), the two routes
    within one iteration of each other; PBICGSTAB_AGGREGATION_W_JACOBI
    at 64^3 (no warm solve: its W cycle over 11 levels is ~19 s a solve);
    GMRES_AMG_D2 at 128^3 and 64^3 and agg_cheb4 at 128^3. An
    anchored run holds the JAX package's status and iterations +- 2 (at
    max_iters its final residual to 1 %); every run reports the host
    syncs of a warm solve."""
    for name, n in (("PBICGSTAB_CLASSICAL_JACOBI", 64),
                    ("PBICGSTAB_NOPREC", 128)):
        iters = {}
        for fusion in (1, 0):
            rec, c, res = krylov_file_run(torch, amgx, dev, per_path, name,
                                          n, fusion)
            iters[fusion] = res.iterations
            if fusion:
                check(c["dia_spmv_ddot"] == 2 * res.iterations,
                      f"{rec['config']}: B6-ddot twice per iteration {c}")
            else:
                check(c["dia_spmv_ddot"] == 0
                      and c["dia_spmv"] >= 2 * res.iterations,
                      f"{rec['config']}: no B6-ddot, B1 for the SpMVs {c}")
            if name == "PBICGSTAB_NOPREC":
                check(rec["host_syncs_warm"] <= rec["warm_iterations"] + 3,
                      f"{rec['config']}: {rec['host_syncs_warm']} host "
                      f"syncs in {rec['warm_iterations']} iterations")
            else:
                check(c["csr_smooth"] > 0 and c["csr_spmv"] > 0,
                      f"{rec['config']}: B8/B9 on the classical levels {c}")
        check(abs(iters[1] - iters[0]) <= 1,
              f"{name} {n}^3: krylov_fusion 1 / 0 iterations {iters}")
    rec, c, res = krylov_file_run(torch, amgx, dev, per_path,
                                  "PBICGSTAB_AGGREGATION_W_JACOBI", 64,
                                  warm=False)
    check(c["dia_spmv_ddot"] == 2 * res.iterations and c["csr_smooth"] > 0,
          f"{rec['config']}: B6-ddot twice per iteration, B9 {c}")
    for n in (128, 64):
        rec, c, res = krylov_file_run(torch, amgx, dev, per_path,
                                      "GMRES_AMG_D2", n)
        check(c["dia_spmv"] >= res.iterations and c["csr_smooth"] > 0,
              f"{rec['config']}: B1 per Arnoldi step, B9 {c}")
    rec, c, res = krylov_file_run(torch, amgx, dev, per_path, "agg_cheb4",
                                  128)
    check(c["dia_spmv"] > 0 and c["csr_spmv"] > 0,
          f"{rec['config']}: B1 and B8 under the Chebyshev smoother {c}")


# the kernels that must not launch on a multicolor path: B2-B5 (every
# smoother-kernel counter), B6 / B7 (PCG's shell: PCG_DILU only) and B9;
# the setup's B10-relabel and K8 (its ordered sums) may
MC_ALLOWED = ("dia_spmv", "csr_spmv", "rap_values_relabel", "ordered_sum")
MC_SHELL = ("dia_spmv_dot", "cg_update")


def mc_forbidden(c, allowed=MC_ALLOWED):
    """The launches in counts `c` of kernels outside `allowed`."""
    return {k: v for k, v in c.items() if v and k not in allowed}


def profile_solve(torch, slv, b, iterations=6):
    """The first `iterations` iterations of a warm solve under
    torch.profiler (`profile_call`; a whole solve is ~10^5 launches):
    wall, the device's busy time, idle share, device ops and
    device->host copies, each also per iteration."""
    full = slv.max_iters
    slv.max_iters = iterations
    try:
        slv.solve(b)
        res, prof = profile_call(torch, lambda: slv.solve(b))
    finally:
        slv.max_iters = full
    it = max(res.iterations, 1)
    return {"iterations": res.iterations, "wall_s": prof["wall_s"],
            "device_busy_s": prof["device_busy_s"],
            "idle_share": prof["idle_share"],
            "device_ops": prof["device_ops"],
            "device_ops_per_iteration": prof["device_ops"] / it,
            "dtoh_per_iteration": prof["dtoh"] / it}


def mc_bits(torch, amg):
    """agg_bits plus each level's row colors and DILU Einv, on the CPU."""
    out = agg_bits(torch, amg)
    for lv in amg.levels:
        out += [lv.smoother.row_colors.cpu(), lv.smoother._Einv.cpu()]
    return out


def color_step_case(torch, amg):
    """One DILU forward color step on level 0 (B1 and three elementwise
    launches): its device ms and CUDA-event ms, on the middle color."""
    from amgx_tpu_torch.ops.spmv import spmv
    sd = amg.levels[0].smoother.solve_data()
    A0, Einv = sd["A"], sd["Einv"]
    mask = sd["masks"][len(sd["masks"]) // 2]
    g = torch.Generator(device=Einv.device).manual_seed(5)
    r = torch.randn(A0.num_rows, generator=g, device=Einv.device)
    delta = torch.where(mask, torch.zeros_like(r), r)

    def step():
        return torch.where(mask, Einv * (r - spmv(A0, delta)), delta)

    dms, recs = device_ms(torch, step, 4)
    return {"rows": A0.num_rows, "launches": 4, "device_ms": dms,
            "device_records": recs, "ms": time_ms(torch, step),
            "spmv_device_ms": device_ms(torch, lambda: spmv(A0, delta),
                                        1)[0]}


def phase_multicolor(torch, amgx, dev, per_path):
    """AmgX's stock multicolor, IDR and scaled files, read verbatim: the
    main path FGMRES_AGGREGATION_DILU at 128^3 (B1 / B8 in the solve,
    one B10-relabel per Galerkin product, nothing else; colors a level,
    a profile of a warm solve, level 0's color step), its 32^3
    determinism (two card setups bit-identical and equal to the CPU
    route's, the same iterations), PCG_DILU (B6 / B7 once an iteration),
    AGGREGATION_DILU / _GS / _THRUST_GS at MC_SIZE^3 (max_iters: status,
    level rows, final residual within MC_FINAL_TOL) and at 32^3 in
    float64 (the JAX package's iterations exactly), FGMRES_AGGREGATION
    at 64^3, IDR_DILU / IDRMSYNC_DILU at 64^3, V-cheby-smoother at 64^3
    in float64 (held to the anchor's divergence) and float32
    (recorded)."""
    main = {}

    def main_extra(slv, A, b, res):
        main["amg"] = amg = precond_amg(slv)
        return {"colors": [lv.smoother.num_colors for lv in amg.levels],
                "profile": profile_solve(torch, slv, b)}

    rec, c, res = krylov_file_run(torch, amgx, dev, per_path,
                                  "FGMRES_AGGREGATION_DILU", 128,
                                  extra=main_extra)
    path = rec["config"]
    amg = main.pop("amg")
    levels = len(amg.levels)
    emit({"phase": "multicolor", "config": path,
          "level0_color_step": color_step_case(torch, amg)})
    cp = per_path[path]
    check(c["dia_spmv"] > 0 and c["csr_spmv"] > 0,
          f"{path}: B1 and B8 in the solve {c}")
    check(not mc_forbidden(cp), f"{path}: no B2-B7 or B9 "
          f"{mc_forbidden(cp)}")
    check(cp["rap_values_relabel"] == levels and c["rap_values_relabel"]
          == 0, f"{path}: one B10-relabel per Galerkin product ({levels}) "
          f"{cp}")
    check(all(lv.smoother.num_colors >= 2 for lv in amg.levels)
          and rec["host_syncs_per_iteration"] <= 2,
          f"{path}: colors {rec['colors']}, host syncs "
          f"{rec['host_syncs_warm']}")
    del amg

    # 32^3 determinism: two card setups and the CPU route's
    name, n = "FGMRES_AGGREGATION_DILU", 32
    cpu = torch.device("cpu")
    cfg = amgx.Config.from_file(os.path.join(ROOT, "configs",
                                             name + ".json"))
    slvs = []
    for d in (dev, dev, cpu):
        s = amgx.create_solver(cfg, device=d)
        s.setup(amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                                     device=d))
        slvs.append(s)
    bits = [mc_bits(torch, precond_amg(s)) for s in slvs]
    same = [len(bits[0]) == len(x) and all(torch.equal(a, b_) for a, b_
                                           in zip(bits[0], x))
            for x in bits[1:]]
    b = torch.ones(n ** 3, dtype=torch.float32)
    rc = run_path(amgx, per_path, f"{name}_{n}^3_determinism",
                  lambda: slvs[0].solve(b.to(dev)))
    rh = slvs[2].solve(b)
    emit({"phase": "multicolor", "config": f"{name}_{n}^3_determinism",
          "levels": precond_amg(slvs[0]).level_rows(),
          "colors": [lv.smoother.num_colors
                     for lv in precond_amg(slvs[0]).levels],
          "tensors_compared": len(bits[0]),
          "card_setups_bit_identical": same[0], "card_equals_cpu": same[1],
          "iterations_cuda": rc.iterations, "iterations_cpu": rh.iterations,
          "status_cuda": rc.status, "status_cpu": rh.status})
    check(same[0], f"{name} {n}^3: two card setups are bit-identical")
    check(same[1], f"{name} {n}^3: the card's setup equals the CPU's")
    check(rc.status == rh.status == "success"
          and rc.iterations == rh.iterations,
          f"{name} {n}^3: card {rc.status} in {rc.iterations}, CPU "
          f"{rh.status} in {rh.iterations}")
    del slvs, bits

    rec, c, res = krylov_file_run(torch, amgx, dev, per_path, "PCG_DILU",
                                  128)
    check(c["dia_spmv_dot"] == c["cg_update"] == res.iterations
          and c["dia_spmv"] > 0
          and not mc_forbidden(c, MC_ALLOWED + MC_SHELL),
          f"{rec['config']}: B6 and B7 once an iteration, B1, no B2-B5 or "
          f"B9 {c}")
    for name in ("AGGREGATION_DILU", "AGGREGATION_GS",
                 "AGGREGATION_THRUST_GS"):
        # no warm solves on these non-main files: the script's time
        rec, c, res = krylov_file_run(
            torch, amgx, dev, per_path, name, MC_SIZE, warm=False,
            extra=lambda slv, A, b, res: {"colors": [
                lv.smoother.num_colors for lv in precond_amg(slv).levels]})
        cp = per_path[rec["config"]]
        check(c["dia_spmv"] > 0 and c["csr_spmv"] > 0
              and not mc_forbidden(cp), f"{rec['config']}: B1 / B8 only, "
              f"B10-relabel in the setup {cp}")
        rec, c, res = krylov_file_run(torch, amgx, dev, per_path, name, 32,
                                      dtype=torch.float64, warm=False)
        it0 = KRYLOV_ANCHORS[(name, 32, "float64")]["iterations"]
        check(res.iterations == it0, f"{rec['config']}: {res.iterations} "
              f"iterations, the JAX package's float64 {it0}")
    rec, c, res = krylov_file_run(torch, amgx, dev, per_path,
                                  "FGMRES_AGGREGATION", 64)
    check(not mc_forbidden(per_path[rec["config"]]),
          f"{rec['config']}: B1 / B8 only {per_path[rec['config']]}")
    for name in ("IDR_DILU", "IDRMSYNC_DILU"):
        rec, c, res = krylov_file_run(torch, amgx, dev, per_path, name, 64)
        check(c["dia_spmv"] >= 3 * res.iterations and not mc_forbidden(c),
              f"{rec['config']}: B1 for A u, A v and DILU's SpMVs {c}")
    krylov_file_run(torch, amgx, dev, per_path, "V-cheby-smoother", 64,
                    dtype=torch.float64)
    krylov_file_run(torch, amgx, dev, per_path, "V-cheby-smoother", 64,
                    hold=False, extra=lambda slv, A, b, res: {
                        "anchor_recorded": VCHEBY_F32_64})


AGGRESSIVE_MAIN = "FGMRES_CLASSICAL_AGGRESSIVE_PMIS"


def classical_bits(torch, amg):
    """Each level's CF split, strength, A, P and R and the coarsest
    operator of a set-up classical hierarchy, on the CPU."""
    out = []
    for lv in amg.levels:
        out += [lv.cf_map, lv.strong]
        for M in (lv.A, lv.P, lv.R):
            out += [M.row_offsets, M.col_indices, M.values]
    M = amg.coarsest_A
    return [t.cpu() for t in out + [M.row_offsets, M.col_indices,
                                    M.values]]


def timed_rs_pass(selectors, times):
    """selectors.rs_split wrapped to append (rows, host seconds) of each
    RS pass to `times`; returns the original."""
    real = selectors.rs_split

    def timed(A, strong):
        t0 = time.perf_counter()
        out = real(A, strong)
        times.append((A.num_rows, time.perf_counter() - t0))
        return out

    selectors.rs_split = timed
    return real


def phase_aggressive_kcycle(torch, amgx, dev, per_path):
    """AmgX's stock aggressive coarsening and K-cycle files, read
    verbatim: the main path FGMRES_CLASSICAL_AGGRESSIVE_PMIS at 128^3 in
    float32 (success; B10 in the setup, B8 and B9 in the solve; level
    rows, setup seconds, peak memory, which transfers level 0 takes), at
    64^3 against its anchor and the CPU route's level rows;
    FGMRES_CLASSICAL_AGGRESSIVE_HMIS at 64^3 (the RS pass's host seconds
    a level); AMG_CLASSICAL_CG, AMG_CLASSICAL_CGF and
    AMG_AGGRREGATION_CG at 64^3 in float32 (max_iters, the final
    residual within KCYCLE_FINAL_TOL of the anchor's; B8 in the coarse
    matvec, no B5) and at 32^3 in float64 (the JAX package's iterations
    exactly); PCG_CLASSICAL_V_JACOBI at 64^3 (B6 / B7); and two 32^3
    card setups of the main file, bit-identical and equal to the CPU
    route's."""
    from amgx_tpu_torch.amg.classical import selectors

    def main_extra(slv, A, b, res):
        amg = precond_amg(slv)
        lv = amg.levels[0]
        stats = amg.grid_stats_dict()
        return {"aggressive": [lv_._aggressive for lv_ in amg.levels],
                "level0_transfers": "weighted (B3w / B4w)"
                if lv._transfer_tables() is not None else "composed (B8)",
                "level0_R_max_row": int(torch.diff(lv.R.row_offsets).max()),
                "level0_P_max_row": int(torch.diff(lv.P.row_offsets).max()),
                "grid_complexity": stats["grid_complexity"],
                "operator_complexity": stats["operator_complexity"]}

    rec, c, res = krylov_file_run(torch, amgx, dev, per_path,
                                  AGGRESSIVE_MAIN, 128, extra=main_extra,
                                  hold=False, phase="aggressive_kcycle")
    path = rec["config"]
    setup = {k: v - c[k] for k, v in per_path[path].items()}
    check(res.status == "success", f"{path}: {res.status}")
    check(setup["rap_values"] > 0 and c["csr_spmv"] > 0
          and c["csr_smooth"] > 0, f"{path}: B10 in the setup {setup}, B8 "
          f"and B9 in the solve {c}")
    rec, c, res = krylov_file_run(torch, amgx, dev, per_path,
                                  AGGRESSIVE_MAIN, 64, warm=False,
                                  extra=main_extra,
                                  phase="aggressive_kcycle")

    times = []
    real = timed_rs_pass(selectors, times)
    try:
        rec, c, res = krylov_file_run(
            torch, amgx, dev, per_path, "FGMRES_CLASSICAL_AGGRESSIVE_HMIS",
            64, warm=False, phase="aggressive_kcycle")
    finally:
        selectors.rs_split = real
    emit({"phase": "aggressive_kcycle", "config": rec["config"],
          "rs_pass_rows_seconds": times})
    check(len(times) >= len(rec["levels"]) - 2,
          f"{rec['config']}: an RS pass on each level below level 0 "
          f"{times}")

    for name in ("AMG_CLASSICAL_CG", "AMG_CLASSICAL_CGF",
                 "AMG_AGGRREGATION_CG"):
        rec, c, res = krylov_file_run(torch, amgx, dev, per_path, name, 64,
                                      warm=False, phase="aggressive_kcycle")
        tail = {k: v for k, v in per_path[rec["config"]].items()
                if k.startswith("dia_coarse_tail") and v}
        check(c["csr_spmv"] > 0 and not tail, f"{rec['config']}: B8 in "
              f"the coarse matvec, no B5 {tail}")
    for name in ("AMG_CLASSICAL_CG", "AMG_CLASSICAL_CGF",
                 "AMG_AGGRREGATION_CG"):
        rec, c, res = krylov_file_run(torch, amgx, dev, per_path, name, 32,
                                      dtype=torch.float64, warm=False,
                                      phase="aggressive_kcycle")
        it0 = KRYLOV_ANCHORS[(name, 32, "float64")]["iterations"]
        check(res.iterations == it0, f"{rec['config']}: {res.iterations} "
              f"iterations, the JAX package's float64 {it0}")
    rec, c, res = krylov_file_run(torch, amgx, dev, per_path,
                                  "PCG_CLASSICAL_V_JACOBI", 64, warm=False,
                                  phase="aggressive_kcycle")
    check(c["dia_spmv_dot"] > 0 and c["cg_update"] > 0,
          f"{rec['config']}: B6 and B7 in PCG's shell {c}")

    # 32^3 determinism: two card setups and the CPU route's
    n = 32
    cpu = torch.device("cpu")
    cfg = amgx.Config.from_file(os.path.join(ROOT, "configs",
                                             AGGRESSIVE_MAIN + ".json"))
    slvs = []
    for d in (dev, dev, cpu):
        slv = amgx.create_solver(cfg, device=d)
        slv.setup(amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                                       device=d))
        slvs.append(slv)
    bits = [classical_bits(torch, precond_amg(slv)) for slv in slvs]
    same = [len(bits[0]) == len(x) and all(torch.equal(a, b_) for a, b_
                                           in zip(bits[0], x))
            for x in bits[1:]]
    b = torch.ones(n ** 3, dtype=torch.float32)
    config = f"{AGGRESSIVE_MAIN}_{n}^3_determinism"
    rc = run_path(amgx, per_path, config, lambda: slvs[0].solve(b.to(dev)))
    rh = slvs[2].solve(b)
    emit({"phase": "aggressive_kcycle", "config": config,
          "levels": precond_amg(slvs[0]).level_rows(),
          "tensors_compared": len(bits[0]),
          "card_setups_bit_identical": same[0], "card_equals_cpu": same[1],
          "iterations_cuda": rc.iterations, "iterations_cpu": rh.iterations,
          "status_cuda": rc.status, "status_cpu": rh.status})
    check(same[0], f"{config}: two card setups are bit-identical")
    check(same[1], f"{config}: the card's setup equals the CPU's")
    check(rc.status == rh.status == "success"
          and rc.iterations == rh.iterations,
          f"{config}: card {rc.status} in {rc.iterations}, CPU "
          f"{rh.status} in {rh.iterations}")


def timed(torch, fn):
    """(fn(), wall seconds with the card's queue drained on both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stencils(amg):
    return [lv.smoother._mf_stencil for lv in amg.levels]


def phase_resetup(torch, amgx, dev, per_path):
    """AMGX_solver_resetup at 128^3 through the entry points.
    (F) the untouched FLAGSHIP with amg:structure_reuse_levels=-1:
    setup(A) and solve (2 / 31); resetup(2 A) takes the value route (one
    host read; every matrix-free level's coefficients exactly twice the
    old), then solves as a fresh setup on 2 A does (the same iterations,
    x within 1e-6); resetup(D A D) takes the generic route, drops every
    stencil and solves as flagship_dad (2 / 81, true residual of A2 <=
    1e-8). (C) FGMRES_CLASSICAL_AGGRESSIVE_PMIS with
    structure_reuse_levels=-1 in float32: setup(A), solve (17),
    resetup(D A D) keeps each level's CF split, P and R (the same
    tensors), builds no RAP plan and runs B10's value phase twice a
    level, then solves; a second solver's setup on new pattern tensors of
    the same content is served every plan from the cache (the lookup
    timed against a build at level 0); peak memory of setup + resetup.
    At 32^3 (C)'s card resetup equals the CPU route's, bit for bit, with
    the same iterations. Wall seconds of every setup and resetup."""
    from amgx_tpu_torch.ops import spgemm
    from amgx_tpu_torch.presets import FLAGSHIP
    card = nvidia_smi()
    n = 128

    # -- (F) ---------------------------------------------------------------
    cfg = amgx.Config.from_string(FLAGSHIP + ", amg:structure_reuse_levels=-1")
    A = amgx.gallery.poisson("7pt", n, n, n, device=dev).init()
    b = torch.ones(n ** 3, dtype=torch.float64, device=dev)

    def inner(res):
        return int(res.extra_stats["inner_iters"])

    def flagship():
        rec = {}
        slv = amgx.create_solver(cfg, device=dev)
        _, rec["setup_s"] = timed(torch, lambda: slv.setup(A))
        res = slv.solve(b)
        rec["setup_iterations"] = [res.iterations, inner(res)]
        check(rec["setup_iterations"] == [2, 31],
              f"resetup (F): setup(A) solves in {rec['setup_iterations']}, "
              f"2 / 31 as the flagship phase")
        amg = precond_amg(slv)
        old = stencils(amg)
        A2 = A.with_values(2 * A.values)
        _, rec["resetup_value_first_s"] = timed(torch,
                                                lambda: slv.resetup(A2))
        value_only = amg._last_resetup_value_only
        new = stencils(amg)
        _, rec["resetup_value_s"] = timed(torch, lambda: slv.resetup(A2))
        _, rec["resetup_value_host_syncs"] = count_syncs(
            torch, lambda: slv.resetup(A2))
        _, rec["coarse_qr_host_syncs"] = count_syncs(
            torch, amg.coarse_solver.solver_setup)
        doubled = all(
            (o is None and s is None) or (
                torch.equal(s.coeffs, 2 * o.coeffs)
                and s.host == tuple(2 * h for h in o.host))
            for o, s in zip(old, new))
        res2 = slv.solve(b)
        fresh = amgx.create_solver(cfg, device=dev)
        _, rec["fresh_setup_2A_s"] = timed(torch, lambda: fresh.setup(A2))
        ref = fresh.solve(b)
        x_rel = float(torch.linalg.norm(res2.x - ref.x)
                      / torch.linalg.norm(ref.x))
        _, rec["warm_solve_s"] = timed(torch, lambda: slv.solve(b))
        rec.update(value_route=value_only, matrix_free_levels=sum(
            s is not None for s in new), coefficients_doubled=doubled,
            iterations_2A=[res2.iterations, inner(res2)],
            fresh_iterations_2A=[ref.iterations, inner(ref)],
            x_rel_diff_2A=x_rel)
        del fresh
        check(value_only and doubled and rec["matrix_free_levels"] > 0,
              f"resetup (F): resetup(2 A) takes the value route and doubles "
              f"every matrix-free level's coefficients {rec}")
        check(res2.status == "success"
              and rec["iterations_2A"] == rec["fresh_iterations_2A"]
              and x_rel <= 1e-6,
              f"resetup (F): the solve after resetup(2 A) is a fresh "
              f"setup's {rec}")
        A3 = dad_operator(torch, A)
        _, rec["resetup_generic_s"] = timed(torch, lambda: slv.resetup(A3))
        rec["generic_route"] = not amg._last_resetup_value_only
        rec["stencils_left"] = sum(s is not None for s in stencils(amg))
        res3 = slv.solve(b)
        rec["iterations_dad"] = [res3.iterations, inner(res3)]
        rec["true_rel_res_dad"] = true_rel_res(torch, A3, res3.x, b)
        _, rec["resetup_generic_host_syncs"] = count_syncs(
            torch, lambda: slv.resetup(A3))
        check(rec["generic_route"] and rec["stencils_left"] == 0
              and res3.status == "success"
              and rec["iterations_dad"] == [2, 81]
              and rec["true_rel_res_dad"] <= 1e-8,
              f"resetup (F): resetup(D A D) takes the generic route and "
              f"solves as flagship_dad {rec}")
        rec["levels"] = amg.level_rows()
        return rec

    rec = run_path(amgx, per_path, "resetup_flagship", flagship)
    c = per_path["resetup_flagship"]
    emit({"phase": "resetup", "config": "flagship_128^3", "rows": n ** 3,
          "nvidia_smi": card, **rec, "launches": c})
    check(c["dia_smooth_restrict_mf"] > 0 and c["dia_coarse_tail_mf"] > 0
          and c["dia_smooth_restrict"] > 0,
          f"resetup (F): B3-mf / B5-mf before D A D, the slab B3 after {c}")

    # -- (C) ---------------------------------------------------------------
    def classical_cfg():
        cfg = amgx.Config.from_file(os.path.join(ROOT, "configs",
                                                 AGGRESSIVE_MAIN + ".json"))
        cfg.set("structure_reuse_levels", -1, scope="amg_solver")
        return cfg

    spgemm.clear_plan_cache()
    torch.cuda.empty_cache()
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                             device=dev).init()
    b = torch.ones(n ** 3, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    slv = amgx.create_solver(classical_cfg(), device=dev)
    _, setup_s = timed(torch, lambda: slv.setup(A))
    setup_peak = torch.cuda.max_memory_allocated(dev)
    res = slv.solve(b)
    amg = precond_amg(slv)
    kept = [(lv.cf_map, lv.P, lv.R, lv.rap_plan) for lv in amg.levels]
    A2 = dad_operator(torch, A)
    amgx.reset_kernel_launches()
    _, resetup_s = timed(torch, lambda: slv.resetup(A2))
    in_resetup, plans = amgx.kernel_launches(), amgx.plan_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    res2 = slv.solve(b)
    per_path["resetup_classical"] = amgx.kernel_launches()
    same = [lv.cf_map is k[0] and lv.P is k[1] and lv.R is k[2]
            and lv.rap_plan is k[3] for lv, k in zip(amg.levels, kept)]
    amgx.reset_kernel_launches()
    slv2 = amgx.create_solver(classical_cfg(), device=dev)
    A_new = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                                 device=dev).init()
    _, warm_setup_s = timed(torch, lambda: slv2.setup(A_new))
    per_path["resetup_classical_warm_setup"] = amgx.kernel_launches()
    warm_plans = amgx.plan_counts()
    lv = precond_amg(slv2).levels[0]
    lookup = [timed(torch, lambda: spgemm.get_rap_plan(lv.R, lv.A, lv.P))[1]
              for _ in range(3)]
    build = [timed(torch, lambda: spgemm.build_rap_plan(lv.R, lv.A, lv.P))[1]
             for _ in range(3)]
    nlev = len(amg.levels)
    rec = {"phase": "resetup", "config": f"{AGGRESSIVE_MAIN}_128^3",
           "rows": n ** 3, "nvidia_smi": card, "levels": amg.level_rows(),
           "setup_s": setup_s, "resetup_s": resetup_s,
           "resetup_over_setup": resetup_s / setup_s,
           "warm_setup_s": warm_setup_s,
           "setup_peak_bytes": setup_peak,
           "setup_resetup_peak_bytes": peak,
           "iterations": res.iterations, "status": res.status,
           "iterations_dad": res2.iterations, "status_dad": res2.status,
           "structure_kept": same,
           "rap_values_launches_in_resetup": in_resetup["rap_values"],
           "plans_in_resetup": plans, "plans_in_warm_setup": warm_plans,
           "level0_plan_lookup_s": sorted(lookup)[1],
           "level0_plan_build_s": sorted(build)[1],
           "level0_plan_bytes": lv.rap_plan.nbytes(),
           "launches": per_path["resetup_classical"]}
    emit(rec)
    check(res.status == "success" and res.iterations == 17,
          f"resetup (C): setup(A) solves in {res.iterations}, 17 as the "
          f"aggressive phase")
    check(all(same), f"resetup (C): CF split, P, R and plan kept {same}")
    check(in_resetup["rap_values"] == 2 * nlev and plans["rap_build"] == 0,
          f"resetup (C): B10 twice on each of {nlev} levels, no plan built "
          f"{in_resetup} {plans}")
    check(res2.status == "success", f"resetup (C): {res2.status} on D A D")
    check(warm_plans["rap_build"] == 0 and warm_plans["rap_hit"]
          == len(precond_amg(slv2).levels), f"resetup (C): the second "
          f"setup's plans all come from the cache {warm_plans}")
    del slv, slv2, amg, lv, kept

    # -- (C) at 32^3: the card's resetup is the CPU route's ----------------
    m = 32
    out = []
    for d in (dev, torch.device("cpu")):
        A = amgx.gallery.poisson("7pt", m, m, m, dtype=torch.float32,
                                 device=d).init()
        s = amgx.create_solver(classical_cfg(), device=d)
        s.setup(A)
        s.resetup(dad_operator(torch, A))
        r = s.solve(torch.ones(m ** 3, dtype=torch.float32, device=d))
        out.append((classical_bits(torch, precond_amg(s)), r))
    (bc, rc), (bh, rh) = out
    equal = len(bc) == len(bh) and all(torch.equal(x, y)
                                       for x, y in zip(bc, bh))
    emit({"phase": "resetup", "config": f"{AGGRESSIVE_MAIN}_{m}^3_cpu",
          "rows": m ** 3, "tensors_compared": len(bc),
          "card_equals_cpu": equal, "iterations_cuda": rc.iterations,
          "iterations_cpu": rh.iterations})
    check(equal and rc.iterations == rh.iterations and rc.status == "success",
          f"resetup (C) {m}^3: the card's resetup equals the CPU's "
          f"({equal}), {rc.iterations} / {rh.iterations} iterations")


# ---------------------------------------------------------------------------
# batched solves (phase_batch)
# ---------------------------------------------------------------------------

# BATCHED_CG (amgx_tpu_torch/presets.py) on the 7-pt BATCH_N^3 in float32,
# BATCH_B systems from numpy's default_rng(BATCH_SEED)
BATCH_N = 128
BATCH_B = 8
BATCH_SEED = 17
# the multi-matrix systems A + c I: from none to shifts well above the
# Poisson operator's smallest eigenvalue (~1.8e-3 at 128^3), so the
# systems stop at different iterations and the freeze runs
BATCH_SHIFTS = (0.0, 0.0005, 0.002, 0.008, 0.03, 0.1, 0.4, 2.0)
# the request batcher's second pattern
BATCH_Q_N = 64
# the batched kernels (ops/cuda_batched.py); K2 in its slab and its
# coefficient ("mf") mode
BATCHED = ("dia_spmv_multi", "dia_step_multi", "dia_step_mf_multi",
           "csr_spmv_multi", "csr_step_multi")
# a batched kernel against its plain multi form (max |diff| / max |plain|,
# float32): one row sum (K1, K3), one damped step and its residual (K2),
# one sweep (K4), each summed in the single kernel's order
BATCH_LIMIT = 1e-6
# a batched system against its solo solve: the batched dots and the
# composed transfers round otherwise than B6 / B7 and B3-mf / B4-mf
BATCH_ITER_TOL = 1
BATCH_RES_RATIO = 2.0


def batch_launches(amg, iters):
    """The batched kernels' launches in one batched PCG solve of `iters`
    iterations (the batch's longest): K1 for the initial residual and A p
    once an iteration; in each cycle (one in the set-up, one an
    iteration) on every level K2 (its coefficient mode on a matrix-free
    level) for each damped step and the residual, or on a CSR level K4
    for each sweep and K3 for the residual. None of it depends on B."""
    per = dict.fromkeys(BATCHED, 0)
    for i, lv in enumerate(amg.levels):
        steps = amg._sweeps(i, pre=True) + amg._sweeps(i, pre=False)
        if lv.smoother._mf_stencil is not None:
            per["dia_step_mf_multi"] += steps + 1
        elif lv.A.dia_vals is not None:
            per["dia_step_multi"] += steps + 1
        else:
            per["csr_step_multi"] += steps
            per["csr_spmv_multi"] += 1
    out = {k: v * (iters + 1) for k, v in per.items()}
    out["dia_spmv_multi"] = iters + 1
    return out


def batch_only(c, allowed=()):
    """The launches of counters other than the batched forms (and
    `allowed`, and K8, a setup sum): a batched path launches no single
    kernel of the solve."""
    return {k: v for k, v in c.items()
            if v and k not in BATCHED and k not in allowed
            and k != "ordered_sum"}


def batch_kernel_case(torch, K, label, name, kern, single, plain, nbytes,
                      flops, per_call, lib, nsys, summary, main=False,
                      limit=BATCH_LIMIT):
    """One batched kernel at a path's shape: its launches, row s of each
    output equal to the single kernel on system s bit for bit (`single`
    gives the B single calls' outputs), within BATCH_LIMIT of the plain
    multi form; its time beside B launches of the single form, the plain
    form, its bound and its library call. The kernels line reports the
    `main` shape's row (else the first), with the largest errors."""
    before = dict(K.LAUNCHES)
    got = kern()
    moved = {k: v - before[k] for k, v in K.LAUNCHES.items()
             if v != before[k]}
    check(moved == {name: per_call},
          f"{name} at {label}: launches {moved}, expected {per_call}")
    got = got if isinstance(got, tuple) else (got,)
    ones = single()
    for s, one in enumerate(ones):
        one = one if isinstance(one, tuple) else (one,)
        check(all(torch.equal(g[s], o) for g, o in zip(got, one)),
              f"{name} at {label}: system {s} differs from its single "
              f"kernel")
    want = plain()
    abs_err, rel_err = max_err(torch, got, want)
    check(rel_err <= limit,
          f"{name} at {label}: {rel_err} from the plain form")
    ms = time_ms(torch, kern)
    dev_ms, recs = None, 0
    # three profiles of BATCH calls, then shorter ones: a profile of
    # fewer calls holds fewer records to lose (K3's level 1 lost them)
    for batch in (BATCH, BATCH, BATCH, 2, 1):
        dev_ms, recs = device_ms(torch, kern, per_call, batch=batch)
        if dev_ms is not None:
            break
    single_ms = time_ms(torch, single)
    plain_ms = time_ms(torch, plain, reps=PLAIN_REPS, batch=PLAIN_BATCH)
    lib_ms = None if lib is None else time_ms(torch, lib)
    b_ms, b_by = bound(nbytes, flops)
    row = {"phase": "kernels_batch", "shape": label, "name": name,
           "systems": nsys, "max_abs_err": abs_err, "max_rel_err": rel_err,
           "limit": limit, "single_bits_equal": True,
           "launches_per_call": per_call, "ms": ms, "device_ms": dev_ms,
           "device_records": recs, "single_x_b_ms": single_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_us": b_ms * 1e3,
           "bound_by": b_by, "library_ms": lib_ms}
    emit(row)
    prev = summary.get(name)
    if prev is None or main:
        summary[name] = row
    if prev is not None:
        for key in ("max_abs_err", "max_rel_err"):
            summary[name][key] = max(prev[key], row[key])


def batch_cases(torch, amgx, data, X, Bv, summary, label):
    """K1-K4 on one batch's solve data (shared or stacked): K1 on the
    Krylov operator, K2 on level 0 (its stencil, and its slab with the
    L1 dinv), K3 and K4 on the first two CSR levels."""
    from amgx_tpu_torch.ops import cuda_batched as KB
    from amgx_tpu_torch.ops import cuda_csr as C
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.ops import stencil as mf
    nb, n = X.shape
    A = data["A"]
    per = A.dia_vals.dim() == 3
    offs = A.dia_offsets
    k = len(offs)
    vs = A.dia_vals
    vrows = [vs[s] if per else vs for s in range(nb)]

    def csr_of(M):
        return csr_library(torch, M)

    lib = None if per else csr_of(A)
    batch_kernel_case(
        torch, K, f"{label} level 0 ({n} rows)", "dia_spmv_multi",
        lambda: KB.dia_spmv_multi(vs, offs, X),
        lambda: [K.dia_spmv(vrows[s], offs, X[s]) for s in range(nb)],
        lambda: K.dia_spmv_plain(vs, offs, X),
        vs.numel() * 4 + 2 * X.numel() * 4, 2 * k * n * nb, 1,
        None if lib is None else (lambda: lib @ X.t()), nb, summary)
    lv0 = data["precond"]["amg"]["levels"][0]
    taus = torch.ones(1, dtype=torch.float32, device=X.device)
    st = lv0["stencil"]
    srows = [dataclasses.replace(st, coeffs=st.coeffs[s], host=st.host[s])
             if st.coeffs.dim() == 2 else st for s in range(nb)]
    batch_kernel_case(
        torch, K, f"{label} level 0 ({n} rows), 1 step + residual",
        "dia_step_mf_multi",
        lambda: KB.dia_smooth_mf_multi(st, taus, Bv, X, True),
        lambda: [K.dia_smooth_mf(srows[s], taus, Bv[s], X[s], True)
                 for s in range(nb)],
        lambda: mf._xla_smooth(st.spec(), st.coeffs, taus, Bv, X, True),
        4 * X.numel() * 4, (4 * k + 6) * n * nb, 2, None, nb, summary)
    # the slab mode on the same level
    batch_slab_case(torch, A, X, Bv, summary, label)
    gen = torch.Generator(device=X.device).manual_seed(BATCH_SEED)
    for i in (1, 2):
        ld = data["precond"]["amg"]["levels"][i]
        M, dinv = ld["A"], ld["smoother"]["dinv"]
        m = M.num_rows
        Y = torch.randn((nb, m), generator=gen, device=X.device)
        Bc = torch.randn((nb, m), generator=gen, device=X.device)
        pv = M.values.dim() == 2
        mrows = [M.values[s] if pv else M.values for s in range(nb)]
        lib = None if pv else csr_of(M)
        ro, ci = M.row_offsets, M.col_indices
        batch_kernel_case(
            torch, K, f"{label} level {i} ({m} rows)", "csr_spmv_multi",
            lambda: KB.csr_spmv_multi(ro, ci, M.values, Y),
            lambda: [C.csr_spmv(ro, ci, mrows[s], Y[s]) for s in range(nb)],
            lambda: C.csr_spmv_plain(ro, ci, M.values, Y),
            M.values.numel() * 4 + M.nnz * 4 + (m + 1) * 4
            + 2 * Y.numel() * 4, 2 * M.nnz * nb, 1,
            None if lib is None else (lambda: lib @ Y.t()), nb, summary)
        drs = [dinv[s] if dinv.dim() == 2 else dinv for s in range(nb)]
        lanes = M.csr_lanes or 1
        batch_kernel_case(
            torch, K, f"{label} level {i} ({m} rows), 1 sweep",
            "csr_step_multi",
            lambda: KB.csr_smooth_multi(ro, ci, M.values, taus, Bc, Y, dinv,
                                        lanes),
            lambda: [C.csr_smooth(ro, ci, mrows[s], taus, Bc[s], Y[s],
                                  drs[s], lanes) for s in range(nb)],
            lambda: C.csr_smooth_plain(ro, ci, M.values, taus, Bc, Y, dinv),
            M.values.numel() * 4 + M.nnz * 4 + (m + 1) * 4
            + dinv.numel() * 4 + 3 * Y.numel() * 4,
            (2 * M.nnz + 4 * m) * nb, 1, None, nb, summary)


def batch_slab_case(torch, A, X, Bv, summary, label, main=False):
    """K2's slab mode on a DIA level 0 (`A` shared or stacked): one
    damped step with the L1 dinv of each system's slab, and the
    residual."""
    from amgx_tpu_torch.ops import cuda_batched as KB
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    nb, n = X.shape
    vs, offs = A.dia_vals, A.dia_offsets
    per = vs.dim() == 3
    vrows = [vs[s] if per else vs for s in range(nb)]
    taus = torch.ones(1, dtype=torch.float32, device=X.device)
    d = torch.stack([safe_recip(l1_strengthened_diag(dataclasses.replace(
        A, values=A.values[s]))) for s in range(nb)]) if per \
        else safe_recip(l1_strengthened_diag(A))
    drows = [d[s] if per else d for s in range(nb)]
    batch_kernel_case(
        torch, K, f"{label} level 0 ({n} rows) slab, 1 step + residual",
        "dia_step_multi",
        lambda: KB.dia_smooth_multi(vs, offs, taus, Bv, X, d, True),
        lambda: [K.dia_smooth(vrows[s], offs, taus, Bv[s], X[s], drows[s],
                              True, grid=A.grid_shape) for s in range(nb)],
        lambda: K.dia_smooth_plain(vs, offs, taus, Bv, X, d, True),
        vs.numel() * 4 + d.numel() * 4 + 4 * X.numel() * 4,
        (4 * len(offs) + 6) * n * nb, 2, None, nb, summary, main)


def diag_shifted(torch, A, shifts):
    """The systems A + c I for c in `shifts`, through with_values."""
    rows = torch.repeat_interleave(
        torch.arange(A.num_rows, device=A.values.device),
        torch.diff(A.row_offsets.long()))
    diag = (rows == A.col_indices.long()).to(A.values.dtype)
    return [A.with_values(A.values + c * diag) for c in shifts]


def batch_check(label, got, ref):
    """A batched system against its solo solve on the card: the same
    status, iterations within BATCH_ITER_TOL, true relative residual
    within BATCH_RES_RATIO."""
    check(got["status"] == ref["status"]
          and abs(got["iterations"] - ref["iterations"]) <= BATCH_ITER_TOL
          and got["true_rel_res"] <= BATCH_RES_RATIO * ref["true_rel_res"]
          and ref["true_rel_res"] <= BATCH_RES_RATIO * got["true_rel_res"],
          f"{label}: batched {got} against solo {ref}")


def batch_systems(torch, res, mats, bs):
    """Per-system status, iterations and true relative residual of a
    batched result (`mats[i]` system i's matrix)."""
    out = []
    for i, r in enumerate(res.per_system()):
        out.append({"status": r.status, "iterations": r.iterations,
                    "true_rel_res": true_rel_res(torch, mats[i], r.x,
                                                 bs[i])})
    return out


def solo_systems(torch, slv, mats, bs, resetup):
    """Solo solves of the same systems on the card (resetup to each
    matrix first when `resetup`), after one warm-up solve: per system
    status, iterations, true relative residual and warm solve seconds."""
    slv.solve(bs[0])
    out = []
    for i in range(len(bs)):
        if resetup:
            slv.resetup(mats[i])
        r, s = timed(torch, lambda: slv.solve(bs[i]))
        out.append({"status": r.status, "iterations": r.iterations,
                    "true_rel_res": true_rel_res(torch, mats[i], r.x,
                                                 bs[i]), "solve_s": s})
    return out


def batch_profile(torch, fn, iterations):
    """One batched solve under torch.profiler (device activity only):
    wall, device busy time, idle share, device ops and device->host copies
    per iteration (the batch's longest)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, ops, dtoh = 0.0, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += ev.time_range.elapsed_us()
        if "Memcpy DtoH" in ev.name:
            dtoh += 1
        elif not ev.name.startswith(("Memcpy", "Memset")):
            ops += 1
    it = max(iterations, 1)
    return {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
            "idle_share": 1.0 - busy_us * 1e-6 / wall, "device_ops": ops,
            "device_ops_per_iteration": ops / it,
            "dtoh_per_iteration": dtoh / it}


def phase_batch(torch, amgx, dev, per_path, summary):
    """Batched solves through the entry points (amgx_tpu_torch.batch):
    BATCHED_CG on the 7-pt 128^3 in float32 with 8 systems.
    (M) multi-RHS: BatchedSolver.solve_many of 8 seeded right-hand sides;
    (MM) multi-matrix: the systems A + c I (BATCH_SHIFTS, with_values of
    one template), hierarchy structure shared, values spliced through
    resetup (B10's relabel form), at least three distinct iteration
    counts; (Q) RequestBatcher: a drain of 8 requests on the 128^3
    pattern (values of three A_i) and 3 on a 64^3 one, dispatched as
    (8, 8) and (3, 4), then a drain of 5 requests sharing one matrix (the
    single-matrix fast path, (5, 8)). Each system against its solo solve
    on the card (resetup + solve): the same status, iterations within
    BATCH_ITER_TOL, true residual within BATCH_RES_RATIO. Only the
    batched kernels launch, each per `batch_launches` (once a use an
    iteration, whatever B is). K1-K4 at the path's shapes, shared and per
    system, against their single kernels bit for bit and their plain
    forms; warm batched wall times against the 8 solo solves'; one
    profiled batched solve. Then (S) the slab route (matrix_free=0) at
    64^3, which runs K2 from the level's slab."""
    from amgx_tpu_torch.batch import BatchedSolver, RequestBatcher
    from amgx_tpu_torch.batch import stack_solve_datas
    from amgx_tpu_torch.presets import BATCHED_CG
    n, nb = BATCH_N, BATCH_B
    rng = np.random.default_rng(BATCH_SEED)

    def rhs(count, rows):
        return torch.from_numpy(rng.standard_normal((count, rows)).astype(
            np.float32)).to(dev)

    A = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                             device=dev).init()
    bs = BatchedSolver(amgx.Config.from_string(BATCHED_CG), device=dev)
    _, setup_s = timed(torch, lambda: bs.setup(A))
    slv, amg = bs.solver, precond_amg(bs.solver)
    levels = amg.level_rows()
    # (M) multi-RHS
    BM = rhs(nb, n ** 3)
    res_m, first_s = timed(torch, lambda: run_path(
        amgx, per_path, "batch_multi_rhs", lambda: bs.solve_many(BM)))
    c = per_path["batch_multi_rhs"]
    want = batch_launches(amg, int(res_m.iterations.max()))
    check({k: c[k] for k in BATCHED} == want and not batch_only(c),
          f"batch (M): launches {c}, expected {want} and no single kernel")
    got_m = batch_systems(torch, res_m, [A] * nb, BM)
    # (BR) one report a system, valid, each with its own stop
    from amgx_tpu_torch.telemetry import validate_report
    reps = res_m.reports or []
    check(len(reps) == nb and all(
        validate_report(r.to_dict()) == [] and r.iterations == int(i)
        and r.status == g["status"]
        for r, i, g in zip(reps, res_m.iterations, got_m)),
        f"batch (BR): {len(reps)} reports, want {nb} valid ones")
    warm_m = [timed(torch, lambda: bs.solve_many(BM))[1] for _ in range(2)]
    prof_m = batch_profile(torch, lambda: bs.solve_many(BM),
                           int(res_m.iterations.max()))
    ref_m = solo_systems(torch, slv, [A] * nb, BM, False)
    for i in range(nb):
        batch_check(f"batch (M) system {i}", got_m[i], ref_m[i])
    batch_cases(torch, amgx, slv.solve_data(), rhs(nb, n ** 3),
                rhs(nb, n ** 3), summary, "shared")
    emit({"phase": "batch", "case": "multi_rhs", "rows": n ** 3,
          "systems": nb, "levels": levels, "setup_s": setup_s,
          "iterations": res_m.iterations.tolist(),
          "status": [g["status"] for g in got_m],
          "true_rel_res": [g["true_rel_res"] for g in got_m],
          "solo": ref_m, "first_batched_s": first_s,
          "warm_batched_s": warm_m,
          "solo_warm_sum_s": sum(r["solve_s"] for r in ref_m),
          "warm_batched_over_one_solo": min(warm_m)
          / float(np.median([r["solve_s"] for r in ref_m])),
          "profile": prof_m, "launches": c, "reports_valid": len(reps)})
    # (MM) multi-matrix
    mats = diag_shifted(torch, A, BATCH_SHIFTS)
    BMM = rhs(nb, n ** 3)
    torch.cuda.reset_peak_memory_stats(dev)
    res_mm, first_mm = timed(torch, lambda: run_path(
        amgx, per_path, "batch_multi_matrix",
        lambda: bs.solve_many(BMM, matrices=mats)))
    peak_mm = torch.cuda.max_memory_allocated(dev)
    c = per_path["batch_multi_matrix"]
    want = batch_launches(amg, int(res_mm.iterations.max()))
    check({k: c[k] for k in BATCHED} == want
          and c["rap_values_relabel"] > 0
          and not batch_only(c, ("rap_values_relabel",)),
          f"batch (MM): launches {c}, expected {want}, B10 in the splice "
          f"and no single kernel")
    its = res_mm.iterations.tolist()
    check(len(set(its)) >= 3, f"batch (MM): iterations {its}, fewer than "
          f"three distinct counts")
    got_mm = batch_systems(torch, res_mm, mats, BMM)
    warm_mm = []
    for _ in range(2):
        r, s = timed(torch, lambda: bs.solve_many(BMM, matrices=mats))
        warm_mm.append({"wall_s": s, "loop_s": r.solve_time})
    splice_s = timed(torch, lambda: stack_solve_datas(
        bs._per_system_data(mats)))[1]
    ref_mm = solo_systems(torch, slv, mats, BMM, True)
    for i in range(nb):
        batch_check(f"batch (MM) system {i}", got_mm[i], ref_mm[i])
    data_mm, _ = stack_solve_datas(bs._per_system_data(mats))
    batch_cases(torch, amgx, data_mm, rhs(nb, n ** 3), rhs(nb, n ** 3),
                summary, "per-system")
    del data_mm
    emit({"phase": "batch", "case": "multi_matrix", "rows": n ** 3,
          "systems": nb, "shifts": list(BATCH_SHIFTS), "iterations": its,
          "status": [g["status"] for g in got_mm],
          "true_rel_res": [g["true_rel_res"] for g in got_mm],
          "solo": ref_mm, "first_batched_s": first_mm,
          "warm_batched": warm_mm, "splice_and_stack_s": splice_s,
          "solo_warm_sum_s": sum(r["solve_s"] for r in ref_mm),
          "peak_bytes": peak_mm, "launches": c})
    # (Q) the request batcher
    Aq = amgx.gallery.poisson("7pt", BATCH_Q_N, BATCH_Q_N, BATCH_Q_N,
                              dtype=torch.float32, device=dev).init()
    Bq = rhs(3, BATCH_Q_N ** 3)
    first = [(mats[0], BM[k], ref_m[k]) for k in range(6)] + [
        (mats[3], BMM[3], ref_mm[3]), (mats[6], BMM[6], ref_mm[6])]
    second = [(mats[0], BM[k], ref_m[k]) for k in range(5)]

    def queue():
        rb = RequestBatcher(amgx.Config.from_string(BATCHED_CG), device=dev)
        t1 = [rb.submit(M, b) for M, b, _ in first]
        tq = [rb.submit(Aq, b) for b in Bq]
        rb.drain()
        t2 = [rb.submit(M, b) for M, b, _ in second]
        rb.drain()
        return rb, t1, tq, t2

    (rb, t1, tq, t2), q_s = timed(torch, lambda: run_path(
        amgx, per_path, "batch_queue", queue))
    c = per_path["batch_queue"]
    log = [(r, p) for _, r, p in rb.dispatch_log]
    check(log == [(8, 8), (3, 4), (5, 8)], f"batch (Q): dispatches {log}")
    check(all(c[k] > 0 for k in ("dia_spmv_multi", "dia_step_mf_multi",
                                 "csr_spmv_multi", "csr_step_multi"))
          and not batch_only(c, ("rap_values_relabel",)),
          f"batch (Q): launches {c}")
    slv_q = amgx.create_solver(amgx.Config.from_string(BATCHED_CG),
                               device=dev)
    slv_q.setup(Aq)
    ref_q = solo_systems(torch, slv_q, [Aq] * 3, Bq, False)
    got_q = []
    for tickets, cases in ((t1, first), (t2, second)):
        for t, (M, b, ref) in zip(tickets, cases):
            g = {"status": t.result.status,
                 "iterations": t.result.iterations,
                 "true_rel_res": true_rel_res(torch, M, t.result.x, b)}
            batch_check("batch (Q)", g, ref)
            got_q.append(g)
    for t, b, ref in zip(tq, Bq, ref_q):
        g = {"status": t.result.status, "iterations": t.result.iterations,
             "true_rel_res": true_rel_res(torch, Aq, t.result.x, b)}
        batch_check("batch (Q) 64^3", g, ref)
        got_q.append(g)
    emit({"phase": "batch", "case": "queue", "dispatches": log,
          "systems": got_q, "solo_64": ref_q, "seconds": q_s,
          "launches": c})
    del rb, t1, tq, t2, slv_q, bs, slv, amg, mats, res_mm
    torch.cuda.empty_cache()
    # (S) the slab route at 64^3: K2 from the level's value slab
    bss = BatchedSolver(amgx.Config.from_string(BATCHED_CG + SLAB),
                        device=dev)
    bss.setup(Aq)
    BS = rhs(nb, BATCH_Q_N ** 3)
    res_s = run_path(amgx, per_path, "batch_slab_64^3",
                     lambda: bss.solve_many(BS))
    c = per_path["batch_slab_64^3"]
    want = batch_launches(precond_amg(bss.solver),
                          int(res_s.iterations.max()))
    check({k: c[k] for k in BATCHED} == want and want["dia_step_multi"] > 0
          and not batch_only(c),
          f"batch (S): launches {c}, expected {want}")
    got_s = batch_systems(torch, res_s, [Aq] * nb, BS)
    ref_s = solo_systems(torch, bss.solver, [Aq] * nb, BS, False)
    for i in range(nb):
        batch_check(f"batch (S) system {i}", got_s[i], ref_s[i])
    # K2's slab mode at the shape (S) launches it, shared and stacked:
    # the kernels line reports the shared row
    batch_slab_case(torch, bss.solver.solve_data()["A"], rhs(nb, Aq.num_rows),
                    rhs(nb, Aq.num_rows), summary, "(S) shared", main=True)
    data_s, _ = stack_solve_datas(bss._per_system_data(
        diag_shifted(torch, Aq, BATCH_SHIFTS)))
    batch_slab_case(torch, data_s["A"], rhs(nb, Aq.num_rows),
                    rhs(nb, Aq.num_rows), summary, "(S) per-system")
    del data_s
    emit({"phase": "batch", "case": "slab_64^3",
          "iterations": res_s.iterations.tolist(), "solo": ref_s,
          "launches": c})


def phase_aggregation(torch, amgx, dev, per_path, summary):
    """AmgX's stock PCG_AGGREGATION_JACOBI and FGMRES_AGGREGATION_JACOBI,
    read from configs/, on the 7-pt 128^3 Poisson in float32 (b = 1):
    setup (one B10-relabel launch per Galerkin product), a first solve
    within 2 of the JAX package's iterations, the anchor's level rows,
    10 warm solves; level 0 matrix-free (B4-mf, B4-mf's dot under PCG),
    the coarse levels CSR (B9 sweeps, B8 residuals), no B5. Then the
    PCG's structure-reuse resetup on D A D (aggregates kept, one
    B10-relabel launch per level, 63 +- 2 iterations); at 32^3 two card
    setups bit-identical and equal to the CPU's, and the resetup's
    iterations equal to the CPU's; last, the kernel cases on this
    hierarchy: B10-relabel on level 0's plan and a middle level's, and
    B3/B4 (slab and coefficient, with the dot) on the SIZE_2 level 0."""
    from amgx_tpu_torch.ops import cuda_rap as R_
    from amgx_tpu_torch.ops import cuda_spmv as K
    n = 128
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                             device=dev).init()
    b = torch.ones(n ** 3, dtype=torch.float32, device=dev)
    slvs = {}
    for name in ("agg-pcg", "agg-fgmres"):
        path = f"{name}_{n}^3"
        # the PCG's reuse depth matters only to its resetup below
        slv = amgx.create_solver(agg_config(
            amgx.Config, name, -1 if name == "agg-pcg" else None),
            device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        amgx.reset_kernel_launches()
        t0 = time.perf_counter()
        slv.setup(A)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        in_setup = amgx.kernel_launches()
        t0 = time.perf_counter()
        res = slv.solve(b)
        first_s = time.perf_counter() - t0
        per_path[path] = c = amgx.kernel_launches()
        warm = sorted(warm_solve(torch, slv, n, torch.float32)[1]
                      for _ in range(PAIRS))
        slvs[name] = slv
        amg = precond_amg(slv)
        levels = len(amg.levels)
        rows = amg.level_rows()
        emit({"phase": "aggregation", "config": path,
              "file": AGG_CONFIGS[name], "rows": n ** 3, "levels": rows,
              "largest_aggregate": [int(torch.bincount(
                  lv.aggregates.long()).max()) for lv in amg.levels],
              "iterations": res.iterations, "anchor": AGG_ANCHORS[name],
              "status": res.status,
              "true_rel_res": true_rel_res(torch, A, res.x, b),
              "setup_s": setup_s, "first_solve_s": first_s,
              "warm_solve_s": {"min": warm[0], "median": warm[len(warm) // 2],
                               "max": warm[-1]},
              "setup_peak_bytes": peak,
              "rap_values_relabel_in_setup": in_setup["rap_values_relabel"],
              "launches": c})
        check(res.status == "success"
              and abs(res.iterations - AGG_ANCHORS[name]) <= 2,
              f"{path}: {res.status} in {res.iterations} iterations, "
              f"anchor {AGG_ANCHORS[name]} +- 2")
        check(rows == AGG_ROWS_128, f"{path}: level rows {rows}, the JAX "
              f"package's {AGG_ROWS_128}")
        check(in_setup["rap_values_relabel"] == levels
              and c["rap_values_relabel"] == levels,
              f"{path}: one B10-relabel launch per Galerkin product "
              f"({levels}) {c}")
        check(c["csr_spmv"] > 0 and c["csr_smooth"] > 0
              and c["dia_coarse_tail"] + c["dia_coarse_tail_dot"]
              + c["dia_coarse_tail_mf"] + c["dia_coarse_tail_mf_dot"] == 0,
              f"{path}: B8/B9 on the CSR levels, no B5 {c}")
        if name == "agg-pcg":
            check(c["dia_prolong_smooth_mf_dot"] == res.iterations + 1
                  and c["dia_spmv_dot"] == c["cg_update"] == res.iterations,
                  f"{path}: B4-mf's dot once per cycle, B6/B7 per "
                  f"iteration {c}")
        else:
            check(c["dia_spmv"] > 0 and c["dia_prolong_smooth_mf"] > 0,
                  f"{path}: B1 and B4-mf ran {c}")

    # structure-reuse resetup of the PCG on A2 = D A D
    slv = slvs["agg-pcg"]
    amg = precond_amg(slv)
    aggs = [lv.aggregates for lv in amg.levels]
    A2 = A.with_values(torch.from_numpy(scaled_values(
        A.row_offsets.cpu(), A.col_indices.cpu(), A.values.cpu())).to(dev))
    amgx.reset_kernel_launches()
    t0 = time.perf_counter()
    slv.resetup(A2)
    torch.cuda.synchronize()
    resetup_s = time.perf_counter() - t0
    in_resetup = amgx.kernel_launches()
    res = slv.solve(b)
    per_path[f"agg-resetup_{n}^3"] = c = amgx.kernel_launches()
    kept = len(aggs) == len(amg.levels) and all(
        a is lv.aggregates for a, lv in zip(aggs, amg.levels))
    emit({"phase": "aggregation_resetup", "config": f"agg-pcg_{n}^3",
          "structure_reuse_levels": -1, "resetup_s": resetup_s,
          "levels": amg.level_rows(), "aggregates_kept": kept,
          "rap_values_relabel_in_resetup": in_resetup["rap_values_relabel"],
          "iterations": res.iterations, "anchor": AGG_RESETUP_ANCHOR,
          "status": res.status,
          "true_rel_res": true_rel_res(torch, A2, res.x, b), "launches": c})
    check(kept, "resetup: the aggregates are the setup's tensors (no "
          "selector ran)")
    check(in_resetup["rap_values_relabel"] == len(amg.levels),
          f"resetup: one B10-relabel launch per level {in_resetup}")
    check(res.status == "success"
          and abs(res.iterations - AGG_RESETUP_ANCHOR) <= 2,
          f"resetup: {res.status} in {res.iterations} iterations, anchor "
          f"{AGG_RESETUP_ANCHOR} +- 2")

    # determinism at 32^3: two card setups, the CPU's; the resetup
    cpu = torch.device("cpu")
    m3 = 32
    runs = []
    for d in (dev, dev, cpu):
        Am = amgx.gallery.poisson("7pt", m3, m3, m3, dtype=torch.float32,
                                  device=d).init()
        sm = amgx.create_solver(agg_config(amgx.Config, "agg-pcg", -1),
                                device=d)
        bm = torch.ones(m3 ** 3, dtype=torch.float32, device=d)
        if d.type == "cuda" and not runs:
            rm = run_path(amgx, per_path, f"agg-pcg_{m3}^3", lambda: (
                sm.setup(Am), sm.solve(bm))[1])
        else:
            sm.setup(Am)
            rm = sm.solve(bm)
        bits = agg_bits(torch, precond_amg(sm))
        A2m = Am.with_values(torch.from_numpy(scaled_values(
            Am.row_offsets.cpu(), Am.col_indices.cpu(),
            Am.values.cpu())).to(d))
        sm.resetup(A2m)
        r2 = sm.solve(bm)
        runs.append((rm, bits, r2))
    (c0, bits0, rr0), (c1, bits1, _), (h, bitsh, rrh) = runs
    same_card = len(bits0) == len(bits1) and all(
        torch.equal(a, b_) for a, b_ in zip(bits0, bits1)) \
        and torch.equal(c0.x, c1.x)
    same_cpu = len(bits0) == len(bitsh) and all(
        torch.equal(a, b_) for a, b_ in zip(bits0, bitsh))
    xdiff = float(torch.linalg.norm(c0.x.cpu() - h.x)
                  / torch.linalg.norm(h.x))
    emit({"phase": "aggregation_determinism", "config": f"agg-pcg_{m3}^3",
          "card_setups_bit_identical": same_card,
          "tensors_compared": len(bits0), "equal_to_cpu_setup": same_cpu,
          "iterations_cuda": c0.iterations, "iterations_cpu": h.iterations,
          "x_rel_diff": xdiff, "resetup_iterations_cuda": rr0.iterations,
          "resetup_iterations_cpu": rrh.iterations})
    check(same_card, f"{m3}^3 aggregation: two card setups and solves are "
          "bit-identical")
    check(same_cpu, f"{m3}^3 aggregation: the card's aggregates and "
          "operators equal the CPU setup's")
    check(c0.iterations == h.iterations and xdiff <= 1e-4
          and rr0.iterations == rrh.iterations,
          f"{m3}^3 aggregation: card and CPU solves agree, before and "
          f"after the resetup")

    # kernel cases on the FGMRES hierarchy (the user's A; the PCG's is
    # now A2's)
    amg = precond_amg(slvs["agg-fgmres"])
    mid = len(amg.levels) // 2
    for lvl in (0, mid):
        lv = amg.levels[lvl]
        case, sizes = relabel_case(torch, R_, lv)
        run_case(torch, K, f"agg_l{lvl}_{n}^3", "rap_values_relabel", *case,
                 lv.A.num_rows, summary, sizes)
    cases, slab, split, mm = agg_transfer_cases(torch, K, amg.levels[0],
                                                dev)
    emit({"phase": "kernels_size2_level0", "rows": n ** 3, **mm})
    for name, case in cases.items():
        run_case(torch, K, f"agg_l0_{n}^3", name, *case, n ** 3, summary,
                 slab=slab.get(name), moved_expect=split.get(name))
    # B9's and B8's bf16 forms on level 1 (the largest CSR level) as
    # amg_precision=bfloat16 hands it over: BLOCK_JACOBI's dinv and omega
    from amgx_tpu_torch.ops import cuda_csr as C
    lv = amg.levels[1]
    sd = lv.smoother.solve_data()
    x1 = torch.zeros(lv.A.num_rows, device=dev)
    tau = lv.smoother._fused_taus(1, x1, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(2468)
    run_case(torch, K, f"agg_l1_{n}^3", "csr_spmv", *csr_spmv_case(
        torch, C, lv.A, torch.randn(lv.A.num_cols, generator=g, device=dev)),
        lv.A.num_rows, summary, repeat=True)
    for label, named in csr_bf16_cases(torch, C, {"agg_A1": lv.A},
                                       sd["dinv"], tau, g).items():
        for name, case in named.items():
            run_case(torch, K, f"agg_l1_{n}^3 {label}", name, *case[:6],
                     lv.A.num_rows, summary, case[6],
                     repeat=name == "csr_spmv_bf16")


# The bf16 hierarchies' paths: (the bf16 configuration, its float32
# twin, size, operator dtype, the bf16 kernels it must launch). The card
# runs each at its size and at BF16_WITNESS, where the CPU route (the
# kernels' plain forms) runs it too: the same status, iterations within
# one, the same level rows. Warm solves in BF16_PAIRS alternating pairs.
# 32^3: at 64^3 the CPU route's runs were ~60 s of the script, at 48^3
# ~20 s, and the later phases need the time; for the same reason the
# three paths that ran at 128^3 run at BF16_N^3 (~0.42x the rows) with
# two pairs, not four.
BF16_WITNESS = 32
BF16_N = 96
BF16_PAIRS = 2
BF16_AGG_KERNELS = ("csr_smooth_bf16", "csr_spmv_bf16",
                    "dia_prolong_smooth_mf_bf16")
BF16_CLS_KERNELS = ("csr_smooth_bf16", "csr_spmv_bf16",
                    "dia_smooth_restrict_w_bf16", "dia_prolong_smooth_w_bf16")


def bf16_paths(amgx, torch):
    def cfg(text):
        return lambda: amgx.Config.from_string(text)
    return {
        "agg-fgmres_bf16": (
            lambda: agg_bf16_config(amgx.Config, "agg-fgmres"),
            lambda: agg_config(amgx.Config, "agg-fgmres"), BF16_N,
            torch.float32, BF16_AGG_KERNELS),
        "agg-pcg_bf16": (
            lambda: agg_bf16_config(amgx.Config, "agg-pcg"),
            lambda: agg_config(amgx.Config, "agg-pcg"), BF16_N,
            torch.float32, BF16_AGG_KERNELS),
        "classical_bf16": (cfg(CLASSICAL_BF16), cfg(CLASSICAL), BF16_N,
                           torch.float64, BF16_CLS_KERNELS),
        "classical_refinement_bf16": (
            cfg(classical_refinement() + ", solve_precision=bfloat16"),
            cfg(classical_refinement()), 64, torch.float64,
            BF16_CLS_KERNELS)}


def run_solve(torch, amgx, make_cfg, n, d, dtype):
    """Set up and solve the 7-pt n^3 system with b = 1 in `dtype` on d:
    (result, solver, setup s, solve s, true relative residual in f64)."""
    from amgx_tpu_torch.ops.spmv import residual
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=dtype, device=d)
    slv = amgx.create_solver(make_cfg(), device=d)
    t0 = time.perf_counter()
    slv.setup(A)
    if d.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(n ** 3, dtype=dtype, device=d)
    t0 = time.perf_counter()
    res = slv.solve(b)
    if d.type == "cuda":
        torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    A64 = amgx.gallery.poisson("7pt", n, n, n, device=d).init()
    b64 = torch.ones(n ** 3, dtype=torch.float64, device=d)
    true_rel = float(torch.linalg.norm(residual(A64, res.x.double(), b64))
                     / torch.linalg.norm(b64))
    check(tuple(res.x.shape) == (n ** 3,) and bool(
        torch.isfinite(res.x).all()), "solution finite, right shape")
    return res, slv, setup_s, solve_s, true_rel


def inner_of(res):
    return None if res.extra_stats is None \
        else int(res.extra_stats["inner_iters"])


def phase_bf16_hierarchies(torch, amgx, dev, per_path):
    """The aggregation and classical hierarchies with their AMG cycle in
    bfloat16: the stock FGMRES_ / PCG_AGGREGATION_JACOBI with
    amg:amg_precision=bfloat16 and CLASSICAL with it at BF16_N^3,
    CLASSICAL_REFINEMENT with solve_precision=bfloat16 at 64^3. Each:
    success (the classical paths at a true f64 residual <= 1e-8), its
    bf16 kernels launched (B9 and B8 on the CSR levels, B3w / B4w on the
    classical level 0, B4-mf on the aggregation level 0), no float32
    smoother kernel and no coarse tail; its float32 twin solved in the
    same call and warm solves of the two in alternating pairs (the
    ratio recorded); the reference's SWELL rules on each CSR level
    (`swell_fit`); then the card against the CPU route at
    BF16_WITNESS^3."""
    cpu = torch.device("cpu")
    for path, (make, make32, n, dtype, kernels) in bf16_paths(
            amgx, torch).items():
        label = f"{path}_{n}^3"
        torch.cuda.reset_peak_memory_stats(dev)
        res, slv, setup_s, solve_s, true_rel = run_path(
            amgx, per_path, label, lambda m=make, n=n, t=dtype: run_solve(
                torch, amgx, m, n, dev, t))
        peak = torch.cuda.max_memory_allocated(dev)
        c = per_path[label]
        r32, slv32, _, _, rel32 = run_solve(torch, amgx, make32, n, dev,
                                            dtype)
        warm, wins = paired_warm(torch, {"float32": slv32, "bf16": slv}, n,
                                 dtype, pairs=BF16_PAIRS)
        amg = precond_amg(slv)
        fits = []
        for i, lv in enumerate(amg.levels):
            if lv.A.dia_vals is not None:
                continue
            fit = {"level": i, "rows": lv.A.num_rows,
                   "A": swell_fit(torch, lv.A)}
            for key in ("P", "R"):
                if getattr(lv, key, None) is not None:
                    fit[key] = swell_fit(torch, getattr(lv, key))
            fits.append(fit)
        emit({"phase": "bf16_hierarchies", "config": label, "rows": n ** 3,
              "levels": amg.level_rows(), "status": res.status,
              "iterations": res.iterations, "inner_iterations": inner_of(res),
              "f32_iterations": r32.iterations,
              "f32_inner_iterations": inner_of(r32),
              "iteration_ratio": (inner_of(res) or res.iterations)
              / max(inner_of(r32) or r32.iterations, 1),
              "true_rel_res": true_rel, "f32_true_rel_res": rel32,
              "setup_s": setup_s, "solve_s": solve_s,
              "setup_peak_bytes": peak, "warm_solve_s": warm,
              "pairs": BF16_PAIRS, "f32_first_wins": wins,
              "warm_f32_over_bf16": warm["float32"]["median"]
              / warm["bf16"]["median"],
              "swell_fit": fits, "launches": c})
        check(res.status == "success" == r32.status,
              f"{label}: {res.status} (float32 twin {r32.status})")
        if dtype == torch.float64:
            check(true_rel <= 1e-8, f"{label}: true relative residual "
                  f"{true_rel} <= 1e-8")
        check(all(c[k] > 0 for k in kernels),
              f"{label}: launched its bf16 kernels {kernels}: {c}")
        if "dia_smooth_restrict_w_bf16" in kernels:
            per_call = weighted_per_call(torch, amg)
            check(weighted_cycles(c, per_call, "_bf16") is not None,
                  f"{label}: B3w ({per_call[0]} launches) and B4w "
                  f"({per_call[1]}) once per cycle {c}")
        check(all(c[k] == 0 for k in F32_SMOOTHERS)
              and c["dia_coarse_tail_bf16"] + c["dia_coarse_tail_mf_bf16"]
              == 0, f"{label}: no float32 smoother, no coarse tail {c}")
        del res, slv, r32, slv32, amg
        torch.cuda.empty_cache()
        # the card against the CPU route on the same input
        w = BF16_WITNESS
        runs = {}
        for d in (dev, cpu):
            def witness(d=d):
                return run_solve(torch, amgx, make, w, d, dtype)
            wr, wslv, _, wsolve, wrel = run_path(
                amgx, per_path, f"{path}_{w}^3", witness) \
                if d.type == "cuda" else witness()
            runs[d.type] = {"status": wr.status, "iterations": wr.iterations,
                            "inner_iterations": inner_of(wr),
                            "levels": levels_of(wslv), "solve_s": wsolve,
                            "true_rel_res": wrel}
        emit({"phase": "bf16_witness", "config": f"{path}_{w}^3",
              "cuda": runs["cuda"], "cpu": runs["cpu"],
              "launches": per_path[f"{path}_{w}^3"]})
        a, h = runs["cuda"], runs["cpu"]
        check(a["status"] == h["status"] == "success"
              and abs(a["iterations"] - h["iterations"]) <= 1
              and abs((a["inner_iterations"] or 0)
                      - (h["inner_iterations"] or 0)) <= 1
              and a["levels"] == h["levels"],
              f"{path} at {w}^3: the card {a} against the CPU {h}")


# ---------------------------------------------------------------------------
# resilience and telemetry (phase_resilience)
# ---------------------------------------------------------------------------

# the grid edges: (RC), (RS), (RG) and (FT) at RES_N, the card-vs-CPU
# witnesses at RES_SMALL, (AS) at RES_ASYNC_N
RES_N = 128
RES_SMALL = 32
RES_ASYNC_N = 64
# the JAX package's stall drill (tests/test_resilience.py), max_iters
# raised to 200
RES_STALL = (
    "solver(amg)=AMG, amg:max_iters=200, amg:monitor_residual=1,"
    " amg:tolerance=1e-8, amg:convergence=RELATIVE_INI,"
    " amg:algorithm=AGGREGATION, amg:selector=SIZE_2,"
    " amg:smoother(sm)=JACOBI_L1, sm:max_iters=1,"
    " amg:presweeps=0, amg:postsweeps=0, amg:cycle=V,"
    " amg:coarse_solver=DENSE_LU_SOLVER, amg:min_coarse_rows=8,"
    " amg:stall_detection_window=4,"
    " fallback_policy=STALLED>escalate_sweeps, max_fallback_attempts=1")
# warm solves telemetry=1 against telemetry=0, alternating
RES_PAIRS = 4
# the B5 tail's launch counters: a probe cycle composes every level
TAIL_COUNTERS = ("dia_coarse_tail", "dia_coarse_tail_dot",
                 "dia_coarse_tail_mf", "dia_coarse_tail_mf_dot",
                 "dia_coarse_tail_bf16", "dia_coarse_tail_mf_bf16")


def on_card(torch, tree):
    """Whether every tensor of a solve-data tree lies on a CUDA device."""
    from amgx_tpu_torch.determinism import tensor_leaves
    leaves = tensor_leaves(tree)
    return bool(leaves) and all(t.device.type == "cuda" for t in leaves)


def chain(res):
    """(fallback history as lists, final status, final iterations)."""
    return ([list(h) for h in getattr(res, "fallback_history", [])],
            res.status, res.iterations)


def witness(torch, amgx, cfg, n, dev, arm=None):
    """The chains of a drill at n^3 on `dev` and on the CPU: float64,
    held equal (iterations too), and float32, whose statuses are held
    equal (a float32 solve that stalls at float32's rounding floor stops
    at a rounding-dependent iteration)."""
    cpu = torch.device("cpu")
    got = {f"{d.type}_{str(dt)[6:]}": chain(resilient_pair(
        torch, amgx, cfg, n, d, dt, arm)[0])
        for dt in (torch.float64, torch.float32) for d in (dev, cpu)}
    ok = got[f"{dev.type}_float64"] == got["cpu_float64"] and [
        h[1] for h in got[f"{dev.type}_float32"][0]] == [
        h[1] for h in got["cpu_float32"][0]]
    return got, ok


def resilient_pair(torch, amgx, cfg, n, dev, dtype, arm=None):
    """(result, solver) of a set-up-and-solve of the 7-pt n^3 system
    (b = 1) under `arm` (faultinject.inject's args) around the setup."""
    from amgx_tpu_torch.resilience import faultinject as fi
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=dtype, device=dev).init()
    slv = amgx.create_solver(amgx.Config.from_string(cfg), device=dev)
    if arm is None:
        slv.setup(A)
    else:
        with fi.inject(arm[0], **arm[1]):
            slv.setup(A)
    return slv.solve(torch.ones(A.num_rows, dtype=dtype, device=dev)), slv


def phase_resilience(torch, amgx, dev, per_path):
    """The resilience layer and the telemetry on the card: (RC), (RS),
    (RG), (FT) and (AS) of the module docs."""
    from amgx_tpu_torch import determinism
    from amgx_tpu_torch.memory_info import peak_bytes
    from amgx_tpu_torch.presets import FLAGSHIP, RESILIENT_CG
    from amgx_tpu_torch.resilience import ResilientSolver
    from amgx_tpu_torch.resilience import faultinject as fi
    from amgx_tpu_torch.telemetry import diagnostics as dg
    from amgx_tpu_torch.telemetry import metrics, spans, validate_report
    cuda = dev.type == "cuda"
    n, f32 = RES_N, torch.float32
    # (RC) RESILIENT_CG: a clean solve (through its chain where the
    # preset's guards call one), a transient NaN on the tree the clean
    # solve left, clean again
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=f32, device=dev).init()
    b = torch.ones(A.num_rows, dtype=f32, device=dev)
    rs = amgx.create_solver(amgx.Config.from_string(RESILIENT_CG),
                            device=dev)
    check(isinstance(rs, ResilientSolver), "RESILIENT_CG is resilient")
    rs.setup(A)
    preset = rs.solver.solve(b)         # the preset's tree, no chain
    clean = run_path(amgx, per_path, "resilient_cg", lambda: rs.solve(b))
    ref = rs.solve(b)                   # the tree the clean solve left
    ref_rel = true_rel_res(torch, A, ref.x, b)
    with fi.inject("spmv_nan", iteration=3, fires=1):
        first = rs.solver.solve(b)
    with fi.inject("spmv_nan", iteration=3, fires=1):
        hit = run_path(amgx, per_path, "resilient_cg_nan",
                       lambda: rs.solve(b))
    hit_rel = true_rel_res(torch, A, hit.x, b)
    after = rs.solve(b)
    emit({"phase": "resilience", "case": "RC", "rows": n ** 3,
          "preset_tree": [preset.status, preset.iterations],
          "preset_residuals_0_12": preset.report.residuals[:13],
          "clean": chain(clean), "reference": chain(ref),
          "true_rel_res": ref_rel, "adopted": rs.solver.name,
          "first_attempt": [first.status, first.iterations],
          "armed": chain(hit), "retry_true_rel_res": hit_rel,
          "after": chain(after), "launches": per_path["resilient_cg_nan"]})
    check(clean.status == "success"
          and ref.fallback_history == [("initial", "success")],
          f"(RC) clean: {chain(clean)}, then {chain(ref)}")
    check((first.status, first.iterations) == ("nan_detected", 4),
          f"(RC) first attempt {first.status} after {first.iterations}")
    check(hit.fallback_history == [("initial", "nan_detected"),
                                   ("retry", "success")]
          and (hit.status, hit.iterations) == (ref.status, ref.iterations)
          and hit_rel <= 2.0 * ref_rel,
          f"(RC) armed: {chain(hit)}, {hit_rel} against {ref_rel}")
    check(chain(after) == chain(ref), f"(RC) after: {chain(after)}")
    del rs, A, b
    # (RS) the stall drill: escalate_sweeps rebuilds on the card
    rs_run = run_path(amgx, per_path, "resilient_stall", lambda: (
        resilient_pair(torch, amgx, RES_STALL, n, dev, f32)))
    res, slv = rs_run
    c = per_path["resilient_stall"]
    small, same = witness(torch, amgx, RES_STALL, RES_SMALL, dev)
    emit({"phase": "resilience", "case": "RS", "rows": n ** 3,
          "chain": chain(res), "levels": levels_of(slv.solver),
          "adopted_on_card": on_card(torch, slv.solver.solve_data()),
          f"chain_{RES_SMALL}": small, "launches": c})
    check(res.fallback_history[0] == ("initial", "stalled")
          and res.fallback_history[1][0] == "escalate_sweeps",
          f"(RS) chain {chain(res)}")
    check(not cuda or c["rap_values_relabel"] >= 2 * (
        len(levels_of(slv.solver)) - 1),
        f"(RS) the rebuild's Galerkin products: {c}")
    check(not cuda or on_card(torch, slv.solver.solve_data()),
          "(RS) the adopted tree lies on the card")
    check(same, f"(RS) {RES_SMALL}^3 card against CPU: {small}")
    del res, slv, rs_run
    # (RG) a perturbed Galerkin product under RESILIENT_CG
    arm = ("galerkin_perturb", {"index": 0, "scale": -1.0})
    small, same = witness(torch, amgx, RESILIENT_CG, RES_SMALL, dev, arm)
    res, slv = run_path(amgx, per_path, "resilient_galerkin", lambda: (
        resilient_pair(torch, amgx, RESILIENT_CG, n, dev, f32, arm)))
    c = per_path["resilient_galerkin"]
    print(f"chip_smoke: (RG) {n}^3 galerkin_perturb chain: "
          f"{res.fallback_history} -> {res.status} after "
          f"{res.iterations}, adopted {slv.solver.name}", flush=True)
    emit({"phase": "resilience", "case": "RG", "rows": n ** 3,
          "chain": chain(res), "adopted": slv.solver.name,
          f"chain_{RES_SMALL}": small, "launches": c})
    check(same, f"(RG) {RES_SMALL}^3 card against CPU: {small}")
    if any(h[0] == "switch_solver=GMRES" for h in res.fallback_history):
        check(slv.solver.name == "GMRES" and (not cuda or c["dia_spmv"] > 0),
              f"(RG) GMRES adopted and launching B1: {c}")
    del res, slv
    # (FT) the flagship with telemetry and diagnostics
    n3 = RES_N
    cfg = FLAGSHIP + ", store_res_history=1"
    runs, slvs = {}, {}
    for label, extra in (("flagship_telemetry", ", diagnostics=0"),
                         ("flagship_telemetry_off", ", telemetry=0"),
                         ("flagship_diagnostics", ", diagnostics=1")):
        runs[label] = run_path(amgx, per_path, label, lambda e=extra: solve(
            torch, amgx, cfg + e, n3, dev))
        slvs[label] = runs[label][1]
    res, slv, _, _, true_rel = runs["flagship_diagnostics"]
    inner = int(res.extra_stats["inner_iters"])
    rep = res.report.to_dict()
    diag = rep["diagnostics"]
    amg = precond_amg(slv)
    # the probe alone, on the solve's final residual
    from amgx_tpu_torch.ops.spmv import residual
    A64 = slv.A
    r_fin = residual(A64, res.x, torch.ones_like(res.x))
    sub = slv.solve_data()["inner"]["precond"]["amg"]
    probe = run_path(amgx, per_path, "probe_cycle", lambda: dg.probe_cycle(
        amg, sub, r_fin, torch.float64))
    pc = per_path["probe_cycle"]
    base = per_path["flagship_telemetry"]
    extra = {k: per_path["flagship_diagnostics"][k] - base[k]
             for k in base if per_path["flagship_diagnostics"][k] != base[k]}
    # host syncs of a warm solve, two rounds in turns (the second is
    # held: the first of a process may count a one-time read)
    syncs = []
    for _ in range(2 if cuda else 0):
        syncs.append({label: count_syncs(torch, lambda lb=label: (
            warm_solve(torch, slvs[lb], n3, torch.float64)))[1]
            for label in ("flagship_telemetry", "flagship_telemetry_off",
                          "flagship_diagnostics")})
    # warm solves of one solver with its telemetry knob on and off, in
    # turns: the same hierarchy either way
    tslv = slvs["flagship_telemetry"]
    times = {"telemetry_1": [], "telemetry_0": []}
    for i in range(RES_PAIRS):
        for flag in ((1, 0) if i % 2 == 0 else (0, 1)):
            tslv.telemetry = bool(flag)
            times[f"telemetry_{flag}"].append(
                warm_solve(torch, tslv, n3, torch.float64)[1])
    tslv.telemetry = True
    warm = {k: {"median": sorted(v)[len(v) // 2], "all": v}
            for k, v in times.items()}
    wins = sum(a < b for a, b in zip(times["telemetry_1"],
                                     times["telemetry_0"]))
    emit({"phase": "resilience", "case": "FT", "rows": n3 ** 3,
          "outer_iterations": res.iterations, "inner_iterations": inner,
          "true_rel_res": true_rel, "report_errors": validate_report(rep),
          "diagnostics": diag, "tail_entry_level": rep["tail_entry_level"],
          "report_levels": rep["levels"], "probe_launches": {
              k: v for k, v in pc.items() if v},
          "diagnostics_minus_telemetry": extra, "host_syncs_warm": syncs,
          "warm_solve_s": warm, "telemetry_1_wins": wins,
          "warm_median_ratio_1_over_0": warm["telemetry_1"]["median"]
          / warm["telemetry_0"]["median"],
          "probe_norms": probe.cpu().tolist()})
    check(res.status == "success" and res.iterations <= 3
          and true_rel <= 1e-8, f"(FT) {res.status} {res.iterations} "
          f"outer, {true_rel}")
    for label in ("flagship_telemetry", "flagship_telemetry_off"):
        r = runs[label][0]
        check((r.iterations, int(r.extra_stats["inner_iters"]))
              == (res.iterations, inner), f"(FT) {label} iterations")
    check(validate_report(rep) == [], f"(FT) report: {validate_report(rep)}")
    check(diag is not None and diag["bottleneck_level"] is not None
          and len(diag["levels"]) == len(amg.levels) and all(
              all(np.isfinite(r[k]) for k in ("presmooth_reduction",
                                              "correction_reduction",
                                              "postsmooth_reduction",
                                              "level_reduction"))
              for r in diag["levels"]), f"(FT) diagnostics {diag}")
    check(extra == {k: v for k, v in pc.items() if v}
          and (not cuda or pc["dia_spmv"] > 0)
          and sum(pc[k] for k in TAIL_COUNTERS if k in pc) == 0,
          f"(FT) the probe's launches {extra} against one composed cycle "
          f"{pc}")
    if "flagship" in per_path:
        for label in ("flagship_telemetry", "flagship_telemetry_off"):
            check(per_path[label] == per_path["flagship"],
                  f"(FT) {label} launches what the flagship phase did")
    if cuda:
        last = syncs[-1]
        check(last["flagship_telemetry"] == last["flagship_telemetry_off"]
              and last["flagship_diagnostics"]
              == last["flagship_telemetry"] + 1,
              f"(FT) host syncs {syncs}")
    # a telemetry_sync=1 solve's Chrome trace; the next create_solver
    # latches the fence off again
    spans.reset()
    tslv = amgx.create_solver(amgx.Config.from_string(
        FLAGSHIP + ", telemetry_sync=1"), device=dev)
    check(spans.sync_enabled(), "(FT) telemetry_sync latched on")
    A = amgx.gallery.poisson("7pt", n3, n3, n3, device=dev)
    tslv.setup(A)
    tslv.solve(torch.ones(n3 ** 3, dtype=torch.float64, device=dev))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "resilience_trace.json")
    n_ev = spans.export_chrome_trace(path)
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    # the allocator's peak against the gauge
    metrics.reset()
    mslv = amgx.create_solver(amgx.Config.from_string(FLAGSHIP),
                              device=dev)
    check(not spans.sync_enabled(), "(FT) telemetry_sync latched off")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    mslv.setup(A)
    gauge = metrics.snapshot()["memory.setup_peak_bytes"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    emit({"phase": "resilience", "case": "FT_trace", "events": n_ev,
          "spans": sorted(names), "setup_peak_bytes_gauge": gauge,
          "max_memory_allocated": peak})
    check({"REFINEMENT.setup", "REFINEMENT.solve"} <= names,
          f"(FT) trace spans {sorted(names)[:20]}")
    check(gauge == peak == peak_bytes([dev]), f"(FT) gauge {gauge}, "
          f"allocator {peak}")
    del runs, slvs, res, slv, tslv, mslv, A, A64, sub, r_fin
    # (AS) setup_async against setup
    na = RES_ASYNC_N
    A = amgx.gallery.poisson("7pt", na, na, na, device=dev)
    sync = amgx.create_solver(amgx.Config.from_string(FLAGSHIP),
                              device=dev).setup(A)
    aslv = amgx.create_solver(amgx.Config.from_string(FLAGSHIP), device=dev)
    task = aslv.setup_async(A)
    check(task.wait() is aslv, "(AS) wait returns the solver")
    fs = determinism.tree_fingerprints(sync.solve_data())
    fa = determinism.tree_fingerprints(aslv.solve_data())
    bb = torch.ones(na ** 3, dtype=torch.float64, device=dev)
    rsync, rasync = sync.solve(bb), aslv.solve(bb)
    its = [(r.iterations, int(r.extra_stats["inner_iters"]))
           for r in (rsync, rasync)]
    emit({"phase": "resilience", "case": "AS", "rows": na ** 3,
          "leaves": len(fs), "bit_identical": fs == fa,
          "iterations": its,
          "on_card": on_card(torch, aslv.solve_data())})
    check(fs == fa and len(fs) > 10, "(AS) async setup = setup, bit for bit")
    check(its[0] == its[1], f"(AS) iterations {its}")
    check(not cuda or on_card(torch, aslv.solve_data()),
          "(AS) the async hierarchy lies on the card")


# ---------------------------------------------------------------------------
# serving: the GEO + CHEBYSHEV_POLY batch, K5 and the service
# ---------------------------------------------------------------------------

SERVE_N = 128
SERVE_COLD_N = 130          # odd coarse sizes (130 -> 65 -> 33 ...)
SERVE_SMALL_N = 64          # the slab route's batch and the anchor's size
SERVE_B = 8
SERVE_SEED = 11
SERVE_SLOTS = 4
SERVE_CHUNK = 4
SERVE_REQUESTS = 24
SERVE_GAP_S = 0.002         # open-loop spacing (bench.py bench_serving)
# the JAX package's SERVING_CG on the 7-pt 64^3 Poisson, float32, b = 1
# (tools/jax_anchors.py --size 64 preset:SERVING_CG): 14 iterations
SERVE_ANCHOR_64 = 14
SINGLE_TAILS = ("dia_coarse_tail", "dia_coarse_tail_mf",
                "dia_coarse_tail_dot", "dia_coarse_tail_mf_dot",
                "dia_coarse_tail_bf16", "dia_coarse_tail_mf_bf16")
MULTI_TAILS = ("dia_coarse_tail_multi", "dia_coarse_tail_mf_multi")


def serve_shift(s):
    """System s of the serving paths is A + serve_shift(s) I (bench.py's
    shifted traffic)."""
    return 0.1 * (s % 3)


def tail_entry(amg):
    """The first level the coarse tail takes."""
    return next(i for i, lv in enumerate(amg.levels)
                if lv.A.num_rows <= amg.cycle_fusion_tail_rows)


def tail_launches(c):
    """(batched tail launches, single tail launches) of a path."""
    return (sum(c[k] for k in MULTI_TAILS), sum(c[k] for k in SINGLE_TAILS))


def k5_case(torch, K, T, amg, data, X, Bv, summary, label, main=False):
    """K5 on a batch's tail (its arrays shared or stacked): row s equal to
    B5 on system s's arrays bit for bit, within the tail's limit of the
    plain form; timed beside B launches of B5."""
    from amgx_tpu_torch.ops.smooth import _tail_plan
    lvl = tail_entry(amg)
    spec, arrs = _tail_plan(amg, "V", data, lvl, X)
    nb = X.shape[0]
    mf = any(ls.mf is not None for ls in spec.levels)
    name = "dia_coarse_tail_mf_multi" if mf else "dia_coarse_tail_multi"
    sys_arrs = [T.system_arrays(arrs, s) for s in range(nb)]
    seen, nbytes = set(), 3 * X.numel() * 4
    for ar in arrs:
        for t in ar.values():
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                nbytes += t.numel() * t.element_size()
    _, flops, phases = tail_work(T, spec, sys_arrs[0], False)
    batch_kernel_case(
        torch, K, f"{label} tail at level {lvl} ({spec.levels[0].n} rows)",
        name, lambda: T.dia_coarse_tail_multi(spec, arrs, Bv, X),
        lambda: [T.dia_coarse_tail(spec, sys_arrs[s], Bv[s], X[s])
                 for s in range(nb)],
        lambda: T.dia_coarse_tail_multi_plain(spec, arrs, Bv, X),
        nbytes, flops * nb, 1, None, nb, summary, main,
        limit=LIMITS["dia_coarse_tail"])
    cluster, cbar, bbar = T.launch_shape(spec, sys_arrs[0], X[0])
    summary[name].update(phases=phases, cluster=cluster,
                         cluster_barriers=cbar, block_barriers=bbar)


def k2_taus_case(torch, K, data, X, Bv, summary, label):
    """K2-mf with per-system damping factors (B, T) on a stacked level 0:
    row s equal to B2-mf with system s's taus and coefficients bit for
    bit. The kernels line keeps the shared-taus row and adds this one as
    `per_system_taus`."""
    from amgx_tpu_torch.ops import cuda_batched as KB
    from amgx_tpu_torch.ops import stencil as mf
    nb, n = X.shape
    lv0 = data["levels"][0]
    st = lv0["stencil"]
    taus = lv0["smoother"]["taus"].float().contiguous()
    check(st.coeffs.dim() == 2 and taus.dim() == 2
          and not torch.equal(taus[0], taus[1]),
          f"serving K2-mf: stacked coefficients and distinct taus "
          f"({tuple(st.coeffs.shape)}, {tuple(taus.shape)})")
    srows = [dataclasses.replace(st, coeffs=st.coeffs[s], host=st.host[s])
             for s in range(nb)]
    k = st.k
    steps = taus.shape[-1]
    own = {}
    batch_kernel_case(
        torch, K, f"{label} level 0 ({n} rows), {steps} steps + residual",
        "dia_step_mf_multi",
        lambda: KB.dia_smooth_mf_multi(st, taus, Bv, X, True),
        lambda: [K.dia_smooth_mf(srows[s], taus[s], Bv[s], X[s], True)
                 for s in range(nb)],
        lambda: mf._xla_smooth(st.spec(), st.coeffs, taus, Bv, X, True),
        4 * X.numel() * 4 + taus.numel() * 4 + st.coeffs.numel() * 4,
        ((2 * k + 3) * steps + 2 * k + 1) * n * nb, steps + 1, None, nb,
        own, limit=LIMITS["dia_smooth_mf"])
    row = own["dia_step_mf_multi"]
    if "dia_step_mf_multi" in summary:
        summary["dia_step_mf_multi"]["per_system_taus"] = row
    else:
        summary["dia_step_mf_multi"] = dict(row, per_system_taus=row)


def serving_requests(torch, amgx, dev, n, cold_n):
    """The SV traffic: (matrix, rhs, deadline_s, pattern, system index) a
    request, spaced SERVE_GAP_S apart by the caller. Every 5th request is
    on the cold pattern; every 7th hot one has deadline_s = 0; system i
    is A + serve_shift(i) I with a rhs from default_rng(SERVE_SEED)."""
    hot = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                               device=dev).init()
    cold = amgx.gallery.poisson("7pt", cold_n, cold_n, cold_n,
                                dtype=torch.float32, device=dev).init()
    rng = np.random.default_rng(SERVE_SEED)
    shifted = {}
    out, n_hot = [], 0
    for i in range(SERVE_REQUESTS):
        pat = "cold" if i % 5 == 0 else "hot"
        A = cold if pat == "cold" else hot
        deadline = None
        if pat == "hot":
            n_hot += 1
            deadline = 0.0 if n_hot % 7 == 0 else None
        key = (pat, i % 3)
        if key not in shifted:
            shifted[key] = diag_shifted(torch, A, [serve_shift(i)])[0]
        b = torch.from_numpy(rng.standard_normal(A.num_rows).astype(
            np.float32)).to(dev)
        out.append((shifted[key], b, deadline, pat, i))
    return out


def sync_sites(torch, fn):
    """The synchronizing CUDA operations fn() makes, as PyTorch's sync
    debug mode reports them: each as the innermost frames of the package
    (and this script) that led to it."""
    import traceback
    torch.cuda.synchronize()
    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            frames = [f"{os.path.basename(f.filename)}:{f.lineno}"
                      for f in traceback.extract_stack()
                      if "amgx_tpu_torch" in f.filename
                      or f.filename.endswith("chip_smoke.py")]
            sites.append(frames[-4:] + [f"{os.path.basename(filename)}:"
                                        f"{lineno}"])

    # the mode switch warns itself: the hook sees fn() alone
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sites


def serve_cfg(amgx, base, store, extra="", aot=True):
    """A service's config: `store` holds its hierarchy store and, with
    `aot`, its warm-start store."""
    return amgx.Config.from_string(
        base + f", serving_bucket_slots={SERVE_SLOTS},"
        f" serving_chunk_iters={SERVE_CHUNK}" + (
            (f", serving_aot_dir={store}/aot" if aot else "")
            + f", serving_hierarchy_dir={store}/hier" if store else "")
        + extra)


def serving_restart(argv):
    """The (SR) process: a new SolveService on the stores the first
    process filled serves one hot request (system `index` of
    serving_requests) on the device named last. Then the warm-start
    store's gain: the same request's first latency in a service without
    it (its bucket probes) and in one with it again, both in this warm
    process. Prints one JSON line and writes x to `out`."""
    import torch
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.ops import cuda_build
    from amgx_tpu_torch.presets import SERVING_CG
    from amgx_tpu_torch.serving import SolveService
    from amgx_tpu_torch.telemetry import metrics as tm
    store, out, n, cold_n, index = argv[0], argv[1], *map(int, argv[2:5])
    dev = torch.device(argv[5])
    t0 = time.perf_counter()
    reqs = serving_requests(torch, amgx, dev, n, cold_n)
    M, b, _, _, _ = reqs[index]
    names = ("amg.setup.full", "amg.setup.restored", "serving.retrace",
             "serving.aot.load")
    def first_request(aot):
        before = {k: tm.get(k) for k in names}
        svc = SolveService(serve_cfg(amgx, SERVING_CG, store, aot=aot),
                           device=dev)
        t1 = time.perf_counter()
        t = svc.submit(M, b)
        svc.drain(timeout_s=300)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        eng = svc.buckets.peek(t.fingerprint)
        row = {"counters": {k: tm.get(k) - before[k] for k in names},
               "aot_warm": eng.aot_warm, "hier_restored": eng.hier_restored,
               "first_request_s": first_s}
        del svc, eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return t, row

    t, row = first_request(True)
    np.save(out, t.result.x.cpu().numpy())
    builds = list(cuda_build.BUILT)
    gain = {}
    for case, aot in (("without_store", False), ("with_store", True)):
        tc, gain[case] = first_request(aot)
        gain[case]["x_equal"] = torch.equal(tc.result.x, t.result.x)
    print(json.dumps({
        **row, "kernel_builds": builds,
        "status": t.result.status, "iterations": t.result.iterations,
        "ticket_latency_s": t.latency_s, "store_gain": gain,
        "process_s": time.perf_counter() - t0}), flush=True)
    return 0


def phase_serving(torch, amgx, dev, per_path, summary, n=SERVE_N,
                  cold_n=SERVE_COLD_N, nb=SERVE_B, small_n=SERVE_SMALL_N):
    """The serving core on SERVING_CG (PCG + GEO aggregation +
    CHEBYSHEV_POLY + DENSE_LU, structure_reuse_levels=-1), 7-pt Poisson
    in float32, system s = A + serve_shift(s) I.
    (SG) the GEO batch, nb x n^3: solve_many multi-RHS and multi-matrix,
    each system against its solo solve (status, iterations +- 1, true
    residual within 2x); K5 once a batched V-cycle and no B5; K5 row s =
    B5 on system s's arrays and K2-mf with per-system taus row s = B2-mf
    with system s's taus, bit for bit; the solo 64^3 solve at the JAX
    package's count (+- 1); the slab route (K5 on slab levels) at 64^3.
    (SV) the service at n^3 (hot) and cold_n^3 (cold), SERVE_SLOTS slots,
    SERVE_CHUNK iterations a cycle, SERVE_REQUESTS open-loop requests
    SERVE_GAP_S apart on the background scheduler: every ticket
    completes, the deadline ones DEADLINE_EXCEEDED, every other one the
    status and iterations of a solve_many of its own system at the
    bucket's width; two full setups; the hot admits through value
    resetups; one host read an engine step; one _CardPlan a bucket.
    (SR) a second process on the same stores serves one hot request:
    zero full setups, serving.retrace 0, no kernel build, x bit-identical;
    then the same request's first latency without the warm-start store
    (one probe) and with it again, in that warm process.
    (SJ) a journaled service dropped after 3 cycles resumes in a new one
    bit-identically. (SC) an armed step_crash quarantines the bucket,
    which resumes bit-identically."""
    import shutil
    import tempfile
    from amgx_tpu_torch.batch import BatchedSolver, stack_solve_datas
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.ops import cuda_tail as T
    from amgx_tpu_torch.presets import SERVING_CG
    cfg = amgx.Config.from_string(SERVING_CG)
    rng = np.random.default_rng(SERVE_SEED + 1)

    def rhs(count, rows):
        return torch.from_numpy(rng.standard_normal((count, rows)).astype(
            np.float32)).to(dev)

    # (SG) the GEO batch
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                             device=dev).init()
    bs = BatchedSolver(cfg, device=dev)
    _, setup_s = timed(torch, lambda: bs.setup(A))
    slv, amg = bs.solver, precond_amg(bs.solver)
    levels = amg.level_rows()
    Bm = rhs(nb, n ** 3)
    mats = diag_shifted(torch, A, [serve_shift(s) for s in range(nb)])
    got, sg = {}, {}
    for case, mm in (("multi_rhs", None), ("multi_matrix", mats)):
        path = f"serving_geo_{case}"
        res, first_s = timed(torch, lambda: run_path(
            amgx, per_path, path, lambda: bs.solve_many(Bm, matrices=mm)))
        c = per_path[path]
        multi, single = tail_launches(c)
        iters = int(res.iterations.max())
        check(multi == iters + 1 and single == 0,
              f"serving (SG) {case}: {multi} K5 launches for {iters} "
              f"iterations (want one a batched V-cycle), {single} B5")
        got[case] = batch_systems(torch, res, mats if mm else [A] * nb, Bm)
        warm = [timed(torch, lambda: bs.solve_many(Bm, matrices=mm))[1]
                for _ in range(2)]
        prof = batch_profile(torch, lambda: bs.solve_many(
            Bm, matrices=mm), iters)
        sg[case] = {"iterations": res.iterations.tolist(),
                    "status": [g["status"] for g in got[case]],
                    "true_rel_res": [g["true_rel_res"] for g in got[case]],
                    "first_batched_s": first_s, "warm_batched_s": warm,
                    "profile": prof, "launches": c}
    solo = amgx.create_solver(cfg, device=dev)
    solo.setup(A)
    ref_m = solo_systems(torch, solo, [A] * nb, Bm, False)
    ref_mm = solo_systems(torch, solo, mats, Bm, True)
    for case, ref in (("multi_rhs", ref_m), ("multi_matrix", ref_mm)):
        for i in range(nb):
            batch_check(f"serving (SG) {case} system {i}", got[case][i],
                        ref[i])
        sg[case]["solo"] = ref
        sg[case]["warm_batched_over_one_solo"] = min(
            sg[case]["warm_batched_s"]) / float(np.median(
                [r["solve_s"] for r in ref]))
    del solo
    # K5 (shared and stacked arrays) and K2-mf with per-system taus
    lvl = tail_entry(amg)
    nt = amg.levels[lvl].A.num_rows
    k5_case(torch, K, T, amg, slv.solve_data()["precond"]["amg"],
            rhs(nb, nt), rhs(nb, nt), summary, "shared", main=True)
    data_mm, _ = stack_solve_datas(bs._per_system_data(mats))
    amg_mm = data_mm["precond"]["amg"]
    k5_case(torch, K, T, amg, amg_mm, rhs(nb, nt), rhs(nb, nt), summary,
            "per-system")
    k2_taus_case(torch, K, amg_mm, rhs(nb, n ** 3), rhs(nb, n ** 3),
                 summary, "per-system")
    del data_mm, amg_mm
    emit({"phase": "serving", "case": "SG", "rows": n ** 3, "systems": nb,
          "levels": levels, "tail_entry": lvl, "setup_s": setup_s,
          **sg})
    del bs, slv
    torch.cuda.empty_cache()
    # the solo 64^3 solve against the JAX package's count; the slab route
    A64 = amgx.gallery.poisson("7pt", small_n, small_n, small_n,
                               dtype=torch.float32, device=dev).init()
    s64 = amgx.create_solver(cfg, device=dev)
    s64.setup(A64)
    r64 = s64.solve(torch.ones(small_n ** 3, device=dev))
    check(r64.status == "success"
          and abs(r64.iterations - SERVE_ANCHOR_64) <= BATCH_ITER_TOL,
          f"serving 64^3 solo: {r64.status} in {r64.iterations}, the JAX "
          f"package {SERVE_ANCHOR_64}")
    bss = BatchedSolver(amgx.Config.from_string(SERVING_CG + SLAB),
                        device=dev)
    bss.setup(A64)
    m64 = diag_shifted(torch, A64, [serve_shift(s) for s in range(nb)])
    B64 = rhs(nb, small_n ** 3)
    res_s = run_path(amgx, per_path, "serving_geo_slab_64^3",
                     lambda: bss.solve_many(B64, matrices=m64))
    c = per_path["serving_geo_slab_64^3"]
    check(c["dia_coarse_tail_multi"] == int(res_s.iterations.max()) + 1
          and tail_launches(c)[1] == 0,
          f"serving slab 64^3: tail launches {c}")
    got_s = batch_systems(torch, res_s, m64, B64)
    ref_s = solo_systems(torch, bss.solver, m64, B64, True)
    for i in range(nb):
        batch_check(f"serving slab 64^3 system {i}", got_s[i], ref_s[i])
    data_s, _ = stack_solve_datas(bss._per_system_data(m64))
    amg_s = precond_amg(bss.solver)
    nts = amg_s.levels[tail_entry(amg_s)].A.num_rows
    k5_case(torch, K, T, amg_s, data_s["precond"]["amg"], rhs(nb, nts),
            rhs(nb, nts), summary, "slab per-system 64^3", main=True)
    emit({"phase": "serving", "case": "SG64", "rows": small_n ** 3,
          "solo_iterations": r64.iterations, "solo_status": r64.status,
          "anchor": SERVE_ANCHOR_64,
          "slab_iterations": res_s.iterations.tolist(), "slab_solo": ref_s,
          "launches": c})
    del bss, data_s, s64
    torch.cuda.empty_cache()

    store = tempfile.mkdtemp(prefix=".serving-", dir=ROOT)
    try:
        serving_service(torch, amgx, dev, per_path, store, n, cold_n)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def serving_service(torch, amgx, dev, per_path, store, n, cold_n):
    """(SV), (SR), (SJ), (SC) of `phase_serving`, their stores under
    `store`."""
    from amgx_tpu_torch.batch import BatchedSolver
    from amgx_tpu_torch.ops import cuda_tail as T
    from amgx_tpu_torch.presets import SERVING_CG
    from amgx_tpu_torch.resilience import faultinject
    from amgx_tpu_torch.serving import SolveService
    from amgx_tpu_torch.telemetry import metrics as tm
    reqs = serving_requests(torch, amgx, dev, n, cold_n)
    names = ("amg.setup.full", "amg.resetup.value", "amg.resetup.structure",
             "serving.retrace", "serving.cache.hit", "serving.cache.miss")
    before = {k: tm.get(k) for k in names}
    plans0 = T.PLAN_BUILDS["multi"]
    svc = SolveService(serve_cfg(amgx, SERVING_CG, store), device=dev)

    def serve():
        svc.start()
        tickets = []
        t0 = time.perf_counter()
        for i, (M, b, dl, _, _) in enumerate(reqs):
            wait = t0 + i * SERVE_GAP_S - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            tickets.append(svc.submit(M, b, deadline_s=dl))
        # a dead scheduler fails the outstanding tickets (BREAKDOWN with
        # the error) instead of leaving them waiting
        svc.drain(timeout_s=600)
        wall = time.perf_counter() - t0
        svc.stop()
        errors = sorted({repr(t.error)[:300] for t in tickets
                         if t.error is not None})
        check(all(t.done for t in tickets) and not errors
              and svc._thread_error is None,
              f"serving (SV): {sum(t.done for t in tickets)} of "
              f"{len(tickets)} tickets done, errors {errors}, scheduler "
              f"{svc._thread_error!r}")
        return tickets, wall

    tickets, wall = run_path(amgx, per_path, "serving_service", serve)
    moved = {k: tm.get(k) - before[k] for k in names}
    plans = T.PLAN_BUILDS["multi"] - plans0
    c = per_path["serving_service"]
    hot = [t for t, r in zip(tickets, reqs) if r[3] == "hot"]
    dl = [t for t, r in zip(tickets, reqs) if r[2] is not None]
    check(all(t.result.status == "deadline_exceeded" for t in dl),
          f"serving (SV): deadline tickets {[t.result.status for t in dl]}")
    check(moved["amg.setup.full"] == 2, f"serving (SV): {moved}")
    admitted_hot = sum(1 for t, r in zip(tickets, reqs)
                       if r[3] == "hot" and r[2] is None)
    check(moved["amg.resetup.value"] >= admitted_hot
          and moved["amg.resetup.structure"] == 0,
          f"serving (SV): {admitted_hot} hot admits, resetups {moved}")
    check(plans == 2, f"serving (SV): {plans} K5 card plans for two "
          f"buckets")
    check(tail_launches(c)[1] == 0 and c["dia_coarse_tail_mf_multi"] > 0,
          f"serving (SV): tail launches {c}")
    engines = [svc.buckets.peek(k) for k in svc.buckets.keys()]
    # one host read an engine step (a bucket admitted directly)
    heng = svc.buckets.peek(hot[0].fingerprint)
    M, b = reqs[1][0], reqs[1][1]
    heng.admit(0, M, b)
    heng.step()
    sites = sync_sites(torch, heng.step)
    check(len(sites) == 1, f"serving (SV): {len(sites)} host reads in one "
          f"step, at {sites}")
    heng.finalize([0])
    heng.release(0)
    # every other ticket: its system's solve_many at the bucket's width
    served = [(t, r) for t, r in zip(tickets, reqs) if r[2] is None]
    for pat in ("hot", "cold"):
        group = [(t, r) for t, r in served if r[3] == pat]
        ref = BatchedSolver(amgx.Config.from_string(SERVING_CG), device=dev)
        ref.setup(group[0][1][0].with_values(group[0][1][0].values * 1))
        for k in range(0, len(group), SERVE_SLOTS):
            part = group[k:k + SERVE_SLOTS]
            part = part + [part[-1]] * (SERVE_SLOTS - len(part))
            res = ref.solve_many(torch.stack([r[1] for _, r in part]),
                                 matrices=[r[0] for _, r in part])
            for s, (t, r) in enumerate(part):
                check(t.result.status == _status(res, s)
                      and t.result.iterations == int(res.iterations[s]),
                      f"serving (SV) request {r[4]}: {t.result.status} in "
                      f"{t.result.iterations}, solve_many "
                      f"{_status(res, s)} in {int(res.iterations[s])}")
        del ref
    lat = sorted(t.latency_s for t, _ in served)
    emit({"phase": "serving", "case": "SV", "rows": [n ** 3, cold_n ** 3],
          "requests": len(reqs), "slots": SERVE_SLOTS,
          "chunk": SERVE_CHUNK, "gap_s": SERVE_GAP_S,
          "statuses": [t.result.status for t in tickets],
          "iterations": [t.result.iterations for t in tickets],
          "solves_per_s": len(served) / wall, "wall_s": wall,
          "latency_p50_s": float(np.percentile(lat, 50)),
          "latency_p99_s": float(np.percentile(lat, 99)),
          "counters": moved, "card_plans": plans,
          "engine_steps": [e.host_reads for e in engines],
          "build_s": [e.build_time for e in engines], "launches": c})
    # (SR) a second process on the same stores
    x_path = os.path.join(store, "restart_x.npy")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--serving-restart",
         store, x_path, str(n), str(cold_n), "1", str(dev)],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"serving (SR) process: {proc.stderr[-2000:]}")
    sr = json.loads(proc.stdout.strip().splitlines()[-1])
    x_sr = torch.from_numpy(np.load(x_path)).to(dev)
    first = tickets[1]
    gain = sr["store_gain"]
    check(sr["counters"]["amg.setup.full"] == 0
          and sr["counters"]["serving.retrace"] == 0
          and sr["kernel_builds"] == [] and sr["aot_warm"]
          and sr["hier_restored"]
          and torch.equal(x_sr, first.result.x)
          and sr["iterations"] == first.result.iterations
          and gain["without_store"]["counters"]["serving.retrace"] == 1
          and gain["with_store"]["counters"]["serving.retrace"] == 0
          and all(g["x_equal"] for g in gain.values()),
          f"serving (SR): {sr}, x equal "
          f"{torch.equal(x_sr, first.result.x)}")
    emit({"phase": "serving", "case": "SR", **sr})
    x_first, it_first = first.result.x, first.result.iterations
    del svc, tickets, served, engines, heng, first
    torch.cuda.empty_cache()
    # (SJ) journal resume and (SC) step_crash, on hot request 3 (A
    # itself, the slowest of the shifts)
    M, b = reqs[3][0], reqs[3][1]
    jcfg = serve_cfg(amgx, SERVING_CG, None,
                     f", serving_journal_dir={store}/journal,"
                     f" serving_checkpoint_cycles=1")
    ref = SolveService(serve_cfg(amgx, SERVING_CG, None), device=dev)
    rt = ref.submit(M, b)
    # request 1 again, its bucket built inline: the bits of the (SV)
    # bucket the builder thread built
    r1 = ref.submit(reqs[1][0], reqs[1][1])
    ref.drain(timeout_s=600)
    check(torch.equal(r1.result.x, x_first)
          and r1.result.iterations == it_first,
          "serving: the builder thread's bucket and an inline build "
          "differ")
    del ref, r1
    victim = SolveService(jcfg, device=dev)
    vt = victim.submit(M, b)
    for _ in range(3):
        victim.step()
    check(not vt.done, "serving (SJ): finished before the drop")
    del victim, vt
    torch.cuda.empty_cache()
    res0 = tm.get("serving.recovery.resumed")
    # serving_recover=1 (the default): the journal replays here
    succ = SolveService(jcfg, device=dev)
    done = succ.drain(timeout_s=600)
    resumed = tm.get("serving.recovery.resumed") - res0
    check(len(done) == 1 and resumed == 1
          and done[0].result.iterations == rt.result.iterations
          and torch.equal(done[0].result.x.to(dev), rt.result.x),
          f"serving (SJ): {len(done)} replayed, {resumed} resumed, "
          f"iterations {[d.result.iterations for d in done]} against "
          f"{rt.result.iterations}")
    del succ, done
    torch.cuda.empty_cache()
    svc = SolveService(serve_cfg(amgx, SERVING_CG, None), device=dev)
    q0 = tm.get("serving.recovery.quarantined")
    t = svc.submit(M, b)
    svc.step()
    with faultinject.inject("step_crash", fires=1):
        svc.step()
    quarantined = tm.get("serving.recovery.quarantined") - q0
    svc.drain(timeout_s=600)
    check(quarantined == 1 and t.result.iterations == rt.result.iterations
          and torch.equal(t.result.x, rt.result.x),
          f"serving (SC): {quarantined} quarantined, {t.result.iterations} "
          f"iterations against {rt.result.iterations}")
    emit({"phase": "serving", "case": "SJ+SC", "iterations":
          rt.result.iterations, "status": rt.result.status,
          "journal_resumed": resumed, "quarantined": quarantined})


# the eigensolvers (phase_eigen): a 7-pt Poisson box of about the
# flagship's rows with three distinct sides (a cube's repeated
# eigenvalues defeat single-vector Krylov), in float32
EIG_BOX = (128, 120, 112)            # 1,720,320 rows
PAGERANK_N = 1_000_000
PAGERANK_SEED = 23
PAGERANK_DANGLING = 0.05             # share of nodes without out-links


def box_eigenvalues(shape):
    """The spectrum of the gallery's 7-point operator (6 on the
    diagonal, -1 to each neighbour, Dirichlet boundary) on a box, in
    ascending order: lambda = sum_d (2 - 2 cos(k_d pi / (n_d + 1)))."""
    lam = np.zeros(1)
    for n in shape:
        per = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
        lam = np.add.outer(per, lam).ravel()
    return np.sort(lam)


def pagerank_graph(n, seed=PAGERANK_SEED, dangling=PAGERANK_DANGLING):
    """A seeded directed graph on n nodes as (rows, cols) link arrays:
    out-degrees 1-20, a `dangling` share of nodes with none, targets
    uniform (repeated links sum into one heavier link)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 21, n)
    deg[rng.random(n) < dangling] = 0
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    return rows, cols


def pagerank_reference(rows, cols, n, damping, tol=1e-13, max_iters=1000,
                       v=None):
    """The PageRank vector of the graph in float64 with scipy on the
    host: the Google-matrix power iteration to an L1 step below `tol`
    (the same operator as PageRankOperator: out-degree normalisation,
    dangling nodes and teleport spread uniformly). With `v`, also the
    L1 residual ||G v - v||_1 of v scaled to sum 1: (pi, residual)."""
    import scipy.sparse as sp
    A = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
    deg = np.asarray(A.sum(axis=1)).ravel()
    Ht = (sp.diags(np.where(deg > 0, 1.0 / np.maximum(deg, 1e-300), 0.0))
          @ A).T.tocsr()
    a = damping * (deg == 0) + (1.0 - damping)
    pi = np.full(n, 1.0 / n)
    for _ in range(max_iters):
        y = damping * (Ht @ pi) + (a @ pi) / n
        y /= y.sum()
        step = np.abs(y - pi).sum()
        pi = y
        if step < tol:
            break
    if v is None:
        return pi
    v = v / v.sum()
    return pi, float(np.abs(damping * (Ht @ v) + (a @ v) / n - v).sum())


# the fleet (phase_fleet): two SERVING_CG replicas sharing one card
FLEET_REQUESTS = 12
FLEET_GAP_S = 0.002          # open-loop spacing, as SV
FLEET_KILL_REQUESTS = 4      # the kill drill's requests (journaled)


def fleet_requests(torch, amgx, dev, n, cold_n, count):
    """(matrix, rhs) a request, alternating the n^3 and cold_n^3
    patterns; system i is A + serve_shift(i) I with a rhs from
    default_rng(SERVE_SEED + 2)."""
    pats = [amgx.gallery.poisson("7pt", m, m, m, dtype=torch.float32,
                                 device=dev).init() for m in (n, cold_n)]
    rng = np.random.default_rng(SERVE_SEED + 2)
    shifted, out = {}, []
    for i in range(count):
        key = (i % 2, i % 3)
        if key not in shifted:
            shifted[key] = diag_shifted(torch, pats[i % 2],
                                        [serve_shift(i)])[0]
        b = torch.from_numpy(rng.standard_normal(
            pats[i % 2].num_rows).astype(np.float32)).to(dev)
        out.append((shifted[key], b))
    return out


def fleet_check_x(label, tickets, xs):
    check(all(t.done and t.result.converged for t in tickets),
          f"fleet ({label}): {[(t.done, t.result and t.result.status) for t in tickets]}")
    same = [bool(t.result.x.equal(x)) for t, x in zip(tickets, xs)]
    check(all(same), f"fleet ({label}): x bit-identical to the unfaulted "
          f"run: {same}")


def phase_fleet(torch, amgx, dev, per_path, n=SERVE_N, cold_n=SERVE_COLD_N):
    """FleetRouter over two SERVING_CG replicas on one card (float32,
    7-pt 128^3 and 130^3: SV's two fingerprints), SERVE_SLOTS slots,
    SERVE_CHUNK iterations a cycle.
    (FA) FLEET_REQUESTS open-loop requests FLEET_GAP_S apart on both
    replicas' background schedulers: every ticket converges, every
    repeat of a fingerprint routes warm to its home (2 cold, the rest
    warm, no spill), the two homes differ; route counts, latency p50 /
    p99, the fleet's K2-mf and K5 launches; then one request a replica
    driven inline under torch.profiler (device ops, host reads, idle
    share per ticket iteration). Its x are the unfaulted reference of
    the drills below.
    (FK) a journaled fleet (checkpoints every cycle), driven inline:
    FLEET_KILL_REQUESTS requests, cycles until the victim (request 0's
    home) has tickets in flight and one more, then replica_kill on it:
    no ticket lost, x bit-identical to (FA), the victim DOWN, its
    journal settled (nothing pending), its unfinished tickets requeued
    on the survivor.
    (FD) a rolling restart on (FA)'s fleet: drain_replica on request 0's
    home (its fingerprint spills to the other replica, which builds it
    cold), then restore_replica (the next request routes warm home
    again); x bit-identical.
    (FS) with fleet_spill_depth 1, a second request behind a queued one
    spills with its fleet.handoff note; x bit-identical."""
    import shutil
    import tempfile
    from amgx_tpu_torch.presets import SERVING_CG
    from amgx_tpu_torch.resilience import faultinject
    from amgx_tpu_torch.serving import FleetRouter
    from amgx_tpu_torch.telemetry import flightrec
    from amgx_tpu_torch.telemetry import metrics as tm
    reqs = fleet_requests(torch, amgx, dev, n, cold_n, FLEET_REQUESTS)
    names = ("amg.setup.full", "amg.resetup.value", "fleet.route.warm",
             "fleet.route.cold", "fleet.route.spill",
             "fleet.health.requeued", "fleet.health.adopted",
             "fleet.health.dead", "fleet.health.down",
             "fleet.health.drains", "fleet.health.restores")
    store = tempfile.mkdtemp(prefix=".fleet-", dir=ROOT)
    try:
        # (FA)
        before = {k: tm.get(k) for k in names}
        fa = FleetRouter.build(serve_cfg(amgx, SERVING_CG, None), 2,
                               device=dev)

        def serve():
            fa.start()
            tickets = []
            t0 = time.perf_counter()
            for i, (M, b) in enumerate(reqs):
                wait = t0 + i * FLEET_GAP_S - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                tickets.append(fa.submit(M, b))
            fa.drain(timeout_s=600)
            wall = time.perf_counter() - t0
            fa.stop()
            return tickets, wall

        tickets, wall = run_path(amgx, per_path, "fleet", serve)
        moved = {k: tm.get(k) - before[k] for k in names}
        errors = sorted({repr(t.error)[:300] for t in tickets
                         if t.error is not None})
        check(all(t.done and t.result.converged for t in tickets)
              and not errors and all(s._thread_error is None
                                     for s in fa.replicas.values()),
              f"fleet (FA): {[t.result and t.result.status for t in tickets]}"
              f", errors {errors}")
        homes = {}
        for t in tickets:
            homes.setdefault(t.fingerprint, t.replica)
        sticky = all(t.replica == homes[t.fingerprint] for t in tickets)
        routes = fa.stats()["routes"]
        tot = {k: sum(c[k] for c in routes.values())
               for k in ("cold", "warm", "spill")}
        check(sticky and len(set(homes.values())) == 2
              and tot == {"cold": 2, "warm": len(reqs) - 2, "spill": 0},
              f"fleet (FA): homes {homes}, routes {routes}")
        c = per_path["fleet"]
        k2 = c["dia_step_mf_multi"] + c["dia_step_multi"]
        k5 = tail_launches(c)[0]
        check(k2 > 0 and k5 > 0 and tail_launches(c)[1] == 0,
              f"fleet (FA): K2 {k2}, K5 {k5} launches, {c}")
        lat = sorted(t.latency_s for t in tickets)
        x_ref = [t.result.x for t in tickets]
        # one request a replica, driven inline under the profiler: device
        # ops and host reads per iteration of the two tickets together
        prof_ts = []

        def two():
            prof_ts.extend(fa.submit(M, b) for M, b in reqs[:2])
            fa.drain(timeout_s=600)

        prof = batch_profile(torch, two, 1)
        its = sum(t.result.iterations for t in prof_ts)
        prof = {"ticket_iterations": its, "wall_s": prof["wall_s"],
                "device_busy_s": prof["device_busy_s"],
                "idle_share": prof["idle_share"],
                "device_ops_per_iteration": prof["device_ops"] / its,
                "dtoh_per_iteration": prof["dtoh_per_iteration"] / its}
        emit({"phase": "fleet", "case": "FA", "rows": [n ** 3, cold_n ** 3],
              "replicas": 2, "requests": len(reqs), "slots": SERVE_SLOTS,
              "chunk": SERVE_CHUNK, "homes": sorted(homes.values()),
              "routes": routes, "wall_s": wall,
              "solves_per_s": len(reqs) / wall,
              "latency_p50_s": float(np.percentile(lat, 50)),
              "latency_p99_s": float(np.percentile(lat, 99)),
              "iterations": [t.result.iterations for t in tickets],
              "counters": moved, "k2_launches": k2, "k5_launches": k5,
              "profile": prof, "launches": c})
        # (FK) kill failover, inline
        before = {k: tm.get(k) for k in names}
        kf = FleetRouter.build(serve_cfg(
            amgx, SERVING_CG, None, f", serving_journal_dir={store}/fk,"
            " serving_checkpoint_cycles=1"), 2, device=dev)
        sub = reqs[:FLEET_KILL_REQUESTS]
        kts = [kf.submit(M, b) for M, b in sub]
        victim = kts[0].replica
        on_victim = sum(t.replica == victim for t in kts)
        # step until the victim's tickets are in flight, then one cycle
        # more (a checkpoint of their progress)
        for _ in range(8):
            kf.step()
            inflight = sum(1 for t in kts if t.replica == victim
                           and not t.done and t.admit_t is not None)
            if inflight:
                kf.step()
                break
        pending = [t for t in kts if t.replica == victim and not t.done]
        seq0 = flightrec.last_seq()
        t0 = time.perf_counter()
        with faultinject.inject("replica_kill", fires=1, target=victim):
            run_path(amgx, per_path, "fleet_failover",
                     lambda: kf.drain(timeout_s=600))
        fk_s = time.perf_counter() - t0
        fleet_check_x("FK", kts, x_ref)
        moved = {k: tm.get(k) - before[k] for k in names}
        hs = kf.health_snapshot()
        fo = flightrec.events(kind="fleet.failover", since_seq=seq0)
        check(hs[victim]["down"] and inflight > 0 and pending
              and all(t.replica != victim for t in pending)
              and kf.replicas[victim].journal.pending() == []
              and moved["fleet.health.requeued"] == len(pending)
              and moved["fleet.health.dead"] == 1 and len(fo) == 1,
              f"fleet (FK): victim {victim} ({on_victim} tickets, "
              f"{len(pending)} pending at the kill), health {hs[victim]}, "
              f"{moved}, "
              f"failover {fo}")
        emit({"phase": "fleet", "case": "FK", "victim": victim,
              "victim_tickets": on_victim, "victim_pending": len(pending),
              "replicas": [t.replica for t in kts],
              "iterations": [t.result.iterations for t in kts],
              "failover": fo[0], "counters": moved, "drain_s": fk_s,
              "launches": per_path["fleet_failover"]})
        del kf, kts
        # (FD) rolling restart on (FA)'s fleet, inline
        before = {k: tm.get(k) for k in names}
        home0 = tickets[0].replica
        queued_moved = fa.drain_replica(home0)
        dts = [fa.submit(M, b) for M, b in reqs[:2]]
        fa.drain(timeout_s=600)
        fleet_check_x("FD drained", dts, x_ref[:2])
        check(all(t.replica != home0 for t in dts)
              and dts[0].route == "spill",
              f"fleet (FD): {[(t.replica, t.route) for t in dts]} with "
              f"{home0} draining")
        fa.restore_replica(home0)
        rt = fa.submit(*reqs[2])
        fa.drain(timeout_s=600)
        fleet_check_x("FD restored", [rt], [x_ref[2]])
        check(rt.replica == home0 and rt.route == "warm",
              f"fleet (FD): after restore {rt.replica} {rt.route}")
        # (FS) a load spill
        fa.spill_depth = 1
        seq0 = flightrec.last_seq()
        sts = [fa.submit(*reqs[4]), fa.submit(*reqs[4])]
        fa.drain(timeout_s=600)
        fleet_check_x("FS", sts, [x_ref[4]] * 2)
        ho = flightrec.events(kind="fleet.handoff", since_seq=seq0)
        check([t.route for t in sts] == ["warm", "spill"] and len(ho) == 1
              and ho[0]["reason"] == "overload",
              f"fleet (FS): routes {[t.route for t in sts]}, handoffs {ho}")
        moved = {k: tm.get(k) - before[k] for k in names}
        emit({"phase": "fleet", "case": "FD+FS", "drained": home0,
              "queued_moved": queued_moved,
              "drained_routes": [(t.replica, t.route) for t in dts],
              "restored_route": [rt.replica, rt.route],
              "spill": [(t.replica, t.route) for t in sts],
              "handoff": ho[0], "counters": moved,
              "health": fa.health_snapshot()})
    finally:
        shutil.rmtree(store, ignore_errors=True)


# the autotuner (phase_autotune): the JAX tests' mistuned BATCHED_CG
# (tests/test_autotune.py: an overdamped BLOCK_JACOBI smoother) at 96^3
# (128^3 until a depth cut made room for phase_item8, PERF.md section 6)
AUTOTUNE_N = 96
AUTOTUNE_SEED = 29
AUTOTUNE_MISTUNED = (", amg:smoother(sm2)=BLOCK_JACOBI, sm2:max_iters=1,"
                     " sm2:relaxation_factor=0.15,"
                     " serving_bucket_slots=2, serving_chunk_iters=8,"
                     " autotune=1, autotune_hot_requests=4,"
                     " autotune_hot_exec_share=0.0")
AUTOTUNE_BUDGET = 6          # autotune_shadow_budget's default


def autotune_cfg(amgx, store):
    from amgx_tpu_torch.presets import BATCHED_CG
    return amgx.Config.from_string(
        BATCHED_CG + AUTOTUNE_MISTUNED + (
            f", serving_hierarchy_dir={store}/hier,"
            f" serving_journal_dir={store}/journal" if store else ""))


def autotune_inputs(torch, amgx, dev, n):
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=torch.float32,
                             device=dev).init()
    rng = np.random.default_rng(AUTOTUNE_SEED)
    bs = [torch.from_numpy(rng.standard_normal(n ** 3).astype(
        np.float32)).to(dev) for _ in range(8)]
    return A, bs


def autotune_restart(argv):
    """The second autotune process: a new service on the first one's
    stores serves request 5 once. Prints one JSON line, writes x."""
    import torch
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.serving import SolveService
    from amgx_tpu_torch.telemetry import metrics as tm
    store, out, n = argv[0], argv[1], int(argv[2])
    dev = torch.device(argv[3])
    A, bs = autotune_inputs(torch, amgx, dev, n)
    names = ("amg.setup.full", "amg.setup.restored",
             "autotune.overlay.restored", "autotune.overlay.applied")
    before = {k: tm.get(k) for k in names}
    svc = SolveService(autotune_cfg(amgx, store), device=dev)
    t0 = time.perf_counter()
    t = svc.submit(A, bs[5])
    svc.drain(timeout_s=600)
    first_s = time.perf_counter() - t0
    np.save(out, t.result.x.cpu().numpy())
    rec = next(iter(svc.stats()["autotune"]["fingerprints"].values()))
    print(json.dumps({
        "counters": {k: tm.get(k) - before[k] for k in names},
        "status": t.result.status, "iterations": t.result.iterations,
        "first_request_s": first_s, "tuner": rec}), flush=True)
    return 0


def phase_autotune(torch, amgx, dev, per_path, n=AUTOTUNE_N):
    """The online autotuner on the JAX tests' mistuned config: BATCHED_CG
    with an overdamped BLOCK_JACOBI (relaxation 0.15), 7-pt n^3 float32,
    autotune=1 (hot after 4 requests), hierarchy store and journal.
    Five requests make the fingerprint hot (drain quiesces the tuner:
    no shadow runs there); idle scheduler cycles then run the search --
    the probe baseline and the candidates, each a setup and two solves
    on the card (the wall of the warm second one, read after
    torch.cuda.synchronize) -- and promote within the shadow budget;
    the next request builds with the overlay and takes fewer iterations
    than before (a second one profiled: device ops, host reads, idle
    share an iteration). A second process on the same stores serves that request
    from its first one with 0 full setups, the overlay restored from the
    hierarchy store, x bit-identical. Then a fresh tuned service with an
    armed shadow_crash: the shadow error is counted, every ticket
    completes as it would without it."""
    import shutil
    import tempfile
    from amgx_tpu_torch.resilience import faultinject
    from amgx_tpu_torch.serving import SolveService
    from amgx_tpu_torch.telemetry import flightrec
    from amgx_tpu_torch.telemetry import metrics as tm
    A, bs = autotune_inputs(torch, amgx, dev, n)
    names = ("autotune.hot", "autotune.shadow.runs", "autotune.shadow.errors",
             "autotune.candidates", "autotune.promotions",
             "autotune.overlay.applied", "amg.setup.full")
    store = tempfile.mkdtemp(prefix=".autotune-", dir=ROOT)
    try:
        before = {k: tm.get(k) for k in names}
        svc = SolveService(autotune_cfg(amgx, store), device=dev)

        def heat():
            tix = [svc.submit(A, b) for b in bs[:5]]
            svc.drain(timeout_s=600)
            return tix

        tix, heat_s = timed(torch, lambda: run_path(
            amgx, per_path, "autotune_serve", heat))
        pre = [t.result.iterations for t in tix]
        check(all(t.done for t in tix)
              and tm.get("autotune.shadow.runs")
              == before["autotune.shadow.runs"],
              f"autotune: heat {[t.result.status for t in tix]}, shadows "
              f"during drain")

        def search():
            for step in range(1, 17):
                svc.step()
                if svc.stats()["autotune"]["promoted"]:
                    return step
            return None

        steps, search_s = timed(torch, lambda: run_path(
            amgx, per_path, "autotune_shadow", search))
        snap = svc.stats()["autotune"]
        rec = next(iter(snap["fingerprints"].values()))
        shadows = tm.get("autotune.shadow.runs") \
            - before["autotune.shadow.runs"]
        check(snap["promoted"] == 1 and steps is not None
              and shadows <= AUTOTUNE_BUDGET,
              f"autotune: no promotion in {steps} steps, {shadows} "
              f"shadows: {rec}")
        trail = [e for e in flightrec.events()
                 if e["kind"] in ("autotune.shadow", "autotune.promote")]

        def tuned():
            t = svc.submit(A, bs[5])
            svc.drain(timeout_s=600)
            return t

        t1, tuned_s = timed(torch, lambda: run_path(
            amgx, per_path, "autotune_tuned", tuned))
        check(t1.result.converged and t1.result.iterations < min(pre),
              f"autotune: tuned {t1.result.status} in "
              f"{t1.result.iterations}, before {pre}")
        # a second tuned request under the profiler (its bucket warm)
        t2 = []

        def tuned2():
            t2.append(svc.submit(A, bs[7]))
            svc.drain(timeout_s=600)

        prof = batch_profile(torch, tuned2, 1)
        its = t2[0].result.iterations
        prof.update(iterations=its,
                    device_ops_per_iteration=prof["device_ops"] / its,
                    dtoh_per_iteration=prof["dtoh_per_iteration"] / its)
        moved = {k: tm.get(k) - before[k] for k in names}
        emit({"phase": "autotune", "case": "promote", "rows": n ** 3,
              "iterations_before": pre,
              "statuses_before": [t.result.status for t in tix],
              "iterations_tuned": t1.result.iterations,
              "status_tuned": t1.result.status, "search_steps": steps,
              "shadow_runs": shadows, "tuner": rec,
              "shadow_trail": trail[-(shadows + 1):],
              "heat_s": heat_s, "search_s": search_s, "tuned_s": tuned_s,
              "tuned_profile": prof, "counters": moved,
              "launches": {p: per_path[p] for p in (
                  "autotune_serve", "autotune_shadow", "autotune_tuned")}})
        x_path = os.path.join(store, "restart_x.npy")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--autotune-restart",
             store, x_path, str(n), str(dev)],
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"autotune restart process: {proc.stderr[-2000:]}")
        sr = json.loads(proc.stdout.strip().splitlines()[-1])
        x_sr = torch.from_numpy(np.load(x_path)).to(dev)
        check(sr["counters"]["amg.setup.full"] == 0
              and sr["counters"]["autotune.overlay.restored"] == 1
              and sr["iterations"] == t1.result.iterations
              and torch.equal(x_sr, t1.result.x),
              f"autotune restart: {sr}, x equal "
              f"{torch.equal(x_sr, t1.result.x)}")
        emit({"phase": "autotune", "case": "restart", **sr})
        del svc, tix, t1
        torch.cuda.empty_cache()
        # shadow_crash on a fresh tuned service
        err0 = tm.get("autotune.shadow.errors")
        svc = SolveService(autotune_cfg(amgx, None), device=dev)
        tix = [svc.submit(A, b) for b in bs[:5]]
        svc.drain(timeout_s=600)
        with faultinject.inject("shadow_crash", fires=1):
            svc.step()
        late = svc.submit(A, bs[6])
        svc.drain(timeout_s=600)
        errors = tm.get("autotune.shadow.errors") - err0
        crec = next(iter(svc.stats()["autotune"]["fingerprints"].values()))
        check(errors == 1 and crec["errors"] == 1
              and all(t.done and t.error is None for t in tix + [late])
              and [t.result.iterations for t in tix] == pre,
              f"autotune shadow_crash: {errors} errors, {crec}, tickets "
              f"{[(t.result.status, t.result.iterations) for t in tix]}")
        emit({"phase": "autotune", "case": "shadow_crash",
              "shadow_errors": errors, "tuner": crec,
              "late_iterations": late.result.iterations,
              "late_status": late.result.status})
    finally:
        shutil.rmtree(store, ignore_errors=True)


# the eigensolvers (phase_eigen): the stock files, verbatim, in order
# Two of them stop, verbatim, short of eig_tolerance against the
# closed-form top of a 1.72 M-row box, as their algorithms must (the JAX
# package's are the same): ARNOLDI is one 20-step factorization with no
# restart (not converged), and SUBSPACE_ITERATION's residual test at
# 1e-2 passes on Ritz pairs of the dense cluster just below the top (a
# residual bounds the distance to SOME eigenvalue). Both are held to
# the bounds every run meets (EIG_NOT_AT_TOLERANCE); the rest also to
# eig_tolerance.
EIG_NOT_AT_TOLERANCE = ("ARNOLDI", "SUBSPACE_ITERATION")
EIG_FILES = ("POWER_ITERATION", "SUBSPACE_ITERATION", "LANCZOS", "ARNOLDI",
             "JACOBI_DAVIDSON", "LOBPCG", "INVERSE_FGMRES", "PAGERANK")
# the two with a nested solve at every outer step run on smaller boxes
# (three distinct sides still), set by the script's 1200 s limit:
# INVERSE_FGMRES applies 100 FGMRES iterations of the aggregation +
# MULTICOLOR_DILU cycle a step, LOBPCG 100 V-cycles of the default
# scope's CLASSICAL AMG a step, both launch-bound; and LOBPCG's
# iterations grow with the box, its preconditioner (an approximate
# inverse) damping the very components the largest eigenpair needs
# (1,000 iterations without converging at 24 x 20 x 16; 206 at
# 12 x 10 x 9, as the JAX package's float64 run there; 63 at 6 x 5 x 4,
# as its float32 and float64 runs). PERF.md has the times
EIG_CUT_BOX = {"LOBPCG": (6, 5, 4), "INVERSE_FGMRES": (6, 5, 4)}
# the profiled iterations (eigen_profile): INVERSE_FGMRES launches
# ~6 x 10^4 kernels an iteration at 8 x 7 x 6, and the profiler's
# records of a dozen take minutes to gather
EIG_PROFILE = {"INVERSE_FGMRES": (0, 1)}


def eigen_profile(torch, es, iterations=(2, 12)):
    """Device ops and device->host copies per iteration of an eigensolve
    under torch.profiler: two short solves of `iterations` (eig_max_iters
    cut, nothing else), the difference over the extra iterations (the
    set-up and finalize ops cancel); and the idle share of the longer
    solve (under the profiler's own host cost). Every stock file checks
    convergence each iteration, one host read, so a pair reading fewer
    copies than iterations lost records: it is taken again, up to three
    times, then reported as None."""
    for _ in range(3):
        row = _eigen_profile(torch, es, iterations)
        if row["dtoh_per_iteration"] >= 1.0:
            return row
    return {k: None for k in row}


def _eigen_profile(torch, es, iterations):
    from torch.profiler import ProfilerActivity, profile
    full = es.max_iters
    counts = []
    try:
        for it in iterations:
            es.max_iters = it
            es.solve()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = es.solve()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ops = dtoh = 0
            busy = 0.0
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                busy += ev.time_range.elapsed_us()
                if "Memcpy DtoH" in ev.name:
                    dtoh += 1
                elif not ev.name.startswith(("Memcpy", "Memset")):
                    ops += 1
            counts.append((res.iterations, ops, dtoh, wall, busy * 1e-6))
    finally:
        es.max_iters = full
    (i0, o0, d0, w0, b0), (i1, o1, d1, w1, b1) = counts
    di = max(i1 - i0, 1)
    return {"device_ops_per_iteration": (o1 - o0) / di,
            "dtoh_per_iteration": (d1 - d0) / di,
            "profiled_idle_share": 1.0 - b1 / w1}


def phase_eigen(torch, amgx, dev, per_path):
    """The eight configs/eigen_configs files, verbatim, on the card in
    float32. POWER_ITERATION, SUBSPACE_ITERATION, LANCZOS, ARNOLDI and
    JACOBI_DAVIDSON on the 7-pt Poisson EIG_BOX (three distinct sides);
    LOBPCG and INVERSE_FGMRES on EIG_CUT_BOX. Each eigenvalue is held to
    the box's closed-form Dirichlet spectrum (`box_eigenvalues`): every
    returned value within its own residual (+ float32 rounding) of an
    exact eigenvalue (a symmetric operator's bound), none past the exact
    value it approximates (interlacing; not INVERSE_FGMRES, whose
    operator is an approximate inverse), and, but for
    EIG_NOT_AT_TOLERANCE, converged within eig_tolerance (relative) of
    the wanted end of the spectrum.
    PAGERANK on a seeded directed graph of PAGERANK_N nodes (out-degrees
    1-20, PAGERANK_DANGLING of them with none): eigenvalue 1 to
    eig_tolerance, and the vector within eig_tolerance (L1) of scipy's
    float64 PageRank and within the bound its own L1 residual gives
    (||G v - v||_1 / (1 - damping)). Each: iterations, seconds, the device ops and host reads
    an iteration (`eigen_profile`) and the B1 / B8 launches."""
    from amgx_tpu_torch.eigen import create_eigensolver
    boxes = {}
    for name in EIG_FILES:
        cfg = amgx.Config.from_file(
            os.path.join(ROOT, "configs", "eigen_configs", name))
        tol = float(cfg.get("eig_tolerance", "default"))
        if name == "PAGERANK":
            rows, cols = pagerank_graph(PAGERANK_N)
            M = amgx.CsrMatrix.from_coo(
                torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
                torch.ones(rows.size, dtype=torch.float32, device=dev),
                PAGERANK_N, PAGERANK_N)
            box = None
        else:
            box = EIG_CUT_BOX.get(name, EIG_BOX)
            if box not in boxes:
                boxes[box] = amgx.gallery.poisson(
                    "7pt", *box, dtype=torch.float32, device=dev).init()
            M = boxes[box]

        def run():
            es = create_eigensolver(cfg, device=dev)
            es.setup(M)
            return es, es.solve()

        (es, res), secs = timed(torch, lambda: run_path(
            amgx, per_path, f"eigen_{name}", run))
        c = per_path[f"eigen_{name}"]
        lam = np.real(np.asarray(res.eigenvalues, dtype=np.float64))
        row = {"phase": "eigen", "config": name, "rows": M.num_rows,
               "box": box, "iterations": res.iterations,
               "converged": res.converged, "eigenvalues": lam.tolist(),
               "residuals": np.asarray(res.residuals).tolist(),
               "tolerance": tol, "seconds": secs,
               "setup_s": res.setup_time, "solve_s": res.solve_time,
               "solve_s_per_iteration": res.solve_time
               / max(res.iterations, 1),
               "b1_launches": c["dia_spmv"], "b8_launches": c["csr_spmv"],
               "launches": {k: v for k, v in c.items() if v}}
        if name != "ARNOLDI":
            row.update(eigen_profile(torch, es, EIG_PROFILE.get(
                name, (2, 12))))
        if name == "PAGERANK":
            v = res.eigenvectors[:, 0].double().cpu().numpy()
            pi, r1 = pagerank_reference(rows, cols, PAGERANK_N,
                                        es.damping, v=v)
            l1 = float(np.abs(v / v.sum() - pi).sum())
            # the Google matrix contracts by the damping factor in L1:
            # ||v - pi||_1 <= ||G v - v||_1 / (1 - damping)
            bound = r1 / (1.0 - es.damping) + 1e-6
            row.update(l1_to_reference=l1, l1_residual=r1, l1_bound=bound)
            check(res.converged and abs(lam[0] - 1.0) <= tol
                  and l1 <= bound and l1 <= tol
                  and c["csr_spmv"] >= res.iterations,
                  f"eigen PAGERANK: {row}")
        else:
            exact = box_eigenvalues(box)
            k = lam.size
            want = exact[:k] if es.which == "smallest" \
                else exact[::-1][:k]
            near = np.array([np.min(np.abs(exact - x)) for x in lam])
            resid = np.asarray(res.residuals, dtype=np.float64)
            if name == "INVERSE_FGMRES":
                # the residual is the inverse operator's (eigenvalue
                # 1 / lambda): it bounds lambda to resid x lambda^2
                resid = resid * lam ** 2
            slack = 1e-5 * np.abs(lam)          # float32 rounding
            rel = np.abs(np.sort(lam) - np.sort(want)) / np.abs(np.sort(want))
            # Rayleigh-Ritz values never pass the exact ones they
            # approximate (Cauchy interlacing): the i-th largest at most
            # the box's i-th largest, the smallest at least its smallest
            sign = 1.0 if es.which == "smallest" else -1.0
            order = np.sort(sign * lam) * sign
            inter = bool(np.all(sign * (order - want) >= -slack))
            row.update(exact=want.tolist(), rel_err=rel.tolist(),
                       nearest_exact_dist=near.tolist(), interlaced=inter,
                       meets_tolerance=bool(res.converged
                                            and np.all(rel <= tol)))
            spmv = c["dia_spmv"] + c["csr_spmv"]
            check(np.all(near <= resid + slack) and spmv > 0
                  and (inter or name == "INVERSE_FGMRES"),
                  f"eigen {name}: eigenvalues off the spectrum by more "
                  f"than their residuals, or past the exact ones: {row}")
            if name not in EIG_NOT_AT_TOLERANCE:
                check(row["meets_tolerance"], f"eigen {name}: {row}")
        emit(row)
        del es, res
        torch.cuda.empty_cache()


CAPI_N = 128                   # the flagship's grid through the C API (CA)
CAPI_SMALL_N = 64              # CB, CS, CF, CC
CAPI_MM_N = 32                 # the MatrixMarket round trip (CI)
CAPI_PAIRS = 10                # alternating warm solves, C API / direct
CAPI_EIG_BOX = (64, 60, 56)    # POWER_ITERATION (CE)
CAPI_PAGERANK_N = 100_000      # PAGERANK (CE)
CAPI_DILU = ("solver=PCG, max_iters=200, monitor_residual=1,"
             " tolerance=1e-6, convergence=RELATIVE_INI, norm=L2,"
             " preconditioner(p)=MULTICOLOR_DILU, p:max_iters=1")


def capi_caller(capi, calls):
    """call(name, *args): the C API function `name`, its RC held to OK
    (a failure raises with the call's name and exception text); returns
    what follows the RC (None, one value or a tuple). `calls` counts the
    calls by name."""
    def call(name, *args, **kw):
        out = getattr(capi, name)(*args, **kw)
        rc = out if isinstance(out, capi.RC) else out[0]
        calls[name] = calls.get(name, 0) + 1
        check(rc == capi.RC.OK, f"C API {name} returned {rc!r}: "
                                f"{capi.last_error()}")
        if isinstance(out, capi.RC):
            return None
        return out[1] if len(out) == 2 else out[1:]
    return call


def profile_call(torch, fn):
    """(fn(), its profile): fn() once under torch.profiler (device
    activity only, one stream): wall, the device's busy time (kernel and
    copy durations), idle share, device ops, device->host and
    host->device copies."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, ops, dtoh, htod = 0.0, 0, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += ev.time_range.elapsed_us()
        if "Memcpy DtoH" in ev.name:
            dtoh += 1
        elif "Memcpy HtoD" in ev.name:
            htod += 1
        elif not ev.name.startswith(("Memcpy", "Memset")):
            ops += 1
    return out, {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
                 "idle_share": 1.0 - busy_us * 1e-6 / wall,
                 "device_ops": ops, "dtoh": dtoh, "htod": htod}


def red_black(shape):
    """The red-black coloring of a grid's rows (x fastest): (x + y + z)
    mod 2, a valid coloring of the 7-point stencil."""
    nx, ny, nz = shape
    i = np.arange(nx * ny * nz)
    return ((i % nx + (i // nx) % ny + i // (nx * ny)) % 2).astype(np.int32)


def phase_capi(torch, amgx, dev, per_path, printed):
    """The AmgX C API (amgx_tpu_torch/capi.py) on the card, every call's
    RC held to OK (`capi_caller`), each path against its direct twin:
    (CA) the amgx_capi.c sequence on FLAGSHIP at 128^3 in dDDI:
    AMGX_generate_distributed_poisson_7pt, setup, a zero-guess solve,
    status, iterations, residual history, download and
    AMGX_solver_calculate_residual_norm: 2 outer / 31 inner, a true
    relative residual below 1e-10, x bit-identical to
    create_solver(FLAGSHIP)'s on the same A and b, every kernel launched
    as often as in the direct solve; warm walls in alternating pairs (the
    C API's solve alone and with b's upload and x's download, against
    the direct solve), a profile of each (device ops, idle share, copies
    an inner iteration: the C API adds no host read to the solve).
    (CI) the same system written in binary (io.write_system), read back
    with AMGX_read_system, AMGX_matrix_attach_geometry, setup and solve:
    x bit-identical to CA's; a 32^3 MatrixMarket round trip through
    AMGX_write_system / AMGX_read_system to equal arrays;
    examples/matrix.mtx with configs/FGMRES_AGGREGATION.json to success.
    (CT) AMGX_matrix_vector_multiply = spmv bit for bit,
    AMGX_matrix_download_all round-trips through AMGX_matrix_upload_all,
    the setup with amg:convergence_analysis=2 prints the per-level report
    (every ratio below 1), AMGX_matrix_replace_coefficients with D A D
    values (`scaled_values`) + AMGX_solver_resetup + solve = the direct
    resetup's iterations and x. (CB) AMGX_vector_upload_batched /
    AMGX_solver_solve_batched on BATCHED_CG, 8 x 64^3 float32: the
    direct solve_many's statuses, iterations and x, bit for bit. (CS)
    AMGX_service_* on SERVING_CG, 4 requests at 64^3: each ticket's x =
    a direct SolveService's. (CF) AMGX_fleet_* with 2 replicas, 4
    requests on 64^3 and 64x64x62: each ticket's replica and x = a
    direct FleetRouter's, AMGX_fleet_health. (CE) AMGX_eigensolver_*:
    POWER_ITERATION on 64 x 60 x 56 and PAGERANK on 10^5 nodes, the
    direct eigensolver's eigenvalues and iterations. (CC) PCG +
    MULTICOLOR_DILU at 64^3 with a red-black coloring attached through
    AMGX_matrix_attach_coloring = the same coloring set on the
    CsrMatrix directly: the iterations and x. A block upload returns
    BAD_PARAMETERS and the setup after it launches nothing."""
    import tempfile
    from amgx_tpu_torch import capi
    from amgx_tpu_torch.eigen import create_eigensolver
    from amgx_tpu_torch.ops.spmv import residual, spmv
    from amgx_tpu_torch.presets import BATCHED_CG, FLAGSHIP, SERVING_CG
    from amgx_tpu_torch.serving import FleetRouter, SolveService
    calls = {}
    call = capi_caller(capi, calls)
    n = CAPI_N
    rows = n ** 3
    call("AMGX_initialize")
    cfg_text = FLAGSHIP + ", store_res_history=1"
    cfg = call("AMGX_config_create", cfg_text)
    rs = call("AMGX_resources_create_simple", cfg)
    A, b, x = (call(f"AMGX_{k}_create", rs, "dDDI")
               for k in ("matrix", "vector", "vector"))
    slv = call("AMGX_solver_create", rs, "dDDI", cfg)

    # -- (CA) ----------------------------------------------------------------
    def ca():
        call("AMGX_generate_distributed_poisson_7pt", A, b, x, 1, 1, n, n, n)
        call("AMGX_solver_setup", slv, A)
        call("AMGX_solver_solve_with_0_initial_guess", slv, b, x)
    _, ca_s = timed(torch, lambda: run_path(amgx, per_path, "CA", ca))
    status = call("AMGX_solver_get_status", slv)
    outer = call("AMGX_solver_get_iterations_number", slv)
    hist = [call("AMGX_solver_get_iteration_residual", slv, i)
            for i in range(outer + 1)]
    x_ca = call("AMGX_vector_download", x)
    norm = call("AMGX_solver_calculate_residual_norm", slv, A, b, x)
    inner = int(capi._get(slv).result.extra_stats["inner_iters"])
    A_ca = capi._get(A).A
    amgx.reset_kernel_launches()
    direct = amgx.create_solver(amgx.Config.from_string(cfg_text),
                                device=dev)
    A_dir = amgx.gallery.poisson("7pt", n, n, n, device=dev)
    b_dir = torch.ones(rows, dtype=torch.float64, device=dev)
    direct.setup(A_dir)
    r_dir = direct.solve(b_dir)
    direct_counts = amgx.kernel_launches()
    x_dir = r_dir.x.cpu().numpy()
    true_rel = float(torch.linalg.norm(residual(
        A_ca, torch.from_numpy(x_ca).to(dev), b_dir))
        / torch.linalg.norm(b_dir))
    b_host = np.ones(rows)

    def capi_solve():
        call("AMGX_solver_solve_with_0_initial_guess", slv, b, x)

    def capi_round():
        call("AMGX_vector_upload", b, rows, 1, b_host)
        capi_solve()
        return call("AMGX_vector_download", x)

    turns = {"capi_round": capi_round, "capi_solve": capi_solve,
             "direct": lambda: direct.solve(b_dir)}
    walls = {k: [] for k in turns}
    for i in range(CAPI_PAIRS):
        for k in (list(turns) if i % 2 == 0 else list(turns)[::-1]):
            walls[k].append(timed(torch, turns[k])[1])
    warm = {k: {"median": float(np.median(v)), "all": v}
            for k, v in walls.items()}
    # a profile can lose device records (fewer ops than launched): the
    # fullest of three is kept; host reads are counted apart, by sync
    # debug mode, which loses none
    prof, syncs = {}, {}
    for k, f in turns.items():
        prof[k] = max((profile_call(torch, f)[1] for _ in range(3)),
                      key=lambda p: p["device_ops"])
        prof[k].update(device_ops_per_iteration=prof[k]["device_ops"] / inner,
                       dtoh_per_iteration=prof[k]["dtoh"] / inner)
        syncs[k] = count_syncs(torch, f)[1]
    row = {"phase": "capi", "path": "CA", "rows": rows, "seconds": ca_s,
           "status": status, "outer_iterations": outer,
           "inner_iterations": inner,
           "direct_iterations": [r_dir.iterations,
                                 int(r_dir.extra_stats["inner_iters"])],
           "res_history": hist, "residual_norm": norm.tolist(),
           "true_rel_res": true_rel,
           "x_bit_identical": bool(np.array_equal(x_ca, x_dir)),
           "launches": per_path["CA"], "direct_launches": direct_counts,
           "warm_s": warm, "profile": prof, "host_syncs": syncs,
           "capi_minus_direct_round_ms":
               1e3 * (warm["capi_round"]["median"]
                      - warm["direct"]["median"]),
           "capi_minus_direct_solve_ms":
               1e3 * (warm["capi_solve"]["median"]
                      - warm["direct"]["median"])}
    emit(row)
    check(status == 0 and [outer, inner] == [2, 31] and true_rel < 1e-10,
          f"capi CA: 2 outer / 31 inner to below 1e-10: {row}")
    check(row["x_bit_identical"] and row["direct_iterations"] == [2, 31],
          "capi CA: x bit-identical to the direct FLAGSHIP solve")
    check(per_path["CA"] == direct_counts
          and all(per_path["CA"][k] > 0 for k in (
              "dia_spmv", "dia_smooth_restrict_mf", "dia_prolong_smooth_mf",
              "dia_coarse_tail_mf")),
          f"capi CA: the direct solve's launches: {per_path['CA']} vs "
          f"{direct_counts}")
    check(syncs["capi_solve"] == syncs["direct"],
          f"capi CA: the C API's solve reads the host as often as the "
          f"direct one: {syncs}")

    # -- (CI) ----------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.bin")

        def ci():
            amgx.io.write_system(path, A_ca, b=capi._get(b).v, fmt="binary")
            Ai, bi, xi = (call(f"AMGX_{k}_create", rs, "dDDI")
                          for k in ("matrix", "vector", "vector"))
            call("AMGX_read_system", Ai, bi, xi, path)
            i = np.arange(rows)
            call("AMGX_matrix_attach_geometry", Ai, i % n, (i // n) % n,
                 i // (n * n))
            si = call("AMGX_solver_create", rs, "dDDI", cfg)
            call("AMGX_solver_setup", si, Ai)
            call("AMGX_solver_solve", si, bi, xi)
            out = call("AMGX_vector_download", xi), os.path.getsize(path)
            for h, k in ((si, "solver"), (xi, "vector"), (bi, "vector"),
                         (Ai, "matrix")):
                call(f"AMGX_{k}_destroy", h)
            return out
        (x_ci, size), ci_s = timed(torch, lambda: run_path(
            amgx, per_path, "CI", ci))
        mm = os.path.join(tmp, "small.mtx")
        m = CAPI_MM_N
        Am, bm, Am2, bm2, xm2 = (
            call(f"AMGX_{k}_create", rs, "dDDI")
            for k in ("matrix", "vector", "matrix", "vector", "vector"))
        call("AMGX_generate_distributed_poisson_7pt", Am, None, None, 1, 1,
             m, m, m)
        bvals = np.random.default_rng(7).standard_normal(m ** 3)
        call("AMGX_vector_upload", bm, m ** 3, 1, bvals)
        _, mm_write_s = timed(torch, lambda: call(
            "AMGX_write_system", Am, bm, None, mm))
        _, mm_read_s = timed(torch, lambda: call(
            "AMGX_read_system", Am2, bm2, xm2, mm))
        arrs = [call("AMGX_matrix_download_all", h)[:3] for h in (Am, Am2)]
        mm_equal = all(np.array_equal(p, q) for p, q in zip(*arrs)) \
            and np.array_equal(call("AMGX_vector_download", bm2), bvals)
    cfg_ex = call("AMGX_config_create_from_file",
                  os.path.join(ROOT, "configs", "FGMRES_AGGREGATION.json"))
    Ae, be, xe = (call(f"AMGX_{k}_create", rs, "dDDI")
                  for k in ("matrix", "vector", "vector"))
    se = call("AMGX_solver_create", rs, "dDDI", cfg_ex)
    call("AMGX_read_system", Ae, be, xe,
         os.path.join(ROOT, "examples", "matrix.mtx"))
    call("AMGX_solver_setup", se, Ae)
    call("AMGX_solver_solve", se, be, xe)
    ex = [call("AMGX_solver_get_status", se),
          call("AMGX_solver_get_iterations_number", se)]
    row = {"phase": "capi", "path": "CI", "rows": rows, "seconds": ci_s,
           "binary_bytes": size,
           "x_bit_identical_to_CA": bool(np.array_equal(x_ci, x_ca)),
           "launches": per_path["CI"], "mm_rows": m ** 3,
           "mm_round_trip_equal": mm_equal, "mm_write_s": mm_write_s,
           "mm_read_s": mm_read_s, "example_status_iterations": ex}
    emit(row)
    check(row["x_bit_identical_to_CA"] and mm_equal and ex[0] == 0,
          f"capi CI: {row}")
    del Am, bm, Am2, bm2, xm2

    # -- (CT) ----------------------------------------------------------------
    y = call("AMGX_vector_create", rs, "dDDI")
    texts = []

    def capture(msg, length):
        texts.append(msg)
        printed.append(length)
    cfg_an = call("AMGX_config_create",
                  cfg_text + ", amg:convergence_analysis=2")
    s_an = call("AMGX_solver_create", rs, "dDDI", cfg_an)
    vals2 = scaled_values(A_ca.row_offsets.cpu(), A_ca.col_indices.cpu(),
                          A_ca.values.cpu())

    def ct():
        call("AMGX_matrix_vector_multiply", A, x, y)
        ro, ci, va = call("AMGX_matrix_download_all", A)[:3]
        Ar = call("AMGX_matrix_create", rs, "dDDI")
        call("AMGX_matrix_upload_all", Ar, rows, va.size, 1, 1, ro, ci, va)
        back = call("AMGX_matrix_download_all", Ar)[:3]
        call("AMGX_matrix_destroy", Ar)
        call("AMGX_register_print_callback", capture)
        try:
            call("AMGX_solver_setup", s_an, A)
        finally:
            call("AMGX_register_print_callback",
                 lambda msg, length: printed.append(length))
        call("AMGX_matrix_replace_coefficients", A, rows, va.size, vals2)
        call("AMGX_solver_resetup", slv, A)
        call("AMGX_solver_solve_with_0_initial_guess", slv, b, x)
        return all(np.array_equal(p, q) for p, q in zip((ro, ci, va), back))
    round_trip, ct_s = timed(torch, lambda: run_path(amgx, per_path, "CT",
                                                     ct))
    spmv_bits = bool(torch.equal(capi._get(y).v, spmv(
        A_ca, torch.from_numpy(x_ca).to(dev))))
    report = [ln for ln in "".join(texts).splitlines()
              if ln.split()[:1] and ln.split()[0].isdigit()]
    ratios = [[float(v) for v in ln.split()[2:6]] for ln in report]
    res_ct = capi._get(slv).result
    x_ct = call("AMGX_vector_download", x)
    direct.resetup(dad_operator(torch, A_dir.init()))
    r_dr = direct.solve(b_dir)
    row = {"phase": "capi", "path": "CT", "rows": rows, "seconds": ct_s,
           "spmv_bit_identical": spmv_bits,
           "download_all_round_trip": round_trip,
           "analysis_report": report, "analysis_ratios": ratios,
           "resetup_iterations": [res_ct.iterations,
                                  int(res_ct.extra_stats["inner_iters"])],
           "direct_resetup_iterations": [
               r_dr.iterations, int(r_dr.extra_stats["inner_iters"])],
           "resetup_x_bit_identical": bool(np.array_equal(
               x_ct, r_dr.x.cpu().numpy())),
           "launches": per_path["CT"]}
    emit(row)
    check(spmv_bits and round_trip, f"capi CT: matvec and download: {row}")
    check(len(ratios) == 2 and all(0 < r < 1 for rr in ratios for r in rr),
          f"capi CT: the convergence_analysis report, 2 levels, every "
          f"ratio below 1: {row}")
    check(res_ct.status == "success" and row["resetup_x_bit_identical"]
          and row["resetup_iterations"] == row["direct_resetup_iterations"],
          f"capi CT: replace_coefficients + resetup = the direct "
          f"resetup: {row}")
    for h, k in ((s_an, "solver"), (cfg_an, "config"), (slv, "solver"),
                 (y, "vector"), (x, "vector"), (b, "vector"),
                 (A, "matrix")):
        call(f"AMGX_{k}_destroy", h)
    del direct, A_dir, A_ca, r_dir, r_dr, res_ct
    torch.cuda.empty_cache()

    # -- (CB) ----------------------------------------------------------------
    s = CAPI_SMALL_N
    rng = np.random.default_rng(SERVE_SEED + 5)
    Bs = rng.standard_normal((SERVE_B, s ** 3)).astype(np.float32)
    cfg_b = call("AMGX_config_create", BATCHED_CG)
    Ab, bb, xb = (call(f"AMGX_{k}_create", rs, "dFFI")
                  for k in ("matrix", "vector", "vector"))
    sb = call("AMGX_solver_create", rs, "dFFI", cfg_b)

    def cb():
        call("AMGX_generate_distributed_poisson_7pt", Ab, None, None, 1, 1,
             s, s, s)
        call("AMGX_vector_upload_batched", bb, SERVE_B, s ** 3, 1, Bs)
        call("AMGX_solver_setup", sb, Ab)
        call("AMGX_solver_solve_batched", sb, bb, xb)
    _, cb_s = timed(torch, lambda: run_path(amgx, per_path, "CB", cb))
    res_b = capi._get(sb).result
    xbs = call("AMGX_vector_download", xb)
    d_b = amgx.create_solver(amgx.Config.from_string(BATCHED_CG), device=dev)
    d_b.setup(amgx.gallery.poisson("7pt", s, s, s, dtype=torch.float32,
                                   device=dev))
    r_db = d_b.solve_many(torch.from_numpy(Bs).to(dev))
    row = {"phase": "capi", "path": "CB", "systems": SERVE_B,
           "rows": s ** 3, "seconds": cb_s,
           "batch_status": call("AMGX_solver_get_batch_status",
                                sb).tolist(),
           "iterations": np.asarray(res_b.iterations).tolist(),
           "direct_iterations": np.asarray(r_db.iterations).tolist(),
           "direct_status": np.asarray(r_db.status).tolist(),
           "status": np.asarray(res_b.status).tolist(),
           "x_bit_identical": bool(np.array_equal(
               xbs, r_db.x.cpu().numpy())),
           "launches": per_path["CB"]}
    emit(row)
    check(row["x_bit_identical"] and row["iterations"]
          == row["direct_iterations"] and row["status"]
          == row["direct_status"] and row["batch_status"] == [0] * SERVE_B,
          f"capi CB: the direct solve_many: {row}")
    for h, k in ((sb, "solver"), (xb, "vector"), (bb, "vector"),
                 (Ab, "matrix")):
        call(f"AMGX_{k}_destroy", h)
    del d_b, r_db, res_b

    # -- (CS) / (CF) ---------------------------------------------------------
    serve_text = SERVING_CG + ", serving_bucket_slots=4, serving_chunk_iters=4"
    cfg_s = call("AMGX_config_create", serve_text)
    shapes = {"CS": [(s, s, s)] * 4, "CF": [(s, s, s), (s, s, s - 2)] * 2}
    for path_name, shp in shapes.items():
        fleet = path_name == "CF"
        mats, vecs = {}, []
        for i, sh in enumerate(shp):
            if sh not in mats:
                mats[sh] = call("AMGX_matrix_create", rs, "dFFI")
                call("AMGX_generate_distributed_poisson_7pt", mats[sh], None,
                     None, 1, 1, *sh)
            v = call("AMGX_vector_create", rs, "dFFI")
            call("AMGX_vector_upload", v, int(np.prod(sh)), 1,
                 rng.standard_normal(int(np.prod(sh))).astype(np.float32))
            vecs.append(v)

        def serve():
            h = call("AMGX_fleet_create", rs, "dFFI", cfg_s, 2) if fleet \
                else call("AMGX_service_create", rs, "dFFI", cfg_s)
            pre = "AMGX_fleet_" if fleet else "AMGX_service_"
            ts = [call(pre + "submit", h, mats[sh], v)
                  for sh, v in zip(shp, vecs)]
            done = call(pre + "drain", h, 600)
            return h, ts, done
        (h, ts, done), serve_s = timed(torch, lambda: run_path(
            amgx, per_path, path_name, serve))
        out = []
        for t in ts:
            st = call("AMGX_service_ticket_status", t)
            xv = call("AMGX_vector_create", rs, "dFFI")
            call("AMGX_service_ticket_download", t, xv)
            out.append((st, call("AMGX_vector_download", xv),
                        call("AMGX_fleet_ticket_replica", t)))
            call("AMGX_vector_destroy", xv)
        cfg_d = amgx.Config.from_string(serve_text)
        twin = FleetRouter.build(cfg_d, 2, device=dev) if fleet \
            else SolveService(cfg_d, device=dev)
        dts = [twin.submit(capi._get(mats[sh]).A, capi._get(v).v)
               for sh, v in zip(shp, vecs)]
        twin.drain(timeout_s=600)
        row = {"phase": "capi", "path": path_name, "requests": len(ts),
               "shapes": shp, "seconds": serve_s, "completed": done,
               "ticket_status": [o[0] for o in out],
               "replicas": [o[2] for o in out],
               "direct_replicas": [getattr(t, "replica", None)
                                   for t in dts],
               "x_bit_identical": [bool(np.array_equal(
                   o[1], t.result.x.cpu().numpy())) for o, t in zip(out, dts)],
               "launches": per_path[path_name]}
        if fleet:
            row["health"] = json.loads(json.dumps(
                call("AMGX_fleet_health", h), default=str))
            row["routes"] = json.loads(json.dumps(
                call("AMGX_fleet_stats", h)["routes"], default=str))
        else:
            row["stats_queue_depth"] = call("AMGX_service_stats",
                                            h)["queue_depth"]
        emit(row)
        check(done == len(ts) and all(o[0] == (1, 0) for o in out)
              and all(row["x_bit_identical"])
              and row["replicas"] == row["direct_replicas"],
              f"capi {path_name}: the direct twin's tickets: {row}")
        for t in ts:
            call("AMGX_service_ticket_destroy", t)
        call("AMGX_fleet_destroy" if fleet else "AMGX_service_destroy", h)
        twin.stop()
        for v in vecs:
            call("AMGX_vector_destroy", v)
        for mh in mats.values():
            call("AMGX_matrix_destroy", mh)
        del twin, dts

    # -- (CE) ----------------------------------------------------------------
    rows_pr, cols_pr = pagerank_graph(CAPI_PAGERANK_N)
    M = amgx.CsrMatrix.from_coo(
        torch.from_numpy(rows_pr).to(dev), torch.from_numpy(cols_pr).to(dev),
        torch.ones(rows_pr.size, dtype=torch.float32, device=dev),
        CAPI_PAGERANK_N, CAPI_PAGERANK_N)
    handles = {}
    for name in ("POWER_ITERATION", "PAGERANK"):
        fpath = os.path.join(ROOT, "configs", "eigen_configs", name)
        cfg_e = call("AMGX_config_create_from_file", fpath)
        Ah = call("AMGX_matrix_create", rs, "dFFI")
        if name == "PAGERANK":
            call("AMGX_matrix_upload_all", Ah, M.num_rows, M.nnz, 1, 1,
                 M.row_offsets.cpu().numpy(), M.col_indices.cpu().numpy(),
                 M.values.cpu().numpy())
        else:
            call("AMGX_generate_distributed_poisson_7pt", Ah, None, None,
                 1, 1, *CAPI_EIG_BOX)
        handles[name] = (fpath, Ah, call("AMGX_vector_create", rs, "dFFI"),
                         call("AMGX_eigensolver_create", rs, "dFFI", cfg_e))

    def ce():
        out = {}
        for name, (_, Ah, xh, es) in handles.items():
            call("AMGX_eigensolver_setup", es, Ah)
            if name == "PAGERANK":
                call("AMGX_eigensolver_pagerank_setup", es, xh)
            call("AMGX_eigensolver_solve", es, xh)
            out[name] = call("AMGX_eigensolver_get_eigenvalues", es)
        return out
    lams, ce_s = timed(torch, lambda: run_path(amgx, per_path, "CE", ce))
    eig = {}
    for name, (fpath, Ah, xh, es) in handles.items():
        Mdir = M if name == "PAGERANK" else amgx.gallery.poisson(
            "7pt", *CAPI_EIG_BOX, dtype=torch.float32, device=dev)
        d_es = create_eigensolver(amgx.Config.from_file(fpath), device=dev)
        d_es.setup(Mdir)
        d_res = d_es.solve()
        eig[name] = {"rows": Mdir.num_rows,
                     "eigenvalues": lams[name].tolist(),
                     "iterations": capi._get(es).result.iterations,
                     "direct_eigenvalues": np.asarray(
                         d_res.eigenvalues).tolist(),
                     "direct_iterations": d_res.iterations}
        call("AMGX_eigensolver_destroy", es)
        call("AMGX_vector_destroy", xh)
        call("AMGX_matrix_destroy", Ah)
    row = {"phase": "capi", "path": "CE", "seconds": ce_s, "eigen": eig,
           "launches": per_path["CE"]}
    emit(row)
    check(all(e["eigenvalues"] == e["direct_eigenvalues"]
              and e["iterations"] == e["direct_iterations"]
              for e in eig.values()), f"capi CE: the direct eigensolvers: "
                                      f"{row}")
    del M, Mdir, d_es, d_res

    # -- (CC) ----------------------------------------------------------------
    colors = red_black((s, s, s))
    cfg_c = call("AMGX_config_create", CAPI_DILU)
    Ac, bc, xc = (call(f"AMGX_{k}_create", rs, "dFFI")
                  for k in ("matrix", "vector", "vector"))
    sc = call("AMGX_solver_create", rs, "dFFI", cfg_c)

    def cc():
        call("AMGX_generate_distributed_poisson_7pt", Ac, bc, xc, 1, 1,
             s, s, s)
        call("AMGX_matrix_attach_coloring", Ac, colors, s ** 3, 2)
        call("AMGX_solver_setup", sc, Ac)
        call("AMGX_solver_solve_with_0_initial_guess", sc, bc, xc)
    _, cc_s = timed(torch, lambda: run_path(amgx, per_path, "CC", cc))
    res_c = capi._get(sc).result
    used = capi._get(sc).solver.preconditioner.row_colors
    x_cc = call("AMGX_vector_download", xc)
    Ad = dataclasses.replace(
        amgx.gallery.poisson("7pt", s, s, s, dtype=torch.float32,
                             device=dev).init(),
        user_colors=torch.from_numpy(colors).to(dev), user_num_colors=2)
    d_c = amgx.create_solver(amgx.Config.from_string(CAPI_DILU), device=dev)
    d_c.setup(Ad)
    r_dc = d_c.solve(torch.ones(s ** 3, dtype=torch.float32, device=dev))
    row = {"phase": "capi", "path": "CC", "rows": s ** 3, "seconds": cc_s,
           "status": res_c.status, "iterations": res_c.iterations,
           "direct_iterations": r_dc.iterations,
           "colors_used": bool(np.array_equal(used.cpu().numpy(), colors)),
           "x_bit_identical": bool(np.array_equal(
               x_cc, r_dc.x.cpu().numpy())),
           "launches": per_path["CC"]}
    emit(row)
    check(res_c.status == "success" and row["colors_used"]
          and row["x_bit_identical"]
          and res_c.iterations == r_dc.iterations,
          f"capi CC: the coloring set directly: {row}")
    for h, k in ((sc, "solver"), (xc, "vector"), (bc, "vector"),
                 (Ac, "matrix")):
        call(f"AMGX_{k}_destroy", h)

    # -- the refusal ---------------------------------------------------------
    Abk = call("AMGX_matrix_create", rs, "dDDI")
    sbk = call("AMGX_solver_create", rs, "dDDI", cfg)
    amgx.reset_kernel_launches()
    rc_blk = capi.AMGX_matrix_upload_all(
        Abk, 2, 2, 2, 2, np.array([0, 1, 2]), np.array([0, 1]),
        np.ones(8))
    msg = capi.last_error().strip().splitlines()[-1]
    rc_setup = capi.AMGX_solver_setup(sbk, Abk)
    refused = {"upload_rc": int(rc_blk), "message": msg,
               "setup_rc": int(rc_setup),
               "launches": sum(amgx.kernel_launches().values())}
    check(rc_blk == capi.RC.BAD_PARAMETERS and "item 8.4" in msg
          and rc_setup != capi.RC.OK and refused["launches"] == 0,
          f"capi: the block upload is refused and nothing runs: {refused}")
    call("AMGX_finalize")
    emit({"phase": "capi", "path": "refusal", **refused,
          "calls": calls, "distinct_calls": len(calls)})


# ---------------------------------------------------------------------------
# Queue A item 8 (phase_item8): the ENERGYMIN level, CR, AFFINITY, the
# device RS sweep, the new smoothers and aggregation selectors, K6 / K7,
# random_matrix and ops/permute.py
# ---------------------------------------------------------------------------
# The JAX package's anchors of the 64^3 and 32^3 paths on the CPU
# (`tools/jax_anchors.py item8:LABEL`): iterations, status, final
# monitored residual relative to the initial one, level rows. KM and
# KMn are its float64 runs (`--dtype float64`: its float32 KACZMARZ
# and ILU(1) turn their state float64 and fail its loop; IL1 has none,
# its float64 ILU(1) setup at 64^3 did not end in 46 min); the card's
# float32 run is held to them within ITEM8_F64_TOL of the iterations,
# and to the float32 SIZE_2 hierarchy's level rows (PY's: the smoother
# does not enter the setup; the float64 matching pairs a few rows
# otherwise).
ITEM8_F32_LEVELS = [262144, 120263, 56799, 27033, 12901, 6171, 2947, 1418,
                    678, 324, 157, 75]
ITEM8_ANCHORS = {
    "GS32": dict(iterations=23, status="success",
                 final=9.191365825213817e-07,
                 levels=[32768, 15044, 7074, 3358, 1588, 753, 365, 173, 80]),
    "GR": dict(iterations=28, status="success",
               final=5.170899282494936e-07,
               levels=[32768, 8460, 2251, 592, 156, 42]),
    "PY": dict(iterations=13, status="success",
               final=3.315517460578121e-07,
               levels=[262144, 120263, 56799, 27033, 12901, 6171, 2947,
                       1418, 678, 324, 157, 75]),
    "KZ": dict(iterations=15, status="success",
               final=4.4319966718830983e-07,
               levels=[262144, 120263, 56799, 27033, 12901, 6171, 2947,
                       1418, 678, 324, 157, 75]),
    "IL0": dict(iterations=14, status="success",
                final=5.306313255459827e-07,
                levels=[262144, 120263, 56799, 27033, 12901, 6171, 2947,
                        1418, 678, 324, 157, 75]),
    # EMp / EM64: the port's CPU route (`tools/jax_anchors.py --port`),
    # held exactly; the JAX package's own run beside it (`jax`): its
    # LAPACK QR rounds EM's patch solves otherwise in the last bits, and
    # the CR / EM hierarchy moves from level 2 on (PERF.md section 6)
    "EMp": dict(iterations=29, status="success",
                final=6.145511298872582e-09, exact=True,
                levels=[262144, 81948, 16723, 2478, 662, 258, 98],
                jax=dict(iterations=27, levels=[262144, 81948, 16732, 2492,
                                                670, 289, 117])),
    # EM64: CR's splits part from level 2 between the JAX package and
    # the port, and deep down between the port's CPU route and the card
    # (float64 norms): held to success and level 1, the iterations of
    # both recorded (`cpu`: the port's CPU route)
    "EM64": dict(iterations=58, status="success",
                 final=8.926456066199956e-09, record_iterations=True,
                 levels=[262144, 82798, 19007, 2876, 777, 428, 322, 233,
                         195, 159, 133, 110],
                 cpu=dict(iterations=42, levels=[262144, 82798, 18986, 2919,
                                                 822, 455, 335, 282, 245,
                                                 213, 195, 157, 144, 122])),
    "CJ": dict(iterations=12, status="success",
               final=4.102420357354065e-09,
               levels=[262144, 81948, 10458, 1239, 236, 132, 126]),
    "KM": dict(iterations=34, status="success",
               final=6.649293234023943e-07,
               dtype="float64",
               levels=ITEM8_F32_LEVELS),
    "KMn": dict(iterations=97, status="success",
                final=8.885982298365333e-07,
                dtype="float64",
                levels=ITEM8_F32_LEVELS),
}
ITEM8_ITER_TOL = 2
ITEM8_F64_TOL = 0.1
ITEM8_FINAL_TOL = 0.05
ITEM8_TRUE_MAX = 1e-8          # EM at 128^3: the true f64 residual
RSW_DET_N = 32
# 10^6 rows took 16 s of host assembly (the JAX package's row loop):
# cut to a quarter for the script's time (PERF.md section 6)
RANDOM_N = 250_000
# the kernels each path must launch (setup and solve); a classical
# level 0 whose weighted tables the caps decline composes its transfers
# with B8 instead of B3w / B4w (`item8_level0`)
ITEM8_KERNELS = {
    "EM": ("qr_solve", "ordered_sum", "csr_spmv", "csr_smooth"),
    "AY": ("csr_spmv", "csr_smooth"),
    "RSW": ("csr_spmv", "csr_smooth"),
    "PG": ("dia_spmv", "csr_spmv", "csr_smooth", "rap_values_relabel",
           "dia_spmv_dot", "cg_update"),
    "AV": ("dia_spmv", "csr_spmv", "csr_smooth", "rap_values_relabel"),
    "EM64": ("qr_solve", "ordered_sum"),
    "EMp": ("qr_solve", "ordered_sum", "csr_spmv", "csr_smooth"),
    "PY": ("dia_spmv", "csr_spmv", "rap_values_relabel"),
    "KZ": ("dia_spmv", "csr_spmv", "rap_values_relabel"),
    "KM": ("dia_spmv", "csr_spmv", "rap_values_relabel"),
    "KMn": ("dia_spmv", "csr_spmv", "rap_values_relabel"),
    "IL0": ("dia_spmv", "csr_spmv", "rap_values_relabel"),
    "IL1": ("dia_spmv", "csr_spmv", "rap_values_relabel"),
    "CJ": ("dia_spmv", "csr_spmv"),
    "GS32": ("gs_sweep", "rap_values_relabel"),
    "GR": ("csr_smooth", "rap_values_relabel"),
}


def item8_level0(torch, amg):
    """'weighted' when a classical level 0 rides B3w / B4w (its tables,
    a smoother with the fused hooks, a float32 cycle), 'composed' when it
    composes R r / P xc, None for an aggregation level."""
    lv = amg.levels[0]
    if getattr(lv, "cf_map", None) is None:
        return None
    dt = amg.solve_data()["levels"][0]["A"].dtype
    return "weighted" if lv._transfer_tables() is not None and hasattr(
        lv.smoother, "smooth_restrict") and dt == torch.float32 \
        else "composed"


def item8_run(torch, amgx, dev, per_path, card, label, warm=True,
              probe=None):
    """Set up and solve ITEM8[label] on the 7-pt n^3 with b = 1, a warm
    solve after; emit its row (the card, status, iterations, level rows,
    true residual, setup / solve seconds, launches by kernel in the setup
    and the solve) and hold it to its anchor and its kernels. `probe()`,
    run right after the first solve, adds fields. Returns (row, solver,
    result)."""
    text, n, dtype = ITEM8[label]
    dt = getattr(torch, dtype)
    A = amgx.gallery.poisson("7pt", n, n, n, dtype=dt, device=dev).init()
    b = torch.ones(n ** 3, dtype=dt, device=dev)
    slv = amgx.create_solver(item8_config(amgx.Config, label), device=dev)
    amgx.reset_kernel_launches()
    t0 = time.perf_counter()
    slv.setup(A)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    in_setup = amgx.kernel_launches()
    t0 = time.perf_counter()
    res = slv.solve(b)
    solve_s = time.perf_counter() - t0
    per_path[label] = c = amgx.kernel_launches()
    extra = probe() if probe is not None else {}
    warm_s = warm_solve(torch, slv, n, dt)[1] if warm else None
    amg = precond_amg(slv)
    anchor = ITEM8_ANCHORS.get(label)
    row = {"phase": "item8", "path": label, "nvidia_smi": card,
           "config": text, "rows": n ** 3, "dtype": dtype,
           "status": res.status, "iterations": res.iterations,
           "levels": amg.level_rows(), "level0_transfers": item8_level0(torch, amg),
           "final_rel_res": float(res.res_norm / res.norm0),
           "true_rel_res": true_rel_res(torch, A, res.x, b),
           "setup_s": setup_s, "first_solve_s": solve_s,
           "warm_solve_s": warm_s, "anchor": anchor,
           "launches_in_setup": {k: v for k, v in in_setup.items() if v},
           "launches_in_solve": {k: c[k] - in_setup[k] for k in c
                                 if c[k] - in_setup[k]}, **extra}
    emit(row)
    check(tuple(res.x.shape) == (n ** 3,)
          and bool(torch.isfinite(res.x).all()), f"{label}: x finite")
    want = ITEM8_KERNELS[label]
    if row["level0_transfers"] == "weighted":
        want += ("dia_smooth_restrict_w", "dia_prolong_smooth_w")
    missing = [k for k in want if not c[k]]
    check(not missing, f"{label}: {missing} did not launch "
          f"{ {k: v for k, v in c.items() if v} }")
    if anchor is not None:
        itol = 0 if anchor.get("exact") \
            else ITEM8_ITER_TOL if anchor.get("dtype", dtype) == dtype \
            else max(ITEM8_ITER_TOL, round(ITEM8_F64_TOL
                                           * anchor["iterations"]))
        # record_iterations: status and level 1 held, iterations recorded
        held = 2 if anchor.get("record_iterations") else None
        check(res.status == anchor["status"]
              and (held is not None
                   or abs(res.iterations - anchor["iterations"]) <= itol)
              and row["levels"][:held] == anchor["levels"][:held],
              f"{label}: {res.status} in {res.iterations} on {row['levels']}"
              f", anchor {anchor}")
        if res.status == "max_iters":
            check(abs(row["final_rel_res"] - anchor["final"])
                  <= ITEM8_FINAL_TOL * anchor["final"],
                  f"{label}: final residual {row['final_rel_res']}, anchor "
                  f"{anchor['final']} +- {ITEM8_FINAL_TOL:.0%}")
    return row, slv, res


def qr_ops(k):
    """K7's operations on one k x k patch: the reflectors (norm, scale,
    their application to the columns right of them and to b) and the
    back substitution."""
    ops = k * k
    for j in range(k):
        m = k - 1 - j
        ops += 3 * m + (m + 1) * (4 * m + 2)
    return ops


def k7_cases(torch, K, amg, summary, label="EM64"):
    """K7 on the `label` path's level 0 batch (float64, the driven route)
    against its plain version and the library call (the same QR + solve);
    the same batch in float32, and wide patches on the global route. The
    library forms Q patch by patch: 38.6 s on EM 128^3's 656,194 patches
    (PERF.md section 6), so the case runs on EM64's."""
    from amgx_tpu_torch.amg.energymin import em_patches
    from amgx_tpu_torch.ops import dense
    lv = amg.levels[0]
    A_FF, rhs = em_patches(lv.A, lv.cf_map)[:2]
    nb, k = rhs.shape

    def plain():
        return dense.solve_qr_plain(A_FF, rhs)

    # the plain version is the library route (torch.linalg.qr forms Q
    # patch by patch on the card: seconds a call), timed once
    run_case(torch, K, f"{label} level 0: {nb} patches of {k}", "qr_solve",
             lambda: dense.solve_qr(A_FF, rhs), plain,
             nb * (k * k + 2 * k) * 8, nb * qr_ops(k), 1, "plain", nb,
             summary, extra={"patch_k": k, "threads": dense.qr_threads(
                 k, 8), "bound_peak": "float64, 34 TFLOP/s",
                 "library": "torch.linalg.qr + solve_triangular, 1 call"},
             peak=PEAK_F64_S, plain_reps=None)
    a32, b32 = A_FF[:65536].float(), rhs[:65536].float()
    err32 = max_err(torch, dense.solve_qr(a32, b32),
                    dense.solve_qr_plain(a32, b32))[1]
    g = torch.Generator(device=A_FF.device).manual_seed(7)
    wide = torch.randn(64, 20, 20, generator=g, device=A_FF.device,
                       dtype=torch.float64) + 8 * torch.eye(
        20, dtype=torch.float64, device=A_FF.device)
    wb = torch.randn(64, 20, generator=g, device=A_FF.device,
                     dtype=torch.float64)
    errw = max_err(torch, dense.solve_qr(wide, wb),
                   dense.solve_qr_plain(wide, wb))[1]
    emit({"phase": "item8", "kernel": "qr_solve", "float32_patches":
          a32.shape[0], "float32_rel_err": err32,
          "float32_limit": 1e-6, "global_route_k": 20,
          "global_route_threads": dense.qr_threads(20, 8),
          "global_route_rel_err": errw})
    check(err32 <= 1e-6 and errw <= 1e-12 and dense.qr_threads(20, 8) == 0,
          f"qr_solve: float32 {err32}, global route {errw}")


def k8_cases(torch, K, amg, summary):
    """K8 on CR's relaxation product (float64) at EM 128^3's level 1 and
    at its level with the longest rows, against its plain version (the
    same additions: the bits must agree) and the library's index_add_."""
    from amgx_tpu_torch.ops import segment
    longest = max(range(1, len(amg.levels)), key=lambda i: int(
        (amg.levels[i].A.row_offsets[1:]
         - amg.levels[i].A.row_offsets[:-1]).max()))
    for i in dict.fromkeys((1, longest)):
        A = amg.levels[i].A
        n, dev = A.num_rows, A.device
        g = torch.Generator(device=dev).manual_seed(8)
        x = torch.randn(n, generator=g, device=dev, dtype=A.dtype)
        v = A.values * x[A.col_indices.long()]
        plan = segment.ordered_sum_plan(A.row_offsets)
        rid = A.coo()[0].long()
        row_max = int(plan[3][0])
        run_case(torch, K, f"EM 128^3 level {i}: {n} rows, {A.nnz} "
                 f"entries, rows of up to {row_max}", "ordered_sum",
                 lambda: segment.ordered_sum(v, plan, n),
                 lambda: segment.ordered_sum_plain(v, plan, n),
                 A.nnz * 8 + n * (3 * 8 + 8), A.nnz, 1,
                 lambda: torch.zeros(n, dtype=A.dtype,
                                     device=dev).index_add_(0, rid, v),
                 n, summary, extra={"level": i, "row_max": row_max,
                                    "library": "index_add_"},
                 peak=PEAK_F64_S)


def k6_cases(torch, K, amg, summary):
    """K6 on GS32's level 0 (float32, the driven sweep) against the row
    loop; the same operator in float64."""
    from amgx_tpu_torch.ops.gs import gs_sweep, gs_sweep_plain
    lv = amg.levels[0]
    A, sd = lv.A, lv.smoother.solve_data()
    n, dev = A.num_rows, A.device
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(n, generator=g, device=dev, dtype=A.dtype)
    b = torch.randn(n, generator=g, device=dev, dtype=A.dtype)
    w = lv.smoother.relaxation_factor
    args = (A.row_offsets, A.col_indices, A.values, b, sd["gs_diag"],
            sd["dinv"], x, w)
    run_case(torch, K, f"GS32 level 0: {n} rows", "gs_sweep",
             lambda: gs_sweep(*args),
             lambda: gs_sweep_plain(*args).to(dev),
             (n + 1) * 4 + A.nnz * 8 + 5 * n * 4, 2 * A.nnz + 6 * n, 1,
             None, n, summary, extra={"chain_steps": n})
    a64 = tuple(t.double() if t.is_floating_point() else t
                for t in args[:-1]) + (w,)
    err64 = max_err(torch, gs_sweep(*a64), gs_sweep_plain(*a64).to(dev))[1]
    emit({"phase": "item8", "kernel": "gs_sweep", "float64_rel_err": err64,
          "float64_limit": 1e-12})
    check(err64 <= 1e-12, f"gs_sweep float64: {err64}")


def rsw_determinism(torch, amgx, dev, per_path):
    """RSW's split at 32^3 (float64): two card setups and the CPU
    route's, every level's CF map bit for bit."""
    n = RSW_DET_N
    cfg = item8_config(amgx.Config, "RSW")
    splits = []
    for d in (dev, dev, torch.device("cpu")):
        slv = amgx.create_solver(cfg, device=d)
        slv.setup(amgx.gallery.poisson("7pt", n, n, n, device=d))
        splits.append([lv.cf_map.cpu() for lv in precond_amg(slv).levels])
    same = [len(splits[0]) == len(s) and all(torch.equal(a, b_) for a, b_
                                             in zip(splits[0], s))
            for s in splits[1:]]
    emit({"phase": "item8", "path": f"RSW_{n}^3_determinism",
          "levels": len(splits[0]), "card_setups_bit_identical": same[0],
          "card_equals_cpu": same[1]})
    check(same[0] and same[1], f"RSW {n}^3: splits {same}")


def io_checks(torch, amgx, dev, card):
    """random_matrix(RANDOM_N, 9, seed=3) on the card through B8 against its
    plain version; the 128^3 operator's permutation round trip."""
    from amgx_tpu_torch.ops import cuda_csr
    from amgx_tpu_torch.ops.permute import permute_matrix
    t0 = time.perf_counter()
    R_ = amgx.gallery.random_matrix(RANDOM_N, 9, seed=3, dtype=torch.float32,
                                    device=dev)
    build_s = time.perf_counter() - t0
    x = torch.ones(RANDOM_N, dtype=torch.float32, device=dev)
    args = (R_.row_offsets, R_.col_indices, R_.values, x)
    err = max_err(torch, cuda_csr.csr_spmv(*args),
                  cuda_csr.csr_spmv_plain(*args))[1]
    A = amgx.gallery.poisson("7pt", 128, 128, 128, dtype=torch.float32,
                             device=dev)
    p = np.random.default_rng(5).permutation(A.num_rows)
    ip = np.argsort(p)
    t0 = time.perf_counter()
    B = permute_matrix(permute_matrix(A, p, p), ip, ip)
    perm_s = time.perf_counter() - t0
    same = all(torch.equal(a, b_) for a, b_ in (
        (A.row_offsets, B.row_offsets), (A.col_indices, B.col_indices),
        (A.values, B.values)))
    emit({"phase": "item8", "path": "IO", "nvidia_smi": card,
          "random_matrix_rows": RANDOM_N, "random_matrix_nnz": R_.nnz,
          "random_matrix_build_s": build_s, "csr_spmv_rel_err": err,
          "csr_spmv_limit": LIMITS["csr_spmv"], "permute_rows": A.num_rows,
          "permute_round_trip_bit_equal": same, "permute_round_trip_s":
          perm_s})
    check(err <= LIMITS["csr_spmv"] and same,
          f"IO: random_matrix B8 {err}, permutation round trip {same}")


def phase_item8(torch, amgx, dev, per_path, summary):
    """Queue A item 8's paths (`ITEM8`), K6 / K7 held against their plain
    versions at the driven shapes, RSW's 32^3 determinism and the IO
    checks."""
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.solvers import multicolor
    card = nvidia_smi()
    row, slv, res = item8_run(torch, amgx, dev, per_path, card, "EM")
    amg = precond_amg(slv)
    check(res.status == "success" and row["true_rel_res"] <= ITEM8_TRUE_MAX
          and per_path["EM"]["qr_solve"] == len(amg.levels),
          f"EM: {res.status}, true residual {row['true_rel_res']}, K7 "
          f"{per_path['EM']['qr_solve']} launches on {len(amg.levels)} "
          f"levels")
    k8_cases(torch, K, amg, summary)
    del slv, amg
    for label in ("AY", "RSW"):
        row, _, res = item8_run(torch, amgx, dev, per_path, card, label)
        check(res.status == "success"
              and row["true_rel_res"] <= ITEM8_TRUE_MAX,
              f"{label}: {res.status}, {row['true_rel_res']}")
    rsw_determinism(torch, amgx, dev, per_path)
    row, _, res = item8_run(torch, amgx, dev, per_path, card, "PG")
    check(res.status == "success"
          and abs(res.iterations - AGG_ANCHORS["agg-pcg"]) <= 2
          and row["levels"] == AGG_ROWS_128,
          f"PG: {res.status} in {res.iterations} on {row['levels']}, "
          f"agg-pcg's {AGG_ANCHORS['agg-pcg']} on {AGG_ROWS_128}")
    item8_run(torch, amgx, dev, per_path, card, "AV")
    for label in ("EM64", "EMp", "PY", "KZ", "KM", "KMn", "IL0", "IL1",
                  "CJ"):
        row, slv, res = item8_run(torch, amgx, dev, per_path, card, label,
                                  warm=False)
        if label == "EM64":
            check(per_path["EM64"]["qr_solve"] == len(
                precond_amg(slv).levels), f"EM64: K7 once a setup level")
            k7_cases(torch, K, precond_amg(slv), summary)
    sweeps = [0]
    real = multicolor.GSSolver.solve_iteration

    def counted(self, *a, **kw):
        sweeps[0] += 1
        return real(self, *a, **kw)

    multicolor.GSSolver.solve_iteration = counted
    try:
        row, slv, res = item8_run(torch, amgx, dev, per_path, card, "GS32",
                                  probe=lambda: {"gs_sweeps": sweeps[0]})
    finally:
        multicolor.GSSolver.solve_iteration = real
    check(per_path["GS32"]["gs_sweep"] == row["gs_sweeps"] > 0,
          f"GS32: K6 {per_path['GS32']['gs_sweep']} launches for "
          f"{row['gs_sweeps']} sweeps")
    k6_cases(torch, K, precond_amg(slv), summary)
    del slv
    item8_run(torch, amgx, dev, per_path, card, "GR")
    io_checks(torch, amgx, dev, card)


def _status(res, s):
    from amgx_tpu_torch.resilience.status import status_string
    return status_string(int(res.status[s]))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # past WATCHDOG_S every thread's stack goes to stderr: where a run
    # that outgrows its limit spends its time
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.ops import cuda_build
    # float32 stays float32: no TF32 in matrix products (FGMRES's CGS2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # the stock files' solve and grid tables go to a callback, away from
    # the JSON lines: only their count is reported
    printed = []
    amgx.register_print_callback(lambda msg, n: printed.append(n))
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
    # local memory (a stack frame, spills) in any kernel, by source
    local = {src: sorted({ln.strip() for ln in log.splitlines()
                          if "stack frame" in ln
                          and not ln.strip().startswith("0 bytes stack "
                                                        "frame, 0 bytes "
                                                        "spill stores")})
             for src, log in rep["ptxas"].items()}
    emit({"phase": "build", "seconds": rep["seconds"],
          "built": rep["built"], "ptxas_registers": regs,
          "ptxas_local_memory": local,
          "ptxas_stencil_tb": tb_forms(cuda_build.resource_lines(
              rep["ptxas"].get("stencil_tb.cu", "") + "\n"
              + rep["ptxas"].get("stencil_tb_slab.cu", "")))})

    summary = timed_phase(phase_kernels, torch, amgx, dev)
    per_path = {}
    timed_phase(phase_small, torch, amgx, dev, per_path)
    f32_runs, f32_slvs = timed_phase(phase_flagship, torch, amgx, dev,
                                     per_path)
    timed_phase(phase_flagship_bf16, torch, amgx, dev, per_path, f32_runs,
                f32_slvs)
    del f32_slvs
    timed_phase(phase_flagship_dad, torch, amgx, dev, per_path)
    timed_phase(phase_unfused, torch, amgx, dev, per_path, f32_runs)
    for phase in (phase_unfused_bf16, phase_krylov, phase_classical,
                  phase_determinism, phase_classical_refinement):
        timed_phase(phase, torch, amgx, dev, per_path)
    timed_phase(phase_aggregation, torch, amgx, dev, per_path, summary)
    for phase in (phase_bf16_hierarchies, phase_bicgstab, phase_multicolor,
                  phase_aggressive_kcycle, phase_resetup):
        timed_phase(phase, torch, amgx, dev, per_path)
    timed_phase(phase_batch, torch, amgx, dev, per_path, summary)
    timed_phase(phase_resilience, torch, amgx, dev, per_path)
    timed_phase(phase_serving, torch, amgx, dev, per_path, summary)
    for phase in (phase_fleet, phase_autotune, phase_eigen):
        timed_phase(phase, torch, amgx, dev, per_path)
    timed_phase(phase_capi, torch, amgx, dev, per_path, printed)
    timed_phase(phase_item8, torch, amgx, dev, per_path, summary)
    faulthandler.cancel_dump_traceback_later()

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
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for key in ("phases", "cluster", "cluster_barriers",
                    "block_barriers", "phase_chain_floor_ms", "library",
                    "repeat_bit_equal", "slab_max_abs_diff",
                    "sparse_csr_spmv_ms",
                    "max_err_bf16_ulps", "bit_equal_share",
                    "bound_launches_ms", "launches_per_call", "step_route_ms",
                    "step_route_device_ms", "step_route_launches_per_call",
                    "step_route_max_abs_diff", "split", "systems",
                    "single_x_b_ms", "per_system_taus"):
            if key in row:
                entry[key] = row[key]
        if name in ROUTE_COUNTERS:
            entry["route_counters"] = {
                k: {p: c[k] for p, c in per_path.items() if c[k]}
                for k in ROUTE_COUNTERS[name]}
        kernels.append(entry)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": {k: round(v, 3)
                            for k, v in PHASE_SECONDS.items()},
          "function_seconds": {k: round(v, 3)
                               for k, v in FUNCTION_SECONDS.items()},
          "package_output_messages": len(printed),
          "package_output_chars": sum(printed)})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serving-restart"]:
        sys.exit(serving_restart(sys.argv[2:]))
    if sys.argv[1:2] == ["--autotune-restart"]:
        sys.exit(autotune_restart(sys.argv[2:]))
    sys.exit(main())
