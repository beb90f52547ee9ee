"""Scoped, typed configuration system (the port of amgx_tpu/config.py).

Analog of AMG_Config (include/amg_config.h:126, implementation
src/amg_config.cu; parameters registered in src/core.cu:307-544). The
product-defining behaviors reproduced here:

- a global registry of typed parameters with defaults / allowed values /
  ranges (`register_parameter`);
- flat config strings  ``scope:name(new_scope)=value`` separated by
  ``,`` / ``;`` / newlines;
- JSON "config_version 2" files where nested solver objects create
  *scopes* — a parameter may hold different values per nesting site, and
  lookups fall back scope -> "default" -> registered default;
- solver-role parameters ("solver", "preconditioner", "smoother",
  "coarse_solver", ...) carry the *scope binding* of their child solver so
  the solver tree can be built recursively.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from .errors import BadConfigurationError, BadParametersError

# ---------------------------------------------------------------------------
# parameter registry
# ---------------------------------------------------------------------------


@dataclass
class ParamDesc:
    name: str
    type: type
    doc: str
    default: Any
    allowed: Optional[tuple] = None      # enumerated allowed values
    min_value: Any = None
    max_value: Any = None


_REGISTRY: Dict[str, ParamDesc] = {}


def register_parameter(name, type_, doc, default, allowed=None,
                       min_value=None, max_value=None):
    _REGISTRY[name] = ParamDesc(name, type_, doc, default,
                                tuple(allowed) if allowed else None,
                                min_value, max_value)


BOOL01 = (0, 1)

# Solver-role parameters whose value names a child solver and whose JSON
# object form introduces a new scope (matches the recursion in the
# reference JSON import, include/amg_config.h:144-269).
SOLVER_ROLE_PARAMS = (
    "solver", "preconditioner", "smoother", "coarse_solver",
    "fine_smoother", "coarse_smoother", "eig_solver",
)


def _register_default_parameters():
    """Register the reference's parameter surface (src/core.cu:307-544).
    Names, defaults and docs match the reference so its config files and
    config strings work unchanged; knobs the port does not act on are
    kept as accepted-but-inert for compatibility."""
    R = register_parameter
    # determinism / exception handling
    R("determinism_flag", int, "force deterministic coarsening/coloring", 0, BOOL01)
    R("exception_handling", int, "internal exception processing instead of error codes", 0, BOOL01)
    # consolidation
    R("fine_level_consolidation", int, "consolidate the fine level", 0, BOOL01)
    R("use_cuda_ipc_consolidation", int, "inert", 0, BOOL01)
    R("amg_consolidation_flag", int, "use amg level consolidation", 0)
    R("matrix_consolidation_lower_threshold", int, "avg rows to trigger merge", 0)
    R("matrix_consolidation_upper_threshold", int, "avg rows after merge", 1000)
    # memory pools (inert: the PyTorch caching allocator owns allocation)
    R("device_mem_pool_size", int, "inert", 256 * 1024 * 1024)
    R("device_consolidation_pool_size", int, "inert", 256 * 1024 * 1024)
    R("device_mem_pool_max_alloc_size", int, "inert", 20 * 1024 * 1024)
    R("device_alloc_scaling_factor", int, "inert", 10)
    R("device_alloc_scaling_threshold", int, "inert", 16 * 1024)
    R("device_mem_pool_size_limit", int, "inert", 0)
    # async framework
    R("num_streams", int, "inert", 0)
    R("serialize_threads", int, "inert", 0, BOOL01)
    R("high_priority_stream", int, "inert", 0, BOOL01)
    # distributed
    R("communicator", str, "collective backend <ICI|MPI|MPI_DIRECT>", "ICI")
    R("separation_interior", str, "latency-hiding separation view", "INTERIOR",
      ("INTERIOR", "OWNED", "FULL", "ALL"))
    R("separation_exterior", str, "calculation-limit view", "OWNED",
      ("INTERIOR", "OWNED", "FULL", "ALL"))
    R("min_rows_latency_hiding", int, "inert", -1)
    R("exact_coarse_solve", int, "inert", 0, BOOL01)
    R("matrix_halo_exchange", int, "0 none / 1 diagonal / 2 full", 0)
    R("boundary_coloring", str, "boundary coloring handling", "SYNC_COLORS",
      ("FIRST", "SYNC_COLORS", "LAST"))
    R("halo_coloring", str, "halo coloring handling", "LAST",
      ("FIRST", "SYNC_COLORS", "LAST"))
    R("use_sum_stopping_criteria", int, "sum rows over ranks for coarsening stop", 0)
    # data format
    R("rhs_from_a", int, "reader: synthesize rhs from A (1: A*e, 0: ones)", 0)
    R("complex_conversion", int, "complex->real K-formulation on read", 0)
    R("matrix_writer", str, "matrix write format", "matrixmarket",
      ("matrixmarket", "binary"))
    R("block_format", str, "block storage order", "ROW_MAJOR", ("ROW_MAJOR", "COL_MAJOR"))
    R("block_convert", int, "reader converts to bxb block matrix (0=off)", 0)
    # solver roles
    R("solver", str, "the solving algorithm", "AMG")
    R("preconditioner", str, "the preconditioner algorithm", "AMG")
    R("coarse_solver", str, "coarsest-level solver", "DENSE_LU_SOLVER")
    R("smoother", str, "the smoothing algorithm", "BLOCK_JACOBI")
    R("fine_smoother", str, "fine-level smoother", "BLOCK_JACOBI")
    R("coarse_smoother", str, "coarse-level smoother", "BLOCK_JACOBI")
    # gmres
    R("gmres_n_restart", int, "Krylov vectors before restart", 20)
    R("gmres_krylov_dim", int, "max Krylov dim (0 = match restart)", 0)
    # idr
    R("subspace_dim_s", int, "IDR(s) shadow-space dimension", 8)
    # dense lu
    R("dense_lu_num_rows", int, "trigger dense LU when rows <=", 128)
    R("dense_lu_max_rows", int, "never trigger when rows >= (0=unused)", 0)
    # relaxation
    R("relaxation_factor", float, "relaxation factor", 0.9, None, 0.0, 2.0)
    R("ilu_sparsity_level", int, "ILU(k) level", 0)
    R("symmetric_GS", int, "symmetric GS sweeps", 0, BOOL01)
    R("jacobi_iters", int, "inner iterations for GSINNER", 5)
    R("GS_L1_variant", int, "L1 Gauss-Seidel variant", 0, BOOL01)
    R("kpz_mu", int, "KPZ polynomial mu", 4)
    R("kpz_order", int, "KPZ polynomial order", 3)
    R("chebyshev_polynomial_order", int, "Chebyshev smoother order", 5)
    R("chebyshev_lambda_estimate_mode", int, "eigenvalue estimation mode", 0, None, 0, 3)
    R("cheby_max_lambda", float, "max-eigenvalue guess", 1.0, None, 0.0, 1.0e20)
    R("cheby_min_lambda", float, "min-eigenvalue guess", 0.125, None, 0.0, 1.0e20)
    R("kaczmarz_coloring_needed", int, "multicolor Kaczmarz", 1)
    R("cf_smoothing_mode", int, "CF-Jacobi flavour", 0)
    # amg level
    R("algorithm", str, "AMG algorithm", "CLASSICAL",
      ("CLASSICAL", "AGGREGATION", "ENERGYMIN"))
    R("amg_host_levels_rows", int, "rows below which levels run on host "
      "(-1 off); inert", -1)
    # cycles
    R("cycle", str, "cycle shape", "V", ("V", "W", "F", "CG", "CGF"))
    R("max_levels", int, "max number of levels", 100)
    R("min_fine_rows", int, "min rows in a fine level", 1)
    R("min_coarse_rows", int, "min block rows in a level", 2)
    R("max_coarse_iters", int, "max iterations of coarsest solver", 100)
    R("coarsen_threshold", float, "threshold for creating new coarse level", 1.0)
    R("presweeps", int, "presmooth iterations", 1)
    R("postsweeps", int, "postsmooth iterations", 1)
    R("finest_sweeps", int, "finest-level sweeps (-1 = use pre/post)", -1)
    R("coarsest_sweeps", int, "smoothing iterations at coarsest level", 2)
    R("cycle_iters", int, "CG-cycle inner iterations", 2)
    R("structure_reuse_levels", int, "hierarchy reuse depth on resetup", 0)
    R("amg_precision", str, "precision of the stored hierarchy + cycle "
      "(mixed-precision preconditioning, the dDFI-mode analog: "
      "a float32/bfloat16 cycle inside an f64 flexible Krylov solver). "
      "Resolved through the shared precision policy (precision.py) with "
      "solve_precision/tpu_dtype: contradictory combinations are "
      "rejected at configuration time",
      "double", ("double", "float", "bfloat16"))
    R("error_scaling", int, "coarse-correction scaling mode", 0, (0, 2, 3))
    R("reuse_scale", int, "reuse correction scale for next N iters", 0)
    R("scaling_smoother_steps", int, "smoother steps before computing scale", 2)
    R("intensive_smoothing", int, "drastically increase smoothing", 0)
    # aggregation
    R("coarseAgenerator", str, "Galerkin product method; all reference "
      "choices compute the same product, so every name maps to the one "
      "implementation (the structured path for GEO levels)", "LOW_DEG",
      ("LOW_DEG", "THRUST", "HYBRID"))
    R("coarseAgenerator_coarse", str, "Galerkin method for coarser levels "
      "(same mapping as coarseAgenerator)", "LOW_DEG")
    R("interpolator", str, "classical interpolation", "D1")
    R("energymin_interpolator", str, "energymin interpolation", "EM")
    R("energymin_selector", str, "energymin selection", "CR")
    R("selector", str, "coarse-grid selection algorithm", "PMIS")
    R("aggressive_levels", int, "levels of aggressive coarsening (classical)", 0)
    R("aggressive_selector", str, "aggressive selector", "DEFAULT")
    R("aggressive_interpolator", str, "aggressive interpolator", "MULTIPASS")
    R("handshaking_phases", int, "handshaking phases in matching", 1)
    R("aggregation_edge_weight_component", int, "block component for edge weights", 0)
    R("max_matching_iterations", int, "max matching iterations", 15)
    R("max_unassigned_percentage", float, "max unaggregated fraction", 0.05)
    R("weight_formula", int, "pairwise weight formula", 0)
    R("aggregation_passes", int, "MULTI_PAIRWISE passes", 3)
    R("filter_weights", int, "remove weak edges before aggregation", 0)
    R("filter_weights_alpha", float, "weak-edge threshold alpha", 0.5, None, 0.0, 1.0)
    R("full_ghost_level", int, "full Galerkin for ghost level", 0)
    R("notay_weights", int, "Notay quality-measure weights", 0)
    R("ghost_offdiag_limit", int, "limit offdiagonals in ghost rows", 0)
    R("merge_singletons", int, "merge singleton aggregates", 1)
    R("serial_matching", int, "serial matching (study tool)", 0)
    R("modified_handshake", int, "modified handshake algorithm", 0)
    R("aggregate_size", int, "DUMMY selector aggregate size", 2)
    # classical strength / truncation
    R("strength", str, "strength of connection", "AHAT", ("AHAT", "ALL", "AFFINITY"))
    R("strength_threshold", float, "strength threshold", 0.25)
    R("max_row_sum", float, "weaken dependencies when row sum exceeds", 1.1)
    R("interp_truncation_factor", float, "interp truncation factor", 1.1)
    R("interp_max_elements", int, "max interp elements per row (-1 off)", -1)
    R("affinity_iterations", int, "affinity smoothing iterations", 4)
    R("affinity_vectors", int, "affinity test vectors", 4)
    # coloring
    R("coloring_level", int, "coloring distance (0=off)", 1)
    R("reorder_cols_by_color", int, "reorder columns by color", 0)
    R("insert_diag_while_reordering", int, "insert diagonal while reordering", 0)
    R("matrix_coloring_scheme", str, "coloring algorithm", "MIN_MAX")
    R("max_num_hash", int, "hash tables in min_max coloring", 7)
    R("num_colors", int, "colors for round_robin coloring", 10)
    R("max_uncolored_percentage", float, "max improperly-colored fraction", 0.15,
      None, 0.0, 1.0)
    R("initial_color", int, "initial color", 0)
    R("use_bsrxmv", int, "inert (cusparse expert API)", 0)
    R("fine_levels", int, "levels < N use fine_smoother, others "
      "coarse_smoother (-1 = no split, all use 'smoother')", -1)
    R("coloring_try_remove_last_colors", int, "try removing N last colors", 0)
    R("coloring_custom_arg", str, "custom coloring argument", "")
    R("print_coloring_info", int, "print coloring info", 0)
    R("weakness_bound", int, "min-max-2ring flexibility bound", 2**31 - 1)
    R("late_rejection", int, "late rejection in min-max-2ring", 0)
    R("geometric_dim", int, "uniform coloring dimension", 2)
    # spgemm knobs (accepted-inert)
    R("spmm_gmem_size", int, "deprecated", 1024)
    R("spmm_no_sort", int, "deprecated", 1)
    R("spmm_verbose", int, "verbose SpGEMM", 0)
    R("spmm_max_attempts", int, "inert", 6)
    R("use_opt_kernels", int, "use optimised fast-path kernels", 0)
    R("use_cusparse_spgemm", int, "inert", 0)
    R("cusparse_spgemm_alg", str, "inert", "CUSPARSE_SPGEMM_DEFAULT")
    R("cusparse_spgemm_fraction", float, "inert", 0.5)
    # stopping criteria
    R("max_iters", int, "maximum solve iterations", 100)
    R("monitor_residual", int, "compute residual every iteration", 0, BOOL01)
    R("convergence", str, "convergence criterion", "ABSOLUTE")
    R("norm", str, "norm for convergence testing", "L2", ("L1", "L2", "LMAX"))
    R("use_scalar_norm", int, "scalar norm for block matrices", 0)
    R("tolerance", float, "convergence tolerance", 1e-12)
    R("alt_rel_tolerance", float, "alternate relative tolerance (COMBINED)", 1e-12)
    R("rel_div_tolerance", float, "relative divergence tolerance (-1 off)", -1.0)
    # reporting
    R("verbosity_level", int, "output verbosity", 3)
    R("solver_verbose", int, "print solver parameters", 0)
    R("print_config", int, "print configuration", 0)
    R("print_solve_stats", int, "print per-iteration solve stats", 0)
    R("print_grid_stats", int, "print AMG hierarchy stats", 0)
    R("print_vis_data", int, "print visualization data", 0)
    R("print_aggregation_info", int, "print aggregation info", 0)
    R("obtain_timings", int, "print setup/solve timings", 0)
    R("store_res_history", int, "store residual history", 0)
    R("convergence_analysis", int, "levels to analyse", 0)
    # scaling
    R("scaling", str, "matrix scaling algorithm", "NONE",
      ("NONE", "BINORMALIZATION", "NBINORMALIZATION", "DIAGONAL_SYMMETRIC"))
    # eigensolvers (reference registers these in eigensolver registration)
    R("eig_solver", str, "eigensolver algorithm", "POWER_ITERATION")
    R("eig_max_iters", int, "eigensolver max iterations", 100)
    R("eig_tolerance", float, "eigensolver tolerance", 1e-6)
    R("eig_shift", float, "spectral shift sigma", 0.0)
    R("eig_damping_factor", float, "PageRank damping factor", 0.85)
    R("eig_which", str, "which eigenpair", "largest",
      ("smallest", "largest", "pagerank", "shift"))
    R("eig_eigenvector", int, "number of eigenvectors wanted", 0)
    R("eig_eigenvector_solver", str, "eigenvector extraction solver", "default")
    R("eig_wanted_count", int, "number of wanted eigenvalues", 1)
    R("eig_subspace_size", int, "subspace size for block/Krylov methods", -1)
    R("eig_convergence_check_freq", int, "convergence check frequency", 1)
    # port additions (the knobs of the JAX package that this port reads)
    R("tpu_dtype", str, "legacy compute-dtype override, resolved as an "
      "alias of the shared precision policy (precision.py: float64 -> "
      "double, float32 -> float, bfloat16 -> bfloat16); prefer "
      "solve_precision", "", ("", "float32", "float64", "bfloat16"))
    R("solve_precision", str, "solve-phase precision of the inner "
      "multigrid cycle (precision.py policy; owns amg_precision/"
      "tpu_dtype when set); unset ('') leaves the hierarchy in the "
      "operator's dtype", "", ("", "double", "float", "bfloat16"))
    R("fused_smoother", int, "run damped-relaxation smoother steps and "
      "the trailing cycle residual through the DIA smoother kernel "
      "(ops/smooth.py); 0 composes sweep-by-sweep SpMVs", 1, BOOL01)
    R("matrix_free", str, "matrix-free form for constant-coefficient "
      "GEO levels (ops/stencil.py): a setup-time detector replaces the "
      "level's DIA value slab with a StencilOperator (k coefficients + "
      "static geometry, O(levels) operator memory) and every fused "
      "smoother/transfer/tail kernel reads the coefficients instead of "
      "streaming the A value slab; variable-coefficient levels always "
      "keep the slab path. auto = on when the level's operator is on a "
      "CUDA device (CPU runs bit-identical to the slab build), 1 = force "
      "the detector on every device (the plain masked-coefficient forms "
      "on the CPU), 0 = never detect -- the slab path bit-for-bit",
      "auto", ("auto", "0", "1"))
    R("cycle_fusion", int, "fold the cycle's grid transfers into the "
      "smoother kernels on aggregation/DIA levels (restriction epilogue "
      "in the presmoother, prolongation+correction prologue in the "
      "postsmoother) and run the coarse tail of the hierarchy as one "
      "kernel; 0 composes smooth/restrict/prolongate per level", 1,
      BOOL01)
    R("cycle_fusion_tail_rows", int, "largest level row count admitted "
      "into the fused coarse-tail kernel (levels above it keep "
      "per-level kernels; 0 turns the tail off)", 65536, None, 0)
    R("krylov_fusion", int, "fuse the Krylov shell around the cycle on "
      "float32 DIA operators: the direction update, SpMV and p.Ap run as "
      "one kernel, the x/r updates and the monitor's r.r as a second, and "
      "PCG's r.z rides the cycle's last kernel; 0 composes the unfused "
      "SpMV and vector operations", 1, BOOL01)
    # setup placement and the Galerkin plan (the JAX package's values and
    # defaults; what each one means in the port)
    R("spgemm_plan", str, "plan-split Galerkin RAP (ops/spgemm.py): the "
      "structure phase runs once per pattern on the operator's device "
      "(memoized on the level, cached across setups), the "
      "value phase through the RAP value kernel (float32) or the plain "
      "ordered sums; 0 = the eager (R A) P composition on classical "
      "levels; aggregation levels always take the planned relabel "
      "product (the JAX package's eager `coarse_a_from_aggregates` is "
      "not ported)", "auto", ("auto", "0", "1"))
    R("setup_backend", str, "where the AMG setup runs; the port always "
      "builds the hierarchy on the operator's device (the JAX package's "
      "`device`), so every value is accepted and means that",
      "auto", ("auto", "device", "host"))
    R("amg_host_setup", str, "the JAX package's host-CPU hierarchy build "
      "for remote accelerators; accepted, inert in the port (its setup "
      "runs where the operator lives)", "auto",
      {"auto", "always", "never"})
    R("setup_device_min_rows", int, "setup_backend=device: levels below "
      "this many rows may take host fast paths in the JAX package; "
      "accepted, inert in the port", 0, None, 0)
    R("selector_device_sweep", str, "RS/HMIS first-pass implementation: "
      "auto and 0 run the host bucket queue; 1 (the JAX package's "
      "device-parallel sweep) is not ported and raises",
      "auto", ("auto", "0", "1"))
    # resilience (solve-loop status classification)
    R("health_guards", int, "NaN/breakdown guards in the solve loop "
      "(status classification rides the existing residual check; 0 "
      "restores the bare converged/diverged monitor)", 1, BOOL01)
    R("stall_detection_window", int, "flag STALLED when the residual "
      "norm fails to improve over this many iterations (0 = off)", 0,
      None, 0)
    R("stall_tolerance", float, "minimum relative residual decrease "
      "over the stall window; 0 = any non-decrease stalls", 0.0, None,
      0.0, 1.0)
    R("fallback_policy", str, "resilience chains "
      "'STATUS>action[=arg]|...' (actions: retry, rescale_retry, "
      "switch_solver=<NAME>, escalate_sweeps), applied host-side by "
      "ResilientSolver (resilience/policy.py) when a solve ends in that "
      "status; a rebuilt tree is built on the solver's device", "")
    R("max_fallback_attempts", int, "bound on total fallback/retry "
      "attempts per solve", 2, None, 0)
    # telemetry (amgx_tpu_torch/telemetry/)
    R("telemetry", int, "attach a structured SolveReport to solve "
      "results and sample the allocator's memory watermarks per phase "
      "(telemetry/report.py): built on the host from values the solve "
      "already holds, so the kernels launched and the device->host "
      "reads are the same either way; 0 skips report construction", 1,
      BOOL01)
    R("diagnostics", int, "convergence diagnostics "
      "(telemetry/diagnostics.py): after a root solve, ONE instrumented "
      "probe cycle on the final residual records per-level residual "
      "norms at the entry/post-presmooth/post-correction/post-postsmooth "
      "cycle stages (one device->host read for all of them); host-side "
      "derivation attaches per-level reduction factors, smoother "
      "effectiveness, an asymptotic convergence-factor estimate and a "
      "bottleneck-level attribution to SolveReport.diagnostics. Cost "
      "when on: about one composed cycle per solve; 0 (default) runs "
      "nothing extra", 0, BOOL01)
    R("telemetry_sync", int, "fence device work at every span boundary "
      "(telemetry/spans.py: torch.cuda.synchronize) so host spans bound "
      "device occupancy in the exported Perfetto timeline. Debugging "
      "mode. Process-wide: each create_solver latches the mode from its "
      "config, in both directions", 0, BOOL01)
    R("flightrec_dir", str, "directory for the crash-surviving flight "
      "recorder (telemetry/flightrec.py): state transitions (fallback "
      "hops, resetup routing, chaos injections) append one JSON line "
      "each, rotated and corruption-tolerant. '' = in-memory ring only "
      "(AMGX_TPU_FLIGHTREC_DIR env also attaches a directory)", "")

    # serving subsystem (amgx_tpu_torch/serving/)
    R("serving_chunk_iters", int, "continuous-batching cycle length: "
      "iterations every in-flight system advances per scheduler cycle "
      "before the service checks convergence/deadlines and refills "
      "drained bucket slots (serving/engine.py). Smaller = lower "
      "admission latency, more host syncs per solve", 8, None, 1)
    R("serving_bucket_slots", int, "in-flight systems per serving "
      "bucket: the fixed batch width of the continuous-batching engine "
      "(one set of stacked tensors serves the bucket for its lifetime; empty slots ride along "
      "converged and cost nothing)", 4, None, 1)
    R("serving_cache_bytes", int, "byte budget for the hierarchy/LRU "
      "cache of live serving buckets (solve-data footprint estimate); "
      "idle least-recently-used buckets are evicted past it. 0 = "
      "unbounded", 0, None, 0)
    R("serving_cache_entries", int, "max live serving buckets "
      "regardless of bytes (each holds a hierarchy + engine traces)",
      16, None, 1)
    R("serving_aot_dir", str, "directory of the warm-start store "
      "(serving/aot.py) keyed by (pattern fingerprint, bucket geometry, "
      "solver config): each bucket's per-slot / shared split of the "
      "solve data, its widths and the CUDA libraries it launches, so a "
      "restarted service builds a bucket without the probe resetup and "
      "loads its kernels before the first request. '' = off", "")
    R("serving_deadline_action", str, "what an expired in-flight "
      "request completes with: 'partial' = its current iterate "
      "(best-effort degrade), 'reject' = the initial/zero iterate; "
      "either way the status is DEADLINE_EXCEEDED and the bucket keeps "
      "cycling — deadlines never stall neighbors", "partial",
      ("partial", "reject"))
    R("serving_max_queue", int, "admission control: submits beyond "
      "this many queued requests complete immediately with "
      "OVERLOADED instead of growing the queue without bound "
      "(0 = unbounded)", 0, None, 0)
    # serving fault tolerance (serving/{journal,hstore}.py + the
    # recovery/shed/supervision machinery in serving/service.py)
    R("serving_journal_dir", str, "directory for the durable request "
      "journal + solve checkpoints (serving/journal.py): submits are "
      "journaled write-ahead, in-flight states checkpoint every "
      "serving_checkpoint_cycles cycles, and a restarted service "
      "replays pending records — resuming checkpointed solves from "
      "their saved iterate. '' = journaling off", "")
    R("serving_checkpoint_cycles", int, "scheduler cycles between "
      "solve-state checkpoints of journaled in-flight requests (each "
      "checkpoint is one device->host state pull + one file write per "
      "slot). 0 = journal requests but never checkpoint mid-flight",
      4, None, 0)
    R("serving_recover", int, "replay the journal at service "
      "construction (crash recovery); 0 defers to an explicit "
      "recover() call", 1, BOOL01)
    R("serving_hierarchy_dir", str, "directory persisting hierarchy "
      "STRUCTURE snapshots next to the warm-start store "
      "(serving/hstore.py): a restarted service rebuilds each "
      "bucket's hierarchy via load + structure-reuse (values only, "
      "amg.setup.restored) instead of a full multi-second coarsening. "
      "'' = off", "")
    R("serving_shed_policy", str, "load shedding beyond the hard "
      "queue bound: 'deadline' rejects requests (OVERLOADED) whose "
      "deadline the live execution-time estimate (median of recent "
      "in-bucket execs, scaled by queue-depth waves + 25% margin) "
      "says is unmeetable; '' = hard bound only",
      "", ("", "deadline"))
    R("serving_tenant_quota", int, "per-tenant fairness quota: a "
      "tenant with this many live (queued + in-flight) requests has "
      "further submits shed OVERLOADED (0 = unbounded)", 0, None, 0)
    R("serving_supervisor_cycles", int, "wedged-bucket detector: a "
      "busy bucket whose progress heartbeat (per-cycle iteration "
      "counters) flatlines for this many consecutive cycles is "
      "quarantined — salvageable slots finalize, the rest requeue. "
      "0 = supervision off", 8, None, 0)
    R("serving_fault_policy", str, "service-level failure chains "
      "'EVENT>action|...' (events: BUILD_FAILED, STEP_FAILED, WEDGED; "
      "actions: retry_backoff, requeue, reject — "
      "resilience/policy.py parse_service_policy). Multiple steps per "
      "event are tried in order across consecutive failures",
      "BUILD_FAILED>reject|STEP_FAILED>requeue|WEDGED>requeue")
    R("serving_retry_backoff_s", float, "base delay of the "
      "retry_backoff action: rebuild attempt n waits base * 2^n",
      0.05)
    R("serving_retry_max_attempts", int, "bound on per-fingerprint "
      "build/step recovery attempts; beyond it the affected tickets "
      "reject with BREAKDOWN", 3, None, 0)
    # request-path observability (telemetry/spans.py flow chains +
    # telemetry/flightrec.py)
    R("serving_tracing", int, "request-path tracing: every ticket "
      "mints a trace id and the serving pipeline emits per-lifecycle "
      "spans (submit / shed / queue / build / admit / chunk-cycle / "
      "checkpoint / finalize) tagged with it, exported as one "
      "connected Perfetto flow chain per request "
      "(spans.export_chrome_trace); the journal persists trace ids so "
      "a crash-recovered resume links its spans to the ORIGINAL "
      "trace. Host-side dict appends only; 0 restores the "
      "pre-tracing span set",
      1, BOOL01)
    R("serving_replica_id", str, "replica/shard label stamped on "
      "every OpenMetrics sample (replica=\"...\") so multi-replica "
      "scrapes don't collide — the fleet-router prerequisite. '' "
      "defers to the AMGX_REPLICA_ID env var; either is process-wide "
      "(one replica = one process)", "")
    R("serving_bucket_ladder", str, "mixed bucket-width ladder "
      "(serving/ladder.py): '|'-separated strictly-increasing slot "
      "widths (e.g. '1|4|16') the bucket builder draws from by queue "
      "composition — each BUILD uses the smallest rung seating every "
      "queued same-fingerprint request (capped at the top rung) "
      "instead of the fixed serving_bucket_slots width, cutting pad "
      "waste for singleton patterns and queue latency for bursts. "
      "Each rung keeps its own warm-start entry (slots is part of the "
      "store's key). '' = fixed width", "")
    R("autotune", int, "the online per-fingerprint config autotuner of "
      "the JAX package's serving layer; not ported yet: a SolveService "
      "with autotune=1 raises (ROADMAP.md Queue A item 11: the "
      "autotuner). 0 (default): no tuner", 0, BOOL01)

_register_default_parameters()

# ---------------------------------------------------------------------------
# AMG_Config
# ---------------------------------------------------------------------------

_FLAT_RE = re.compile(
    r"^\s*(?:(?P<scope>[A-Za-z_]\w*):)?"
    r"(?P<name>[A-Za-z_]\w*)"
    r"(?:\((?P<new_scope>[A-Za-z_]\w*)\))?"
    r"\s*=\s*(?P<value>.*?)\s*$")


@dataclass
class Config:
    """Scoped parameter store (AMG_Config analog).

    Values live in `values[(scope, name)]`; solver-role parameters may have
    an attached child scope in `param_scopes[(scope, name)]`.
    """

    values: Dict[Tuple[str, str], Any] = field(default_factory=dict)
    param_scopes: Dict[Tuple[str, str], str] = field(default_factory=dict)

    # -- parsing ----------------------------------------------------------
    @classmethod
    def from_string(cls, options: str) -> "Config":
        cfg = cls()
        cfg.parse_parameter_string(options)
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            text = f.read()
        cfg = cls()
        stripped = text.lstrip()
        if stripped.startswith("{"):
            cfg.parse_json(json.loads(text))
        else:
            cfg.parse_parameter_string(text)
        return cfg

    @classmethod
    def from_dict(cls, obj: dict) -> "Config":
        cfg = cls()
        cfg.parse_json(obj)
        return cfg

    def parse_parameter_string(self, options: str):
        """Parse flat `scope:name(new_scope)=value` items separated by
        ',', ';' or newlines (reference: AMG_Config::parseParameterString)."""
        if not options:
            return
        for item in re.split(r"[,;\n]+", options):
            item = item.strip()
            if not item or item.startswith("#") or item.startswith("%"):
                continue
            if item.startswith("config_version"):
                continue
            if item.split("=", 1)[0].strip().endswith(":config_version"):
                continue  # scoped spelling (eigen_configs/JACOBI_DAVIDSON)
            m = _FLAT_RE.match(item)
            if not m:
                raise BadConfigurationError(f"cannot parse config entry {item!r}")
            scope = m.group("scope") or "default"
            name = m.group("name")
            new_scope = m.group("new_scope")
            self._set(scope, name, m.group("value"), new_scope)

    def parse_json(self, obj: dict):
        """Import a config_version-2 JSON object: nested solver objects
        create scopes (reference: include/amg_config.h:144-269)."""
        version = obj.get("config_version", 1)
        if version not in (1, 2):
            raise BadConfigurationError(f"unsupported config_version {version}")
        for key, val in obj.items():
            if key == "config_version":
                continue
            if isinstance(val, dict):
                self._import_json_solver(key, val, "default")
            else:
                self._set("default", key, val, None)

    def _import_json_solver(self, role: str, obj: dict, parent_scope: str):
        child_scope = obj.get("scope", role)
        if "solver" not in obj:
            raise BadConfigurationError(
                f"JSON solver object {role!r} missing 'solver' key")
        # bind role -> (algorithm, child scope) in the parent scope
        self._set(parent_scope, role, obj["solver"], child_scope)
        for key, val in obj.items():
            if key in ("scope", "solver"):
                continue
            if isinstance(val, dict):
                self._import_json_solver(key, val, child_scope)
            else:
                self._set(child_scope, key, val, None)

    # -- set/get ----------------------------------------------------------
    def _convert(self, desc: ParamDesc, value: Any) -> Any:
        if desc.type is int:
            v = int(value)
        elif desc.type is float:
            v = float(value)
        elif desc.type is str:
            v = str(value)
        else:
            v = desc.type(value)
        if desc.allowed is not None and v not in desc.allowed:
            # string enums are case-tolerant in the reference
            if isinstance(v, str) and v.upper() in desc.allowed:
                v = v.upper()
            elif isinstance(v, str) and v.lower() in desc.allowed:
                v = v.lower()
            else:
                raise BadConfigurationError(
                    f"value {v!r} not allowed for parameter {desc.name!r} "
                    f"(allowed: {desc.allowed})")
        if desc.min_value is not None and v < desc.min_value:
            raise BadConfigurationError(
                f"value {v!r} below minimum {desc.min_value} for {desc.name!r}")
        if desc.max_value is not None and desc.max_value != 0 and v > desc.max_value:
            raise BadConfigurationError(
                f"value {v!r} above maximum {desc.max_value} for {desc.name!r}")
        return v

    def _set(self, scope: str, name: str, value: Any, new_scope: Optional[str]):
        desc = _REGISTRY.get(name)
        if desc is None:
            from .errors import did_you_mean
            raise BadConfigurationError(
                f"unknown parameter {name!r}"
                f"{did_you_mean(name, _REGISTRY)}")
        self.values[(scope, name)] = self._convert(desc, value)
        if new_scope:
            if name not in SOLVER_ROLE_PARAMS:
                raise BadConfigurationError(
                    f"parameter {name!r} cannot declare a new scope")
            self.param_scopes[(scope, name)] = new_scope

    def set(self, name: str, value: Any, scope: str = "default",
            new_scope: Optional[str] = None):
        self._set(scope, name, value, new_scope)

    def get(self, name: str, scope: str = "default") -> Any:
        """Scoped lookup with fallback scope -> default -> registered default
        (reference: getParameter, include/amg_config.h:186)."""
        if (scope, name) in self.values:
            return self.values[(scope, name)]
        if ("default", name) in self.values:
            return self.values[("default", name)]
        desc = _REGISTRY.get(name)
        if desc is None:
            from .errors import did_you_mean
            raise BadParametersError(
                f"unknown parameter {name!r}"
                f"{did_you_mean(name, _REGISTRY)}")
        return desc.default

    def get_scope(self, name: str, scope: str = "default") -> str:
        """The child scope bound to a solver-role parameter at `scope`
        (defaults to 'default' when the parameter was set without one)."""
        if (scope, name) in self.param_scopes:
            return self.param_scopes[(scope, name)]
        if (scope, name) in self.values:
            return "default"
        if ("default", name) in self.param_scopes:
            return self.param_scopes[("default", name)]
        return "default"

    def get_solver(self, role: str, scope: str = "default") -> Tuple[str, str]:
        """Return (algorithm_name, child_scope) for a solver-role param."""
        return str(self.get(role, scope)), self.get_scope(role, scope)

    def clone(self) -> "Config":
        return Config(dict(self.values), dict(self.param_scopes))

    def __repr__(self):
        items = ", ".join(f"{s}:{n}={v!r}" for (s, n), v in sorted(self.values.items()))
        return f"Config({items})"

