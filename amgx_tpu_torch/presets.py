"""Named solver presets (copies of amgx_tpu/presets.py's FLAGSHIP and
BATCHED_CG).

FLAGSHIP is the configuration the JAX package's benchmarks and driver
entry use: full f64 accuracy via defect correction (REFINEMENT) around
an f32 FGMRES + GEO-aggregation AMG V-cycle with Chebyshev-polynomial
smoothing.

FLAGSHIP_TAIL_OFF is FLAGSHIP with the fused coarse-tail kernel (B5)
switched off through its own knob: every level then runs the per-level
smoother/transfer kernels and the coarsest level the dense solve -- the
same arithmetic the tail performs in one launch.
"""

FLAGSHIP = (
    "solver=REFINEMENT, max_iters=20, monitor_residual=1, tolerance=1e-8,"
    " convergence=RELATIVE_INI, norm=L2,"
    " preconditioner(in)=FGMRES, in:max_iters=60, in:monitor_residual=1,"
    " in:tolerance=1e-6, in:gmres_n_restart=10, in:convergence=RELATIVE_INI,"
    " in:norm=L2, in:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION,"
    " amg:selector=GEO, amg:smoother=CHEBYSHEV_POLY,"
    " amg:chebyshev_polynomial_order=2, amg:presweeps=1, amg:postsweeps=1,"
    " amg:max_iters=1, amg:cycle=V, amg:max_levels=50,"
    " amg:min_coarse_rows=32")

FLAGSHIP_TAIL_OFF = FLAGSHIP + ", amg:cycle_fusion_tail_rows=0"

# The batched-solve preset (amgx_tpu_torch/batch/): CG + aggregation-AMG
# V-cycle with Jacobi-L1 smoothing, every value-derived piece in the
# solve data; structure_reuse_levels=-1 is load-bearing -- multi-matrix
# batches reuse ONE hierarchy structure and splice per-system values
# through resetup, and the request batcher assumes a resetup never
# re-coarsens.
BATCHED_CG = (
    "solver(s)=PCG, s:max_iters=100, s:tolerance=1e-8,"
    " s:convergence=RELATIVE_INI, s:norm=L2, s:monitor_residual=1,"
    " s:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION,"
    " amg:selector=SIZE_2, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1,"
    " amg:presweeps=1, amg:postsweeps=1, amg:cycle=V, amg:max_iters=1,"
    " amg:coarse_solver=DENSE_LU_SOLVER, amg:min_coarse_rows=32,"
    " amg:max_levels=20, amg:structure_reuse_levels=-1")
