// The temporally blocked slab B2, B3 and B4 (stencil_tb.cuh): the C entry of
// the slab forms, the rows' values and dinv read from the level's stored
// (7, n) slab through the per-column ring (ops/cuda_spmv.py
// `_tb_launch`). Arguments as `tb_smooth`; x may be a split call's
// float32 state.
#include "stencil_tb.cuh"

extern "C" {

int amgx_tb_smooth_slab(
    const void* stencil, const void* geom, int k, const void* vals,
    const void* dinv, const float* taus, const void* b, const void* x,
    int x_f32, const void* xc, const int* agg, void* out, float* keep,
    const int* ctab, int m, int nc, const int* rows, const int* roff,
    void* resid, int r_bf16, void* bc, float* partials,
    unsigned int* counter, float* dot, int n, int blocks, int smem,
    int bf16_io, cudaStream_t stream) {
  return tb_smooth<kTbRing>(
      stencil, geom, k, vals, dinv, taus, b, x, x_f32, xc, agg, out, keep,
      ctab, m, nc, rows, roff, resid, r_bf16, bc, partials, counter, dot, n,
      blocks, smem, bf16_io, stream);
}

}  // extern "C"
