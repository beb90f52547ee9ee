// K6: one serial Gauss-Seidel sweep for Hopper (sm_90a), bound through a
// plain C interface (ctypes, amgx_tpu_torch/ops/gs.py). It replaces no
// TPU kernel: the JAX package's GS smoother (amgx_tpu/solvers/
// multicolor.py `GSSolver.solve_iteration`) is one `lax.fori_loop` over
// the rows, which XLA compiles into a device loop. In PyTorch each row
// would be about three launches; this is the whole sweep in one.
//
// Row i in natural order, on x updated in place:
//   dot  = sum_j a_ij x_j                (the row as stored, a_ii included)
//   x_i <- (1 - w) x_i + w dinv_i (b_i - dot + d_i x_i)
// with d the diagonal or its L1-strengthened form (GS_L1_variant) and
// dinv = 1 / d (0 where d = 0), the JAX package's expression.
//
// What bounds it: the chain of n dependent rows (row i reads x_j of rows
// j < i written just before), not bytes or operations: the bytes bound
// (the matrix, b, d, dinv read once, x read and written once) is
// microseconds, the chain is n times one row's latency. Design: one warp.
// Its lanes load a row's entries side by side (lane l takes entries l,
// l + 32, ... in stored order), the partial sums meet in a fixed xor
// butterfly (the same order every run), lane 0 writes x_i, and
// __syncwarp orders that write before the next row's reads. Nothing is
// atomic: the same bits on every run.
#include <cuda_runtime.h>

namespace {

template <class T>
__global__ void __launch_bounds__(32)
gs_sweep_kernel(const int* __restrict__ ro, const int* __restrict__ ci,
                const T* __restrict__ vals, const T* __restrict__ b,
                const T* __restrict__ d, const T* __restrict__ dinv, T* x,
                int n, T w) {
  const int lane = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    const int e0 = __ldg(ro + i), e1 = __ldg(ro + i + 1);
    T s = 0;
    for (int e = e0 + lane; e < e1; e += 32) s += __ldg(vals + e) * x[__ldg(ci + e)];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const T xi = x[i];
      const T xn = __ldg(dinv + i) * (__ldg(b + i) - s + __ldg(d + i) * xi);
      x[i] = (T(1) - w) * xi + w * xn;
    }
    __syncwarp();
  }
}

template <class T>
int launch(const int* ro, const int* ci, const T* vals, const T* b,
           const T* d, const T* dinv, T* x, int n, double w,
           cudaStream_t stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  gs_sweep_kernel<T><<<1, 32, 0, stream>>>(ro, ci, vals, b, d, dinv, x, n,
                                           static_cast<T>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One sweep over the n rows of the CSR matrix (ro, ci, vals), x updated
// in place.
int amgx_gs_sweep_f32(const int* ro, const int* ci, const float* vals,
                      const float* b, const float* d, const float* dinv,
                      float* x, int n, double w, cudaStream_t stream) {
  return launch<float>(ro, ci, vals, b, d, dinv, x, n, w, stream);
}

int amgx_gs_sweep_f64(const int* ro, const int* ci, const double* vals,
                      const double* b, const double* d, const double* dinv,
                      double* x, int n, double w, cudaStream_t stream) {
  return launch<double>(ro, ci, vals, b, d, dinv, x, n, w, stream);
}

}  // extern "C"
