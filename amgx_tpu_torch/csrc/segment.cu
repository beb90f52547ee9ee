// K8: the ordered segment sum for Hopper (sm_90a), bound through a plain C
// interface (ctypes, amgx_tpu_torch/ops/segment.py `ordered_sum`). It
// replaces no Pallas kernel: the JAX package sums sorted segments with
// XLA's `jax.ops.segment_sum(..., indices_are_sorted=True)` (the CSR
// product of amgx_tpu/ops/spmv.py, the Galerkin values of ops/spgemm.py),
// one device program a call. The port's plain form adds position j of
// every segment in one gather-add, as many steps as the longest segment
// (three launches a step): on a coarse level whose rows hold a thousand
// entries, a thousand steps a product, which made the setup's ordered
// sums launch-bound on the card.
//
// out[s] = ((0 + v[start_s]) + v[start_s + 1]) + ... in stored order: the
// plain form's additions, one at a time in the value's type, so the bits
// are the plain form's (and the CPU's) on every run. One thread a
// segment; the segments come longest first (the plan's order), so the
// long ones share the first warps. Nothing is atomic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <class T>
__global__ void __launch_bounds__(kThreads)
ordered_sum_kernel(const T* __restrict__ v, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ first,
                   const int64_t* __restrict__ length, T* __restrict__ out,
                   int64_t nseg) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nseg) return;
  const T* p = v + first[i];
  const int64_t len = length[i];
  T acc = 0;
  for (int64_t j = 0; j < len; ++j) acc += p[j];
  out[order[i]] = acc;
}

template <class T>
int launch(const T* v, const int64_t* order, const int64_t* first,
           const int64_t* length, T* out, int64_t nseg, cudaStream_t stream) {
  if (nseg < 0) return -1;
  if (nseg == 0) return 0;
  const int64_t blocks = (nseg + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  ordered_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(v, order, first, length, out, nseg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (nseg,) = the ordered sum of each segment of v: segment order[i]
// starts at first[i] and holds length[i] values (the plan of
// ops/segment.py `ordered_sum_plan`).
int amgx_ordered_sum_f32(const float* v, const int64_t* order,
                         const int64_t* first, const int64_t* length,
                         float* out, int64_t nseg, cudaStream_t stream) {
  return launch<float>(v, order, first, length, out, nseg, stream);
}

int amgx_ordered_sum_f64(const double* v, const int64_t* order,
                         const int64_t* first, const int64_t* length,
                         double* out, int64_t nseg, cudaStream_t stream) {
  return launch<double>(v, order, first, length, out, nseg, stream);
}

}  // extern "C"
