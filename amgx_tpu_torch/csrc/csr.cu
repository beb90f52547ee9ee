// Unstructured (CSR) SpMV and damped-Jacobi sweep kernels for Hopper
// (sm_90a): the CUDA counterparts of the Pallas TPU kernels B8
// `_swell_spmv_call` and B9 `_swell_smooth_call`
// (amgx_tpu/ops/pallas_swell.py), bound through a plain C interface
// (ctypes, amgx_tpu_torch/ops/cuda_csr.py). Each entry point launches ONE
// kernel on the caller's stream and returns cudaGetLastError().
//
// Storage: plain CSR, float32 values and int32 row offsets / columns, as
// CsrMatrix holds them. The TPU kernels read a windowed-ELL (SWELL) slab
// and emulate the gather with 128-lane take_along_axis inside DMA'd x
// windows; Hopper gathers natively, so none of that is carried over.
//
// What bounds them on an H100: memory. A stored entry costs 8 bytes
// (value + column) and a gathered x read for one multiply-add. A row is
// walked by `lanes` consecutive lanes of a warp (1, 2, 4, ..., 32),
// chosen per matrix at CsrMatrix.init() from the mean row length: one
// thread per row for short rows (interpolation P holds at most
// interp_max_elements entries per row), a few lanes for the coarse
// classical operators and R (tens of entries per row), so a warp keeps
// several rows' loads in flight instead of idling lanes or waiting on
// one row's chain of dependent loads. The lanes combine by a fixed
// shuffle tree and x is read through the read-only path (__ldg). Each
// row's sum has a fixed order, so the result is deterministic.
//
// B9 is B8's traversal with the damped-Jacobi epilogue
// x'_i = x_i + (tau * (b_i - (A x)_i)) * dinv_i, written to a fresh
// buffer because neighbouring rows read the old x; tau is read from a
// device array (the smoother's damping schedule) at index t.
#include "common.cuh"

namespace {

struct Csr {
  const int* __restrict__ ro;
  const int* __restrict__ ci;
  const float* __restrict__ v;
};

// The damped step's operands; taus == nullptr means a plain product.
struct Step {
  const float* __restrict__ x;
  const float* __restrict__ b;
  const float* __restrict__ dinv;
  const float* __restrict__ taus;
  int t;
};

template <bool kSmooth>
__device__ __forceinline__ float epilogue(const Step& s, int i, float ax) {
  if (!kSmooth) return ax;
  float upd = s.taus[s.t] * (s.b[i] - ax);
  if (s.dinv != nullptr) upd *= s.dinv[i];
  return s.x[i] + upd;
}

// kLanes consecutive lanes of a warp share a row (1: one thread per row,
// 32: one warp per row); each lane strides the row by kLanes and the
// lanes combine by a fixed shuffle tree, so every row sums in one order.
template <int kLanes, bool kSmooth>
__global__ void __launch_bounds__(kThreads)
csr_kernel(Csr a, const float* __restrict__ x, float* __restrict__ y, int n,
           Step s) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int i = static_cast<int>(t / kLanes);
  const int lane = static_cast<int>(t % kLanes);
  // a row's kLanes lanes sit aligned in one warp and share i: they leave
  // together, and the shuffle mask names only lanes that stay
  if (i >= n) return;
  float acc = 0.0f;
  const int e1 = a.ro[i + 1];
  for (int e = a.ro[i] + lane; e < e1; e += kLanes)
    acc += a.v[e] * __ldg(x + a.ci[e]);
  const unsigned mask =
      kLanes == 32 ? 0xffffffffu
                   : ((1u << kLanes) - 1u) << ((threadIdx.x & 31) &
                                                ~(kLanes - 1));
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc += __shfl_down_sync(mask, acc, o, kLanes);
  if (lane == 0) y[i] = epilogue<kSmooth>(s, i, acc);
}

template <int kLanes, bool kSmooth>
void launch_lanes(const Csr& a, const float* x, float* y, int n,
                  const Step& s, cudaStream_t stream) {
  const long long threads = static_cast<long long>(kLanes) * n;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  csr_kernel<kLanes, kSmooth><<<blocks, kThreads, 0, stream>>>(a, x, y, n, s);
}

template <bool kSmooth>
int launch(const Csr& a, const float* x, float* y, int n, int lanes,
           const Step& s, cudaStream_t stream) {
  switch (lanes) {
    case 1: launch_lanes<1, kSmooth>(a, x, y, n, s, stream); break;
    case 2: launch_lanes<2, kSmooth>(a, x, y, n, s, stream); break;
    case 4: launch_lanes<4, kSmooth>(a, x, y, n, s, stream); break;
    case 8: launch_lanes<8, kSmooth>(a, x, y, n, s, stream); break;
    case 16: launch_lanes<16, kSmooth>(a, x, y, n, s, stream); break;
    case 32: launch_lanes<32, kSmooth>(a, x, y, n, s, stream); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B8: y = A x over n rows, `lanes` (1, 2, 4, ..., 32) lanes per row.
int amgx_csr_spmv(const int* ro, const int* ci, const float* vals,
                  const float* x, float* y, int n, int lanes,
                  cudaStream_t stream) {
  if (n < 1) return -1;
  return launch<false>(Csr{ro, ci, vals}, x, y, n, lanes,
                       Step{nullptr, nullptr, nullptr, nullptr, 0}, stream);
}

// B9: out = x + (taus[t] * (b - A x)) * dinv (dinv optional), one sweep;
// out must not alias x.
int amgx_csr_step(const int* ro, const int* ci, const float* vals,
                  const float* x, const float* b, const float* dinv,
                  const float* taus, int t, float* out, int n, int lanes,
                  cudaStream_t stream) {
  if (n < 1 || taus == nullptr || b == nullptr || out == x) return -1;
  return launch<true>(Csr{ro, ci, vals}, x, out, n, lanes,
                      Step{x, b, dinv, taus, t}, stream);
}

}  // extern "C"
