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
//
// The bfloat16 forms (a bf16 hierarchy's CSR levels, `amg_precision=
// bfloat16`): the values, x, b, dinv and the output are bf16, widened on
// load; the products, the row sum and the update are float32 in the
// float32 kernels' order, and the output is rounded once at its store.
// B9 in bf16 is the TPU kernel's bf16 form (`swell_smooth_supported`
// takes bf16 value slabs): it computes in f32 and rounds x' to the
// vector dtype after every sweep (`swell_smooth_step`), so each sweep's
// x' is bf16 -- unlike the DIA kernels, whose state stays f32 between
// steps. B8 in bf16 is not a TPU kernel (`swell_spmv_supported` is
// float32 only): it computes the XLA op the JAX package compiles in its
// place, `swell_spmv_xla` on bf16 operands, whose fused gather-multiply-
// reduce sums the exact products in f32 and rounds the sum once (a bf16
// CSR level's trailing residual, classical R r and P xc). Bound by
// bytes: a stored entry streams 6 bytes (bf16 value + int32 column)
// against float32's 8; x, b, dinv and x' 2 bytes each.
#include "common.cuh"

namespace {

template <class T>
struct Csr {
  const int* __restrict__ ro;
  const int* __restrict__ ci;
  const T* __restrict__ v;
};

// The damped step's operands; taus == nullptr means a plain product.
template <class T>
struct Step {
  const T* __restrict__ x;
  const T* __restrict__ b;
  const T* __restrict__ dinv;
  const float* __restrict__ taus;
  int t;
};

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) {
  return __bfloat162float(__ldg(p));
}

template <class T, bool kSmooth>
__device__ __forceinline__ float epilogue(const Step<T>& s, int i,
                                          float ax) {
  if (!kSmooth) return ax;
  float upd = s.taus[s.t] * (ld(s.b, i) - ax);
  if (s.dinv != nullptr) upd *= ld(s.dinv, i);
  return ld(s.x, i) + upd;
}

// kLanes consecutive lanes of a warp share a row (1: one thread per row,
// 32: one warp per row); each lane strides the row by kLanes and the
// lanes combine by a fixed shuffle tree, so every row sums in one order.
// T is the storage type of the values and vectors; the sums are float32.
template <class T, int kLanes, bool kSmooth>
__global__ void __launch_bounds__(kThreads)
csr_kernel(Csr<T> a, const T* __restrict__ x, T* __restrict__ y, int n,
           Step<T> s) {
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
    acc += ld(a.v, e) * ldg(x + a.ci[e]);
  const unsigned mask =
      kLanes == 32 ? 0xffffffffu
                   : ((1u << kLanes) - 1u) << ((threadIdx.x & 31) &
                                                ~(kLanes - 1));
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc += __shfl_down_sync(mask, acc, o, kLanes);
  if (lane == 0) st(y, i, epilogue<T, kSmooth>(s, i, acc));
}

template <class T, int kLanes, bool kSmooth>
void launch_lanes(const Csr<T>& a, const T* x, T* y, int n, const Step<T>& s,
                  cudaStream_t stream) {
  const long long threads = static_cast<long long>(kLanes) * n;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  csr_kernel<T, kLanes, kSmooth><<<blocks, kThreads, 0, stream>>>(a, x, y, n,
                                                                  s);
}

template <class T, bool kSmooth>
int launch(const Csr<T>& a, const T* x, T* y, int n, int lanes,
           const Step<T>& s, cudaStream_t stream) {
  switch (lanes) {
    case 1: launch_lanes<T, 1, kSmooth>(a, x, y, n, s, stream); break;
    case 2: launch_lanes<T, 2, kSmooth>(a, x, y, n, s, stream); break;
    case 4: launch_lanes<T, 4, kSmooth>(a, x, y, n, s, stream); break;
    case 8: launch_lanes<T, 8, kSmooth>(a, x, y, n, s, stream); break;
    case 16: launch_lanes<T, 16, kSmooth>(a, x, y, n, s, stream); break;
    case 32: launch_lanes<T, 32, kSmooth>(a, x, y, n, s, stream); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int spmv_as(const int* ro, const int* ci, const void* vals, const void* x,
            void* y, int n, int lanes, cudaStream_t stream) {
  return launch<T, false>(Csr<T>{ro, ci, static_cast<const T*>(vals)},
                          static_cast<const T*>(x), static_cast<T*>(y), n,
                          lanes, Step<T>{nullptr, nullptr, nullptr, nullptr, 0},
                          stream);
}

template <class T>
int step_as(const int* ro, const int* ci, const void* vals, const void* x,
            const void* b, const void* dinv, const float* taus, int t,
            void* out, int n, int lanes, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  return launch<T, true>(Csr<T>{ro, ci, static_cast<const T*>(vals)}, xt,
                         static_cast<T*>(out), n, lanes,
                         Step<T>{xt, static_cast<const T*>(b),
                                 static_cast<const T*>(dinv), taus, t},
                         stream);
}

}  // namespace

extern "C" {

// B8: y = A x over n rows, `lanes` (1, 2, 4, ..., 32) lanes per row; with
// `bf16_io` set the values, x and y are bfloat16 (the products and the
// sum float32, y rounded once).
int amgx_csr_spmv(const int* ro, const int* ci, const void* vals,
                  const void* x, void* y, int n, int lanes, int bf16_io,
                  cudaStream_t stream) {
  if (n < 1) return -1;
  return bf16_io ? spmv_as<bf16>(ro, ci, vals, x, y, n, lanes, stream)
                 : spmv_as<float>(ro, ci, vals, x, y, n, lanes, stream);
}

// B9: out = x + (taus[t] * (b - A x)) * dinv (dinv optional), one sweep;
// out must not alias x. With `bf16_io` set the values, x, b, dinv and
// out are bfloat16 (taus float32, the products and sums float32), out
// rounded once.
int amgx_csr_step(const int* ro, const int* ci, const void* vals,
                  const void* x, const void* b, const void* dinv,
                  const float* taus, int t, void* out, int n, int lanes,
                  int bf16_io, cudaStream_t stream) {
  if (n < 1 || taus == nullptr || b == nullptr || out == x) return -1;
  return bf16_io ? step_as<bf16>(ro, ci, vals, x, b, dinv, taus, t, out, n,
                                 lanes, stream)
                 : step_as<float>(ro, ci, vals, x, b, dinv, taus, t, out, n,
                                  lanes, stream);
}

}  // extern "C"
