// K7: the batched QR patch solve for Hopper (sm_90a), bound through a
// plain C interface (ctypes, amgx_tpu_torch/ops/dense.py). It replaces no
// TPU kernel: the JAX package solves the energy-minimization patches
// (amgx_tpu/amg/energymin/__init__.py, `EMInterpolator.generate`) with
// one batched `jnp.linalg.qr` + `solve_triangular` (amgx_tpu/ops/dense.py
// `solve_qr`), which XLA compiles. On the card the same batch is 10^5 -
// 10^6 patches of k <= 6 at 128^3, and PyTorch's CUDA `linalg.qr` forms
// Q patch by patch; this kernel runs the whole batch in one launch.
//
// Each patch: x = A^{-1} b by Householder QR in LAPACK's convention
// (dlarfg: beta = -sign(alpha) |(alpha, x)|, tau = (beta - alpha) / beta,
// v = x / (alpha - beta), no reflection where the column below the
// diagonal is zero), applying each reflector to b as it goes (Q is never
// formed), then back substitution R x = Q^T b. A singular patch (a zero
// pivot) divides by zero and gives a non-finite x, as the plain version
// does; the caller decides what to do with it.
//
// What bounds it on an H100: memory at small k. A patch is read once
// (k^2 + k values) and written once (k values), against ~4/3 k^3 + 2 k^2
// operations; at k = 6 that is ~2 flop/byte in f64, far below the card's
// balance. Design: one thread per patch. A block stages its patches in
// shared memory, interleaved (element e of patch p at s[e * threads + p],
// so the threads of a warp touch consecutive words: no bank conflict),
// with coalesced copies in and out (a block's patches are contiguous in
// A, b and x). The block has at most 128 threads and takes at most 48 KB
// of shared memory; the wrapper picks the threads from k
// (`dense.qr_threads`). A patch too wide for 32 threads to share 48 KB
// (k above 13 in f64, 19 in f32) takes the global route: the same
// arithmetic on a workspace interleaved across the batch (element e of
// patch p at work[e * nb + p]), so the threads' accesses coalesce there
// too.
// Nothing is atomic: the result is the same bits on every run.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Element e of one patch at base[e * stride].
template <class T>
struct Strided {
  T* base;
  size_t stride;
  __device__ __forceinline__ T& operator[](size_t e) const {
    return base[e * stride];
  }
};

// a: the k x k patch, row-major (a[i * k + j]); y: the right-hand side,
// which holds x on exit.
template <class T>
__device__ void qr_solve_patch(Strided<T> a, Strided<T> y, int k) {
  for (int j = 0; j < k; ++j) {
    const size_t jj = static_cast<size_t>(j) * k + j;
    const T alpha = a[jj];
    T xnorm2 = 0;
    for (int i = j + 1; i < k; ++i) {
      const T v = a[static_cast<size_t>(i) * k + j];
      xnorm2 += v * v;
    }
    if (xnorm2 == T(0)) continue;  // H = I; R[j][j] = alpha
    const T beta = -copysign(hypot(alpha, sqrt(xnorm2)), alpha);
    const T tau = (beta - alpha) / beta;
    const T scal = T(1) / (alpha - beta);
    for (int i = j + 1; i < k; ++i) a[static_cast<size_t>(i) * k + j] *= scal;
    a[jj] = beta;
    // H = I - tau v v^T (v_j = 1) on the columns right of j and on y
    for (int c = j + 1; c < k; ++c) {
      T s = a[static_cast<size_t>(j) * k + c];
      for (int i = j + 1; i < k; ++i)
        s += a[static_cast<size_t>(i) * k + j] * a[static_cast<size_t>(i) * k + c];
      s *= tau;
      a[static_cast<size_t>(j) * k + c] -= s;
      for (int i = j + 1; i < k; ++i)
        a[static_cast<size_t>(i) * k + c] -= s * a[static_cast<size_t>(i) * k + j];
    }
    T s = y[j];
    for (int i = j + 1; i < k; ++i) s += a[static_cast<size_t>(i) * k + j] * y[i];
    s *= tau;
    y[j] -= s;
    for (int i = j + 1; i < k; ++i) y[i] -= s * a[static_cast<size_t>(i) * k + j];
  }
  // R x = Q^T b
  for (int i = k - 1; i >= 0; --i) {
    T s = y[i];
    for (int c = i + 1; c < k; ++c) s -= a[static_cast<size_t>(i) * k + c] * y[c];
    y[i] = s / a[static_cast<size_t>(i) * k + i];
  }
}

template <class T>
__global__ void __launch_bounds__(128)
qr_staged_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ X, int nb, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  const int tpb = blockDim.x;
  const size_t kk = static_cast<size_t>(k) * k;
  T* sy = sa + kk * tpb;
  const int first = blockIdx.x * tpb;
  const int here = min(tpb, nb - first);
  const T* Ab = A + static_cast<size_t>(first) * kk;
  for (size_t idx = threadIdx.x; idx < static_cast<size_t>(here) * kk;
       idx += tpb) {
    const size_t p = idx / kk;
    sa[(idx - p * kk) * tpb + p] = Ab[idx];
  }
  const T* Bb = B + static_cast<size_t>(first) * k;
  for (size_t idx = threadIdx.x; idx < static_cast<size_t>(here) * k;
       idx += tpb) {
    const size_t p = idx / k;
    sy[(idx - p * k) * tpb + p] = Bb[idx];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < here)
    qr_solve_patch(Strided<T>{sa + threadIdx.x, static_cast<size_t>(tpb)},
                   Strided<T>{sy + threadIdx.x, static_cast<size_t>(tpb)}, k);
  __syncthreads();
  T* Xb = X + static_cast<size_t>(first) * k;
  for (size_t idx = threadIdx.x; idx < static_cast<size_t>(here) * k;
       idx += tpb) {
    const size_t p = idx / k;
    Xb[idx] = sy[(idx - p * k) * tpb + p];
  }
}

template <class T>
__global__ void __launch_bounds__(128)
qr_global_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ X, T* __restrict__ work, int nb, int k) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nb) return;
  const size_t kk = static_cast<size_t>(k) * k;
  const size_t stride = static_cast<size_t>(nb);
  Strided<T> a{work + p, stride};
  Strided<T> y{work + kk * stride + p, stride};
  const T* Ap = A + static_cast<size_t>(p) * kk;
  for (size_t e = 0; e < kk; ++e) a[e] = Ap[e];
  for (int e = 0; e < k; ++e) y[e] = B[static_cast<size_t>(p) * k + e];
  qr_solve_patch(a, y, k);
  for (int e = 0; e < k; ++e) X[static_cast<size_t>(p) * k + e] = y[e];
}

template <class T>
int launch(const T* A, const T* B, T* X, T* work, int nb, int k, int threads,
           cudaStream_t stream) {
  if (nb < 0 || k < 1) return -1;
  if (nb == 0) return 0;
  if (threads > 0) {
    if (threads > 128) return -1;
    const size_t smem =
        (static_cast<size_t>(k) * k + k) * threads * sizeof(T);
    if (smem > 48 * 1024) return -1;
    const int blocks = (nb + threads - 1) / threads;
    qr_staged_kernel<T><<<blocks, threads, smem, stream>>>(A, B, X, nb, k);
  } else {
    if (work == nullptr) return -1;
    qr_global_kernel<T><<<(nb + 127) / 128, 128, 0, stream>>>(A, B, X, work,
                                                               nb, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x[p] = A[p]^{-1} b[p] for nb row-major k x k patches A (nb, k, k) and
// right-hand sides b (nb, k); x (nb, k). threads > 0: the staged route
// with that many threads a block (at most 128, at most 48 KB of shared
// memory); 0: the global route on `work` ((k * k + k) * nb elements).
int amgx_qr_solve_f32(const float* A, const float* B, float* X, float* work,
                      int nb, int k, int threads, cudaStream_t stream) {
  return launch<float>(A, B, X, work, nb, k, threads, stream);
}

int amgx_qr_solve_f64(const double* A, const double* B, double* X,
                      double* work, int nb, int k, int threads,
                      cudaStream_t stream) {
  return launch<double>(A, B, X, work, nb, k, threads, stream);
}

}  // extern "C"
