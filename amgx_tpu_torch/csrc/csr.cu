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
// The batched forms (K3, K4: a batched solve's CSR levels) are these two
// kernels with grid.y over the systems: system s reads its values at
// v + s * stride (stride 0: a shared matrix, multi-RHS; the systems'
// blocks then read the same values, from L2 after the first) and its
// vectors at s times their length, so its row sums and updates are the
// single launch's, bit for bit. A single launch is system 0 of one.
//
// B8's kernel also computes B3w's restriction (ops/cuda_spmv.py
// `dia_smooth_restrict` with weights): bc = R r over R's compact rows,
// r = b - A x' stored once per fine row in float32 by dia.cu's residual
// kernel, so each residual is computed once and not once for each of the
// ~3 coarse rows whose child it is. Products rounded, then added in entry
// order (B8's rounding and the plain form's, `restrict_plain`).
//
// What bounds them on an H100: memory. A stored entry costs 8 bytes
// (value + column) and a gathered x read for one multiply-add; x itself
// (a coarse level's, a few MB) stays in L2.
//
// B8, row blocks staged through shared memory (the CSR-stream idea of
// Greathouse & Daga's CSR-Adaptive): a table built once per matrix
// structure (ops/cuda_csr.py `csr_row_blocks`) cuts the rows into blocks
// of consecutive rows whose entries fit kChunk. One CUDA block per row
// block streams the block's values and columns with coalesced loads (each
// thread kChunk / kThreads independent entries, so their x gathers are in
// flight together), writes each product v * x[col], rounded to float32,
// into shared memory, and then each thread adds one row's products in the
// row's stored order. A row of more than kLongRow entries has a row block
// of its own: the block's threads each add a strided share of its
// products, and a fixed tree (block_sum) adds the shares. Every row sums
// in one fixed order: the result is deterministic, without atomics.
//
// B9 walks a row with `lanes` consecutive lanes of a warp (1, 2, 4, ...,
// 32), chosen per matrix at CsrMatrix.init() from the mean row length
// (`csr_lanes`): one thread per row for short rows, a few lanes for the
// coarse classical operators, so a warp keeps several rows' loads in
// flight; the lanes combine by a fixed shuffle tree and x is read through
// the read-only path (__ldg).
//
// B9's epilogue is the damped-Jacobi step
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
// CSR level's trailing residual, classical R r and P xc): a product of
// two bf16 values is exact in float32, so B8's stored products lose
// nothing. Bound by bytes: a stored entry streams 6 bytes (bf16 value +
// int32 column) against float32's 8; x, b, dinv and x' 2 bytes each.
#include "common.cuh"

namespace {

// csr_row_blocks' constants (ops/cuda_csr.py CSR_CHUNK, CSR_LONG_ROW)
constexpr int kChunk = 2048;   // entries a row block holds at most
constexpr int kLongRow = 128;  // longer rows get a row block of their own

template <class T>
struct Csr {
  const int* __restrict__ ro;
  const int* __restrict__ ci;
  const T* __restrict__ v;
};

// A batch's strides (elements from one system to the next): the values
// (0: shared), x, y and B9's dinv (0: shared); all 0 for a single launch.
struct Strides {
  long long v, x, y, d;
};

// B9's operands
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

// entry e's product, rounded to float32 (no fused multiply-add: the
// row sums add stored products)
template <class T, class XT>
__device__ __forceinline__ float product(const Csr<T>& a, const XT* x,
                                         int e) {
  return __fmul_rn(ld(a.v, e), ldg(x + a.ci[e]));
}

// B8: one block per row block [rb[blk], rb[blk + 1]). T is the storage
// type of the values and y, XT that of x (T, or float32: B3w's restriction
// bc = R r of a float32 residual); the sums are float32.
template <class T, class XT>
__global__ void __launch_bounds__(kThreads)
csr_block_kernel(Csr<T> a, const int* __restrict__ rb,
                 const XT* __restrict__ x, T* __restrict__ y, Strides bs) {
  __shared__ float prod[kChunk];
  const long long sys = blockIdx.y;
  a.v += sys * bs.v;
  x += sys * bs.x;
  y += sys * bs.y;
  const int r0 = rb[blockIdx.x], r1 = rb[blockIdx.x + 1];
  const int e0 = a.ro[r0], e1 = a.ro[r1];
  if (r1 - r0 == 1 && e1 - e0 > kLongRow) {
    // a long row: strided shares, then a fixed tree
    float acc = 0.0f;
    for (int e = e0 + threadIdx.x; e < e1; e += kThreads)
      acc = __fadd_rn(acc, product(a, x, e));
    acc = block_sum(acc);
    if (threadIdx.x == 0) st(y, r0, acc);
    return;
  }
#pragma unroll
  for (int k = 0; k < kChunk / kThreads; ++k) {
    const int e = e0 + k * kThreads + threadIdx.x;
    if (e < e1) prod[e - e0] = product(a, x, e);
  }
  __syncthreads();
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const int end = a.ro[r + 1] - e0;
    float acc = 0.0f;
    for (int j = a.ro[r] - e0; j < end; ++j) acc = __fadd_rn(acc, prod[j]);
    st(y, r, acc);
  }
}

template <class T, class XT>
int spmv_as(const int* ro, const int* ci, const void* vals, const int* rb,
            int nblocks, const void* x, void* y, int nsys,
            const Strides& bs, cudaStream_t stream) {
  csr_block_kernel<T, XT><<<dim3(nblocks, nsys), kThreads, 0, stream>>>(
      Csr<T>{ro, ci, static_cast<const T*>(vals)}, rb,
      static_cast<const XT*>(x), static_cast<T*>(y), bs);
  return static_cast<int>(cudaGetLastError());
}

// B9: kLanes consecutive lanes of a warp share a row (1: one thread per
// row, 32: one warp per row); each lane strides the row by kLanes and the
// lanes combine by a fixed shuffle tree, so every row sums in one order.
template <class T, int kLanes>
__global__ void __launch_bounds__(kThreads)
csr_step_kernel(Csr<T> a, T* __restrict__ y, int n, Step<T> s,
                Strides bs) {
  const long long sys = blockIdx.y;
  a.v += sys * bs.v;
  y += sys * bs.y;
  s.x += sys * bs.x;
  s.b += sys * bs.y;
  if (s.dinv != nullptr) s.dinv += sys * bs.d;
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
    acc += ld(a.v, e) * ldg(s.x + a.ci[e]);
  const unsigned mask =
      kLanes == 32 ? 0xffffffffu
                   : ((1u << kLanes) - 1u) << ((threadIdx.x & 31) &
                                                ~(kLanes - 1));
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc += __shfl_down_sync(mask, acc, o, kLanes);
  if (lane != 0) return;
  float upd = s.taus[s.t] * (ld(s.b, i) - acc);
  if (s.dinv != nullptr) upd *= ld(s.dinv, i);
  st(y, i, ld(s.x, i) + upd);
}

template <class T, int kLanes>
void launch_lanes(const Csr<T>& a, T* y, int n, const Step<T>& s, int nsys,
                  const Strides& bs, cudaStream_t stream) {
  const long long threads = static_cast<long long>(kLanes) * n;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  csr_step_kernel<T, kLanes>
      <<<dim3(blocks, nsys), kThreads, 0, stream>>>(a, y, n, s, bs);
}

template <class T>
int step_as(const int* ro, const int* ci, const void* vals, const void* x,
            const void* b, const void* dinv, const float* taus, int t,
            void* out, int n, int lanes, int nsys, const Strides& bs,
            cudaStream_t stream) {
  const Csr<T> a{ro, ci, static_cast<const T*>(vals)};
  T* y = static_cast<T*>(out);
  const Step<T> s{static_cast<const T*>(x), static_cast<const T*>(b),
                  static_cast<const T*>(dinv), taus, t};
  switch (lanes) {
    case 1: launch_lanes<T, 1>(a, y, n, s, nsys, bs, stream); break;
    case 2: launch_lanes<T, 2>(a, y, n, s, nsys, bs, stream); break;
    case 4: launch_lanes<T, 4>(a, y, n, s, nsys, bs, stream); break;
    case 8: launch_lanes<T, 8>(a, y, n, s, nsys, bs, stream); break;
    case 16: launch_lanes<T, 16>(a, y, n, s, nsys, bs, stream); break;
    case 32: launch_lanes<T, 32>(a, y, n, s, nsys, bs, stream); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B8: y = A x over the row blocks rb[0..nblocks] (csr_row_blocks: row
// starts, then the row count); with `bf16_io` set the values, x and y
// are bfloat16 (the products and the sum float32, y rounded once), and
// with `x_f32` too x is float32 (B3w's bf16 restriction: bf16 weights, a
// float32 residual, bc rounded once).
int amgx_csr_spmv(const int* ro, const int* ci, const void* vals,
                  const int* rb, int nblocks, const void* x, void* y,
                  int bf16_io, int x_f32, cudaStream_t stream) {
  if (nblocks < 1 || rb == nullptr) return -1;
  const Strides one{0, 0, 0, 0};
  if (!bf16_io)
    return spmv_as<float, float>(ro, ci, vals, rb, nblocks, x, y, 1, one,
                                 stream);
  return x_f32 ? spmv_as<bf16, float>(ro, ci, vals, rb, nblocks, x, y, 1,
                                      one, stream)
               : spmv_as<bf16, bf16>(ro, ci, vals, rb, nblocks, x, y, 1, one,
                                     stream);
}

// B9: out = x + (taus[t] * (b - A x)) * dinv (dinv optional), one sweep,
// `lanes` (1, 2, 4, ..., 32) lanes per row; out must not alias x. With
// `bf16_io` set the values, x, b, dinv and out are bfloat16 (taus
// float32, the products and sums float32), out rounded once.
int amgx_csr_step(const int* ro, const int* ci, const void* vals,
                  const void* x, const void* b, const void* dinv,
                  const float* taus, int t, void* out, int n, int lanes,
                  int bf16_io, cudaStream_t stream) {
  if (n < 1 || taus == nullptr || b == nullptr || out == x) return -1;
  const Strides one{0, 0, 0, 0};
  return bf16_io ? step_as<bf16>(ro, ci, vals, x, b, dinv, taus, t, out, n,
                                 lanes, 1, one, stream)
                 : step_as<float>(ro, ci, vals, x, b, dinv, taus, t, out, n,
                                  lanes, 1, one, stream);
}

// K3 (B8 batched): Y = A X for nsys systems, float32; X (nsys, ncols), Y
// (nsys, nrows); the values (nnz,) shared or, with `per_system`,
// (nsys, nnz).
int amgx_csr_spmv_multi(const int* ro, const int* ci, const float* vals,
                        const int* rb, int nblocks, const float* x, float* y,
                        int nrows, int ncols, long long nnz, int nsys,
                        int per_system, cudaStream_t stream) {
  if (nblocks < 1 || rb == nullptr || nsys < 1 || nsys > 65535) return -1;
  const Strides bs{per_system ? nnz : 0, ncols, nrows, 0};
  return spmv_as<float, float>(ro, ci, vals, rb, nblocks, x, y, nsys, bs,
                               stream);
}

// K4 (B9 batched): one damped sweep out = x + (taus[t] * (b - A x)) * dinv
// for nsys systems of n rows, float32; the values (nnz,) or (nsys, nnz)
// by `per_system`, dinv (optional) (n,) or (nsys, n) by
// `dinv_per_system`.
int amgx_csr_step_multi(const int* ro, const int* ci, const float* vals,
                        const float* x, const float* b, const float* dinv,
                        const float* taus, int t, float* out, int n,
                        int lanes, long long nnz, int nsys, int per_system,
                        int dinv_per_system, cudaStream_t stream) {
  if (n < 1 || taus == nullptr || b == nullptr || out == x || nsys < 1 ||
      nsys > 65535)
    return -1;
  const Strides bs{per_system ? nnz : 0, n, n, dinv_per_system ? n : 0};
  return step_as<float>(ro, ci, vals, x, b, dinv, taus, t, out, n, lanes,
                        nsys, bs, stream);
}

}  // extern "C"
