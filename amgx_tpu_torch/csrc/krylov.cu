// Krylov-shell kernels for Hopper (sm_90a): the CUDA counterparts of the
// Pallas TPU kernels B6 `_dia_spmv_dot_call` and B7 `_cg_update_call`
// (amgx_tpu/ops/pallas_spmv.py), bound through a plain C interface
// (ctypes, amgx_tpu_torch/ops/cuda_krylov.py). Each entry point launches
// ONE kernel on the caller's stream and returns cudaGetLastError().
//
// Both are bound by memory on an H100: a handful of flops per 4-byte
// element streamed. The TPU kernels carry their dot products as per-block
// partial rows that XLA adds after the grid; Hopper blocks run in no
// order, so here each block writes its partial and the last block to
// finish adds them in block order (common.cuh `finish_dot`): one launch,
// deterministic, no float atomics. The scalars alpha / beta arrive by
// device pointer, so a solver iteration never reads them on the host.
//
// B6 has two forms here. The beta prologue (CG / PCG / PCGF): p' = z +
// beta p, Ap', p'.Ap'. One thread per row.
// The TPU kernel recomputes the prologue on its halo rows; here each
// thread recomputes z_j + beta p_j at every neighbour j from global
// memory / L2 (the same fused multiply-add everywhere, so p'[j] read by a
// neighbour equals the p'[j] written), and p' goes to a new buffer
// because neighbours read the old p. Bytes: (k + 4) n floats.
// The streamed dot operand (BiCGStab / PBiCGStab, `spmv_ddot`): Ap, d.Ap
// and, with self_dot, Ap.Ap, one thread per row with B1's row product
// (so Ap has B1's bits), both sums carried through one finish_dots pass
// (a template flag picks one or two). p and d are only read, so d may be
// p itself (BiCGStab's t = A s with t.s); Ap goes to a fresh buffer.
// Bytes: (k + 3) n floats, (k + 2) n when d is p.
//
// B7: x + alpha p, r - alpha Ap, r'.r' in one elementwise pass. Fresh
// outputs, not in place: PCGF reads the old r after the update. Bytes:
// 6 n floats.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
spmv_pdot_kernel(const float* __restrict__ vals, const float* __restrict__ p,
                 const float* __restrict__ z, const float* __restrict__ beta,
                 float* __restrict__ pout, float* __restrict__ ap, int n,
                 Offsets of, float* partials, unsigned int* counter,
                 float* dot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float bt = *beta;
  float part = 0.0f;
  if (i < n) {
    float acc = 0.0f;
    for (int d = 0; d < of.k; ++d) {
      const int j = i + of.o[d];
      if (j >= 0 && j < n) {
        const float pj = __fmaf_rn(bt, p[j], z[j]);
        acc += vals[static_cast<size_t>(d) * n + i] * pj;
      }
    }
    const float pi = __fmaf_rn(bt, p[i], z[i]);
    pout[i] = pi;
    ap[i] = acc;
    part = pi * acc;
  }
  finish_dot(part, partials, counter, dot);
}

template <bool kSelf>
__global__ void __launch_bounds__(kThreads)
spmv_ddot_kernel(const float* __restrict__ vals, const float* p,
                 const float* d, float* __restrict__ ap, int n, Offsets of,
                 float* partials, unsigned int* counter, float* dots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float part[kSelf ? 2 : 1] = {};
  if (i < n) {
    const SlabVals vs{vals, nullptr, n};
    const float acc = dia_row(vs, vs.row(i), PlainX{p}, n, i, of);
    ap[i] = acc;
    part[0] = d[i] * acc;
    if constexpr (kSelf) part[1] = acc * acc;
  }
  finish_dots(part, partials, counter, dots);
}

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ x, const float* __restrict__ p,
                 const float* __restrict__ r, const float* __restrict__ ap,
                 const float* __restrict__ alpha, float* __restrict__ xo,
                 float* __restrict__ ro, int n, float* partials,
                 unsigned int* counter, float* rr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float a = *alpha;
  float part = 0.0f;
  if (i < n) {
    xo[i] = x[i] + a * p[i];
    const float rn = r[i] - a * ap[i];
    ro[i] = rn;
    part = rn * rn;
  }
  finish_dot(part, partials, counter, rr);
}

}  // namespace

extern "C" {

// Number of dot partials a launch over n rows writes (one per block).
int amgx_krylov_blocks(int n) { return blocks_for(n); }

// B6: pout = z + beta p, ap = A pout, *dot = pout.ap; partials holds
// amgx_krylov_blocks(n) floats, counter is zero on entry and left zero.
int amgx_spmv_pdot(const float* vals, const float* p, const float* z,
                   const float* beta, float* pout, float* ap, int n,
                   const int* offs, int k, float* partials,
                   unsigned int* counter, float* dot, cudaStream_t stream) {
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of)) return -1;
  spmv_pdot_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      vals, p, z, beta, pout, ap, n, of, partials, counter, dot);
  return static_cast<int>(cudaGetLastError());
}

// B6, streamed dot operand: ap = A p, dots[0] = d.ap and, when self_dot,
// dots[1] = ap.ap; partials holds (self_dot ? 2 : 1) *
// amgx_krylov_blocks(n) floats. d may equal p; ap must be neither.
int amgx_spmv_ddot(const float* vals, const float* p, const float* d,
                   float* ap, int n, const int* offs, int k, int self_dot,
                   float* partials, unsigned int* counter, float* dots,
                   cudaStream_t stream) {
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of) || ap == p || ap == d) return -1;
  if (self_dot)
    spmv_ddot_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(
        vals, p, d, ap, n, of, partials, counter, dots);
  else
    spmv_ddot_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(
        vals, p, d, ap, n, of, partials, counter, dots);
  return static_cast<int>(cudaGetLastError());
}

// B7: xo = x + alpha p, ro = r - alpha ap, *rr = ro.ro.
int amgx_cg_update(const float* x, const float* p, const float* r,
                   const float* ap, const float* alpha, float* xo, float* ro,
                   int n, float* partials, unsigned int* counter, float* rr,
                   cudaStream_t stream) {
  if (n < 1) return -1;
  cg_update_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      x, p, r, ap, alpha, xo, ro, n, partials, counter, rr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
