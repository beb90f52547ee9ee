// DIA SpMV and damped-relaxation smoother kernels for Hopper (sm_90a).
//
// Hand-written CUDA counterparts of the Pallas TPU kernels B1-B4 of
// amgx_tpu/ops/pallas_spmv.py, bound to PyTorch through a plain C
// interface (ctypes, amgx_tpu_torch/ops/cuda_spmv.py). Every entry point
// launches ONE kernel on the caller's stream and returns
// cudaGetLastError(); the Python wrappers allocate every buffer and
// orchestrate multi-application calls.
//
// Storage: a DIA operator is a contiguous (k, n) float32 slab,
// vals[d * n + i] = A[i, i + off[d]], zero where the column leaves
// [0, n). Offsets are ascending (at most kMaxOffsets) and travel by value
// in the kernel's parameter block.
//
// What bounds these kernels on an H100: memory. One application streams
// k value floats, the vector x (neighbour reads hit L1/L2: every x entry
// is read by k rows), b, and writes one float per row -- about 2 flops
// per 4 bytes, far under the ~20 flop/byte the card needs to become
// compute-bound in float32. The design is therefore one thread per row
// with coalesced reads of vals[d * n + i] and x[i + off[d]] for a warp of
// consecutive rows.
//
// What the TPU kernels did that these do not (yet): the TPU smoother runs
// all steps and the residual in ONE pass by temporal blocking over a VMEM
// window of ~100k rows at 128^3; a Hopper block has 227 KB of shared
// memory, far too little for that window. Here every application is one
// grid-wide launch (x ping-pongs between two buffers), so a call with s
// steps and a residual streams the value slab s + 1 times. The
// restriction epilogue recomputes the residual at each child of a coarse
// row instead of writing r, and the prolongation prologue reads
// x + xc[agg] on the fly instead of storing x + P xc. B4's x'.b epilogue
// (PCG's r.z) rides the last step's launch: block partials added in a
// fixed order by the last block, no float atomics (common.cuh).
//
// Weighted transfer rows (classical AMG's general-CSR P and R = P^T, the
// `weighted=` forms of the TPU kernels): the restriction epilogue weighs
// each child, bc[c] = sum_j cwt[j, c] * r[ctab[j, c]] (R's rows hold up to
// 32 entries against an aggregate's 8, so a coarse row costs more
// recomputed residuals), and the prolongation prologue reads
// x_j + sum_t pwt[t, j] * xc[ptab[t, j]] at every neighbour j (P's rows
// hold up to interp_max_elements entries). Templates keep the
// unit-weight kernels unchanged.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, int n, Offsets of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = dia_row(vals, PlainX{x}, n, i, of);
}

// One damped-relaxation step x' = x + (tau_t * (b - A x)) * dinv. With
// kDot the launch also returns x'.b (B4's dot epilogue, PCG's r.z):
// per-block partials, added in block order by the last block to finish.
struct DotOut {
  float* partials;        // one float per block
  unsigned int* counter;  // zero between launches
  float* out;
};

template <class XR, bool kHasDinv, bool kDot>
__global__ void __launch_bounds__(kThreads)
dia_step_kernel(const float* __restrict__ vals, const float* __restrict__ dinv,
                const float* __restrict__ taus, int t,
                const float* __restrict__ b, XR xr, float* __restrict__ out,
                int n, Offsets of, DotOut dot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float part = 0.0f;
  if (i < n) {
    float upd = taus[t] * (b[i] - dia_row(vals, xr, n, i, of));
    if (kHasDinv) upd *= dinv[i];
    const float v = xr(i) + upd;
    out[i] = v;
    if (kDot) part = v * b[i];
  }
  if (kDot) finish_dot(part, dot.partials, dot.counter, dot.out);
}

__global__ void __launch_bounds__(kThreads)
dia_residual_kernel(const float* __restrict__ vals,
                    const float* __restrict__ b, const float* __restrict__ x,
                    float* __restrict__ r, int n, Offsets of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) r[i] = b[i] - dia_row(vals, PlainX{x}, n, i, of);
}

// bc[c] = sum_j r[ctab[j, c]] with r = b - A x recomputed at each child:
// one thread per coarse row, a fixed summation order, no atomics, and r
// never written to memory.
// With kWeighted, child j of coarse row c carries the weight cwt[j, c].
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
dia_restrict_kernel(const float* __restrict__ vals,
                    const float* __restrict__ b, const float* __restrict__ x,
                    const int* __restrict__ ctab,
                    const float* __restrict__ cwt, int m, int nc,
                    float* __restrict__ bc, int n, Offsets of) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  float acc = 0.0f;
  for (int j = 0; j < m; ++j) {
    const size_t s = static_cast<size_t>(j) * nc + c;
    const int f = ctab[s];
    if (f < 0) continue;
    const float r = b[f] - dia_row(vals, PlainX{x}, n, f, of);
    acc += kWeighted ? cwt[s] * r : r;
  }
  bc[c] = acc;
}

// x as B4's weighted prologue reads it: x_j + (P xc)_j through the
// (mp, n) tables of P's rows, -1 / 0 past a row's end.
struct WeightedX {
  const float* __restrict__ x;
  const float* __restrict__ xc;
  const int* __restrict__ ptab;
  const float* __restrict__ pwt;
  int mp;
  int n;
  __device__ __forceinline__ float operator()(int j) const {
    float corr = 0.0f;
    for (int t = 0; t < mp; ++t) {
      const size_t s = static_cast<size_t>(t) * n + j;
      const int q = ptab[s];
      if (q >= 0) corr += pwt[s] * xc[q];
    }
    return x[j] + corr;
  }
};

template <class XR, bool kHasDinv>
void launch_step_kernel(const float* vals, const float* dinv,
                        const float* taus, int t, const float* b, XR xr,
                        float* out, int n, const Offsets& of,
                        const DotOut& dot, cudaStream_t s) {
  if (dot.out != nullptr) {
    dia_step_kernel<XR, kHasDinv, true><<<blocks_for(n), kThreads, 0, s>>>(
        vals, dinv, taus, t, b, xr, out, n, of, dot);
  } else {
    dia_step_kernel<XR, kHasDinv, false><<<blocks_for(n), kThreads, 0, s>>>(
        vals, dinv, taus, t, b, xr, out, n, of, dot);
  }
}

template <class XR>
void launch_step(const float* vals, const float* dinv, const float* taus,
                 int t, const float* b, XR xr, float* out, int n,
                 const Offsets& of, const DotOut& dot, cudaStream_t s) {
  if (dinv != nullptr) {
    launch_step_kernel<XR, true>(vals, dinv, taus, t, b, xr, out, n, of,
                                 dot, s);
  } else {
    launch_step_kernel<XR, false>(vals, dinv, taus, t, b, xr, out, n, of,
                                  dot, s);
  }
}

}  // namespace

extern "C" {

// B1: y = A x.
int amgx_dia_spmv(const float* vals, const float* x, float* y, int n,
                  const int* offs, int k, cudaStream_t stream) {
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of)) return -1;
  dia_spmv_kernel<<<blocks_for(n), kThreads, 0, stream>>>(vals, x, y, n, of);
  return static_cast<int>(cudaGetLastError());
}

// One smoothing application (B2-B4): out = x + (taus[t] * (b - A x)) *
// dinv, with dinv optional (nullptr) and x read as x + xc[agg] when xc
// and agg are given, or as x + P xc through the (mp, n) tables ptab /
// pwt when xc and ptab are (B4's prolongation prologue, unit or
// weighted). When dot is given, *dot = out.b (B4's epilogue) through
// `partials` (one float per block of 256 rows) and `counter` (zero on
// entry, left zero).
int amgx_dia_step(const float* vals, const float* dinv, const float* taus,
                  int t, const float* b, const float* x, const float* xc,
                  const int* agg, const int* ptab, const float* pwt, int mp,
                  float* out, int n, const int* offs, int k,
                  float* partials, unsigned int* counter, float* dot,
                  cudaStream_t stream) {
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of)) return -1;
  if ((xc == nullptr) != (agg == nullptr && ptab == nullptr)) return -1;
  if (agg != nullptr && ptab != nullptr) return -1;
  if (ptab != nullptr && (pwt == nullptr || mp < 1)) return -1;
  if (dot != nullptr && (partials == nullptr || counter == nullptr))
    return -1;
  const DotOut d{partials, counter, dot};
  if (ptab != nullptr) {
    launch_step(vals, dinv, taus, t, b, WeightedX{x, xc, ptab, pwt, mp, n},
                out, n, of, d, stream);
  } else if (xc != nullptr) {
    launch_step(vals, dinv, taus, t, b, CorrectedX{x, xc, agg}, out, n, of,
                d, stream);
  } else {
    launch_step(vals, dinv, taus, t, b, PlainX{x}, out, n, of, d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// B2's trailing residual: r = b - A x.
int amgx_dia_residual(const float* vals, const float* b, const float* x,
                      float* r, int n, const int* offs, int k,
                      cudaStream_t stream) {
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of)) return -1;
  dia_residual_kernel<<<blocks_for(n), kThreads, 0, stream>>>(vals, b, x, r,
                                                              n, of);
  return static_cast<int>(cudaGetLastError());
}

// B3's restriction epilogue: bc = R (b - A x) through the child table
// ctab (m, nc), -1 where a coarse row has fewer than m children, each
// child weighted by cwt (m, nc) when it is given (else unit weights).
int amgx_dia_restrict(const float* vals, const float* b, const float* x,
                      const int* ctab, const float* cwt, int m, int nc,
                      float* bc, int n, const int* offs, int k,
                      cudaStream_t stream) {
  Offsets of;
  if (n < 1 || nc < 1 || m < 1 || !fill_offsets(offs, k, &of)) return -1;
  if (cwt != nullptr) {
    dia_restrict_kernel<true><<<blocks_for(nc), kThreads, 0, stream>>>(
        vals, b, x, ctab, cwt, m, nc, bc, n, of);
  } else {
    dia_restrict_kernel<false><<<blocks_for(nc), kThreads, 0, stream>>>(
        vals, b, x, ctab, cwt, m, nc, bc, n, of);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
