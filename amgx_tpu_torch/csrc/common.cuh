// Pieces shared by the port's CUDA sources (dia.cu, krylov.cu, tail.cu):
// the DIA offset table, the operand storage types, the value sources (a
// stored slab, or a constant-coefficient stencil), the row product, and a
// deterministic dot reduction. Each .cu compiles into its own library, so
// everything here has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>

namespace {

// Operand storage: float32, or bfloat16 (the reduced-precision cycle's
// streams). A bf16 element is widened on load and rounded to nearest even
// at the store; all arithmetic is float32 (the TPU kernels' `cdt`).
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

constexpr int kMaxOffsets = 32;  // CsrMatrix.DIA_MAX_OFFSETS
constexpr int kThreads = 256;

struct Offsets {
  int k;
  int o[kMaxOffsets];
};

// x as a kernel reads it: plainly, or with the piecewise-constant
// prolongation of a coarse correction folded in (x + xc[agg]).
// T is the storage type of x and xc; the sum is float32.
template <class T>
struct PlainXT {
  const T* __restrict__ x;
  __device__ __forceinline__ float operator()(int j) const { return ld(x, j); }
};
using PlainX = PlainXT<float>;

template <class T>
struct CorrectedXT {
  const T* __restrict__ x;
  const T* __restrict__ xc;
  const int* __restrict__ agg;
  __device__ __forceinline__ float operator()(int j) const {
    return ld(x, j) + ld(xc, agg[j]);
  }
};
using CorrectedX = CorrectedXT<float>;

// The values of a DIA operator as the kernels read them. A value source
// gives row i's context (`row(i)`), diagonal d's value in that row
// (`val(row, d)`) and the row's diagonal inverse (`inv(row, i, k)`, read
// only when the kernel was told there is one).
//
// SlabVals: the stored (k, n) slab, vals[d * n + i], and a stored dinv,
// both of storage type T.
template <class T>
struct SlabValsT {
  const T* __restrict__ vals;
  const T* __restrict__ dinv;  // nullptr: none
  int n;
  struct Row {
    int i;
  };
  __device__ __forceinline__ Row row(int i) const { return Row{i}; }
  __device__ __forceinline__ float val(const Row& r, int d) const {
    return ld(vals, static_cast<size_t>(d) * n + r.i);
  }
  __device__ __forceinline__ float inv(const Row&, int i, int) const {
    return ld(dinv, i);
  }
};
using SlabVals = SlabValsT<float>;

// A constant-coefficient grid stencil (the coefficient or "matrix-free"
// mode of the TPU kernels, amgx_tpu/ops/pallas_spmv.py `_mf_vals_dinv`):
// A[i, i + off[d]] = c[d] where row i's grid shift (sx, sy, sz)[d] stays
// inside the nx x ny x nz grid (x fastest), else 0. The diagonal inverse
// is synthesized from the coefficients: none, 1 / c[diag] ("jacobi"), or
// 1 / (c0 + sign(c0) * sum of |c[d]| over the in-grid off-diagonals)
// ("l1"), with 0 -> 0. Travels by value in the kernel's parameter block
// (the host fills it; ops/cuda_spmv.py `StencilArg` mirrors the layout).
enum DinvMode { kDinvNone = 0, kDinvJacobi = 1, kDinvL1 = 2 };

// n / d for 0 <= n < 2^31 as a multiply-high and a shift, with the
// constants the host computes for d (ops/cuda_spmv.py `fast_div`;
// mul == 0 means d == 1): a row's grid coordinates cost two of these
// instead of two integer divisions.
struct FastDiv {
  unsigned mul;
  int shr;
  __device__ __forceinline__ int operator()(int n) const {
    return mul == 0u ? n
                     : static_cast<int>(
                           __umulhi(static_cast<unsigned>(n), mul) >> shr);
  }
};

struct Stencil {
  float c[kMaxOffsets];
  int sx[kMaxOffsets], sy[kMaxOffsets], sz[kMaxOffsets];
  int nx, ny, nz;
  int diag;  // index of offset 0, -1 when absent
  int dinv;  // DinvMode
  FastDiv by_nx, by_ny;
};

struct GridRow {
  int x, y, z;
};

// grid coordinates of row i (x fastest)
__device__ __forceinline__ GridRow grid_row(int i, int nx, int ny,
                                            const FastDiv& by_nx,
                                            const FastDiv& by_ny) {
  const int t = by_nx(i);
  const int z = by_ny(t);
  return GridRow{i - t * nx, t - z * ny, z};
}

__device__ __forceinline__ bool in_grid(const GridRow& g, int dx, int dy,
                                        int dz, int nx, int ny, int nz) {
  return static_cast<unsigned>(g.x + dx) < static_cast<unsigned>(nx) &&
         static_cast<unsigned>(g.y + dy) < static_cast<unsigned>(ny) &&
         static_cast<unsigned>(g.z + dz) < static_cast<unsigned>(nz);
}

// 1 / (diagonal as `mode` strengthens it), 0 where that is 0; `c(d)` is
// diagonal d's value in the row (0 where its shift leaves the grid). The
// L1 sum runs in offset order and the sign product is exact, so the bits
// equal the plain version's (ops/stencil.py `_dinv_vec`).
template <class C>
__device__ __forceinline__ float stencil_inv(const C& c, int k, int diag,
                                             int mode) {
  const float c0 = c(diag);
  float den = c0;
  if (mode == kDinvL1) {
    float l1 = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxOffsets; ++d) {
      if (d >= k) break;
      if (d != diag) l1 = __fadd_rn(l1, fabsf(c(d)));
    }
    const float sg = c0 > 0.0f ? 1.0f : (c0 < 0.0f ? -1.0f : 0.0f);
    den = __fadd_rn(c0, __fmul_rn(sg, l1));
  }
  return den == 0.0f ? 0.0f : 1.0f / den;
}

struct StencilVals {
  Stencil st;
  using Row = GridRow;
  __device__ __forceinline__ Row row(int i) const {
    return grid_row(i, st.nx, st.ny, st.by_nx, st.by_ny);
  }
  __device__ __forceinline__ float val(const Row& g, int d) const {
    return in_grid(g, st.sx[d], st.sy[d], st.sz[d], st.nx, st.ny, st.nz)
               ? st.c[d]
               : 0.0f;
  }
  __device__ __forceinline__ float inv(const Row& g, int, int k) const {
    return stencil_inv([&](int d) { return val(g, d); }, k, st.diag,
                       st.dinv);
  }
};

// (A x)[i] for one row; diagonals in ascending offset order. Unrolled
// over the table's capacity, so every per-diagonal parameter (offset,
// coefficient, shift) is read at a constant position.
template <class VS, class XR>
__device__ __forceinline__ float dia_row(const VS& vs,
                                         const typename VS::Row& r,
                                         const XR& xr, int n, int i,
                                         const Offsets& of) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < kMaxOffsets; ++d) {
    if (d >= of.k) break;
    const int j = i + of.o[d];
    if (j >= 0 && j < n) acc += vs.val(r, d) * xr(j);
  }
  return acc;
}

bool fill_offsets(const int* offs, int k, Offsets* of) {
  if (k < 1 || k > kMaxOffsets) return false;
  of->k = k;
  for (int d = 0; d < k; ++d) of->o[d] = offs[d];
  return true;
}

// A host stencil the kernels can take: a grid of n rows, a diagonal where
// a dinv mode needs one.
bool stencil_ok(const Stencil* st, int n, int k) {
  if (st == nullptr || st->nx < 1 || st->ny < 1 || st->nz < 1) return false;
  if (static_cast<long long>(st->nx) * st->ny * st->nz != n) return false;
  if (st->dinv < kDinvNone || st->dinv > kDinvL1) return false;
  return st->dinv == kDinvNone || (st->diag >= 0 && st->diag < k);
}

int blocks_for(int rows) { return (rows + kThreads - 1) / kThreads; }

// Sum of v over the block (whole warps, at most 1024 threads), valid in
// thread 0. A fixed tree: the same inputs give the same bits on every
// run. Every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_part[w] = v;
  __syncthreads();
  v = 0.0f;
  if (w == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_part[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_part may be reused by the next call
  return v;
}

// Grid-wide dots without float atomics: each block writes its partial
// sum of each of the kN values; the block that arrives last (an integer
// counter) adds each value's partials in index order, writes out[0..kN)
// and resets the counter to zero for the next launch. partials holds
// kN * gridDim.x floats, value s at [s * gridDim.x, (s + 1) * gridDim.x).
// Launches sharing a counter must not overlap in time (they run on one
// stream).
template <int kN>
__device__ __forceinline__ void finish_dots(float (&part)[kN],
                                            float* partials,
                                            unsigned int* counter,
                                            float* out) {
  __shared__ bool last;
#pragma unroll
  for (int s = 0; s < kN; ++s) part[s] = block_sum(part[s]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kN; ++s)
      partials[s * gridDim.x + blockIdx.x] = part[s];
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    float v = 0.0f;
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
         b += blockDim.x)
      v += __ldcg(partials + s * gridDim.x + b);
    v = block_sum(v);
    if (threadIdx.x == 0) out[s] = v;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// Where a launch's dot epilogue writes (finish_dot's arguments).
struct DotOut {
  float* partials;        // one float per block
  unsigned int* counter;  // zero between launches
  float* out;
};

// One grid-wide dot (finish_dots with a single value).
__device__ __forceinline__ void finish_dot(float part, float* partials,
                                           unsigned int* counter,
                                           float* out) {
  float p[1] = {part};
  finish_dots<1>(p, partials, counter, out);
}

}  // namespace
