// Pieces shared by the port's CUDA sources (dia.cu, krylov.cu, tail.cu):
// the DIA offset table, the row product, and a deterministic dot
// reduction. Each .cu compiles into its own library, so everything here
// has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kMaxOffsets = 32;  // CsrMatrix.DIA_MAX_OFFSETS
constexpr int kThreads = 256;

struct Offsets {
  int k;
  int o[kMaxOffsets];
};

// x as a kernel reads it: plainly, or with the piecewise-constant
// prolongation of a coarse correction folded in (x + xc[agg]).
struct PlainX {
  const float* __restrict__ x;
  __device__ __forceinline__ float operator()(int j) const { return x[j]; }
};

struct CorrectedX {
  const float* __restrict__ x;
  const float* __restrict__ xc;
  const int* __restrict__ agg;
  __device__ __forceinline__ float operator()(int j) const {
    return x[j] + xc[agg[j]];
  }
};

// (A x)[i] for one row; diagonals in ascending offset order.
template <class XR>
__device__ __forceinline__ float dia_row(const float* __restrict__ vals,
                                         const XR& xr, int n, int i,
                                         const Offsets& of) {
  float acc = 0.0f;
  for (int d = 0; d < of.k; ++d) {
    const int j = i + of.o[d];
    if (j >= 0 && j < n) acc += vals[static_cast<size_t>(d) * n + i] * xr(j);
  }
  return acc;
}

bool fill_offsets(const int* offs, int k, Offsets* of) {
  if (k < 1 || k > kMaxOffsets) return false;
  of->k = k;
  for (int d = 0; d < k; ++d) of->o[d] = offs[d];
  return true;
}

int blocks_for(int rows) { return (rows + kThreads - 1) / kThreads; }

// Sum of v over the block (blockDim.x == kThreads), valid in thread 0.
// A fixed tree: the same inputs give the same bits on every run. Every
// thread of the block must call it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_part[w] = v;
  __syncthreads();
  v = 0.0f;
  if (w == 0) {
    v = lane < kThreads / 32 ? warp_part[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_part may be reused by the next call
  return v;
}

// Grid-wide dot without float atomics: each block writes its partial
// sum; the block that arrives last (an integer counter) adds the
// partials in index order, writes *out and resets the counter to zero
// for the next launch. Launches sharing a counter must not overlap in
// time (they run on one stream).
__device__ __forceinline__ void finish_dot(float part, float* partials,
                                           unsigned int* counter,
                                           float* out) {
  __shared__ bool last;
  part = block_sum(part);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float v = 0.0f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)
    v += __ldcg(partials + b);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *out = v;
    *counter = 0u;
  }
}

}  // namespace
