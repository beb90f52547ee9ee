// Galerkin RAP value kernel for Hopper (sm_90a): the CUDA counterpart of
// the Pallas TPU kernel B10 `_rap_kernel_program` (body `_rap_kernel`,
// amgx_tpu/ops/pallas_spgemm.py), bound through a plain C interface
// (ctypes, amgx_tpu_torch/ops/cuda_rap.py). Each entry point launches ONE
// kernel on the caller's stream and returns cudaGetLastError().
//
// The value phase of a planned R A P (ops/spgemm.py RapPlan): the
// structure phase stored every candidate product in coalesced output
// order, so each output entry's contributors are one contiguous run.
//
//   stage 1: t[k] = sum_{e in [s1[k], s1[k+1])} a[sa[e]] * p[sp[e]]
//   stage 2: c[u] = sum_{f in [s2[u], s2[u+1])} r[sr[f]] * t[st[f]]
//
// What bounds it on an H100: memory. Each candidate costs two 4-byte
// index reads and two gathered 4-byte value reads for one multiply-add,
// far below the ~20 flop/byte the card needs to become compute-bound.
// The TPU kernel holds a whole chunk of output in VMEM and unrolls runs
// up to RAP_MAX_CONTRIB = 64, declining larger plans to an XLA program;
// both caps are TPU artefacts and are dropped here. The design is two
// launches with one thread per output entry (a T entry in stage 1, a C
// entry in stage 2), each walking its run left to right: the index
// streams are read once, coalesced across a warp's consecutive runs, and
// the value gathers go through the read-only path. No candidate array is
// materialized and nothing is atomic, so the result is deterministic.
// The products and sums are rounded separately (__fmul_rn / __fadd_rn,
// never contracted into an FMA), so the kernel gives the bits of its
// plain PyTorch twin, on the card as on the CPU.
//
// The relabel form (the TPU kernel with has1=False, has_r=False): the
// Galerkin product of unsmoothed aggregation, where P is the 0/1
// aggregates map, so R A P only relabels A's entries (ops/spgemm.py
// AggPlan). One stage and no multiply:
//
//   c[u] = sum_{f in [s2[u], s2[u+1])} af[st[f]]
//
// Its own entry point, so it reads no vector of ones and counts under
// its own name. Memory-bound the same way (one index read and one
// gathered value per candidate, 8 B for one add); the same design, one
// thread per coarse entry adding its run left to right with __fadd_rn.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
rap_run_kernel(const float* __restrict__ u, const float* __restrict__ v,
               const int* __restrict__ su, const int* __restrict__ sv,
               const int* __restrict__ starts, float* __restrict__ out,
               int nout) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nout) return;
  const int e1 = starts[k + 1];
  float acc = 0.0f;
  for (int e = starts[k]; e < e1; ++e)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(u + su[e]), __ldg(v + sv[e])));
  out[k] = acc;
}

__global__ void __launch_bounds__(kThreads)
rap_relabel_kernel(const float* __restrict__ af, const int* __restrict__ st,
                   const int* __restrict__ starts, float* __restrict__ out,
                   int nout) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= nout) return;
  const int f1 = starts[u + 1];
  float acc = 0.0f;
  for (int f = starts[u]; f < f1; ++f)
    acc = __fadd_rn(acc, __ldg(af + st[f]));
  out[u] = acc;
}

}  // namespace

extern "C" {

// One stage of the value phase: out[k] = sum over the run
// [starts[k], starts[k+1]) of u[su[e]] * v[sv[e]], added left to right.
// Stage 1 passes (a, p, sa, sp, starts1) into t (nT entries); stage 2
// (r, t, sr, st, starts2) into the coarse values (nU entries).
int amgx_rap_stage(const float* u, const float* v, const int* su,
                   const int* sv, const int* starts, float* out, int nout,
                   cudaStream_t stream) {
  if (nout < 0) return -1;
  if (nout == 0) return 0;
  rap_run_kernel<<<blocks_for(nout), kThreads, 0, stream>>>(
      u, v, su, sv, starts, out, nout);
  return static_cast<int>(cudaGetLastError());
}

// The relabel form: out[u] = sum over the run [starts[u], starts[u+1])
// of af[st[f]], added left to right (nout coarse entries).
int amgx_rap_relabel(const float* af, const int* st, const int* starts,
                     float* out, int nout, cudaStream_t stream) {
  if (nout < 0) return -1;
  if (nout == 0) return 0;
  rap_relabel_kernel<<<blocks_for(nout), kThreads, 0, stream>>>(
      af, st, starts, out, nout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
