// The coarse-tail sub-cycle in one launch for Hopper (sm_90a): the CUDA
// counterpart of the Pallas TPU kernel B5 `_dia_coarse_tail_call` (body
// `_tail_compute`, amgx_tpu/ops/pallas_spmv.py), bound through a plain C
// interface (ctypes, amgx_tpu_torch/ops/cuda_tail.py).
//
// The TPU kernel holds every tail level in VMEM and runs the whole
// sub-cycle (pre-sweeps, restriction, recursion, coarsest solve,
// prolongation, post-sweeps on every level from the entry down) in one
// grid step. On an H100 the tail does not fit one block: at the
// flagship's 128^3 the 32768-row entry level alone holds 0.9 MB of
// values against 227 KB of shared memory. Design: ONE cooperative launch
// of as many blocks as can be co-resident (capped by the entry level's
// rows), grid-stride loops within each phase, and a grid barrier
// (cooperative_groups grid.sync) between dependent phases. The host
// flattens the V/W/F recursion once per (hierarchy, shape, dot) into a
// small int32 phase program that the kernel walks:
//
//   STEP      one damped step on level l from slot src into slot dst;
//             with CORRECTED, x is read as x + xc[agg] (the first
//             post-step folds the coarse correction in)
//   RESTRICT  b_{l+1}[c] = sum_j (b - A x)[ctab[j, c]] (the residual is
//             computed at each child, never stored) and x_{l+1} = 0
//   COARSE    x_z = inv b_z (DENSE_LU's explicit inverse), or 0
//   CORRECT   x + xc[agg] when a level has no post-sweeps
//   DOT       block 0 adds the per-block partials of x'.b in block order
//
// What bounds it: at these sizes (32768 rows and below) neither bytes
// nor flops -- the whole tail moves about 2.5 MB -- but the chain of
// dependent phases: one grid barrier per phase, ~34 for the flagship's V
// tail. Collapsing ~34 separate launches (and their host-side launch
// cost) into one is the point of the kernel.
//
// Stencil levels (the coefficient mode, `_tail_compute`'s `level_vals`
// matrix-free branch): a level whose operator is a constant-coefficient
// grid stencil carries its k coefficients, shifts and grid shape in the
// per-level tables instead of a value slab, and the kernel synthesizes
// the values and the diagonal inverse from them (common.cuh), with the
// same arithmetic as on a slab level.
//
// Slots: every level l >= 1 has b and two x buffers (A, B) in a
// workspace the wrapper allocates once per hierarchy; level 0 reads the
// caller's b and x (slot IN) and ping-pongs between the output (A) and
// one workspace buffer (B), the program arranging that the last write
// lands in the output.
//
// bfloat16 (the reduced-precision cycle): the slab levels' values and
// dinv and the entry level's b, x and output are bf16; the TPU kernel
// upcasts them at entry / use and runs the whole sub-cycle in f32, the
// coarse inverse f32. Here every workspace buffer stays float32, level
// 0's slot A is a float32 workspace too, and the program's last level-0
// write (flag OUT) also stores its value rounded to bf16 in the output:
// the only bf16 store of the launch. Stencil coefficients arrive as
// float32 (the bf16 level's values, exact).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// per-level pointer and integer tables (ops/cuda_tail.py builds them). A
// stencil level has P_COEF (its k coefficients) and no P_VALS / P_DINV;
// its grid, diagonal index, dinv mode and shifts are in the int table.
enum PtrField { P_VALS, P_DINV, P_COEF, P_TPRE, P_TPOST, P_CTAB, P_AGG, P_B,
                P_XA, P_XB, kPtrFields };
enum IntField { I_N, I_K, I_M, I_NC, I_NX, I_NY, I_NZ, I_DIAG, I_DINV,
                I_NX_MUL, I_NX_SHR, I_NY_MUL, I_NY_SHR, I_OFF,
                I_SX = I_OFF + kMaxOffsets, I_SY = I_SX + kMaxOffsets,
                I_SZ = I_SY + kMaxOffsets, kIntFields = I_SZ + kMaxOffsets };
// program rows: op, level, src slot, dst slot, tau index, next-level
// slot (the coarse correction's source), flags
enum Opcode { OP_STEP, OP_RESTRICT, OP_COARSE, OP_CORRECT, OP_DOT };
enum Slot { S_A, S_B, S_IN, S_Z };
enum Flag { F_POST = 1, F_CORRECTED = 2, F_DOT = 4, F_OUT = 8 };
constexpr int kOpCols = 7;

struct TailArgs {
  const int* prog;
  int nops;
  const long long* ptrs;  // (nlev, kPtrFields) device addresses
  const int* ints;        // (nlev, kIntFields)
  int nlev;
  const void* b0;         // entry level's b, x in (storage per `half`)
  const void* xin;
  float* out;             // level 0's slot A: the output, or (half) f32
  bf16* out16;            // half: the bf16 output (flag OUT), else unused
  int half;               // b0, xin, out16, vals and dinv are bfloat16
  float* bz;              // coarsest level's b and x
  float* xz;
  const float* inv;       // (nz, nz) row-major, or nullptr: no correction
  int nz;
  float* partials;        // one float per block
  float* dot;
};

__device__ __forceinline__ const long long* level_ptrs(const TailArgs& a,
                                                       int l) {
  return a.ptrs + static_cast<size_t>(l) * kPtrFields;
}

// A vector the kernel reads: float32, or bfloat16 widened on load (the
// caller's b and x at the entry level of a bf16 cycle).
struct Vec {
  const void* p;
  int half;
  __device__ __forceinline__ float operator[](size_t j) const {
    return half ? ld(static_cast<const bf16*>(p), j)
                : ld(static_cast<const float*>(p), j);
  }
};

// the float32 buffer of slot s at level l (a write target; never IN)
__device__ __forceinline__ float* x_slot(const TailArgs& a, int l, int s) {
  if (s == S_Z) return a.xz;
  if (l == 0 && s == S_A) return a.out;
  return reinterpret_cast<float*>(level_ptrs(a, l)[s == S_A ? P_XA : P_XB]);
}

__device__ __forceinline__ Vec x_src(const TailArgs& a, int l, int s) {
  if (s == S_IN) return Vec{a.xin, a.half};
  return Vec{x_slot(a, l, s), 0};
}

__device__ __forceinline__ float* b_ws(const TailArgs& a, int l) {
  if (l == a.nlev) return a.bz;
  return reinterpret_cast<float*>(level_ptrs(a, l)[P_B]);
}

__device__ __forceinline__ Vec b_of(const TailArgs& a, int l) {
  if (l == 0) return Vec{a.b0, a.half};
  return Vec{b_ws(a, l), 0};
}

// x_j, or x_j + xc[agg_j] when a coarse correction is folded in
__device__ __forceinline__ float x_at(const Vec& x, const float* xc,
                                      const int* agg, int j) {
  return xc != nullptr ? x[j] + xc[agg[j]] : x[j];
}

// One tail level's values: its slab and dinv, or its stencil (the
// coefficient mode; the flag is uniform across the grid within a phase).
// `I` and `coef` point at the block's shared-memory copy of the level's
// tables.
struct TailVals {
  const void* vals;   // float32, or bfloat16 when `half`
  const void* dinv;   // slab levels: nullptr = none
  const float* coef;  // stencil levels, else nullptr
  const int* I;
  int n;
  int half;
  struct Row {
    int i;
    GridRow g;
  };
  __device__ __forceinline__ Row row(int i) const {
    if (coef == nullptr) return Row{i, GridRow{0, 0, 0}};
    return Row{i, grid_row(i, I[I_NX], I[I_NY],
                           FastDiv{static_cast<unsigned>(I[I_NX_MUL]),
                                   I[I_NX_SHR]},
                           FastDiv{static_cast<unsigned>(I[I_NY_MUL]),
                                   I[I_NY_SHR]})};
  }
  __device__ __forceinline__ float val(const Row& r, int d) const {
    if (coef == nullptr)
      return Vec{vals, half}[static_cast<size_t>(d) * n + r.i];
    return in_grid(r.g, I[I_SX + d], I[I_SY + d], I[I_SZ + d], I[I_NX],
                   I[I_NY], I[I_NZ])
               ? coef[d]
               : 0.0f;
  }
  __device__ __forceinline__ bool has_dinv() const {
    return coef != nullptr ? I[I_DINV] != kDinvNone : dinv != nullptr;
  }
  __device__ __forceinline__ float inv(const Row& r) const {
    if (coef == nullptr) return Vec{dinv, half}[r.i];
    return stencil_inv([&](int d) { return val(r, d); }, I[I_K], I[I_DIAG],
                       I[I_DINV]);
  }
};

__device__ __forceinline__ float row_ax(const TailVals& vs,
                                        const TailVals::Row& r, const Vec& x,
                                        const float* xc, const int* agg) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < kMaxOffsets; ++d) {
    if (d >= vs.I[I_K]) break;
    const int j = r.i + vs.I[I_OFF + d];
    if (j >= 0 && j < vs.n) acc += vs.val(r, d) * x_at(x, xc, agg, j);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) coarse_tail_kernel(TailArgs a) {
  __shared__ int s_ints[kIntFields];
  __shared__ float s_coef[kMaxOffsets];
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int p = 0; p < a.nops; ++p) {
    const int* op = a.prog + static_cast<size_t>(p) * kOpCols;
    const int code = op[0], l = op[1], src = op[2], dst = op[3];
    const int tau = op[4], next = op[5], flags = op[6];
    if (code == OP_COARSE) {
      for (int i = tid; i < a.nz; i += stride) {
        float acc = 0.0f;
        if (a.inv != nullptr)
          for (int j = 0; j < a.nz; ++j)
            acc += a.inv[static_cast<size_t>(i) * a.nz + j] * a.bz[j];
        a.xz[i] = acc;
      }
    } else if (code == OP_DOT) {
      if (blockIdx.x == 0) {
        float v = 0.0f;
        for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
             i += kThreads)
          v += a.partials[i];
        v = block_sum(v);
        if (threadIdx.x == 0) *a.dot = v;
      }
    } else {
      const long long* P = level_ptrs(a, l);
      // the level's int table and coefficients, staged once per phase
      const int* Ig = a.ints + static_cast<size_t>(l) * kIntFields;
      const float* coef = reinterpret_cast<const float*>(P[P_COEF]);
      for (int f = threadIdx.x; f < kIntFields; f += kThreads)
        s_ints[f] = Ig[f];
      if (coef != nullptr && threadIdx.x < kMaxOffsets)
        s_coef[threadIdx.x] = threadIdx.x < Ig[I_K] ? coef[threadIdx.x] : 0.0f;
      __syncthreads();
      const int* I = s_ints;
      const int n = I[I_N];
      const TailVals vs{reinterpret_cast<const void*>(P[P_VALS]),
                        reinterpret_cast<const void*>(P[P_DINV]),
                        coef != nullptr ? s_coef : nullptr, I, n, a.half};
      const Vec b = b_of(a, l);
      const Vec x = x_src(a, l, src);
      if (code == OP_RESTRICT) {
        const int m = I[I_M], nc = I[I_NC];
        const int* ctab = reinterpret_cast<const int*>(P[P_CTAB]);
        float* bn = b_ws(a, l + 1);
        float* xn = l + 1 < a.nlev ? x_slot(a, l + 1, S_A) : nullptr;
        for (int c = tid; c < nc; c += stride) {
          float acc = 0.0f;
          for (int j = 0; j < m; ++j) {
            const int f = ctab[static_cast<size_t>(j) * nc + c];
            if (f >= 0)
              acc += b[f] - row_ax(vs, vs.row(f), x, nullptr, nullptr);
          }
          bn[c] = acc;
          if (xn != nullptr) xn[c] = 0.0f;
        }
      } else {  // OP_STEP, OP_CORRECT
        float* y = x_slot(a, l, dst);
        const int* agg = reinterpret_cast<const int*>(P[P_AGG]);
        const float* xc =
            (flags & F_CORRECTED) ? x_slot(a, l + 1, next) : nullptr;
        const bool has_dinv = vs.has_dinv();
        const float t = code == OP_STEP
            ? reinterpret_cast<const float*>(
                  P[(flags & F_POST) ? P_TPOST : P_TPRE])[tau]
            : 0.0f;
        float part = 0.0f;
        for (int i = tid; i < n; i += stride) {
          float v;
          if (code == OP_STEP) {
            const TailVals::Row r = vs.row(i);
            float upd = t * (b[i] - row_ax(vs, r, x, xc, agg));
            if (has_dinv) upd *= vs.inv(r);
            v = x_at(x, xc, agg, i) + upd;
          } else {
            v = x[i] + xc[agg[i]];
          }
          y[i] = v;
          if (flags & F_OUT) st(a.out16, i, v);
          if (flags & F_DOT) part += v * b[i];
        }
        if (flags & F_DOT) {
          part = block_sum(part);
          if (threadIdx.x == 0) a.partials[blockIdx.x] = part;
        }
      }
    }
    if (p + 1 < a.nops) grid.sync();
  }
}

}  // namespace

extern "C" {

// The grid a launch uses for an entry level of `rows` rows: every block
// co-resident (a cooperative launch requires it), and no more blocks
// than the entry level has rows for. Returns 0 and sets *grid, or a
// negative code: -2 the device cannot launch cooperatively, -3 the
// kernel fits no block on an SM; else a cudaError_t.
int amgx_tail_grid(int rows, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, coarse_tail_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return -2;
  if (per_sm < 1) return -3;
  const int want = blocks_for(rows > 0 ? rows : 1);
  *grid = want < per_sm * sms ? want : per_sm * sms;
  return 0;
}

// B5: one cooperative launch of `grid` blocks walking `prog` (nops rows
// of kOpCols ints). partials holds `grid` floats. With `half` b0, xin,
// the levels' vals and dinv are bfloat16, `out` is level 0's float32
// slot A and out16 receives the result in bf16 (no dot). A grid larger than
// co-residency is refused by the runtime
// (cudaErrorCooperativeLaunchTooLarge), never shrunk here.
int amgx_dia_coarse_tail(const int* prog, int nops, const long long* ptrs,
                         const int* ints, int nlev, const void* b0,
                         const void* xin, float* out, void* out16, int half,
                         float* bz, float* xz, const float* inv, int nz,
                         float* partials, float* dot, int grid,
                         cudaStream_t stream) {
  if (nops < 1 || nlev < 1 || nz < 1 || grid < 1) return -1;
  if (half && (out16 == nullptr || dot != nullptr)) return -1;
  TailArgs a{prog,  nops, ptrs, ints, nlev, b0, xin, out,
             static_cast<bf16*>(out16), half, bz, xz, inv, nz, partials,
             dot};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(coarse_tail_kernel), dim3(grid),
      dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
