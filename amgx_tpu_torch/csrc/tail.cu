// The coarse-tail sub-cycle in one launch for Hopper (sm_90a): the CUDA
// counterpart of the Pallas TPU kernel B5 `_dia_coarse_tail_call` (body
// `_tail_compute`, amgx_tpu/ops/pallas_spmv.py), bound through a plain C
// interface (ctypes, amgx_tpu_torch/ops/cuda_tail.py).
//
// The TPU kernel holds every tail level in VMEM and runs the whole
// sub-cycle (pre-sweeps, restriction, recursion, coarsest solve,
// prolongation, post-sweeps on every level from the entry down) in one
// grid step. The host flattens the V/W/F recursion once per (hierarchy,
// shape, dot) into a small int32 phase program that the kernel walks:
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
// What bounds it: at these sizes (the entry level has at most 65536
// rows, the flagship's 32768) neither bytes nor flops -- the whole tail
// moves about 2.5 MB -- but the chain of dependent phases, ~34 for the
// flagship's V tail: each phase must finish everywhere before the next
// reads its rows, so a phase costs a barrier plus the latency of its
// rows' dependent loads.
//
// Design: ONE thread-block cluster (cudaLaunchKernelEx with a cluster
// dimension; up to 16 blocks of 1024 threads, sized by the host from
// cudaOccupancyMaxActiveClusters), the tail's vectors in the cluster's
// distributed shared memory:
//
//   - every level's x_A, x_B and b (level 0: x_A and x_B; its b and the
//     caller's x stay in global memory, read-only) and the coarse b_z,
//     x_z live in shared memory: on a level wider than the host's
//     BLOCK_ROWS each block holds a power-of-two slice of consecutive
//     rows, on a narrower one block 0 holds all of it. Rows of other
//     blocks (a stencil neighbour, a restriction child, a coarse
//     correction) are read and written through the cluster's
//     shared-memory window (map_shared_rank); only the read-only
//     operands (slabs, dinv, ctab, agg, the damping factors, the coarse
//     inverse) come from global memory;
//   - a phase on a wider level runs across the cluster, each block on
//     the rows it holds, and ends at a cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire: every block's
//     writes, shared memory included, are visible to every block after
//     it); a phase on a narrower level runs in block 0 alone, with
//     __syncthreads() between such phases, the other blocks going
//     straight to the cluster barrier that closes the block-local run.
//     A launch whose last phase reads other blocks' rows ends at a
//     cluster barrier, so no block leaves while its shared memory is
//     read.
//
// The level tables and the program are staged in shared memory once per
// launch. The entry level's last write (flag OUT) also stores its rows in
// the output.
//
// Stencil levels (the coefficient mode, `_tail_compute`'s `level_vals`
// matrix-free branch): a level whose operator is a constant-coefficient
// grid stencil carries its k coefficients, shifts and grid shape in the
// per-level tables instead of a value slab, and the kernel synthesizes
// the values and the diagonal inverse from them (common.cuh), with the
// same arithmetic as on a slab level.
//
// bfloat16 (the reduced-precision cycle): the slab levels' values and
// dinv and the entry level's b, x and output are bf16; the TPU kernel
// upcasts them at entry / use and runs the whole sub-cycle in f32, the
// coarse inverse f32. Here the shared-memory vectors are float32 and the
// OUT store rounds to bf16: the only bf16 store of the launch. Stencil
// coefficients arrive as float32 (the bf16 level's values, exact).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// per-level pointer and integer tables (ops/cuda_tail.py builds them). A
// stencil level has P_COEF (its k coefficients) and no P_VALS / P_DINV;
// its grid, diagonal index, dinv mode and shifts are in the int table,
// with the level's place in shared memory: the rows a block holds
// (1 << SH) and the offsets (floats) of its b, x_A and x_B arrays.
enum PtrField { P_VALS, P_DINV, P_COEF, P_TPRE, P_TPOST, P_CTAB, P_AGG,
                kPtrFields };
enum IntField { I_N, I_K, I_M, I_NC, I_NX, I_NY, I_NZ, I_DIAG, I_DINV,
                I_NX_MUL, I_NX_SHR, I_NY_MUL, I_NY_SHR, I_SH, I_OB, I_OXA,
                I_OXB, I_OFF, I_SX = I_OFF + kMaxOffsets,
                I_SY = I_SX + kMaxOffsets, I_SZ = I_SY + kMaxOffsets,
                kIntFields = I_SZ + kMaxOffsets };
// program rows: op, level, src slot, dst slot, tau index, next-level
// slot (the coarse correction's source), flags, the barrier after it
enum Opcode { OP_STEP, OP_RESTRICT, OP_COARSE, OP_CORRECT, OP_DOT };
enum Slot { S_A, S_B, S_IN, S_Z };
enum Flag { F_POST = 1, F_CORRECTED = 2, F_DOT = 4, F_OUT = 8, F_LOCAL = 16 };
enum Barrier { BAR_NONE, BAR_BLOCK, BAR_CLUSTER };
constexpr int kOpCols = 8;
constexpr int kTailThreads = 1024;
constexpr int kMaxCluster = 16;   // non-portable; 8 is the portable size
constexpr int kGather = 8;        // diagonals a row gathers before it adds
constexpr int kMaxLevels = 16;
constexpr int kMaxStagedOps = 512;

struct TailArgs {
  const int* prog;
  int nops;
  const long long* ptrs;  // (nlev, kPtrFields) device addresses
  const int* ints;        // (nlev, kIntFields)
  int nlev;
  const void* b0;         // entry level's b, x in (storage VT)
  const void* xin;
  void* out;              // the result (storage VT)
  const float* inv;       // (nz, nz) row-major, or nullptr: no correction
  int nz;
  int sh_z, off_bz, off_xz;  // the coarse b_z, x_z in shared memory
  int off_part;           // the blocks' partials of x'.b (block 0's)
  float* dot;
  long long* clock;       // nullptr, or nops + 1 SM clock readings
};

__host__ __device__ size_t tables_bytes(int nlev, int nops) {
  const size_t b = static_cast<size_t>(nlev) *
                       (kPtrFields * sizeof(long long) +
                        kIntFields * sizeof(int) +
                        kMaxOffsets * sizeof(float)) +
                   (nops <= kMaxStagedOps
                        ? static_cast<size_t>(nops) * kOpCols * sizeof(int)
                        : 0);
  return (b + 15) & ~static_cast<size_t>(15);
}

// The launch's shared memory: the level tables (and the program when it
// fits kMaxStagedOps rows), then the vectors.
struct Tables {
  const long long* ptrs;  // (nlev, kPtrFields)
  const int* ints;        // (nlev, kIntFields)
  const float* coef;      // (nlev, kMaxOffsets), 0 past a level's k
  const int* prog;
  float* vec;             // this block's vector arrays
};

__device__ Tables stage_tables(const TailArgs& a, unsigned char* smem) {
  long long* ptrs = reinterpret_cast<long long*>(smem);
  int* ints = reinterpret_cast<int*>(ptrs + a.nlev * kPtrFields);
  float* coef = reinterpret_cast<float*>(ints + a.nlev * kIntFields);
  int* prog = reinterpret_cast<int*>(coef + a.nlev * kMaxOffsets);
  for (int f = threadIdx.x; f < a.nlev * kPtrFields; f += blockDim.x)
    ptrs[f] = a.ptrs[f];
  for (int f = threadIdx.x; f < a.nlev * kIntFields; f += blockDim.x)
    ints[f] = a.ints[f];
  const bool staged = a.nops <= kMaxStagedOps;
  if (staged)
    for (int f = threadIdx.x; f < a.nops * kOpCols; f += blockDim.x)
      prog[f] = a.prog[f];
  for (int f = threadIdx.x; f < a.nlev * kMaxOffsets; f += blockDim.x) {
    const int l = f / kMaxOffsets, d = f % kMaxOffsets;
    const float* c = reinterpret_cast<const float*>(
        a.ptrs[l * kPtrFields + P_COEF]);
    coef[f] = c != nullptr && d < a.ints[l * kIntFields + I_K] ? c[d] : 0.0f;
  }
  __syncthreads();
  return Tables{ptrs, ints, coef, staged ? prog : a.prog,
                reinterpret_cast<float*>(
                    smem + tables_bytes(a.nlev, a.nops))};
}

// read-only global operands, through the read-only path
__device__ __forceinline__ float ldr(const float* p, size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ldr(const bf16* p, size_t i) {
  return __bfloat162float(__ldg(p + i));
}

// A vector operand the launch never writes: the caller's b or x
// (storage T), in global memory.
template <class T>
struct InVec {
  const T* p;
  __device__ __forceinline__ float operator[](int j) const {
    return ldr(p, j);
  }
};

// A float32 vector in the cluster's shared memory: row j lives in block
// j >> sh, at j & (2^sh - 1) of that block's array (`base` is this
// block's). at(j) is its address in the cluster's shared-memory window;
// mine(j) the address of a row this block holds.
struct SmVec {
  float* base;
  int sh;
  __device__ __forceinline__ float* at(int j) const {
    return cg::this_cluster().map_shared_rank(base + (j & ((1 << sh) - 1)),
                                              j >> sh);
  }
  __device__ __forceinline__ float* mine(int j) const {
    return base + (j & ((1 << sh) - 1));
  }
  __device__ __forceinline__ float operator[](int j) const { return *at(j); }
};

// slot s of level l (never IN; S_Z: the coarse x_z)
__device__ __forceinline__ SmVec x_slot(const TailArgs& a, const Tables& t,
                                        int l, int s) {
  if (s == S_Z) return SmVec{t.vec + a.off_xz, a.sh_z};
  const int* I = t.ints + l * kIntFields;
  return SmVec{t.vec + I[s == S_A ? I_OXA : I_OXB], I[I_SH]};
}

// level l's b (l == nlev: the coarse b_z)
__device__ __forceinline__ SmVec b_vec(const TailArgs& a, const Tables& t,
                                       int l) {
  if (l == a.nlev) return SmVec{t.vec + a.off_bz, a.sh_z};
  const int* I = t.ints + l * kIntFields;
  return SmVec{t.vec + I[I_OB], I[I_SH]};
}

// One tail level's operator as a phase reads it: a value slab of
// storage VT, or a stencil. `I` and `coef` point at the launch's
// shared-memory tables.
template <class VT>
struct SlabLevel {
  const VT* vals;
  const VT* dinv;  // nullptr = none
  const int* I;
  int n;
  struct Row {
    int i;
  };
  __device__ __forceinline__ Row row(int i) const { return Row{i}; }
  __device__ __forceinline__ float val(const Row& r, int d) const {
    return ldr(vals, static_cast<size_t>(d) * n + r.i);
  }
  __device__ __forceinline__ bool has_dinv() const { return dinv != nullptr; }
  __device__ __forceinline__ float inv(const Row& r) const {
    return ldr(dinv, r.i);
  }
};

// the coefficient mode (`_tail_compute`'s matrix-free branch): values
// and the diagonal inverse synthesized from the level's stencil
struct StencilLevel {
  const float* coef;
  const int* I;
  int n;
  using Row = GridRow;
  __device__ __forceinline__ Row row(int i) const {
    return grid_row(i, I[I_NX], I[I_NY],
                    FastDiv{static_cast<unsigned>(I[I_NX_MUL]), I[I_NX_SHR]},
                    FastDiv{static_cast<unsigned>(I[I_NY_MUL]), I[I_NY_SHR]});
  }
  __device__ __forceinline__ float val(const Row& g, int d) const {
    return in_grid(g, I[I_SX + d], I[I_SY + d], I[I_SZ + d], I[I_NX],
                   I[I_NY], I[I_NZ])
               ? coef[d]
               : 0.0f;
  }
  __device__ __forceinline__ bool has_dinv() const {
    return I[I_DINV] != kDinvNone;
  }
  __device__ __forceinline__ float inv(const Row& g) const {
    return stencil_inv([&](int d) { return val(g, d); }, I[I_K], I[I_DIAG],
                       I[I_DINV]);
  }
};

// x_j, or (kCorr) x_j + xc[agg_j]: x with the coarse correction folded in
template <bool kCorr, class XV>
__device__ __forceinline__ float x_at(const XV& x, const SmVec& xc,
                                      const int* agg, int j) {
  return kCorr ? x[j] + xc[__ldg(agg + j)] : x[j];
}

// (A x)_i of row r (row index i), the diagonals in ascending offset
// order. A row of at most kGather diagonals loads all its operands before
// the first add.
template <bool kCorr, class LV, class XV>
__device__ __forceinline__ float row_ax(const LV& lv,
                                        const typename LV::Row& r, int i,
                                        const XV& x, const SmVec& xc,
                                        const int* agg) {
  const int k = lv.I[I_K];
  float acc = 0.0f;
  if (k > kGather) {
    for (int d = 0; d < k; ++d) {
      const int j = i + lv.I[I_OFF + d];
      if (j >= 0 && j < lv.n) acc += lv.val(r, d) * x_at<kCorr>(x, xc, agg, j);
    }
    return acc;
  }
  float xv[kGather], av[kGather];
  bool in[kGather];
#pragma unroll
  for (int d = 0; d < kGather; ++d) {
    const int j = i + lv.I[I_OFF + d];
    in[d] = d < k && j >= 0 && j < lv.n;
    xv[d] = in[d] ? x_at<kCorr>(x, xc, agg, j) : 0.0f;
    av[d] = in[d] ? lv.val(r, d) : 0.0f;
  }
#pragma unroll
  for (int d = 0; d < kGather; ++d)
    if (in[d]) acc += av[d] * xv[d];
  return acc;
}

// What a STEP or CORRECT phase reads and writes besides x and b.
struct PhaseOut {
  SmVec y;        // the slot written
  SmVec xc;       // the coarse correction (F_CORRECTED)
  const int* agg;
  float tw;       // the damping factor of a STEP
  int flags;
  float part;     // F_DOT: this thread's share of x'.b
};

// STEP (x' = x + (tw (b - A x)) dinv, x read with the correction folded
// in when kCorr) or CORRECT (x' = x + xc[agg]) over the rows this block
// holds, [lo, hi).
template <bool kCorr, class VT, class LV, class XV, class BV>
__device__ __forceinline__ void step_rows(const TailArgs& a, const LV& lv,
                                          const XV& x, const BV& b,
                                          bool step, int lo, int hi,
                                          PhaseOut& o) {
  const bool has_dinv = lv.has_dinv();
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float v;
    if (!step) {
      v = x_at<true>(x, o.xc, o.agg, i);
    } else {
      const typename LV::Row r = lv.row(i);
      const float di = has_dinv ? lv.inv(r) : 1.0f;
      const float bi = b[i];
      const float xi = x_at<kCorr>(x, o.xc, o.agg, i);
      float upd = o.tw * (bi - row_ax<kCorr>(lv, r, i, x, o.xc, o.agg));
      if (has_dinv) upd *= di;
      v = xi + upd;
    }
    *o.y.mine(i) = v;
    if (o.flags & F_OUT) st(static_cast<VT*>(a.out), i, v);
    if (o.flags & F_DOT) o.part += v * b[i];
  }
}

// This block's share [lo, hi) of a phase's `total` work items: all of
// them in a block-local phase, else a warp-aligned chunk of each block.
__device__ __forceinline__ void item_range(int total, bool local, int* lo,
                                           int* hi) {
  if (local) {
    *lo = 0;
    *hi = total;
    return;
  }
  const int per = ((total + gridDim.x - 1) / gridDim.x + 31) & ~31;
  *lo = min(total, static_cast<int>(blockIdx.x) * per);
  *hi = min(total, *lo + per);
}

// RESTRICT: b_{l+1}[c] = sum_j (b - A x)[ctab[j, c]], x_{l+1}[c] = 0. The
// children of a coarse row sit on G = pow2 >= m consecutive lanes, each
// lane computing one child's residual; the group's first lane adds them
// in ctab order (shuffles), so the sum is the serial one, bit for bit.
// Groups of more than 32 children: one thread a coarse row.
template <class LV, class XV, class BV>
__device__ __forceinline__ void restrict_rows(const LV& lv, const XV& x,
                                              const BV& b, const int* ctab,
                                              int m, int nc, const SmVec& bn,
                                              const SmVec* xn, bool local) {
  const SmVec none{nullptr, 0};
  auto residual = [&](int f) {
    return b[f] - row_ax<false>(lv, lv.row(f), f, x, none, nullptr);
  };
  int lo, hi;
  if (m > 32) {
    item_range(nc, local, &lo, &hi);
    for (int c = lo + threadIdx.x; c < hi; c += blockDim.x) {
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) {
        const int f = __ldg(ctab + static_cast<size_t>(j) * nc + c);
        if (f >= 0) acc += residual(f);
      }
      *bn.at(c) = acc;
      if (xn != nullptr) *xn->at(c) = 0.0f;
    }
    return;
  }
  int g = 1;
  while (g < m) g *= 2;
  const int lane = threadIdx.x & 31, first = lane & ~(g - 1);
  item_range(nc * g, local, &lo, &hi);
  // whole warps walk the warp-aligned range: every lane takes part in
  // the shuffles
  const int end = lo + ((hi - lo + 31) & ~31);
  for (int u = lo + threadIdx.x; u < end; u += blockDim.x) {
    const int c = u / g, j = u % g;
    const int f = u < hi && j < m
        ? __ldg(ctab + static_cast<size_t>(j) * nc + c) : -1;
    const float r = f >= 0 ? residual(f) : 0.0f;
    float acc = 0.0f;
    for (int jj = 0; jj < g; ++jj) {
      const float rj = __shfl_sync(0xffffffffu, r, first + jj);
      const int fj = __shfl_sync(0xffffffffu, f, first + jj);
      if (fj >= 0) acc += rj;
    }
    if (j == 0 && u < hi) {
      *bn.at(c) = acc;
      if (xn != nullptr) *xn->at(c) = 0.0f;
    }
  }
}

// COARSE: x_z = inv b_z, or 0. 16 lanes a row, each adding its stretch
// of the row in order, then a fixed shuffle tree.
__device__ __forceinline__ void coarse_rows(const TailArgs& a,
                                            const Tables& t, bool local) {
  constexpr int kG = 16;
  const SmVec bz = b_vec(a, t, a.nlev), xz = x_slot(a, t, 0, S_Z);
  const int nz = a.nz, chunk = (nz + kG - 1) / kG;
  int lo, hi;
  item_range(nz * kG, local, &lo, &hi);
  const int end = lo + ((hi - lo + 31) & ~31);
  for (int u = lo + threadIdx.x; u < end; u += blockDim.x) {
    const int i = u / kG, g = u % kG;
    float acc = 0.0f;
    if (u < hi && a.inv != nullptr) {
      const int j1 = min(nz, (g + 1) * chunk);
      for (int j = g * chunk; j < j1; ++j)
        acc += __ldg(a.inv + static_cast<size_t>(i) * nz + j) * bz[j];
    }
    for (int o = kG / 2; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o, kG);
    if (g == 0 && u < hi) *xz.at(i) = acc;
  }
}

// A STEP, CORRECT or RESTRICT phase on level l, on the level type LV and
// the vector operands XV (the x read) and BV (the level's b).
template <class VT, class LV, class XV, class BV>
__device__ void level_phase(const TailArgs& a, const Tables& t, const int* op,
                            const LV& lv, const XV& x, const BV& b) {
  const int code = op[0], l = op[1], dst = op[3];
  const int tau = op[4], next = op[5], flags = op[6];
  const long long* P = t.ptrs + l * kPtrFields;
  if (code == OP_RESTRICT) {
    const SmVec xn = x_slot(a, t, l + 1, S_A);
    restrict_rows(lv, x, b, reinterpret_cast<const int*>(P[P_CTAB]),
                  lv.I[I_M], lv.I[I_NC], b_vec(a, t, l + 1),
                  l + 1 < a.nlev ? &xn : nullptr, flags & F_LOCAL);
    return;
  }
  const bool step = code == OP_STEP;
  const SmVec none{nullptr, 0};
  PhaseOut o{x_slot(a, t, l, dst),
             (flags & F_CORRECTED) ? x_slot(a, t, l + 1, next) : none,
             reinterpret_cast<const int*>(P[P_AGG]),
             step ? __ldg(reinterpret_cast<const float*>(
                        P[(flags & F_POST) ? P_TPOST : P_TPRE]) + tau)
                  : 0.0f,
             flags, 0.0f};
  // the rows this block holds (block 0: all rows of a block-local level)
  const int lo = static_cast<int>(blockIdx.x) << lv.I[I_SH];
  const int hi = min(lv.n, lo + (1 << lv.I[I_SH]));
  if (step && (flags & F_CORRECTED))
    step_rows<true, VT>(a, lv, x, b, true, lo, hi, o);
  else
    step_rows<false, VT>(a, lv, x, b, step, lo, hi, o);
  if (flags & F_DOT) {
    o.part = block_sum(o.part);
    if (threadIdx.x == 0)
      *cg::this_cluster().map_shared_rank(t.vec + a.off_part + blockIdx.x,
                                          0) = o.part;
  }
}

// The phase's vectors: level 0's b and (slot IN) x are the caller's, of
// storage VT, in global memory; every other vector lives in the
// cluster's shared memory.
template <class VT, class LV>
__device__ __forceinline__ void vector_phase(const TailArgs& a,
                                             const Tables& t, const int* op,
                                             const LV& lv) {
  const int l = op[1], src = op[2];
  const InVec<VT> b0{static_cast<const VT*>(a.b0)};
  if (l == 0 && src == S_IN)
    level_phase<VT>(a, t, op, lv, InVec<VT>{static_cast<const VT*>(a.xin)},
                    b0);
  else if (l == 0)
    level_phase<VT>(a, t, op, lv, x_slot(a, t, l, src), b0);
  else
    level_phase<VT>(a, t, op, lv, x_slot(a, t, l, src), b_vec(a, t, l));
}

// One phase in the blocks that run it: the whole cluster, or (F_LOCAL)
// block 0 alone. `parts`: the blocks whose partials a DOT adds (those
// that ran the phase before it). VT: the storage of the caller's vectors
// and the value slabs (float32 or bfloat16).
template <class VT>
__device__ void run_phase(const TailArgs& a, const Tables& t, const int* op,
                          int parts) {
  const int code = op[0], l = op[1];
  if (code == OP_COARSE) {
    coarse_rows(a, t, op[6] & F_LOCAL);
    return;
  }
  if (code == OP_DOT) {
    float v = 0.0f;
    for (int i = threadIdx.x; i < parts; i += blockDim.x)
      v += t.vec[a.off_part + i];
    v = block_sum(v);
    if (threadIdx.x == 0) *a.dot = v;
    return;
  }
  const long long* P = t.ptrs + l * kPtrFields;
  const int* I = t.ints + l * kIntFields;
  if (P[P_COEF] != 0)
    vector_phase<VT>(a, t, op,
                     StencilLevel{t.coef + l * kMaxOffsets, I, I[I_N]});
  else
    vector_phase<VT>(a, t, op,
                     SlabLevel<VT>{reinterpret_cast<const VT*>(P[P_VALS]),
                                   reinterpret_cast<const VT*>(P[P_DINV]),
                                   I, I[I_N]});
}

template <class VT>
__global__ void __launch_bounds__(kTailThreads, 1)
coarse_tail_kernel(TailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables t = stage_tables(a, smem);
  cg::cluster_group cluster = cg::this_cluster();
  // the phase clock: block 0's clock after staging and after each
  // phase's barrier (a measuring aid; off when `clock` is null)
  const bool stamp = a.clock != nullptr && blockIdx.x == 0 &&
                     threadIdx.x == 0;
  if (stamp) a.clock[0] = clock64();
  int parts = 1;
  for (int p = 0; p < a.nops; ++p) {
    const int* op = t.prog + static_cast<size_t>(p) * kOpCols;
    const bool local = op[6] & F_LOCAL;
    if (!local || blockIdx.x == 0) run_phase<VT>(a, t, op, parts);
    parts = local ? 1 : gridDim.x;
    if (op[7] == BAR_CLUSTER)
      cluster.sync();
    else if (op[7] == BAR_BLOCK && blockIdx.x == 0)
      __syncthreads();
    if (stamp) a.clock[p + 1] = clock64();
  }
}

// One block barrier or cluster barrier after another, `iters` times: the
// card's cost of each (the tail's phase-chain floor).
template <bool kCluster>
__global__ void __launch_bounds__(kTailThreads, 1)
barrier_probe_kernel(int iters) {
  for (int i = 0; i < iters; ++i) {
    if (kCluster)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
}

template <class... Args>
cudaError_t launch_cluster(void (*kernel)(Args...), int cluster, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kTailThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// let a kernel take a 16-block cluster and `smem` bytes of dynamic
// shared memory
template <class... Args>
cudaError_t allow(void (*kernel)(Args...), size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  return e;
}

}  // namespace

extern "C" {

// The dynamic shared memory of a launch: the tables of `nlev` levels and
// `nops` phases, then `vec_floats` floats of vectors a block holds.
long long amgx_tail_smem(int nlev, int nops, int vec_floats) {
  return static_cast<long long>(tables_bytes(nlev, nops)) +
         4LL * vec_floats;
}

// How many clusters of `cluster` 1024-thread blocks with `smem` bytes of
// dynamic shared memory the card holds at once
// (cudaOccupancyMaxActiveClusters) for the float32 or (half) the
// bfloat16 kernel, in *active. Returns 0, -1 (arguments), else a
// cudaError_t.
int amgx_tail_clusters(int cluster, long long smem, int half, int* active) {
  if (cluster < 1 || cluster > kMaxCluster || smem < 0) return -1;
  void (*kernel)(TailArgs) =
      half ? coarse_tail_kernel<bf16> : coarse_tail_kernel<float>;
  cudaError_t e = allow(kernel, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kTailThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  *active = 0;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(active, kernel, &cfg));
}

// B5: one launch of a `cluster`-block cluster walking `prog` (nops rows
// of kOpCols ints) with `smem` bytes of dynamic shared memory
// (amgx_tail_smem; amgx_tail_clusters has let the kernel take it). With
// `half` b0, xin, out and the levels' vals and dinv are bfloat16 (no
// dot). `clock`, when not null, receives nops + 1 SM clock readings (the
// phase clock). A cluster the card cannot hold is refused by the
// runtime, never shrunk here.
int amgx_dia_coarse_tail(const int* prog, int nops, const long long* ptrs,
                         const int* ints, int nlev, const void* b0,
                         const void* xin, void* out, int half,
                         const float* inv, int nz, int sh_z, int off_bz,
                         int off_xz, int off_part, float* dot, int cluster,
                         long long smem, long long* clock,
                         cudaStream_t stream) {
  if (nops < 1 || nlev < 1 || nlev > kMaxLevels || nz < 1 || cluster < 1 ||
      cluster > kMaxCluster || smem < 0)
    return -1;
  if (half && dot != nullptr) return -1;
  TailArgs a{prog, nops, ptrs,   ints,   nlev,   b0,       xin,
             out,  inv,  nz,     sh_z,   off_bz, off_xz,   off_part,
             dot,  clock};
  const cudaError_t e =
      half ? launch_cluster(coarse_tail_kernel<bf16>, cluster,
                            static_cast<size_t>(smem), stream, a)
           : launch_cluster(coarse_tail_kernel<float>, cluster,
                            static_cast<size_t>(smem), stream, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// `iters` barriers in one launch of a `cluster`-block cluster: cluster
// barriers (`kind` 1) or block barriers (0). Timing launches of two
// counts gives the cost of one.
int amgx_tail_barrier_probe(int cluster, int iters, int kind,
                            cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || iters < 0) return -1;
  cudaError_t e = kind ? allow(barrier_probe_kernel<true>, 0)
                       : allow(barrier_probe_kernel<false>, 0);
  if (e == cudaSuccess)
    e = kind ? launch_cluster(barrier_probe_kernel<true>, cluster, 0, stream,
                              iters)
             : launch_cluster(barrier_probe_kernel<false>, cluster, 0,
                              stream, iters);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
