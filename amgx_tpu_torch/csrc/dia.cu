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
// `weighted=` forms of the TPU kernels): a fine row is a child of up to
// interp_max_elements coarse rows and a row of P holds as many entries, so
// recomputing r (or x + P xc) at each use, as the unit-weight epilogue
// and prologue do, would repeat each row's work ~3x. The weighted calls
// therefore compute each row's transfer quantity once: r = b - A x' is
// stored in float32 (for bf16 operands too) by the residual kernel below
// after the per-step launches, or by the tiled slab launch on a grid
// level (stencil_tb.cuh), and B8's row-block kernel (csr.cu) sums bc = R
// r over R's compact rows; `amgx_dia_prolong_w` stores x + P xc in
// float32 and the first step reads it as the float32 state.
//
// The coefficient ("matrix-free") mode of the TPU kernels (B2-mf, B3-mf,
// B4-mf: `_dia_stencil_smooth_call`, `_dia_stencil_smooth_restrict_call`,
// `_dia_stencil_prolong_smooth_call`): on a constant-coefficient grid
// level the value slab is k scalars repeated, so these kernels take the
// k coefficients, the grid shifts and the grid shape by value and
// synthesize row i's values from its grid coordinates (one div/mod pair
// per row); the diagonal inverse (none, "jacobi" or "l1") is synthesized
// too. The value source is a template parameter (common.cuh SlabVals /
// StencilVals): everything below the value fetch is the slab kernels'
// code, so both fetch the same values in the same order. Bound by bytes:
// a step streams b and x and writes x' (12 bytes a row against the
// slab's 40 with dinv at k = 7). B3-mf and B4-mf no longer launch these
// per step: csrc/stencil_tb.cu runs all of a call's steps in one launch;
// B2-mf still does, and B3-mf's restriction on children tables that
// cross its tiles is amgx_dia_restrict_mf below.
//
// The bfloat16 forms (the reduced-precision cycle, `solve_precision=
// bfloat16`; the TPU kernels' bf16 operand dtype): the value slab, dinv,
// b, xc, the first step's x, the last step's x' and the outputs r / bc
// are stored in bf16 and widened on load; every sum is float32, in the
// order of the float32 kernels. The TPU kernel keeps the state in f32
// across all steps of a call (VMEM) and rounds only its final stores;
// here the state crosses device memory between launches, so steps
// 1..s-1 read and write a float32 scratch and only the first load and
// the last store are bf16 (a bf16 store per step would round the state s
// times, the XLA route's rounding, which triples the flagship's inner
// iterations). The last step also keeps its float32 state (`keep`) for
// the residual / restriction launch, which recomputes r from it, as the
// TPU kernel does from its f32 `s`. Bound by bytes: the streams that are
// bf16 move half the bytes, the f32 scratch (8 bytes a row per middle
// step) does not shrink. The float32 instantiations are unchanged.
#include "common.cuh"

#include <type_traits>

namespace {

__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, int n, Offsets of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const SlabVals vs{vals, nullptr, n};
  if (i < n) y[i] = dia_row(vs, vs.row(i), PlainX{x}, n, i, of);
}

// One damped-relaxation step x' = x + (tau_t * (b - A x)) * dinv, the
// values (and dinv) from the source VS, b of storage type BT, x' stored
// as OT (and, when `keep` is given, also as float32 there). With kDot the
// launch also returns x'.b (B4's dot epilogue, PCG's r.z): per-block
// partials, added in block order by the last block to finish (DotOut).

template <class VS, class XR, class BT, class OT, bool kHasDinv, bool kDot>
__global__ void __launch_bounds__(kThreads)
dia_step_kernel(VS vs, const float* __restrict__ taus, int t,
                const BT* __restrict__ b, XR xr, OT* __restrict__ out,
                float* __restrict__ keep, int n, Offsets of, DotOut dot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float part = 0.0f;
  if (i < n) {
    const typename VS::Row r = vs.row(i);
    float upd = taus[t] * (ld(b, i) - dia_row(vs, r, xr, n, i, of));
    if (kHasDinv) upd *= vs.inv(r, i, of.k);
    const float v = xr(i) + upd;
    st(out, i, v);
    if (keep != nullptr) keep[i] = v;
    if (kDot) part = v * ld(b, i);
  }
  if (kDot) finish_dot(part, dot.partials, dot.counter, dot.out);
}

// r = b - A x, x the float32 state, b of storage type BT, r of RT (BT,
// or float32: the weighted restriction's residual, never rounded).
template <class VS, class BT, class RT>
__global__ void __launch_bounds__(kThreads)
dia_residual_kernel(VS vs, const BT* __restrict__ b,
                    const float* __restrict__ x, RT* __restrict__ r, int n,
                    Offsets of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    st(r, i, ld(b, i) - dia_row(vs, vs.row(i), PlainX{x}, n, i, of));
}

// bc[c] = sum_j r[ctab[j, c]] with r = b - A x recomputed at each child:
// one thread per coarse row, a fixed summation order, no atomics, and r
// never written to memory; x is the float32 state, the sum float32, bc
// stored once as BT. For unit-weight tables only, where each fine row has
// one coarse row (the SIZE_2 pairs after the tiled steps, B3-mf's
// epilogue) and nothing is recomputed.
template <class VS, class BT>
__global__ void __launch_bounds__(kThreads)
dia_restrict_kernel(VS vs, const BT* __restrict__ b,
                    const float* __restrict__ x,
                    const int* __restrict__ ctab, int m, int nc,
                    BT* __restrict__ bc, int n, Offsets of) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  float acc = 0.0f;
  for (int j = 0; j < m; ++j) {
    const int f = ctab[static_cast<size_t>(j) * nc + c];
    if (f < 0) continue;
    const float r = ld(b, f) - dia_row(vs, vs.row(f), PlainX{x}, n, f, of);
    acc += r;
  }
  st(bc, c, acc);
}

// x + P xc at row j through the (mp, n) tables of P's rows (-1 / 0 past a
// row's end): the correction a chain of fused multiply-adds over the
// row's entries in order from 0, then x_j added, float32 and not rounded
// to T (x, xc and the weights of storage type T). B4w's prologue
// (`amgx_dia_prolong_w` below: a row's sum once, before the steps).
template <class T>
struct WeightedXT {
  const T* __restrict__ x;
  const T* __restrict__ xc;
  const int* __restrict__ ptab;
  const T* __restrict__ pwt;
  int mp;
  int n;
  __device__ __forceinline__ float operator()(int j) const {
    float corr = 0.0f;
    for (int t = 0; t < mp; ++t) {
      const size_t s = static_cast<size_t>(t) * n + j;
      const int q = ptab[s];
      if (q >= 0) corr = __fmaf_rn(ld(pwt, s), ld(xc, q), corr);
    }
    return ld(x, j) + corr;
  }
};

// B4's weighted prologue: x0 = x + P xc in float32, one thread a row, for
// the first step to read as the float32 state (so every row's correction
// is summed once, not once for each of the k stencil rows that read it).
template <class T>
__global__ void __launch_bounds__(kThreads)
dia_prolong_w_kernel(WeightedXT<T> xr, float* __restrict__ x0, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x0[i] = xr(i);
}

template <class VS, class XR, class BT, class OT, bool kHasDinv>
void launch_step_kernel(const VS& vs, const float* taus, int t, const BT* b,
                        XR xr, OT* out, float* keep, int n, const Offsets& of,
                        const DotOut& dot, cudaStream_t s) {
  // the dot epilogue exists for float32 operands only (a reduced-
  // precision cycle declines it)
  if constexpr (std::is_same<BT, float>::value &&
                std::is_same<OT, float>::value) {
    if (dot.out != nullptr) {
      dia_step_kernel<VS, XR, BT, OT, kHasDinv, true>
          <<<blocks_for(n), kThreads, 0, s>>>(vs, taus, t, b, xr, out, keep,
                                              n, of, dot);
      return;
    }
  }
  dia_step_kernel<VS, XR, BT, OT, kHasDinv, false>
      <<<blocks_for(n), kThreads, 0, s>>>(vs, taus, t, b, xr, out, keep, n,
                                          of, dot);
}

template <class VS, class XR, class BT, class OT>
void launch_step(const VS& vs, bool has_dinv, const float* taus, int t,
                 const BT* b, XR xr, OT* out, float* keep, int n,
                 const Offsets& of, const DotOut& dot, cudaStream_t s) {
  if (has_dinv) {
    launch_step_kernel<VS, XR, BT, OT, true>(vs, taus, t, b, xr, out, keep,
                                             n, of, dot, s);
  } else {
    launch_step_kernel<VS, XR, BT, OT, false>(vs, taus, t, b, xr, out, keep,
                                              n, of, dot, s);
  }
}

// mode bits of a step launch: kBf16 the streams (vals, dinv, b, xc) are
// bfloat16; then kXf32 x is the float32 state (else bfloat16) and kOutF32
// x' is stored as float32 (else bfloat16). 0: everything float32.
enum StepMode { kBf16 = 1, kXf32 = 2, kOutF32 = 4 };

// float32 streams: the first step's x plain or + xc[agg].
template <class VS>
int launch_step_f32(const VS& vs, bool has_dinv, const float* taus, int t,
                    const float* b, const float* x, const float* xc,
                    const int* agg, float* out, float* keep, int n,
                    const Offsets& of, const DotOut& d, cudaStream_t stream) {
  if (xc != nullptr) {
    launch_step(vs, has_dinv, taus, t, b, CorrectedX{x, xc, agg}, out, keep,
                n, of, d, stream);
  } else {
    launch_step(vs, has_dinv, taus, t, b, PlainX{x}, out, keep, n, of, d,
                stream);
  }
  return 0;
}

template <class VS, class XR>
void launch_step_out(const VS& vs, bool has_dinv, int mode,
                     const float* taus, int t, const bf16* b, XR xr,
                     void* out, float* keep, int n, const Offsets& of,
                     cudaStream_t stream) {
  const DotOut none{nullptr, nullptr, nullptr};
  if (mode & kOutF32) {
    launch_step(vs, has_dinv, taus, t, b, xr, static_cast<float*>(out), keep,
                n, of, none, stream);
  } else {
    launch_step(vs, has_dinv, taus, t, b, xr, static_cast<bf16*>(out), keep,
                n, of, none, stream);
  }
}

// bfloat16 streams, no dot; the correction x + xc[agg] rides the first
// step, which reads the caller's bf16 x (or the float32 state, kXf32).
template <class VS>
int launch_step_bf16(const VS& vs, bool has_dinv, int mode, const float* taus,
                     int t, const bf16* b, const void* x, const bf16* xc,
                     const int* agg, void* out, float* keep, int n,
                     const Offsets& of, cudaStream_t stream) {
  if (mode & kXf32) {
    if (xc != nullptr) return -1;
    launch_step_out(vs, has_dinv, mode, taus, t, b,
                    PlainXT<float>{static_cast<const float*>(x)}, out, keep,
                    n, of, stream);
  } else if (xc != nullptr) {
    launch_step_out(vs, has_dinv, mode, taus, t, b,
                    CorrectedXT<bf16>{static_cast<const bf16*>(x), xc, agg},
                    out, keep, n, of, stream);
  } else {
    launch_step_out(vs, has_dinv, mode, taus, t, b,
                    PlainXT<bf16>{static_cast<const bf16*>(x)}, out, keep, n,
                    of, stream);
  }
  return 0;
}

template <class VS, class BT, class RT>
void launch_residual(const VS& vs, const BT* b, const float* x, RT* r, int n,
                     const Offsets& of, cudaStream_t stream) {
  dia_residual_kernel<<<blocks_for(n), kThreads, 0, stream>>>(vs, b, x, r, n,
                                                               of);
}

template <class VS, class BT>
void launch_restrict(const VS& vs, const BT* b, const float* x,
                     const int* ctab, int m, int nc, BT* bc, int n,
                     const Offsets& of, cudaStream_t stream) {
  dia_restrict_kernel<VS, BT><<<blocks_for(nc), kThreads, 0, stream>>>(
      vs, b, x, ctab, m, nc, bc, n, of);
}

bool step_args_ok(const void* xc, const int* agg, const float* partials,
                  const unsigned int* counter, const float* dot, int mode) {
  if ((xc == nullptr) != (agg == nullptr)) return false;
  if (mode < 0 || mode > (kBf16 | kXf32 | kOutF32)) return false;
  if (!(mode & kBf16) && mode != 0) return false;
  if ((mode & kBf16) && dot != nullptr) return false;
  return dot == nullptr || (partials != nullptr && counter != nullptr);
}

// One step, float32 or bfloat16 streams per `mode`: `vf` is the value
// source of the float32 streams, `vb` that of the bfloat16 ones (the
// stencil serves both).
template <class VF, class VB>
int step_any(const VF& vf, const VB& vb, bool has_dinv, int mode,
             const float* taus, int t, const void* b, const void* x,
             const void* xc, const int* agg, void* out, float* keep, int n,
             const Offsets& of, const DotOut& d, cudaStream_t stream) {
  if (mode & kBf16)
    return launch_step_bf16(vb, has_dinv, mode, taus, t,
                            static_cast<const bf16*>(b), x,
                            static_cast<const bf16*>(xc), agg, out, keep, n,
                            of, stream);
  return launch_step_f32(vf, has_dinv, taus, t, static_cast<const float*>(b),
                         static_cast<const float*>(x),
                         static_cast<const float*>(xc), agg,
                         static_cast<float*>(out), keep, n, of, d, stream);
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
// and agg are given (B4's unit-weight prolongation prologue). When dot
// is given, *dot = out.b (B4's epilogue) through `partials` (one float
// per block of 256 rows) and `counter` (zero on entry, left zero).
// `mode` (StepMode) says which operands are bfloat16; with kBf16 the dot
// is refused. `keep`, when given, also receives out as float32.
int amgx_dia_step(const void* vals, const void* dinv, const float* taus,
                  int t, const void* b, const void* x, const void* xc,
                  const int* agg, void* out, float* keep, int n,
                  const int* offs, int k, float* partials,
                  unsigned int* counter, float* dot, int mode,
                  cudaStream_t stream) {
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of)) return -1;
  if (!step_args_ok(xc, agg, partials, counter, dot, mode)) return -1;
  const int rc = step_any(
      SlabVals{static_cast<const float*>(vals),
               static_cast<const float*>(dinv), n},
      SlabValsT<bf16>{static_cast<const bf16*>(vals),
                      static_cast<const bf16*>(dinv), n},
      dinv != nullptr, mode, taus, t, b, x, xc, agg, out, keep, n, of,
      DotOut{partials, counter, dot}, stream);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// B2's trailing residual: r = b - A x, x the float32 state; with `bf16`
// set, vals, b and r are bfloat16, unless `r_f32` stores r as float32
// (B3w's residual, which the restriction reads unrounded).
int amgx_dia_residual(const void* vals, const void* b, const float* x,
                      void* r, int n, const int* offs, int k, int bf16_io,
                      int r_f32, cudaStream_t stream) {
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of)) return -1;
  const SlabValsT<bf16> vb{static_cast<const bf16*>(vals), nullptr, n};
  if (bf16_io && r_f32) {
    launch_residual(vb, static_cast<const bf16*>(b), x, static_cast<float*>(r),
                    n, of, stream);
  } else if (bf16_io) {
    launch_residual(vb, static_cast<const bf16*>(b), x, static_cast<bf16*>(r),
                    n, of, stream);
  } else {
    launch_residual(SlabVals{static_cast<const float*>(vals), nullptr, n},
                    static_cast<const float*>(b), x, static_cast<float*>(r),
                    n, of, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// B3's unit-weight restriction epilogue: bc = R (b - A x) through the
// child table ctab (m, nc), -1 where a coarse row has fewer than m
// children; x is the float32 state. With `bf16_io` set, vals, b and bc
// are bfloat16 (the sum float32, bc rounded once).
int amgx_dia_restrict(const void* vals, const void* b, const float* x,
                      const int* ctab, int m, int nc, void* bc, int n,
                      const int* offs, int k, int bf16_io,
                      cudaStream_t stream) {
  Offsets of;
  if (n < 1 || nc < 1 || m < 1 || !fill_offsets(offs, k, &of)) return -1;
  if (bf16_io) {
    launch_restrict(SlabValsT<bf16>{static_cast<const bf16*>(vals), nullptr,
                                    n},
                    static_cast<const bf16*>(b), x, ctab, m, nc,
                    static_cast<bf16*>(bc), n, of, stream);
  } else {
    launch_restrict(SlabVals{static_cast<const float*>(vals), nullptr, n},
                    static_cast<const float*>(b), x, ctab, m, nc,
                    static_cast<float*>(bc), n, of, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// B4's weighted prologue (B4w): x0 = x + P xc in float32 through the
// (mp, n) tables ptab / pwt of P's rows (-1 / 0 past a row's end), summed
// as common.cuh WeightedXT sums it. With `bf16_io` set, x, xc and pwt are
// bfloat16 (x0 float32 all the same: the first step reads it unrounded).
int amgx_dia_prolong_w(const void* x, const void* xc, const int* ptab,
                       const void* pwt, int mp, float* x0, int n,
                       int bf16_io, cudaStream_t stream) {
  if (n < 1 || mp < 1 || x == nullptr || xc == nullptr || ptab == nullptr ||
      pwt == nullptr || x0 == nullptr)
    return -1;
  if (bf16_io) {
    dia_prolong_w_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        WeightedXT<bf16>{static_cast<const bf16*>(x),
                         static_cast<const bf16*>(xc), ptab,
                         static_cast<const bf16*>(pwt), mp, n},
        x0, n);
  } else {
    dia_prolong_w_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        WeightedXT<float>{static_cast<const float*>(x),
                          static_cast<const float*>(xc), ptab,
                          static_cast<const float*>(pwt), mp, n},
        x0, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The coefficient mode of the three entries above (B2-mf, B3-mf, B4-mf):
// the same kernels with the values and the diagonal inverse synthesized
// from the host stencil `st` (copied into the launch's parameter block);
// no value slab, no dinv vector. The arguments are those of the slab
// entries with `stencil` (a common.cuh Stencil, passed as void* so the C
// symbols keep external linkage) in place of vals and dinv. In the
// bfloat16 mode the coefficients are the bf16 level's values, held as
// float32 (exact), and the synthesized dinv is float32.
int amgx_dia_step_mf(const void* stencil, const float* taus, int t,
                     const void* b, const void* x, const void* xc,
                     const int* agg, void* out, float* keep, int n,
                     const int* offs, int k, float* partials,
                     unsigned int* counter, float* dot, int mode,
                     cudaStream_t stream) {
  const Stencil* st = static_cast<const Stencil*>(stencil);
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of) || !stencil_ok(st, n, k))
    return -1;
  if (!step_args_ok(xc, agg, partials, counter, dot, mode)) return -1;
  const int rc = step_any(StencilVals{*st}, StencilVals{*st},
                          st->dinv != kDinvNone, mode, taus, t, b, x, xc, agg,
                          out, keep, n, of, DotOut{partials, counter, dot},
                          stream);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

int amgx_dia_residual_mf(const void* stencil, const void* b, const float* x,
                         void* r, int n, const int* offs, int k, int bf16_io,
                         cudaStream_t stream) {
  const Stencil* st = static_cast<const Stencil*>(stencil);
  Offsets of;
  if (n < 1 || !fill_offsets(offs, k, &of) || !stencil_ok(st, n, k))
    return -1;
  if (bf16_io) {
    launch_residual(StencilVals{*st}, static_cast<const bf16*>(b), x,
                    static_cast<bf16*>(r), n, of, stream);
  } else {
    launch_residual(StencilVals{*st}, static_cast<const float*>(b), x,
                    static_cast<float*>(r), n, of, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

int amgx_dia_restrict_mf(const void* stencil, const void* b, const float* x,
                         const int* ctab, int m, int nc, void* bc, int n,
                         const int* offs, int k, int bf16_io,
                         cudaStream_t stream) {
  const Stencil* st = static_cast<const Stencil*>(stencil);
  Offsets of;
  if (n < 1 || nc < 1 || m < 1 || !fill_offsets(offs, k, &of) ||
      !stencil_ok(st, n, k))
    return -1;
  if (bf16_io) {
    launch_restrict(StencilVals{*st}, static_cast<const bf16*>(b), x, ctab, m,
                    nc, static_cast<bf16*>(bc), n, of, stream);
  } else {
    launch_restrict(StencilVals{*st}, static_cast<const float*>(b), x, ctab, m,
                    nc, static_cast<float*>(bc), n, of, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched forms (K1, K2): B1 and B2's per-step kernels over a batch of
// systems, the vectors (nsys, n) row-major. The operator is shared by
// every system (stride 0: multi-RHS) or one slab / coefficient set a
// system (multi-matrix). Each system's row is computed by the same
// `dia_row` and the same update expression as the single kernels above,
// so row s of a batched output has the single kernel's bits on system s.
// A thread takes one row of every system when the operator is shared (its
// values leave HBM once for the whole batch; the later systems read them
// from L1), and one row of one system (grid.y = system) when it is not.
// float32 only: the batched solve runs the float32 hierarchy.
// ---------------------------------------------------------------------------
namespace {

// A batch's value sources: what a block stages in shared memory before
// its rows (`stage`), what row i needs of every system (`geom(i)`,
// computed once a thread), then system s's row (`row(s, i, geom)`).
//
// The slab source: system s reads vals + s * vstride and dinv + s *
// dstride (stride 0: shared). Row s, i of it is SlabVals's row i.
struct SlabBatchVals {
  const float* __restrict__ vals;
  const float* __restrict__ dinv;
  int n;
  long long vstride, dstride;
  struct Row {
    int i;
    const float* __restrict__ v;
    const float* __restrict__ d;
  };
  __device__ __forceinline__ void stage(float*) const {}
  __device__ __forceinline__ int geom(int, const float*) const { return 0; }
  __device__ __forceinline__ Row row(int s, int i, int) const {
    return Row{i, vals + s * vstride,
               dinv == nullptr ? nullptr : dinv + s * dstride};
  }
  __device__ __forceinline__ float val(const Row& r, int d) const {
    return r.v[static_cast<size_t>(d) * n + r.i];
  }
  __device__ __forceinline__ float inv(const Row& r, int i, int) const {
    return r.d[i];
  }
};

// The coefficient source: the stencil's geometry by value (its c[]
// unread) and the k coefficients of system s at c + s * cstride in device
// memory (stride 0: shared). A block stages its coefficients in shared
// memory: the shared set, or system blockIdx.y's when the coefficients
// are per system (then a thread takes one system). Row i's geometry is
// the set of its diagonals whose grid shift stays in-grid (one bit each),
// the same for every system. The values and the synthesized dinv are
// StencilVals's, from the same floats.
struct StencilBatchVals {
  Stencil st;
  const float* __restrict__ c;
  int cstride;
  int k;
  struct Row {
    unsigned in;
    const float* c;  // the staged coefficients
  };
  __device__ __forceinline__ void stage(float* smem) const {
    if (threadIdx.x < static_cast<unsigned>(k))
      smem[threadIdx.x] = c[static_cast<size_t>(blockIdx.y) * cstride +
                            threadIdx.x];
  }
  __device__ __forceinline__ Row geom(int i, const float* staged) const {
    const GridRow g = grid_row(i, st.nx, st.ny, st.by_nx, st.by_ny);
    unsigned in = 0u;
#pragma unroll
    for (int d = 0; d < kMaxOffsets; ++d) {
      if (d >= k) break;
      if (in_grid(g, st.sx[d], st.sy[d], st.sz[d], st.nx, st.ny, st.nz))
        in |= 1u << d;
    }
    return Row{in, staged};
  }
  __device__ __forceinline__ Row row(int, int, const Row& g) const {
    return g;
  }
  __device__ __forceinline__ float val(const Row& r, int d) const {
    return (r.in >> d) & 1u ? r.c[d] : 0.0f;
  }
  __device__ __forceinline__ float inv(const Row& r, int, int k) const {
    return stencil_inv([&](int d) { return val(r, d); }, k, st.diag, st.dinv);
  }
};

// The systems [s0, s1) a thread of this launch takes.
struct SysRange {
  int s0, s1;
};
__device__ __forceinline__ SysRange sys_range(int nsys) {
  return gridDim.y == 1 ? SysRange{0, nsys}
                        : SysRange{static_cast<int>(blockIdx.y),
                                   static_cast<int>(blockIdx.y) + 1};
}

// Every batched kernel first stages its block's share of the value source
// (the coefficients, for a stencil) in shared memory.
#define STAGE_VALUES(vs)                   \
  __shared__ float staged_[kMaxOffsets];   \
  vs.stage(staged_);                       \
  __syncthreads()

// K1: Y = A X, row i of every system.
template <class VS>
__global__ void __launch_bounds__(kThreads)
dia_spmv_multi_kernel(VS vs, const float* __restrict__ x,
                      float* __restrict__ y, int n, int nsys, Offsets of) {
  STAGE_VALUES(vs);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const SysRange sr = sys_range(nsys);
  const auto gm = vs.geom(i, staged_);
  for (int s = sr.s0; s < sr.s1; ++s) {
    const size_t o = static_cast<size_t>(s) * n;
    y[o + i] = dia_row(vs, vs.row(s, i, gm), PlainX{x + o}, n, i, of);
  }
}

// K2: one damped step X' = X + (tau_t * (B - A X)) * dinv per system,
// system s's damping factors at taus + s * tstride (0: shared).
template <class VS, bool kHasDinv>
__global__ void __launch_bounds__(kThreads)
dia_step_multi_kernel(VS vs, const float* __restrict__ taus, int t,
                      int tstride, const float* __restrict__ b,
                      const float* __restrict__ x, float* __restrict__ out,
                      int n, int nsys, Offsets of) {
  STAGE_VALUES(vs);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const SysRange sr = sys_range(nsys);
  const auto gm = vs.geom(i, staged_);
  // a thread's systems share row i's dinv (the operator is shared, or the
  // thread takes one system): one synthesis a row, not one a system
  const float dv = kHasDinv ? vs.inv(vs.row(sr.s0, i, gm), i, of.k) : 1.0f;
  for (int s = sr.s0; s < sr.s1; ++s) {
    const size_t o = static_cast<size_t>(s) * n;
    const PlainX xr{x + o};
    const typename VS::Row r = vs.row(s, i, gm);
    float upd = taus[static_cast<size_t>(s) * tstride + t] *
                (b[o + i] - dia_row(vs, r, xr, n, i, of));
    if (kHasDinv) upd *= dv;
    out[o + i] = xr(i) + upd;
  }
}

// K2's residual: R = B - A X per system.
template <class VS>
__global__ void __launch_bounds__(kThreads)
dia_residual_multi_kernel(VS vs, const float* __restrict__ b,
                          const float* __restrict__ x, float* __restrict__ r,
                          int n, int nsys, Offsets of) {
  STAGE_VALUES(vs);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const SysRange sr = sys_range(nsys);
  const auto gm = vs.geom(i, staged_);
  for (int s = sr.s0; s < sr.s1; ++s) {
    const size_t o = static_cast<size_t>(s) * n;
    r[o + i] =
        b[o + i] - dia_row(vs, vs.row(s, i, gm), PlainX{x + o}, n, i, of);
  }
}

// grid.y: 1 when the operator is shared (a thread takes every system),
// else one block row a system
dim3 multi_grid(int n, int nsys, bool per_system) {
  return dim3(blocks_for(n), per_system ? nsys : 1);
}

// One K2 launch on the value source vs: a step (x, taus, t) or, with
// `resid`, the residual of x.
template <class VS>
int step_multi(const VS& vs, bool has_dinv, bool per_system,
               const float* taus, int t, int tstride, const float* b,
               const float* x,
               float* out, int resid, int n, int nsys, const Offsets& of,
               cudaStream_t stream) {
  const dim3 grid = multi_grid(n, nsys, per_system);
  if (resid) {
    dia_residual_multi_kernel<VS>
        <<<grid, kThreads, 0, stream>>>(vs, b, x, out, n, nsys, of);
  } else if (has_dinv) {
    dia_step_multi_kernel<VS, true><<<grid, kThreads, 0, stream>>>(
        vs, taus, t, tstride, b, x, out, n, nsys, of);
  } else {
    dia_step_multi_kernel<VS, false><<<grid, kThreads, 0, stream>>>(
        vs, taus, t, tstride, b, x, out, n, nsys, of);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: Y = A X for nsys systems; vals (k, n) shared or, with
// `per_system`, (nsys, k, n).
int amgx_dia_spmv_multi(const float* vals, const float* x, float* y, int n,
                        int nsys, int per_system, const int* offs, int k,
                        cudaStream_t stream) {
  Offsets of;
  if (n < 1 || nsys < 1 || nsys > 65535 || !fill_offsets(offs, k, &of))
    return -1;
  const long long vstride = per_system ? static_cast<long long>(k) * n : 0;
  dia_spmv_multi_kernel<<<multi_grid(n, nsys, per_system), kThreads, 0,
                          stream>>>(SlabBatchVals{vals, nullptr, n, vstride, 0},
                                    x, y, n, nsys, of);
  return static_cast<int>(cudaGetLastError());
}

// K2 on a slab: one damped step out = x + (taus[t] * (b - A x)) * dinv
// for every system (dinv optional: (n,) shared or (nsys, n)), or with
// `resid` r = b - A x into out. vals (k, n) or (nsys, k, n) by
// `per_system`; `dinv_per_system` says the same of dinv. System s's
// damping factors start at taus + s * tstride: tstride 0 shares one
// schedule, the schedule's length gives each system its own.
int amgx_dia_step_multi(const float* vals, const float* dinv,
                        const float* taus, int t, int tstride,
                        const float* b,
                        const float* x, float* out, int resid, int n,
                        int nsys, int per_system, int dinv_per_system,
                        const int* offs, int k, cudaStream_t stream) {
  Offsets of;
  if (n < 1 || nsys < 1 || nsys > 65535 || !fill_offsets(offs, k, &of) ||
      out == x || tstride < 0 || (!resid && taus == nullptr))
    return -1;
  const SlabBatchVals vs{vals, dinv, n,
                         per_system ? static_cast<long long>(k) * n : 0,
                         dinv_per_system ? static_cast<long long>(n) : 0};
  return step_multi(vs, dinv != nullptr, per_system || dinv_per_system, taus,
                    t, tstride, b, x, out, resid, n, nsys, of, stream);
}

// K2 on a stencil (the coefficient mode): the geometry and dinv mode from
// the host stencil `stencil` (common.cuh Stencil; its coefficients are
// not read), the k coefficients from `coef`: (k,) shared or, with
// `per_system`, (nsys, k); the damping factors as amgx_dia_step_multi's.
int amgx_dia_step_mf_multi(const void* stencil, const float* coef,
                           const float* taus, int t, int tstride,
                           const float* b,
                           const float* x, float* out, int resid, int n,
                           int nsys, int per_system, const int* offs, int k,
                           cudaStream_t stream) {
  const Stencil* st = static_cast<const Stencil*>(stencil);
  Offsets of;
  if (n < 1 || nsys < 1 || nsys > 65535 || coef == nullptr ||
      !fill_offsets(offs, k, &of) || !stencil_ok(st, n, k) || out == x ||
      tstride < 0 || (!resid && taus == nullptr))
    return -1;
  const StencilBatchVals vs{*st, coef, per_system ? k : 0, k};
  return step_multi(vs, st->dinv != kDinvNone, per_system, taus, t, tstride,
                    b, x, out, resid, n, nsys, of, stream);
}

}  // extern "C"
