// Temporally blocked smoothers for Hopper (sm_90a): B2, B3 and B4 on a
// 7-point star grid level in ONE launch per call (or a few, see below),
// from the level's coefficients (B2-mf, B3-mf, B4-mf) or from its stored
// value slab.
// stencil_tb.cu builds the coefficient mode and stencil_tb_slab.cu the
// slab forms from this header, each its own library, so the two sets of
// kernels compile at once.
//
// Replaces `_dia_stencil_smooth_call` (B2-mf),
// `_dia_stencil_smooth_restrict_call` (B3-mf) and
// `_dia_stencil_prolong_smooth_call` (B4-mf, with its x'.b epilogue) of
// amgx_tpu/ops/pallas_spmv.py (:781, :1379, :1725), and on a slab level
// `_dia_smooth_call` (B2), `_dia_smooth_restrict_call` (B3) and
// `_dia_prolong_smooth_call` (B4, :649, :1245, :1585), which run every
// damped step of a call, and the residual (B3's restriction), in one
// pallas_call by temporal blocking over a VMEM row window. A 1-D row
// window needs a halo of (steps + 1) x nx*ny rows (393 KB at 128^3), more
// than the 227 KB of shared memory a Hopper block has; dia.cu's step
// kernels therefore launched once a step and passed the state through
// device memory. Here the blocking is 2.5-D, the standard form of a 3-D
// stencil on a GPU:
//
// - a block owns an x-y tile of the grid and a chunk of z planes
//   (ops/tiling.py `plan_tiles` picks both, and `TbGeom` carries them);
// - time level t (0: x as read, + xc[agg] for B4-mf's prologue; steps:
//   x') is computed on the tile grown by apps - t points in x and y,
//   so the block needs nothing from its neighbours;
// - one thread owns each column of that grown tile (at most 1024); the
//   block marches along z, one plane a step, and each time level lags
//   the one below by one plane so that a step reads only values
//   written in earlier steps (or by the same thread): ONE barrier a
//   step; the global loads of the next plane are in flight while the
//   step's levels compute;
// - one kernel, for the 7-point star (`tb_star_kernel`, every level of
//   the flagship and PCG hierarchies), with the applications (at most
//   6) as a template parameter and the march unrolled by its ring of
//   planes, so level indices and ring slots are compile-time. Any other
//   stencil, and a schedule of more applications, takes dia.cu's
//   per-step kernels (ops/cuda_spmv.py dispatches on the stencil's
//   shifts and the step count);
// - every level's state stays float32 on chip: the call reads x, b (and
//   xc, agg) once from device memory (the halo's re-reads mostly hit L2)
//   and writes x' (and bc) once. For bf16 operands that is the TPU
//   kernel's rounding: b and x widened on load, x' and bc rounded once.
//
// B3-mf: apps = steps + 1, the last application the residual r = b - A x'
// over the tile's interior, kept for three planes; the coarse rows whose
// last child lies on a residual plane are summed from shared memory in
// ctab order (the rows of each (block, plane) come from `restrict_lists`:
// every coarse row must lie in one block, which holds for GEO's 2x2x2
// aggregates on even tiles). Other tables (SIZE_2) take apps = steps:
// this launch writes x' and its float32 state (`keep`, for bf16) and
// dia.cu's restriction kernel runs after it. B4-mf: apps = steps; with
// `dot` the launch also returns x'.b (per-thread partials, a fixed block
// tree, blocks added in order by the last one: common.cuh finish_dot, no
// float atomics; not the step kernel's bits).
//
// Arithmetic per row is the step kernel's (dia.cu dia_step_kernel): the
// diagonals in ascending offset order, each product one fused
// multiply-add; x + (tau_t * (b - A x)) * dinv as tau_t * r rounded and
// one fused multiply-add; the diagonal inverse synthesized as
// common.cuh `stencil_inv`. A neighbour outside the grid is skipped (its
// coefficient is 0), decided from global coordinates. So the kernels give
// the per-step kernels' bits.
//
// The value source is a template parameter (TbVals): the stencil's
// coefficients, synthesized per row from its grid coordinates, or the
// stored (k, n) slab and dinv of a variable-coefficient level. In DIA
// storage row i holds all of its own coefficients (vals[d * n + i]), so
// the thread that owns a column reads only its own column's k values and
// dinv, and uses those of plane p at the apps consecutive steps that
// compute p's time levels. They are loaded once, with the plane's x and
// b one step ahead, into a per-column shared ring of apps + 1 planes
// (each column reads back only what it wrote, so the ring needs no
// barrier; reading them from device memory at each use instead, through
// L1 and L2, measured 1.3-1.5x slower and spilled). A
// neighbour outside the grid is still skipped from the global
// coordinates and never multiplied by the slab's stored 0; the caller
// checks once per level that the slab stores 0 at every off-grid entry
// (ops/cuda_spmv.py `slab_grid`), so skipping gives the per-step
// kernels' bits. A slab call is split into the fewest launches of at
// most kTbSlabApps applications each (ops/tiling.py `plan_calls`: 3 + 3
// for six): each launch streams the slab once and passes its float32
// state to the next (x read as float32: `XT`), and a smaller halo leaves
// more of each tile interior and fits the ring in shared memory (a
// 6-application launch measured 1.9x the time of 3 + 3, 2 + 2 + 2 1.17x).
// B2 and B2-mf (a smoother with no transfer fused into it): the steps,
// split as ops/tiling.py `plan_calls` says (slab: launches of at most
// kTbSlabApps applications; coefficients: of at most kTbCoefApps), the
// last launch storing r = b - A x' of its interior rows in the operands'
// type (`rs.r`, `rs.r_bt`), rounded once from the float32 state. A call
// of any length splits so: `star_fits` limits a launch, not a call.
// B3w (a classical level's weighted restriction on a slab): the last
// application stores r of the interior rows in float32 (`rs.r`), and
// csr.cu's row-block kernel restricts it over R's rows in a launch of its
// own (R's rows cross the tiles). This beat one launch a step and a
// residual launch by 1-10 % at the classical 128^3 level 0. B4w takes no
// tiled form: summing x + P xc in the tile's level 0 (each column its
// row's P entries, halo columns too) measured 3-12 % slower than dia.cu's
// prologue launch and the per-step launch after it.
//
// What bounds it on an H100: bytes would allow ~10 us at 128^3 (x, b, x',
// 12 bytes a row; 28 us with a float32 slab); the halo's redundant point
// updates (a tile of at most 1024 columns grown by apps points: 2.4x the
// interior's columns at 5 applications, 3.4x at 6) run out of shared
// memory, and a step is as long as its busiest warp, so the instruction
// issue of those updates and the per-step barrier bound it, not HBM: a
// step takes 1.4-2 us whether the values stream from a slab or come from
// coefficients, and the bf16 slab is no faster than the float32 one. The
// planner trades the halo against filling the SMs (blocks of up to 1024
// threads: 64 registers a thread, the limit to keep the kernels within).
#pragma once

#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kTbMaxThreads = 1024;  // ops/tiling.py MAX_THREADS

// One launch's tiling (ops/cuda_spmv.py `TbGeomArg` mirrors it).
struct TbGeom {
  int tx, ty, tz;        // the interior x-y tile and the z chunk
  int apps, steps;       // applications per tile; the damped steps among them
  int tiles_x, tiles_y;  // blocks per axis in x and y
};

constexpr int kTbStarApps = 6;  // ops/tiling.py STAR_MAX_APPS

// Where a launch reads the values of the rows it updates: the stencil's
// coefficients, or the stored slab and dinv staged in a per-column ring.
enum TbVals { kTbCoef = 0, kTbRing = 1 };
constexpr int kTbSlabApps = 3;  // a slab launch's applications (ops/tiling.py
                                // SLAB_MAX_APPS: a call splits above it)
constexpr int kTbCoefApps = 3;  // a split B2-mf launch's applications
                                // (ops/tiling.py COEF_MAX_APPS)

// The stored (7, n) value slab of the 7-point star and its dinv (nullptr:
// none), of the operands' storage type T; unused by kTbCoef.
template <class T>
struct TbSlab {
  const T* __restrict__ vals;
  const T* __restrict__ dinv;
  int n;
};
constexpr int kTbStarKids = 8;  // children of an in-tile coarse row
                                // (ops/tiling.py MAX_KIDS)

// The 7-point star's grid shifts in ascending offset order (the
// detector's order on a grid with nx, ny, nz >= 2).
__host__ __device__ constexpr int tb_star_shift(int d, int axis) {
  return (d == 0 && axis == 2) ? -1 : (d == 1 && axis == 1) ? -1
       : (d == 2 && axis == 0) ? -1 : (d == 4 && axis == 0) ? 1
       : (d == 5 && axis == 1) ? 1 : (d == 6 && axis == 2) ? 1 : 0;
}

// B3-mf's in-tile restriction: the children table and the coarse rows of
// each (block, chunk plane); or, where `r` is given instead, the residual
// of every interior row stored there: in float32 for the restriction
// launch that follows (B3w: R's rows cross the tiles), or with `r_bt` in
// the operands' storage type, rounded once (B2's r, the call's output).
struct TbRestrict {
  const int* __restrict__ ctab;  // (m, nc), -1 past a row's children
  const int* __restrict__ rows;  // coarse rows by (block, plane)
  const int* __restrict__ roff;  // blocks * tz + 1 offsets into rows
  int m, nc;
  void* __restrict__ r;          // (n,) or nullptr
  int r_bt;                      // r of type BT (else float32)
};

// How many planes outside [lo, hi) coordinate c lies.
__device__ __forceinline__ int tb_gap(int c, int lo, int hi) {
  return c < lo ? lo - c : (c >= hi ? c - hi + 1 : 0);
}

// The 7-point star (the flagship's and PCG's levels). Level t computes
// plane p = w - t at step w, each level one plane behind the one below,
// so its in-plane neighbours at plane p were written in the step before
// (by other threads, across the barrier) and its own column's plane
// p + 1 earlier in this step (by itself): each level keeps 3 planes of
// every column in shared memory, and the plane a step writes is never
// one another column reads in it. Plane w + 1 of x and b is loaded
// during step w and taken by level 0 at its end, so a load has the
// step's work to arrive; b keeps 9 planes of every column (read by its
// own thread only). kA (the applications) and kResid (B3-mf's in-tile
// residual and restriction) are template parameters and the march is
// unrolled by the ring's 3 planes, so every level index and ring slot is
// known to the compiler. B3-mf sums a residual plane's coarse rows in the
// step after it, with their ctab entries loaded at the start of that
// step. kVals says where the rows' values come from (TbVals): with
// kTbRing plane w + 1's k values and dinv are loaded with its x and b and
// stored at the end of step w in the column's ring of kA + 1 planes (a
// plane is read by levels 1..kA at steps p + 1 .. p + kA, by its own
// thread, before that thread overwrites its slot). x is of type XT: BT,
// or float32 for a launch that continues a split call's state. `out` may
// be null (a split call's first launches write only `keep`).
template <class BT, class XT, bool kHasDinv, int kA, bool kResid, int kVals>
__global__ void __launch_bounds__(kTbMaxThreads, 1)
tb_star_kernel(const Stencil sc, const TbGeom g, const TbSlab<BT> sl,
               const float* __restrict__ taus, const BT* __restrict__ b,
               const XT* __restrict__ x, const BT* __restrict__ xc,
               const int* __restrict__ agg, BT* __restrict__ out,
               float* __restrict__ keep, TbRestrict rs, BT* __restrict__ bc,
               DotOut dot) {
  extern __shared__ __align__(16) float tb_smem[];
  constexpr int kSteps = kResid ? kA - 1 : kA;
  constexpr int kB = 9;             // b's planes, a multiple of 3 >= kA + 2
  constexpr int kNv = kHasDinv ? 8 : 7;  // ring floats a row: values, dinv
  constexpr int kR = kA + 1;             // ring planes
  const int nx = sc.nx, ny = sc.ny, nz = sc.nz;
  const int W = g.tx + 2 * kA, H = g.ty + 2 * kA;
  const int plane = W * H;
  int rest = blockIdx.x;
  const int x0 = (rest % g.tiles_x) * g.tx;
  rest /= g.tiles_x;
  const int y0 = (rest % g.tiles_y) * g.ty;
  const int z0 = (rest / g.tiles_y) * g.tz;
  const int x1 = min(nx, x0 + g.tx), y1 = min(ny, y0 + g.ty);
  const int z1 = min(nz, z0 + g.tz);
  // shared memory (floats): levels 0 .. kA-1, 3 planes each of every
  // column; b, kB planes of every column; B3's residual, 3 planes of
  // the interior; with kTbRing the values ring, kR planes of kNv floats
  // of every column
  const int b_at = kA * 3 * plane;
  const int r_at = b_at + kB * plane;
  const int v_at = r_at + (kResid ? 3 * g.tx * g.ty : 0);
  const int c = threadIdx.x;
  const int ly = c / W, lx = c - ly * W;
  const int gx = x0 - kA + lx, gy = y0 - kA + ly;
  const bool col_in = c < plane && gx >= 0 && gx < nx && gy >= 0 && gy < ny;
  const int top = col_in ? kA - max(tb_gap(gx, x0, x1),
                                    tb_gap(gy, y0, y1))
                         : -1;
  const bool interior = top == kA;
  const bool hxm = gx > 0, hxp = gx < nx - 1, hym = gy > 0, hyp = gy < ny - 1;
  const bool inner_xy = hxm && hxp && hym && hyp;
  const int gcol = gy * nx + gx;    // the grid has fewer than 2^31 rows
  const int nplane = nx * ny;
  const int rcol = ((gy - y0) * g.tx + gx - x0);  // interior columns
  float inv_in = 0.0f;
  if (kVals == kTbCoef && kHasDinv)
    inv_in = stencil_inv([&](int d) { return sc.c[d]; }, 7, sc.diag,
                         sc.dinv);
  __shared__ float tau[kTbStarApps];
  if (c < kSteps) tau[c] = taus[c];
  float part = 0.0f;
  const bool col_load = top >= 0;
  const int lo0 = max(0, z0 - kA), hi0 = min(nz, z1 + kA);
  const int w_end = z1 + kA;
  const int w_beg = lo0 - lo0 % 3;  // planes before lo0 load nothing
  int ag = 0;                       // agg of plane w + 1 during step w
  if (col_load && xc != nullptr) {
    if (w_beg + 1 >= lo0 && w_beg + 1 < hi0)
      ag = agg[(w_beg + 1) * nplane + gcol];
    else if (w_beg + 2 == lo0 && lo0 < hi0)
      ag = agg[lo0 * nplane + gcol];
  }
  int w9 = w_beg % kB;              // w mod kB
  // kTbRing: the planes whose values a level of this column reads
  const int vlo = max(0, z0 - kA + 1), vhi = min(nz, z1 + kA - 1);
  const bool col_vals = kVals == kTbRing && top >= 1;
  int wr = 0;                       // the values ring slot of plane w
  if (c < plane)
    for (int j = 0; j < kB; ++j) tb_smem[b_at + j * plane + c] = 0.0f;
  if (col_load && w_beg == lo0 && lo0 < hi0) {  // plane w_beg, at once
    const int gi = lo0 * nplane + gcol;
    float v = ld(x, gi);
    if (xc != nullptr) v += ld(xc, agg[gi]);
    tb_smem[b_at + w9 * plane + c] = ld(b, gi);
    tb_smem[c] = v;                 // ring slot w_beg mod 3 = 0
    if (col_vals && lo0 >= vlo && lo0 < vhi) {
#pragma unroll
      for (int d = 0; d < kNv; ++d)
        tb_smem[v_at + d * plane + c] =
            d < 7 ? ld(sl.vals, static_cast<size_t>(d) * sl.n + gi)
                  : ld(sl.dinv, gi);
    }
  }
  __syncthreads();                  // tau, plane w_beg
  auto step = [&](auto phase, int w) {
    constexpr int s3 = decltype(phase)::value;  // w mod 3
    // 1. issue plane w + 1 (and agg of plane w + 2)
    const bool load = col_load && w + 1 >= lo0 && w + 1 < hi0;
    float xn = 0.0f, xcn = 0.0f, bn = 0.0f;
    if (load) {
      const int gi = (w + 1) * nplane + gcol;
      xn = ld(x, gi);
      bn = ld(b, gi);
      if (xc != nullptr) {
        xcn = ld(xc, ag);
        if (w + 2 < hi0) ag = agg[gi + nplane];
      }
    } else if (col_load && xc != nullptr && w + 2 == lo0 && lo0 < hi0) {
      ag = agg[lo0 * nplane + gcol];
    }
    // kTbRing: plane w + 1's values and dinv
    const bool vload = col_vals && w + 1 >= vlo && w + 1 < vhi;
    float vn[kVals == kTbRing ? kNv : 1];
    if (vload) {
      const int gi = (w + 1) * nplane + gcol;
#pragma unroll
      for (int d = 0; d < (kVals == kTbRing ? kNv : 1); ++d)
        vn[d] = d < 7 ? ld(sl.vals, static_cast<size_t>(d) * sl.n + gi)
                      : ld(sl.dinv, gi);
    }
    // B3-mf: the ctab entries of the coarse rows whose last child lies on
    // the residual plane of the step before
    const int pr = w - kA - 1;
    int cr = -1;
    int kid[kResid ? kTbStarKids : 1];
    if (kResid && rs.rows != nullptr && pr >= z0 && pr < z1) {
      const int key = blockIdx.x * g.tz + pr - z0;
      const int e = rs.roff[key] + c;
      if (e < rs.roff[key + 1]) {
        cr = rs.rows[e];
#pragma unroll
        for (int j = 0; j < (kResid ? kTbStarKids : 1); ++j)
          kid[j] = j < rs.m ? rs.ctab[j * rs.nc + cr] : -1;
      }
    }
    // 2. level t at plane p = w - t
#pragma unroll
    for (int t = 1; t <= kA; ++t) {
      const int sp = ((s3 - t) % 3 + 3) % 3;  // p mod 3
      const int sm = (sp + 2) % 3, sq = (sp + 1) % 3;  // p - 1, p + 1
      const int p = w - t;
      const int gap = kA - t;
      if (t <= top && p >= max(0, z0 - gap) && p < min(nz, z1 + gap)) {
        const int lv = (t - 1) * 3 * plane + c;   // level t - 1, this column
        const int at = lv + sp * plane;
        const bool hzm = p > 0, hzp = p < nz - 1;
        const float xo = tb_smem[at];
        // the row's values: the coefficients, or the slab's row p
        const int vs = wr >= t ? wr - t : wr - t + kR;  // p's ring slot
        auto val = [&](int d) -> float {
          if (kVals == kTbCoef) return sc.c[d];
          return tb_smem[v_at + (vs * kNv + d) * plane + c];
        };
        float acc = 0.0f;
        if (hzm) acc = __fmaf_rn(val(0), tb_smem[lv + sm * plane], acc);
        if (hym) acc = __fmaf_rn(val(1), tb_smem[at - W], acc);
        if (hxm) acc = __fmaf_rn(val(2), tb_smem[at - 1], acc);
        acc = __fmaf_rn(val(3), xo, acc);
        if (hxp) acc = __fmaf_rn(val(4), tb_smem[at + 1], acc);
        if (hyp) acc = __fmaf_rn(val(5), tb_smem[at + W], acc);
        if (hzp) acc = __fmaf_rn(val(6), tb_smem[lv + sq * plane], acc);
        const int bs = w9 >= t ? w9 - t : w9 - t + kB;  // p mod kB
        const float bv = tb_smem[b_at + bs * plane + c];
        const float r = __fsub_rn(bv, acc);
        if (kResid && t == kA) {
          tb_smem[r_at + sp * g.tx * g.ty + rcol] = r;
          if (rs.r != nullptr) {
            const int gi = p * nplane + gcol;
            if (rs.r_bt)
              st(static_cast<BT*>(rs.r), gi, r);
            else
              static_cast<float*>(rs.r)[gi] = r;
          }
        } else {
          float v;
          if (kHasDinv && kVals == kTbRing) {
            const float inv = tb_smem[v_at + (vs * kNv + 7) * plane + c];
            v = __fmaf_rn(__fmul_rn(tau[t - 1], r), inv, xo);
          } else if (kHasDinv) {
            const bool in = inner_xy && hzm && hzp;
            const float inv =
                in ? inv_in
                   : stencil_inv(
                         [&](int d) {
                           const bool ok = d == 0 ? hzm : d == 1 ? hym
                                         : d == 2 ? hxm : d == 4 ? hxp
                                         : d == 5 ? hyp : d == 6 ? hzp
                                                             : true;
                           return ok ? sc.c[d] : 0.0f;
                         },
                         7, sc.diag, sc.dinv);
            v = __fmaf_rn(__fmul_rn(tau[t - 1], r), inv, xo);
          } else {
            v = __fmaf_rn(tau[t - 1], r, xo);
          }
          if (t < kA) tb_smem[(t * 3 + sp) * plane + c] = v;
          if (t == kSteps && interior && p >= z0 && p < z1) {
            const int gi = p * nplane + gcol;
            if (out != nullptr) st(out, gi, v);
            if (keep != nullptr) keep[gi] = v;
            part = __fmaf_rn(v, bv, part);
          }
        }
      }
    }
    // 3. B3-mf: the restriction of the previous step's residual plane
    //    (its 3-plane ring is not overwritten before the barrier below)
    if (kResid && cr >= 0) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < (kResid ? kTbStarKids : 1); ++j) {
        const int f = kid[j];
        if (f < 0) continue;
        const GridRow q = grid_row(f, nx, ny, sc.by_nx, sc.by_ny);
        acc = __fadd_rn(acc, tb_smem[r_at + ((q.z % 3) * g.ty + q.y - y0) *
                                                 g.tx + q.x - x0]);
      }
      st(bc, cr, acc);
    }
    // 4. level 0 and b take plane w + 1 (zeros outside the block's planes)
    const float x0v = xc != nullptr ? xn + xcn : xn;
    w9 = w9 == kB - 1 ? 0 : w9 + 1;
    if (c < plane) tb_smem[b_at + w9 * plane + c] = bn;
    if (load) tb_smem[((s3 + 1) % 3) * plane + c] = x0v;
    wr = wr == kR - 1 ? 0 : wr + 1;
    if (vload) {
#pragma unroll
      for (int d = 0; d < (kVals == kTbRing ? kNv : 1); ++d)
        tb_smem[v_at + (wr * kNv + d) * plane + c] = vn[d];
    }
    __syncthreads();
  };
  for (int w = w_beg; w < w_end + 1; w += 3) {
    step(std::integral_constant<int, 0>{}, w);
    if (w + 1 < w_end + 1) step(std::integral_constant<int, 1>{}, w + 1);
    if (w + 2 < w_end + 1) step(std::integral_constant<int, 2>{}, w + 2);
  }
  if (dot.out != nullptr)
    finish_dot(part, dot.partials, dot.counter, dot.out);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in, once per
// kernel, device and size; returns 0 or a cudaError_t.
int tb_opt_in(const void* kern, int smem) {
  struct Granted {
    const void* kern;
    int dev, bytes;
  };
  static Granted seen[256];
  static int used = 0;
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int i = 0;
  while (i < used && (seen[i].kern != kern || seen[i].dev != dev)) ++i;
  if (i < used && seen[i].bytes >= smem) return 0;
  if (i == used && used == 256) return -1;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  seen[i] = Granted{kern, dev, smem};
  if (i == used) ++used;
  return 0;
}

// one thread a column of the tile grown by the halo, whole warps
int tb_threads(const TbGeom& g) {
  return ((g.tx + 2 * g.apps) * (g.ty + 2 * g.apps) + 31) / 32 * 32;
}

// One launch's operands (the C entry's, typed by the launch below).
struct TbArgs {
  const Stencil* sc;
  const TbGeom* g;
  int blocks, smem;
  const void *vals, *dinv;  // the slab and its dinv (TbSlab), or nullptr
  int n;
  const float* taus;
  const void *b, *x, *xc;
  const int* agg;
  void* out;
  float* keep;
  TbRestrict rs;
  void* bc;
  DotOut dot;
};

template <class BT, class XT>
using TbStar = void (*)(const Stencil, const TbGeom, const TbSlab<BT>,
                        const float*, const BT*, const XT*, const BT*,
                        const int*, BT*, float*, TbRestrict, BT*, DotOut);

// The kernel of kA applications (and the in-tile residual), or nullptr
// where the value source takes no such launch; only those are compiled.
// From the coefficients, a bf16 launch reads a float32 x only as a later
// launch of a split B2-mf call, of at most kTbCoefApps applications.
template <class BT, class XT, bool kHasDinv, int kVals, int kA, bool kResid>
constexpr TbStar<BT, XT> tb_entry() {
  constexpr bool split = !std::is_same<BT, XT>::value;
  if constexpr ((kResid && kA < 2) ||
                kA > (kVals == kTbCoef ? (split ? kTbCoefApps : kTbStarApps)
                                       : kTbSlabApps))
    return nullptr;
  else
    return tb_star_kernel<BT, XT, kHasDinv, kA, kResid, kVals>;
}

template <class BT, class XT, bool kHasDinv, int kVals>
int launch_tb_typed(const TbArgs& a, cudaStream_t stream) {
  using Star = TbStar<BT, XT>;
  // by applications; [0]: x' only, [1]: with the residual
#define AMGX_TB_ROW(A)                                  \
  {tb_entry<BT, XT, kHasDinv, kVals, A, false>(),      \
   tb_entry<BT, XT, kHasDinv, kVals, A, true>()}
  static const Star kStar[kTbStarApps][2] = {
      AMGX_TB_ROW(1), AMGX_TB_ROW(2), AMGX_TB_ROW(3),
      AMGX_TB_ROW(4), AMGX_TB_ROW(5), AMGX_TB_ROW(6)};
#undef AMGX_TB_ROW
  const TbGeom& g = *a.g;
  const Star kern = kStar[g.apps - 1][g.apps > g.steps ? 1 : 0];
  if (kern == nullptr) return -1;
  const int rc = tb_opt_in(reinterpret_cast<const void*>(kern), a.smem);
  if (rc != 0) return rc;
  const TbSlab<BT> sl{static_cast<const BT*>(a.vals),
                      static_cast<const BT*>(a.dinv), a.n};
  kern<<<a.blocks, tb_threads(g), a.smem, stream>>>(
      *a.sc, g, sl, a.taus, static_cast<const BT*>(a.b),
      static_cast<const XT*>(a.x), static_cast<const BT*>(a.xc), a.agg,
      static_cast<BT*>(a.out), a.keep, a.rs, static_cast<BT*>(a.bc), a.dot);
  return 0;
}

template <class BT, class XT, int kVals>
int launch_tb_vals(const TbArgs& a, bool has_dinv, cudaStream_t stream) {
  return has_dinv ? launch_tb_typed<BT, XT, true, kVals>(a, stream)
                  : launch_tb_typed<BT, XT, false, kVals>(a, stream);
}

// The launch's tiling against the grid and the stencil: the 7-point
// star in its order (the diagonal at 3), the block count the tiling's.
bool geom_ok(const Stencil& sc, const TbGeom& g, int k, int blocks) {
  if (g.tx < 1 || g.ty < 1 || g.tz < 1 || g.apps < 1 ||
      g.apps > kTbStarApps || g.steps < 1 || g.apps - g.steps > 1 ||
      g.apps < g.steps)
    return false;
  if ((g.tx + 2 * g.apps) * (g.ty + 2 * g.apps) > kTbMaxThreads) return false;
  if (g.tiles_x != (sc.nx + g.tx - 1) / g.tx ||
      g.tiles_y != (sc.ny + g.ty - 1) / g.ty ||
      blocks != g.tiles_x * g.tiles_y * ((sc.nz + g.tz - 1) / g.tz))
    return false;
  if (k != 7 || sc.nz < 2 || (sc.dinv != kDinvNone && sc.diag != 3))
    return false;
  for (int d = 0; d < 7; ++d)
    if (sc.sx[d] != tb_star_shift(d, 0) || sc.sy[d] != tb_star_shift(d, 1) ||
        sc.sz[d] != tb_star_shift(d, 2))
      return false;
  return true;
}

// B2 / B3 / B4 in one launch on a 7-point star grid (`stencil`, a
// common.cuh Stencil: the grid, and in the coefficient mode the
// coefficients and the dinv mode) with the tiling `geom` (TbGeom, `blocks`
// blocks, `smem` bytes of dynamic shared memory), the rows' values from
// the value source kVals: the coefficients (`vals` and `dinv` not given),
// or the (7, n) slab `vals` and dinv `dinv` (nullptr: none) of the
// operands' storage type.
// len(taus) = geom.steps damped steps from x (+ xc[agg] when xc is given;
// x is float32 when `x_f32`, a split call's state), x' written to `out`
// when given and as float32 to `keep` when given. When geom.apps = steps
// + 1, also bc = R (b - A x') through ctab (m, nc) and the in-tile row
// lists rows / roff, or instead r = b - A x' to `resid`: float32 (B3w:
// its restriction is launched after), or of the operands' type with
// `r_bf16` (B2's r, bf16 operands); when dot is given, *dot = x'.b
// through `partials` (one float per block) and `counter` (zero on entry,
// left zero). With `bf16_io` b, xc, out, bc (and vals, dinv, and x unless
// x_f32) are bfloat16 (no dot). Either value source takes x as float32
// (`x_f32`). Returns 0, -1 for arguments the kernel does not take, else a
// cudaError_t.
template <int kVals>
int tb_smooth(const void* stencil, const void* geom, int k, const void* vals,
              const void* dinv, const float* taus, const void* b,
              const void* x, int x_f32, const void* xc, const int* agg,
              void* out, float* keep, const int* ctab, int m, int nc,
              const int* rows, const int* roff, void* resid, int r_bf16,
              void* bc, float* partials, unsigned int* counter, float* dot,
              int n, int blocks, int smem, int bf16_io, cudaStream_t stream) {
  constexpr bool slab = kVals == kTbRing;
  const Stencil* sc = static_cast<const Stencil*>(stencil);
  const TbGeom* g = static_cast<const TbGeom*>(geom);
  if (n < 1 || k < 1 || k > kMaxOffsets || g == nullptr ||
      !stencil_ok(sc, n, k) || !geom_ok(*sc, *g, k, blocks))
    return -1;
  if (smem < 1 || smem > 232448 || (xc == nullptr) != (agg == nullptr))
    return -1;
  if ((vals != nullptr) != slab || (!slab && dinv != nullptr) ||
      (slab && sc->dinv != kDinvNone))
    return -1;
  if (out == nullptr && keep == nullptr) return -1;
  const bool in_tile = g->apps > g->steps && resid == nullptr;
  if (resid != nullptr && (g->apps == g->steps || rows != nullptr)) return -1;
  if (r_bf16 && (resid == nullptr || !bf16_io)) return -1;
  if (in_tile && (ctab == nullptr || rows == nullptr || roff == nullptr ||
                  bc == nullptr || m < 1 || m > kTbStarKids || nc < 1))
    return -1;
  if (dot != nullptr && (bf16_io || partials == nullptr || counter == nullptr))
    return -1;
  const TbRestrict rs{ctab, rows, roff, m, nc, resid, r_bf16};
  const TbArgs a{sc, g, blocks, smem, vals, dinv, n, taus, b, x, xc, agg,
                 out, keep, rs, bc, DotOut{partials, counter, dot}};
  const bool has_dinv = slab ? dinv != nullptr : sc->dinv != kDinvNone;
  int rc = -1;
  if (!bf16_io) {
    rc = launch_tb_vals<float, float, kVals>(a, has_dinv, stream);
  } else if (!x_f32) {
    rc = launch_tb_vals<bf16, bf16, kVals>(a, has_dinv, stream);
  } else {
    rc = launch_tb_vals<bf16, float, kVals>(a, has_dinv, stream);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
