// The shared front of the 2DGS surfel compositors (sm_90a): one CTA of 256
// threads per 16 x 16 sub-tile, one pixel per thread; the staging of a batch
// of the tile's segment with the order-preserving screen-circle skip; the
// front of each (slot, pixel) pair; and the forward kernel.
// csrc/surfel_fwd.cu instantiates the forward, csrc/surfel_bwd.cu builds
// the backward on the same front, and csrc/surfel_fwd_probe.cu instantiates
// the forward's stage variants (the stage probes, below).
//
// Launch shape.  composite_subtile.cuh's: a 32 px tile is four sub-tile CTAs
// (blockIdx.x = tile * 4 + q, q = qy * 2 + qx), a 16 px tile one; each
// warp covers an 8 x 4 pixel block of its sub-tile.  Every
// sub-tile CTA walks its tile's whole depth-sorted segment in segment order;
// binning and the segments are the forward's own.
//
// Screen-circle skip.  The first test of every (slot, pixel) pair is the
// circle cut d2 = (X - px)^2 + (Y - py)^2 <= rad^2 in global pixel
// coordinates, and a pair that fails it changes no state (T, the stop, the
// accumulators).  Each staging thread gathers its slot's 96-byte row and
// keeps the slot for this sub-tile only if the circle can reach one of the
// sub-tile's 16 x 16 pixel centres (circle_keep); the kept slots are
// compacted into shared memory in their segment order (a warp ballot, a
// popcount and a prefix over the 8 warp counts).  A dropped slot fails the
// circle test at every pixel of the sub-tile, so each pixel's serial chain
// meets the same slots in the same order and the output is bitwise that of
// the unskipped walk (splat/surfel_kernels.py::subtile_keep is the PyTorch
// mirror of the predicate, with the same f32 operations).
//
// The predicate's error bound.  circle_keep computes e2 = ex^2 + ey^2 with
// ex = x0 - px (centre left of the rectangle of pixel centres [x0, x0 + 15]),
// px - (x0 + 15) (right of it) or 0 (inside its column range), ey likewise,
// each operation rounded as the kernels round theirs.  Round-to-nearest is
// monotone, so for every pixel X of the rectangle |fl(X - px)| >= ex, and
// the squares and the sum keep the order: e2 <= the kernel's d2 at every
// pixel (equal at the nearest pixel when the centre lies outside both
// ranges).  The skip is therefore exact with no margin at all.  It still
// drops a slot only when e2 > rad2 (1 + 2^-16) + 2^-100: without the
// monotonicity argument, each side's d2 is within 4 rounding steps of
// 2^-24 (2^-22 a side, 2^-21 together) of the real squared distance, plus
// under 2^-148 absolute from underflowing squares, so the margin covers the
// rounding 32-fold.  A slot with a non-finite centre or radius is kept.
//
// Stage probes.  surfel_fwd_kernel is templated on the skip and on a stage.
// The production instantiation is surfel_fwd_kernel<TS> with both at their
// defaults: each `if constexpr` then keeps exactly the production
// statements in their order, so that kernels #3 and #4 compile to the same
// machine code as before the probes existed (tools/sass_check.py checks
// this against a parent's sources).  Anyone editing this file edits the
// production kernels.  Each stripped stage writes a defined per-pixel
// quantity (its plain version is splat/probe_kernels.py), all 13 rows from
// its registers, so a row the stage does not reach keeps its initial value
// (0, and T = 1 in row 12):
//   NOOP   the production launch shape, no input read
//   LOAD   every slot staged (ids, 96-byte row gathers, shared memory,
//          barriers), no circle skip, no compaction; row 0 at the pixel of
//          thread t: the sum of the 20 staged values (rad squared) of slot
//          t of each batch, over the batches (the checksum)
//   SKIP   + circle_keep and the ballot compaction; row 0: the checksum of
//          the kept slot t of each batch, row 1: the kept slots
//   ALPHA  + the front through alpha (the circle test, the cross product,
//          1/cr_z, the power, exp, opacity and the 1/255 cull; no z); row 0:
//          the sum of alpha over the pairs that pass
//   GEOMD  + z = det / cr_z, the z > 0.2 cull and the mapped depth m; row 0:
//          the sum of alpha over the pairs that pass both culls, row 1: the
//          sum of m
//   TRANS  + the transmittance chain, the stops and the CTA exit; row 12 =
//          T_final (bitwise production).  A stopping pixel leaves the
//          batch by a break (with the production kernel's jump to the
//          loop's end ptxas spills this stage at 48 registers)
//   ACC    + the color and normal rows and sum w (rows 0-5, 9 and 12
//          bitwise production)
//   FULL   + expected and median depth, the moments and the distortion: the
//          production kernel

#pragma once

#include <cuda_runtime.h>

namespace surfel_subtile {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SUB = 16;         // sub-tile side, px: one pixel per thread
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BATCH = 256;      // forward: slots staged per round
constexpr int ROW = 24;         // table row (96 bytes), see surfel_kernels.py
constexpr int NV = 20;          // live attributes of a row
constexpr int OUT_ROWS = 13;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float NEAR_CULL = 0.2f;
constexpr float MARGIN_REL = 0x1p-16f;
constexpr float MARGIN_ABS = 0x1p-100f;

// the forward's stages (see the header comment); FULL is the production one
namespace stage {
enum : int { NOOP, LOAD, SKIP, ALPHA, GEOMD, TRANS, ACC, FULL };
}

// attribute rows of the table and of the staged batch
enum { AX, AY, AZ, BX, BY, BZ, CX, CY, CZ, DET, PX, PY, OPA, CR, CG, CB, NX, NY,
       NZ, RAD };

// Can the circle of centre (px, py) and radius rad reach a pixel centre of
// the 16 x 16 rectangle [x0, x0 + 15] x [y0, y0 + 15] (global coordinates)
// under the kernels' rounded test d2 <= rad * rad?  See the error bound
// above.  Every operation is explicitly rounded and every select written as
// a comparison, so that the PyTorch mirror performs the same f32 operations.
__device__ __forceinline__ bool circle_keep(float px, float py, float rad,
                                            float x0, float y0) {
  if (!(isfinite(px) && isfinite(py) && isfinite(rad))) return true;
  const float x1 = x0 + (SUB - 1), y1 = y0 + (SUB - 1);   // exact integers
  const float ex = px < x0 ? __fsub_rn(x0, px) : (px > x1 ? __fsub_rn(px, x1) : 0.0f);
  const float ey = py < y0 ? __fsub_rn(y0, py) : (py > y1 ? __fsub_rn(py, y1) : 0.0f);
  const float e2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
  const float rad2 = __fmul_rn(rad, rad);
  return !(e2 > __fadd_rn(rad2, __fadd_rn(__fmul_rn(MARGIN_REL, rad2), MARGIN_ABS)));
}

// One staged batch, compacted: the kept slots' 20 attributes (row RAD holds
// rad * rad) and their index in the batch.
template <int NB>
struct Staged {
  float v[NV][NB];
  int src[NB];
  int wcount[NWARPS];
};

// Stage the slots seg[0, n) (n <= NB <= THREADS, one per thread), keep those
// whose circle can reach the sub-tile with first pixel (x0, y0) (all,
// without SKIP) and compact them into `s` in segment order.  Returns how many were kept.  The caller
// has made sure the previous batch is fully read; on return the compacted
// batch is visible to the whole CTA.
template <int NB, bool SKIP = true>
__device__ __forceinline__ int stage_batch(Staged<NB>& s,
                                           const float* __restrict__ table,
                                           const int* __restrict__ seg, int n,
                                           float x0, float y0) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  bool keep = false;
  float4 r[NV / 4];
  if (t < n) {
    const int g = seg[t];
    const float4* row =
        reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * ROW);
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) r[q] = row[q];
    keep = SKIP ? circle_keep(r[PX / 4].z, r[PY / 4].w, r[RAD / 4].w, x0, y0)
                : true;
  }
  const unsigned ballot = __ballot_sync(FULL_MASK, keep);
  if (lane == 0) s.wcount[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const int cnt = s.wcount[w];
    before += w < warp ? cnt : 0;
    total += cnt;
  }
  if (keep) {
    const int k = before + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      s.v[4 * q][k] = r[q].x;
      s.v[4 * q + 1][k] = r[q].y;
      s.v[4 * q + 2][k] = r[q].z;
      s.v[4 * q + 3][k] = r[q].w;
    }
    s.v[RAD][k] = __fmul_rn(r[RAD / 4].w, r[RAD / 4].w);
    s.src[k] = t;
  }
  __syncthreads();
  return total;
}

// The load probe's staging: every slot of seg[0, n) into `s` at its own
// index, with no predicate and no compaction.  Returns n.
template <int NB>
__device__ __forceinline__ int stage_all(Staged<NB>& s,
                                         const float* __restrict__ table,
                                         const int* __restrict__ seg, int n) {
  const int t = threadIdx.x;
  if (t < n) {
    const int g = seg[t];
    const float4* row =
        reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * ROW);
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const float4 r = row[q];
      s.v[4 * q][t] = r.x;
      s.v[4 * q + 1][t] = r.y;
      s.v[4 * q + 2][t] = r.z;
      s.v[4 * q + 3][t] = r.w;
    }
    s.v[RAD][t] = __fmul_rn(s.v[RAD][t], s.v[RAD][t]);
  }
  __syncthreads();
  return n;
}

// The load and skip probes' checksum of staged slot t: its 20 staged values
// added in row order.
template <int NB>
__device__ __forceinline__ float staged_sum(const Staged<NB>& s, int t) {
  float v = s.v[0][t];
#pragma unroll
  for (int q = 1; q < NV; ++q) v = __fadd_rn(v, s.v[q][t]);
  return v;
}

// This CTA's sub-tile (the launch geometry of composite_subtile.cuh: tile =
// blockIdx.x / CTAS, q = blockIdx.x % CTAS), this thread's pixel in it and
// in global coordinates, and the sub-tile's first pixel.  Each warp covers
// an 8 x 4 block of the sub-tile (warp w at column (w % 2) * 8, row
// (w / 2) * 4, lane l at (l % 8, l / 8)): a circle of a few pixels meets
// fewer warps than with 16 x 2 rows, so fewer warps run the front at partial
// occupancy.
template <int TS>
struct Pixel {
  static constexpr int SIDE = TS / SUB;
  static constexpr int CTAS = SIDE * SIDE;   // sub-tile CTAs per tile
  int tile, q, p;
  float X, Y, x0, y0;

  __device__ __forceinline__ explicit Pixel(int tiles_x) {
    tile = blockIdx.x / CTAS;
    q = blockIdx.x % CTAS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int x = (q % SIDE) * SUB + (warp & 1) * 8 + (lane & 7);
    const int y = (q / SIDE) * SUB + (warp >> 1) * 4 + (lane >> 3);
    p = y * TS + x;
    const int ox = (tile % tiles_x) * TS;
    const int oy = (tile / tiles_x) * TS;
    X = static_cast<float>(ox + x);
    Y = static_cast<float>(oy + y);
    x0 = static_cast<float>(ox + (q % SIDE) * SUB);
    y0 = static_cast<float>(oy + (q / SIDE) * SUB);
  }
};

// The front of one (staged slot k, pixel (X, Y)) pair, in the plain
// version's rounding (splat/surfel_kernels.py::_chunk_geometry), so that the
// two agree bit for bit.
struct Front {
  float dx, dy, crx, cry, crz, rz, z, alpha;
  bool tiny;   // |cr_z| < 1e-8: rz is 1 / 1e-8
  bool sel3;   // the object-space power set the power (else the filter)
};

// The circle test, the ray-plane cross product, 1/cr_z, the power, exp and
// alpha; true where the pair passes the circle test and both culls (alpha
// >= 1/255, z > 0.2), and then `f` holds its quantities.  Without Z (the
// alpha probe) z is not computed and only the alpha cull applies.
template <int NB, bool Z = true>
__device__ __forceinline__ bool front(const Staged<NB>& s, int k, float X,
                                      float Y, Front& f) {
  f.dx = __fsub_rn(X, s.v[PX][k]);
  f.dy = __fsub_rn(Y, s.v[PY][k]);
  const float d2 = __fadd_rn(__fmul_rn(f.dx, f.dx), __fmul_rn(f.dy, f.dy));
  if (!(d2 <= s.v[RAD][k])) return false;
  f.crx = __fadd_rn(__fadd_rn(s.v[AX][k], __fmul_rn(X, s.v[BX][k])),
                    __fmul_rn(Y, s.v[CX][k]));
  f.cry = __fadd_rn(__fadd_rn(s.v[AY][k], __fmul_rn(X, s.v[BY][k])),
                    __fmul_rn(Y, s.v[CY][k]));
  f.crz = __fadd_rn(__fadd_rn(s.v[AZ][k], __fmul_rn(X, s.v[BZ][k])),
                    __fmul_rn(Y, s.v[CZ][k]));
  f.tiny = fabsf(f.crz) < 1e-8f;
  // the correctly rounded 1 / cr_z: __frcp_rn equals __fdiv_rn(1.0f, x)
  f.rz = __frcp_rn(f.tiny ? 1e-8f : f.crz);
  const float u = __fmul_rn(f.crx, f.rz);
  const float v = __fmul_rn(f.cry, f.rz);
  const float g3d = __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)));
  const float g2d = __fmul_rn(-0.25f, d2);
  f.sel3 = g3d >= g2d;
  const float power = f.sel3 ? g3d : g2d;
  if constexpr (Z) f.z = __fmul_rn(s.v[DET][k], f.rz);
  f.alpha = fminf(ALPHA_MAX, __fmul_rn(s.v[OPA][k], expf(power)));
  if constexpr (Z) {
    return f.alpha >= ALPHA_MIN && f.z > NEAR_CULL;
  } else {
    return f.alpha >= ALPHA_MIN;
  }
}

// The mapped depth m = zfar / (zfar - znear) (1 - znear / max(z, 1e-6)).
__device__ __forceinline__ float mapped_depth(float F, float znear, float z) {
  return __fmul_rn(F, __fsub_rn(1.0f, __fdiv_rn(znear, fmaxf(z, 1e-6f))));
}

// The forward: per sub-tile, front-to-back compositing of the kept slots of
// the tile's segment; per pixel the 13 rows color (3), normal (3), expected
// depth, median depth, distortion, sum w, M1, M2 and T_final into out
// (num_tiles, 13, ts*ts).  The CTA leaves the segment once all its pixels
// are done (__syncthreads_count, once per batch).  SKIP: the screen-circle
// skip (without it every slot is staged and kept); STAGE: the probes'
// (header comment).  At their defaults this is the production kernel.
template <int TS, bool SKIP = true, int STAGE = stage::FULL>
__global__ void __launch_bounds__(THREADS)
surfel_fwd_kernel(const float* __restrict__ table,
                  const int* __restrict__ sorted_ids,
                  const int* __restrict__ tile_starts,
                  const int* __restrict__ tile_counts,
                  const float* __restrict__ planes,
                  float* __restrict__ out, int tiles_x) {
  constexpr int NPIX = TS * TS;
  __shared__ Staged<BATCH> s;
  const Pixel<TS> px(tiles_x);
  const int start = tile_starts[px.tile];
  const int count = tile_counts[px.tile];
  const float znear = planes[0];
  const float zfar = planes[1];
  const float F = __fdiv_rn(zfar, __fsub_rn(zfar, znear));

  float T = 1.0f, acc[6] = {}, dexp = 0.0f, dmed = 0.0f, wsum = 0.0f,
        m1 = 0.0f, m2 = 0.0f;
  bool alive = true;
  [[maybe_unused]] int kept_slots = 0;
  if constexpr (STAGE != stage::NOOP) {   // NOOP: the loads above are dead
  for (int base = 0; base < count; base += BATCH) {
    // barrier: the previous batch is fully read before it is overwritten
    if (__syncthreads_count(alive) == 0) break;
    if constexpr (STAGE == stage::LOAD) {
      const int n = stage_all<BATCH>(s, table, sorted_ids + start + base,
                                     min(BATCH, count - base));
      if (static_cast<int>(threadIdx.x) < n)
        acc[0] = __fadd_rn(acc[0], staged_sum(s, threadIdx.x));
      continue;
    }
    const int kept = stage_batch<BATCH, SKIP>(s, table, sorted_ids + start + base,
                                              min(BATCH, count - base), px.x0,
                                              px.y0);
    if constexpr (STAGE == stage::SKIP) {
      if (static_cast<int>(threadIdx.x) < kept)
        acc[0] = __fadd_rn(acc[0], staged_sum(s, threadIdx.x));
      kept_slots += kept;
      continue;
    }
    if (!alive) continue;
    for (int k = 0; k < kept; ++k) {
      Front f;
      if constexpr (STAGE == stage::ALPHA) {
        if (front<BATCH, false>(s, k, px.X, px.Y, f))
          acc[0] = __fadd_rn(acc[0], f.alpha);
        continue;
      }
      if (!front(s, k, px.X, px.Y, f)) continue;
      if constexpr (STAGE == stage::GEOMD) {
        acc[0] = __fadd_rn(acc[0], f.alpha);
        acc[1] = __fadd_rn(acc[1], mapped_depth(F, znear, f.z));
        continue;
      }
      const float U = __fmul_rn(T, __fsub_rn(1.0f, f.alpha));
      if (U < T_EPS) {  // done before this slot: leave the batch
        alive = false;
        if constexpr (STAGE == stage::TRANS) {
          break;        // (see TRANS in the header comment)
        } else {
          k = kept;     // a jump to the loop's end: a break makes ptxas
          continue;     // spill the 32 px kernel at 64 registers
        }
      }
      if constexpr (STAGE == stage::FULL) {
      if (T > 0.5f && U < 0.5f) dmed = f.z;   // the median crossing
      }
      if constexpr (STAGE >= stage::ACC) {
      const float w = __fmul_rn(f.alpha, T);
#pragma unroll
      for (int r = 0; r < 6; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(w, s.v[CR + r][k]));
      if constexpr (STAGE == stage::FULL) {
      dexp = __fadd_rn(dexp, __fmul_rn(w, f.z));
      const float m = mapped_depth(F, znear, f.z);
      const float wm = __fmul_rn(w, m);
      wsum = __fadd_rn(wsum, w);
      m1 = __fadd_rn(m1, wm);
      m2 = __fadd_rn(m2, __fmul_rn(wm, m));
      } else {
      wsum = __fadd_rn(wsum, w);
      }
      }
      T = U;
    }
  }
  }
  if constexpr (STAGE == stage::SKIP) acc[1] = static_cast<float>(kept_slots);

  float* o = out + static_cast<size_t>(px.tile) * OUT_ROWS * NPIX + px.p;
#pragma unroll
  for (int r = 0; r < 6; ++r) o[r * NPIX] = acc[r];
  o[6 * NPIX] = dexp;
  o[7 * NPIX] = dmed;
  o[8 * NPIX] = __fsub_rn(__fmul_rn(wsum, m2), __fmul_rn(m1, m1));
  o[9 * NPIX] = wsum;
  o[10 * NPIX] = m1;
  o[11 * NPIX] = m2;
  o[12 * NPIX] = T;
}

}  // namespace surfel_subtile
