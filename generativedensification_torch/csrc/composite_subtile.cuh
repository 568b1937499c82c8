// The shared front of the 3DGS compositors (sm_90a): one CTA of 256 threads
// per 16 x 16 sub-tile, one pixel per thread; the staging of a batch of the
// tile's segment with the order-preserving footprint skip; and the forward
// kernel.  csrc/composite_fwd.cu instantiates the forward,
// csrc/composite_bwd.cu builds the backward on the same front, and
// csrc/composite_fwd_probe.cu instantiates the forward's stage and
// launch-shape variants (the stage probes, below).
//
// Launch shape.  A 32 px tile is four sub-tile CTAs (blockIdx.x = tile * 4 +
// q, q = qy * 2 + qx); a 16 px tile is one.  Every sub-tile CTA walks its
// tile's whole depth-sorted segment in segment order; binning and the
// segments are the forward's own.
//
// Footprint skip.  Each staging thread gathers its slot's 48-byte row and
// asks whether the slot can reach alpha >= 1/255 anywhere in this CTA's
// 16 x 16 rectangle of pixel centres (subtile_keep).  The kept slots are
// compacted into shared memory in their segment order (a warp ballot, a
// popcount and a prefix over the 8 warp counts), and pixels evaluate only
// those (the forward also skips expf per pixel where the power alone
// decides, power_floor).  A slot is dropped only where the kernel's own
// rounded alpha is below 1/255 at every pixel of the sub-tile, so each
// pixel's serial chain meets the same contributing slots in the same order:
// the output is bitwise that of the unskipped walk
// (splat/kernels.py::subtile_touch is the PyTorch mirror of the predicate,
// with the same f32 operations).
//
// Stage probes.  composite_fwd_kernel is templated on a stage and on its
// launch shape.  The production instantiation is composite_fwd_kernel<TS>
// with every other parameter at its default: each `if constexpr` then keeps
// exactly the production statements in their order, so that kernels #1 and
// #2 compile to the same machine code as before the probes existed
// (tools/sass_check.py checks this against a parent's sources).  Anyone
// editing this file edits the production kernels.  Each stripped stage
// writes a defined per-pixel quantity (its plain version is
// splat/probe_kernels.py), so that nvcc cannot drop the stage's work:
//   NOOP   the production launch shape, no input read; rows 0-4 zero
//   LOAD   every slot staged (ids, 48-byte row gathers, shared memory,
//          barriers), no predicate, no compaction; row 0 at the pixel of
//          thread t: the sum of the ten staged values of slot t of each
//          batch, over the batches (the checksum)
//   SKIP   + subtile_keep and the ballot compaction; row 0: the checksum of
//          the kept slot t of each batch, row 1: the kept slots
//   POWER  + the power form of every (kept slot, pixel); row 0: its sum
//   ALPHA  + power_floor, expf, the 0.99 clamp and the 1/255 cull; row 0:
//          the sum of the alphas that pass
//   TRANS  + the transmittance chain, the per-pixel stop and the CTA exit;
//          row 4 = 1 - T_final (bitwise production), rows 0-3 zero
//   TRIPS  TRANS, and per CTA the executed and the assigned staging batches
//          and the kept slots of the executed ones in rows 0-2
//   FULL   + the color and depth accumulation: the production kernel
// and the launch shape: EXIT (the CTA leaves its segment once every pixel
// is done), SKIP (the footprint skip), NB slots staged per batch, TPB
// consecutive sub-tiles composited in turn by one CTA, BULK (the CTA's
// 5 x 256 outputs staged in shared memory and stored by bulk asynchronous
// copies, which with TPB > 1 overlap the next sub-tile's compositing).

#pragma once

#include <cuda_runtime.h>

namespace subtile {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SUB = 16;            // sub-tile side, px: one pixel per thread
constexpr int BATCH = 256;         // forward: slots staged per round
constexpr int ROW = 12;            // table row: x y a b | c opa r g | b z valid -
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL_MASK = 0xffffffffu;
// The skip's margins, in the units of the power form (log alpha):
//   ABS 2^-13 covers the rounding of expf (<= 2 ulp), of opa * exp, of
//       logf and of the f32 1/255 (together < 1e-6), ~100x;
//   REL 2^-14 times (a + c + 2|b|) times the squared distance from the
//       centre to the farthest pixel of the rectangle covers the kernel's
//       rounded power form (< 3e-7 of that scale) and the f32 eigenvector
//       of the directional bound (< 2e-6 of it, the direction being used
//       only where the eigenvalue gap is >= lambda_max / 16), ~30x.
constexpr float MARGIN_ABS = 1.0f / 8192.0f;
constexpr float MARGIN_REL = 1.0f / 16384.0f;
constexpr float HALF = 0.5f * (SUB - 1);   // half-width of the pixel-centre rect

// the forward's stages (see the header comment); FULL is the production one
namespace stage {
enum : int { NOOP, LOAD, SKIP, POWER, ALPHA, TRANS, TRIPS, FULL };
}

__device__ __forceinline__ float max_or_0(float x) { return x > 0.0f ? x : 0.0f; }
__device__ __forceinline__ float larger(float x, float y) { return x > y ? x : y; }

// Can the slot (tile-local centre gx, gy, conic a b c, folded opacity opa)
// reach alpha >= 1/255 at a pixel centre of the 16 x 16 rectangle centred
// at (rcx, rcy)?  The binning's SAFE bound (splat/binning.py) on this
// rectangle: with M = [[a, b], [b, c]] and q(v) = v'Mv / 2 (power = -q),
//   q >= lambda_min |v|^2 / 2        (v to the rectangle's nearest point)
//   q >= lambda_max (v.u)^2 / 2      (u the major eigenvector, v.u at
//                                     least the rectangle's support distance)
// Drop only when the bound exceeds tau = log(255 opa) plus the margins.
// Keeps every slot with a non-finite entry; then drops every slot whose
// folded opacity is <= 0 (its alpha is 0) and keeps every slot whose conic
// is not positive definite.
// Every operation is explicitly rounded and max / select are written as
// comparisons, so that the PyTorch mirror performs the same f32 operations.
__device__ __forceinline__ bool subtile_keep(float gx, float gy, float a,
                                             float b, float c, float opa,
                                             float rcx, float rcy) {
  if (!(isfinite(gx) && isfinite(gy) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(opa)))
    return true;
  if (opa <= 0.0f) return false;
  const float det = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b));
  if (!(a > 0.0f && c > 0.0f && det > 0.0f)) return true;
  const float m = __fmul_rn(0.5f, __fadd_rn(a, c));
  const float h = __fmul_rn(0.5f, __fsub_rn(a, c));
  const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(h, h), __fmul_rn(b, b)));
  const float lmin = max_or_0(__fsub_rn(m, r));
  const float lmax = __fadd_rn(m, r);
  const float tau = logf(__fmul_rn(opa, 255.0f));

  const float cx = __fsub_rn(gx, rcx);
  const float cy = __fsub_rn(gy, rcy);
  const float ax = fabsf(cx), ay = fabsf(cy);
  const float dxr = max_or_0(__fsub_rn(ax, HALF));
  const float dyr = max_or_0(__fsub_rn(ay, HALF));
  float bound = __fmul_rn(__fmul_rn(0.5f, lmin),
                          __fadd_rn(__fmul_rn(dxr, dxr), __fmul_rn(dyr, dyr)));

  // major eigenvector: the better-conditioned of the two columns
  const float v1x = b, v1y = __fsub_rn(lmax, a);
  const float v2x = __fsub_rn(lmax, c), v2y = b;
  const float n1 = __fadd_rn(__fmul_rn(v1x, v1x), __fmul_rn(v1y, v1y));
  const float n2 = __fadd_rn(__fmul_rn(v2x, v2x), __fmul_rn(v2y, v2y));
  const bool use1 = n1 >= n2;
  const float un = __fsqrt_rn(use1 ? n1 : n2);
  if (__fmul_rn(r, 32.0f) >= lmax && un >= 1e-20f) {   // gap 2r >= lmax / 16
    const float ux = __fdiv_rn(use1 ? v1x : v2x, un);
    const float uy = __fdiv_rn(use1 ? v1y : v2y, un);
    const float du = max_or_0(
        __fsub_rn(fabsf(__fadd_rn(__fmul_rn(cx, ux), __fmul_rn(cy, uy))),
                  __fmul_rn(HALF, __fadd_rn(fabsf(ux), fabsf(uy)))));
    bound = larger(bound, __fmul_rn(__fmul_rn(0.5f, lmax), __fmul_rn(du, du)));
  }

  const float fx = __fadd_rn(ax, HALF), fy = __fadd_rn(ay, HALF);
  const float scale = __fmul_rn(
      __fadd_rn(__fadd_rn(a, c), __fmul_rn(2.0f, fabsf(b))),
      __fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)));
  const float limit =
      __fadd_rn(tau, __fadd_rn(MARGIN_ABS, __fmul_rn(MARGIN_REL, scale)));
  return !(bound > limit);
}

// The forward's per-pixel cull of a kept slot: a power below -(tau +
// MARGIN_ABS) gives alpha < 1/255 whatever expf rounds to, so the pixel
// skips expf (-inf: never, for a slot with a non-finite entry).  It saves
// 4-6% of the forward on an H100 and costs the backward 2-6% (its branch
// splits warps whose lanes go on to the adjoints), so only the forward
// stages it.
__device__ __forceinline__ float power_floor(float gx, float gy, float a,
                                             float b, float c, float opa) {
  if (!(isfinite(gx) && isfinite(gy) && isfinite(a) && isfinite(b) &&
        isfinite(c) && opa > 0.0f && isfinite(opa)))
    return -INFINITY;
  return -__fadd_rn(logf(__fmul_rn(opa, 255.0f)), MARGIN_ABS);
}

// One staged batch, compacted: the kept slots' tile-local centre, conic,
// folded opacity, color, depth and power floor, and their index in the
// batch.
template <int NB>
struct Staged {
  float x[NB], y[NB], a[NB], b[NB], c[NB], o[NB], r[NB], g[NB], bl[NB], z[NB];
  float lim[NB];
  int src[NB];
  int wcount[NWARPS];
};

// Stage the slots seg[0, n) (n <= NB <= THREADS, one per thread), keep those
// that can reach the rectangle centred at (rcx, rcy) (all, without SKIP) and
// compact them into `s` in segment order, with their power floor if CULL.
// Returns how many were kept.  The caller has made sure the previous batch
// is fully read; on return the compacted batch is visible to the whole CTA.
template <int NB, bool SKIP, bool CULL>
__device__ __forceinline__ int stage_batch(Staged<NB>& s,
                                           const float* __restrict__ table,
                                           const int* __restrict__ seg, int n,
                                           float ox, float oy, float rcx,
                                           float rcy) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  bool keep = false;
  float4 r0 = {}, r1 = {}, r2 = {};
  float gx = 0.0f, gy = 0.0f, opa = 0.0f;
  if (t < n) {
    const int g = seg[t];
    const float4* row =
        reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * ROW);
    r0 = row[0];
    r1 = row[1];
    r2 = row[2];
    gx = __fsub_rn(r0.x, ox);          // tile-local center
    gy = __fsub_rn(r0.y, oy);
    opa = r2.z > 0.0f ? r1.y : 0.0f;   // valid flag folded into opacity
    keep = SKIP ? subtile_keep(gx, gy, r0.z, r0.w, r1.x, opa, rcx, rcy) : true;
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
    s.x[k] = gx;
    s.y[k] = gy;
    s.a[k] = r0.z;
    s.b[k] = r0.w;
    s.c[k] = r1.x;
    s.o[k] = opa;
    s.r[k] = r1.z;
    s.g[k] = r1.w;
    s.bl[k] = r2.x;
    s.z[k] = r2.y;
    if constexpr (CULL) s.lim[k] = power_floor(gx, gy, r0.z, r0.w, r1.x, opa);
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
                                         const int* __restrict__ seg, int n,
                                         float ox, float oy) {
  const int t = threadIdx.x;
  if (t < n) {
    const int g = seg[t];
    const float4* row =
        reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * ROW);
    const float4 r0 = row[0], r1 = row[1], r2 = row[2];
    s.x[t] = __fsub_rn(r0.x, ox);
    s.y[t] = __fsub_rn(r0.y, oy);
    s.a[t] = r0.z;
    s.b[t] = r0.w;
    s.c[t] = r1.x;
    s.o[t] = r2.z > 0.0f ? r1.y : 0.0f;
    s.r[t] = r1.z;
    s.g[t] = r1.w;
    s.bl[t] = r2.x;
    s.z[t] = r2.y;
  }
  __syncthreads();
  return n;
}

// The load and skip probes' checksum of staged slot t: its ten staged
// values added in staging order.
template <int NB>
__device__ __forceinline__ float staged_sum(const Staged<NB>& s, int t) {
  float v = __fadd_rn(s.x[t], s.y[t]);
  v = __fadd_rn(v, s.a[t]);
  v = __fadd_rn(v, s.b[t]);
  v = __fadd_rn(v, s.c[t]);
  v = __fadd_rn(v, s.o[t]);
  v = __fadd_rn(v, s.r[t]);
  v = __fadd_rn(v, s.g[t]);
  v = __fadd_rn(v, s.bl[t]);
  return __fadd_rn(v, s.z[t]);
}

// This CTA's sub-tile: its tile, its offset in the tile and this thread's
// pixel (tile-local coordinates and index); sub-tile `cta` of the launch
// (tile * CTAS + q) where a probe's CTA walks several.
template <int TS>
struct SubTile {
  static constexpr int SIDE = TS / SUB;
  static constexpr int CTAS = SIDE * SIDE;   // sub-tile CTAs per tile
  int tile, q, p;
  float px, py, rcx, rcy;

  __device__ __forceinline__ SubTile() : SubTile(blockIdx.x) {}

  __device__ __forceinline__ explicit SubTile(unsigned cta) {
    tile = cta / CTAS;
    q = cta % CTAS;
    const int x = (q % SIDE) * SUB + static_cast<int>(threadIdx.x % SUB);
    const int y = (q / SIDE) * SUB + static_cast<int>(threadIdx.x / SUB);
    p = y * TS + x;
    px = static_cast<float>(x);
    py = static_cast<float>(y);
    rcx = (q % SIDE) * SUB + HALF;
    rcy = (q / SIDE) * SUB + HALF;
  }
};

// The power form of one (slot, pixel), in the plain version's rounding
// (splat/kernels.py::composite_fwd_plain), so that the two agree bit for
// bit.
__device__ __forceinline__ float power_of(float px, float py, float gx,
                                          float gy, float a, float b, float c,
                                          float& dx, float& dy) {
  dx = __fsub_rn(px, gx);
  dy = __fsub_rn(py, gy);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  return fminf(__fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy)),
               0.0f);
}

// 1-D bulk copy shared -> global (Hopper's asynchronous copy engine): the
// issuing thread commits it as one bulk group and must wait for its groups
// to finish reading shared memory before the buffer is written again or
// the CTA exits.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  const unsigned long long g =
      static_cast<unsigned long long>(__cvta_generic_to_global(dst));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(g), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the generic-proxy writes of this thread to shared memory become visible
// to the asynchronous proxy (the bulk copies)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The BULK probes' store of one sub-tile's rows r, g, b, depth and alpha:
// each thread's five values into s_out[5][THREADS] (thread t's pixel is the
// sub-tile's pixel t), then bulk copies into out (num_tiles, 5, ts*ts).  A
// 16 px tile is its sub-tile: its 5 KB of outputs are one contiguous copy.
// In a 32 px tile a sub-tile's output row is 16 runs of 64 B at a 128 B
// stride, so 80 threads copy one run each (a 2-D tensor-map store would
// need the driver API on the host, to encode a map per output pointer).
template <int TS>
__device__ __forceinline__ void bulk_epilogue(float* s_out, float* out,
                                              const SubTile<TS>& st,
                                              const float (&v)[5]) {
  constexpr int NPIX = TS * TS;
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 5; ++r) s_out[r * THREADS + t] = v[r];
  fence_proxy_async_shared();
  __syncthreads();
  float* o = out + static_cast<size_t>(st.tile) * 5 * NPIX;
  if constexpr (SubTile<TS>::CTAS == 1) {
    if (t == 0) bulk_store(o, s_out, 5 * NPIX * sizeof(float));
  } else if (t < 5 * SUB) {
    const int r = t / SUB, y = t % SUB;
    const int qx = st.q % SubTile<TS>::SIDE, qy = st.q / SubTile<TS>::SIDE;
    bulk_store(o + r * NPIX + (qy * SUB + y) * TS + qx * SUB,
               s_out + r * THREADS + y * SUB, SUB * sizeof(float));
  }
}

// The forward: per sub-tile, front-to-back compositing of the kept slots of
// the tile's segment; rows r, g, b, depth and alpha = 1 - T_final of each
// pixel into out (num_tiles, 5, ts*ts).  EXIT: the CTA leaves the segment
// once all its pixels are done (__syncthreads_count); SKIP: the footprint
// skip (without it every slot is staged and kept).  STAGE, NB, TPB and BULK
// are the probes' (header comment); at their defaults this is the
// production kernel, launched as tiles * CTAS CTAs (probes: / TPB).
template <int TS, bool EXIT = true, bool SKIP = true, int STAGE = stage::FULL,
          int NB = BATCH, int TPB = 1, bool BULK = false>
__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ sorted_ids,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     float* __restrict__ out, int tiles_x) {
  constexpr int NPIX = TS * TS;
  __shared__ Staged<NB> s;
  for (int k = 0; k < TPB; ++k) {
  const SubTile<TS> st(blockIdx.x * TPB + k);
  const int start = tile_starts[st.tile];
  const int count = tile_counts[st.tile];
  const float ox = static_cast<float>((st.tile % tiles_x) * TS);
  const float oy = static_cast<float>((st.tile / tiles_x) * TS);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, dz = 0.0f;
  bool alive = true;
  [[maybe_unused]] int trips = 0, kept_slots = 0;
  if constexpr (STAGE != stage::NOOP) {   // NOOP: the loads above are dead
  for (int base = 0; base < count; base += NB) {
    // barrier: the previous batch is fully read before it is overwritten
    if constexpr (EXIT) {
      if (__syncthreads_count(alive) == 0) break;
    } else {
      __syncthreads();
    }
    if constexpr (STAGE == stage::TRIPS) ++trips;
    if constexpr (STAGE == stage::LOAD) {
      const int n = stage_all<NB>(s, table, sorted_ids + start + base,
                                  min(NB, count - base), ox, oy);
      if (static_cast<int>(threadIdx.x) < n)
        cr = __fadd_rn(cr, staged_sum(s, threadIdx.x));
      continue;
    }
    const int kept = stage_batch<NB, SKIP, STAGE >= stage::ALPHA>(
        s, table, sorted_ids + start + base, min(NB, count - base), ox, oy,
        st.rcx, st.rcy);
    if constexpr (STAGE == stage::SKIP) {
      if (static_cast<int>(threadIdx.x) < kept)
        cr = __fadd_rn(cr, staged_sum(s, threadIdx.x));
      kept_slots += kept;
      continue;
    }
    if constexpr (STAGE == stage::TRIPS) kept_slots += kept;
    if (!alive) continue;
    for (int j = 0; j < kept; ++j) {
      float dx, dy;
      const float power =
          power_of(st.px, st.py, s.x[j], s.y[j], s.a[j], s.b[j], s.c[j], dx, dy);
      if constexpr (STAGE == stage::POWER) {
        cr = __fadd_rn(cr, power);
        continue;
      }
      if (power < s.lim[j]) continue;
      const float alpha = fminf(ALPHA_MAX, __fmul_rn(s.o[j], expf(power)));
      if (alpha < ALPHA_MIN) continue;
      if constexpr (STAGE == stage::ALPHA) {
        cr = __fadd_rn(cr, alpha);
        continue;
      }
      const float U = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (U < T_EPS) {  // done before this gaussian
        alive = false;
        break;
      }
      if constexpr (STAGE == stage::FULL) {
      const float w = __fmul_rn(alpha, T);
      cr = __fadd_rn(cr, __fmul_rn(w, s.r[j]));
      cg = __fadd_rn(cg, __fmul_rn(w, s.g[j]));
      cb = __fadd_rn(cb, __fmul_rn(w, s.bl[j]));
      dz = __fadd_rn(dz, __fmul_rn(w, s.z[j]));
      }
      T = U;
    }
  }
  }
  if constexpr (STAGE == stage::SKIP) cg = static_cast<float>(kept_slots);
  if constexpr (STAGE == stage::TRIPS) {
    cr = static_cast<float>(trips);
    cg = static_cast<float>((count + NB - 1) / NB);
    cb = static_cast<float>(kept_slots);
  }

  if constexpr (BULK) {
    __shared__ __align__(128) float s_out[5 * THREADS];
    if (k > 0) {   // this thread's copies of the previous sub-tile read s_out
      bulk_wait_read();
      __syncthreads();
    }
    const float v[5] = {cr, cg, cb, dz, __fsub_rn(1.0f, T)};
    bulk_epilogue<TS>(s_out, out, st, v);
  } else {
  float* o = out + static_cast<size_t>(st.tile) * 5 * NPIX + st.p;
  o[0] = cr;
  o[NPIX] = cg;
  o[2 * NPIX] = cb;
  o[3 * NPIX] = dz;
  o[4 * NPIX] = __fsub_rn(1.0f, T);
  }
  }
  if constexpr (BULK) bulk_wait_read();   // shared memory stays until read
}

}  // namespace subtile
