// 3DGS compositing backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `pallas_composite_bwd` / `_bwd_kernel` of
// generativedensification_tpu/splat/pallas_kernels.py, with the semantics of
// the JAX package's `_xla_bwd` (splat/composite.py): per tile, walk the
// tile's depth-sorted segment front to back, recompute alpha, the
// transmittance T before each gaussian and the include test exactly as the
// forward kernel (composite_fwd.cu) does, carry the inclusive prefix of
// contrib * w with contrib = gC . color + gD * z and w = alpha * T, and form
//   suffix  = G2 - prefix                  (G2 = G + dL/dT_fin, per pixel)
//   g_alpha = contrib * T - suffix / max(1 - alpha, 0.01)
//   g_power = g_alpha * alpha              (0 where alpha is clamped at 0.99)
//   gx = g_power (a dx + b dy),  gy = g_power (c dy + b dx).
// Per slot the kernel reduces over the tile's pixels:
//   full    (12 rows) gx, gy, the three conic rows, g_power / opacity,
//                     w gC (3), w gD, |gx|, |gy|
//   noabs   (10 rows) the first ten
//   selonly ( 2 rows) |gx|, |gy|  (the AbsGS selection pass)
// and writes one row per slot into out (P, rows).  Rows a mode does not
// compute are not stored at all; the caller pads them with zeros.
//
// Design.  One CTA per tile, 256 threads, the forward kernel's pixel layout
// (ts*ts/256 pixels per thread).  The CTA stages BATCH slots of its segment
// in shared memory (ids gathered through sorted_ids, three 16-byte loads per
// table row).  Every slot belongs to exactly one tile, so a slot's row is
// owned by one CTA and written once: no atomics.  The per-slot sum over the
// tile's pixels is taken in a fixed order (each thread over its pixels, a
// warp shuffle tree, then the eight warp partials added in warp order from
// shared memory), so the output is bitwise the same from run to run; the
// selection scores built from it feed a top-k, where a reordered sum could
// flip a near-tied pick between two identical requests.  A warp whose lanes
// have no contribution for a slot skips its shuffles.  The block leaves the
// segment once every pixel is done (__syncthreads_count); slots past that
// point are never written and keep the zeros the wrapper allocates.
//
// Bound on an H100.  Bytes are small (table, live ids, the per-pixel
// cotangent rows and the per-slot output: tens of MB at 262,144 gaussians,
// ~0.01 ms at 3.35 TB/s).  The work is the forward's ~17-operation
// evaluation per (slot, live pixel) plus ~25 operations per contribution
// (selonly; ~45 in full), so the kernel is bound by f32 operations
// (chip_smoke.py computes the bound from each run's own counts).  Every
// operation on the per-pixel chain is an explicitly rounded intrinsic (no
// FMA contraction) in the order of the plain PyTorch version in
// splat/kernels.py.  Build without --use_fast_math: approximate exp, flushed
// denormals or approximate division would move the alpha >= 1/255 and
// T < 1e-4 edges.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ROW = 12;        // table row: x y a b | c opa r g | b z valid -
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
// 1 - ALPHA_MAX as the JAX package rounds it: the f32 nearest 0.01, not
// 1.0f - 0.99f (which is 0.00999999)
constexpr float ONE_M_FLOOR = 0.01f;
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int MODE_FULL = 0;
constexpr int MODE_NOABS = 1;
constexpr int MODE_SELONLY = 2;

template <int MODE>
struct Rows {
  static constexpr int W = MODE == MODE_FULL ? 12 : (MODE == MODE_NOABS ? 10 : 2);
  // slots staged per round: the warp partials take NWARPS * BATCH * W floats
  static constexpr int BATCH = W <= 2 ? 256 : 64;
};

template <int TS, int MODE>
__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ sorted_ids,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const float* __restrict__ gc4,
                     const float* __restrict__ g2,
                     float* __restrict__ out, int tiles_x) {
  constexpr int NPIX = TS * TS;
  constexpr int PPT = NPIX / THREADS;
  constexpr int W = Rows<MODE>::W;
  constexpr int BATCH = Rows<MODE>::BATCH;
  static_assert(PPT * THREADS == NPIX, "tile must be a multiple of 256 px");
  static_assert(BATCH <= THREADS, "one staging thread per slot");

  __shared__ float s_x[BATCH], s_y[BATCH], s_a[BATCH], s_b[BATCH],
      s_c[BATCH], s_o[BATCH], s_r[BATCH], s_g[BATCH], s_bl[BATCH], s_z[BATCH],
      s_opa[BATCH];
  __shared__ float s_part[NWARPS][BATCH][W];

  const int tile = blockIdx.x;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const float ox = static_cast<float>((tile % tiles_x) * TS);
  const float oy = static_cast<float>((tile / tiles_x) * TS);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[PPT], py[PPT], T[PPT], prefix[PPT], G2[PPT];
  float gr[PPT], gg[PPT], gb[PPT], gd[PPT];
  bool alive[PPT];
  const float* gct = gc4 + static_cast<size_t>(tile) * 4 * NPIX;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    px[i] = static_cast<float>(p % TS);
    py[i] = static_cast<float>(p / TS);
    T[i] = 1.0f;
    prefix[i] = 0.0f;
    alive[i] = true;
    gr[i] = gct[p];
    gg[i] = gct[NPIX + p];
    gb[i] = gct[2 * NPIX + p];
    gd[i] = gct[3 * NPIX + p];
    G2[i] = g2[static_cast<size_t>(tile) * NPIX + p];
  }

  for (int base = 0; base < count; base += BATCH) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    // barrier: the previous batch's slots and partials are fully read
    if (__syncthreads_count(any) == 0) break;

    const int n = min(BATCH, count - base);
    if (threadIdx.x < n) {
      const int t = threadIdx.x;
      const int g = sorted_ids[start + base + t];
      const float4* row =
          reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * ROW);
      const float4 r0 = row[0], r1 = row[1], r2 = row[2];
      s_x[t] = __fsub_rn(r0.x, ox);      // tile-local center
      s_y[t] = __fsub_rn(r0.y, oy);
      s_a[t] = r0.z;
      s_b[t] = r0.w;
      s_c[t] = r1.x;
      s_o[t] = r2.z > 0.0f ? r1.y : 0.0f;  // valid flag folded into opacity
      s_opa[t] = r1.y;
      s_r[t] = r1.z;
      s_g[t] = r1.w;
      s_bl[t] = r2.x;
      s_z[t] = r2.y;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float gx0 = s_x[j], gy0 = s_y[j];
      const float a = s_a[j], b = s_b[j], c = s_c[j], opa = s_o[j];
      const float cr = s_r[j], cg = s_g[j], cb = s_bl[j], cz = s_z[j];
      float acc[W];
#pragma unroll
      for (int r = 0; r < W; ++r) acc[r] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!alive[i]) continue;
        const float dx = __fsub_rn(px[i], gx0);
        const float dy = __fsub_rn(py[i], gy0);
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                  __fmul_rn(__fmul_rn(c, dy), dy));
        const float power = fminf(
            __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy)),
            0.0f);
        const float alpha = fminf(ALPHA_MAX, __fmul_rn(opa, expf(power)));
        if (alpha < ALPHA_MIN) continue;
        const float one_m = __fsub_rn(1.0f, alpha);
        const float U = __fmul_rn(T[i], one_m);
        if (U < T_EPS) {  // done before this gaussian
          alive[i] = false;
          continue;
        }
        hit = true;
        const float w = __fmul_rn(alpha, T[i]);
        const float contrib = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(gr[i], cr), __fmul_rn(gg[i], cg)),
                      __fmul_rn(gb[i], cb)),
            __fmul_rn(gd[i], cz));
        prefix[i] = __fadd_rn(prefix[i], __fmul_rn(contrib, w));
        const float suffix = __fsub_rn(G2[i], prefix[i]);
        const float inv_1ma = __frcp_rn(fmaxf(one_m, ONE_M_FLOOR));
        const float g_alpha = __fsub_rn(__fmul_rn(contrib, T[i]),
                                        __fmul_rn(suffix, inv_1ma));
        const float g_power = alpha < ALPHA_MAX ? __fmul_rn(g_alpha, alpha) : 0.0f;
        const float gx = __fmul_rn(
            g_power, __fadd_rn(__fmul_rn(a, dx), __fmul_rn(b, dy)));
        const float gy = __fmul_rn(
            g_power, __fadd_rn(__fmul_rn(c, dy), __fmul_rn(b, dx)));
        if constexpr (MODE == MODE_SELONLY) {
          acc[0] = __fadd_rn(acc[0], fabsf(gx));
          acc[1] = __fadd_rn(acc[1], fabsf(gy));
        } else {
          const float gh = __fmul_rn(g_power, -0.5f);
          acc[0] = __fadd_rn(acc[0], gx);
          acc[1] = __fadd_rn(acc[1], gy);
          acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(gh, dx), dx));
          acc[3] = __fadd_rn(acc[3], __fmul_rn(g_power, __fmul_rn(-dx, dy)));
          acc[4] = __fadd_rn(acc[4], __fmul_rn(__fmul_rn(gh, dy), dy));
          acc[5] = __fadd_rn(acc[5], g_power);
          acc[6] = __fadd_rn(acc[6], __fmul_rn(w, gr[i]));
          acc[7] = __fadd_rn(acc[7], __fmul_rn(w, gg[i]));
          acc[8] = __fadd_rn(acc[8], __fmul_rn(w, gb[i]));
          acc[9] = __fadd_rn(acc[9], __fmul_rn(w, gd[i]));
          if constexpr (MODE == MODE_FULL) {
            acc[10] = __fadd_rn(acc[10], fabsf(gx));
            acc[11] = __fadd_rn(acc[11], fabsf(gy));
          }
        }
        T[i] = U;
      }
      // fixed-order reduction over the warp's lanes (skipped, with a zero
      // partial, when no lane of the warp contributes)
      if (__any_sync(FULL_MASK, hit)) {
#pragma unroll
        for (int r = 0; r < W; ++r) {
          float v = acc[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
          acc[r] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < W; ++r) s_part[warp][j][r] = acc[r];
      }
    }
    __syncthreads();

    // sum the warp partials in warp order and write each slot's row once
    float* dst = out + static_cast<size_t>(start + base) * W;
    for (int idx = threadIdx.x; idx < n * W; idx += THREADS) {
      const int j = idx / W;
      const int r = idx - j * W;
      float s = s_part[0][j][r];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) s = __fadd_rn(s, s_part[w][j][r]);
      if (MODE != MODE_SELONLY && r == 5)
        s = __fdiv_rn(s, fmaxf(s_opa[j], 1e-12f));
      dst[idx] = s;
    }
  }
}

template <int MODE>
int launch(const float* table, const int* sorted_ids, const int* tile_starts,
           const int* tile_counts, const float* gc4, const float* g2,
           float* out, int num_tiles, int tiles_x, int tile_size,
           cudaStream_t s) {
  if (tile_size == 16) {
    composite_bwd_kernel<16, MODE><<<num_tiles, THREADS, 0, s>>>(
        table, sorted_ids, tile_starts, tile_counts, gc4, g2, out, tiles_x);
  } else if (tile_size == 32) {
    composite_bwd_kernel<32, MODE><<<num_tiles, THREADS, 0, s>>>(
        table, sorted_ids, tile_starts, tile_counts, gc4, g2, out, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (N, 12) f32 row-major, 16-byte aligned; sorted_ids (P,) i32;
// tile_starts / tile_counts (num_tiles,) i32 with counts already clamped;
// gc4 (num_tiles, 4, ts*ts) f32 rows gC_r, gC_g, gC_b, gD; g2 (num_tiles,
// ts*ts) f32; out (P, rows) f32, zero-filled by the caller, rows = 12 / 10 /
// 2 for mode 0 (full) / 1 (noabs) / 2 (selonly).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int gd_composite_bwd(const float* table, const int* sorted_ids,
                                const int* tile_starts, const int* tile_counts,
                                const float* gc4, const float* g2, float* out,
                                int num_tiles, int tiles_x, int tile_size,
                                int mode, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FULL:
      return launch<MODE_FULL>(table, sorted_ids, tile_starts, tile_counts,
                               gc4, g2, out, num_tiles, tiles_x, tile_size, s);
    case MODE_NOABS:
      return launch<MODE_NOABS>(table, sorted_ids, tile_starts, tile_counts,
                                gc4, g2, out, num_tiles, tiles_x, tile_size, s);
    case MODE_SELONLY:
      return launch<MODE_SELONLY>(table, sorted_ids, tile_starts, tile_counts,
                                  gc4, g2, out, num_tiles, tiles_x, tile_size, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
