// 3DGS forward compositor for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `pallas_composite_fwd` / `_fwd_kernel` of
// generativedensification_tpu/splat/pallas_kernels.py: per tile, walk the
// tile's depth-sorted segment front to back and composite
//   power = min(-1/2 (a dx^2 + c dy^2) - b dx dy, 0)    (direct difference
//           form in tile-local pixel coordinates)
//   alpha = min(0.99, opacity * exp(power)), skipped below 1/255
//   a pixel stops before the Gaussian whose U = T (1 - alpha) < 1e-4
// and write r, g, b, expected depth and alpha = 1 - T_final per pixel; the
// caller adds T_final * bg.
//
// Design.  One CTA per tile, 256 threads, ts*ts/256 pixels per thread (1 for
// 16 px tiles, 4 for 32 px).  The CTA stages BATCH slots of its segment in
// shared memory: each thread loads one slot's gaussian id from sorted_ids and
// gathers that gaussian's 48-byte row of the (N, 12) attribute table (three
// 16-byte loads), so no sorted-order slab is ever materialized; the table of
// 262,144 gaussians is 12.6 MB and stays in the 50 MB L2 cache.  The block
// leaves the segment as soon as every pixel is done (__syncthreads_count).
//
// Bound on an H100.  The bytes are small (the table read once, the live ids,
// the 5-row output: ~19 MB at 262,144 gaussians, ~6 us at 3.35 TB/s).  The
// work is one ~16-operation evaluation per (slot, live pixel) plus ~14 more
// where the gaussian contributes: about 2.6e8 evaluations per 512^2 view,
// ~0.06 ms at the 67 TFLOP/s f32 rate, so the kernel is bound by f32
// operations (chip_smoke.py computes the bound from each run's own counts).
// No tensor cores: the power term stays strict f32, and every operation on
// the path from power to the accumulators is an explicitly rounded intrinsic
// (no FMA contraction) in the same order as the plain PyTorch version in
// splat/kernels.py, so the two agree to the last bit wherever expf agrees.
// Build without --use_fast_math: approximate exp, flushed denormals or
// approximate division would move the alpha >= 1/255 and T < 1e-4 edges.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BATCH = 256;     // slots staged per round, one per thread
constexpr int ROW = 12;        // table row: x y a b | c opa r g | b z valid -
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

template <int TS>
__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ sorted_ids,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     float* __restrict__ out, int tiles_x) {
  constexpr int NPIX = TS * TS;
  constexpr int PPT = NPIX / THREADS;
  static_assert(PPT * THREADS == NPIX, "tile must be a multiple of 256 px");

  __shared__ float s_x[BATCH], s_y[BATCH], s_a[BATCH], s_b[BATCH],
      s_c[BATCH], s_o[BATCH], s_r[BATCH], s_g[BATCH], s_bl[BATCH], s_z[BATCH];

  const int tile = blockIdx.x;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const float ox = static_cast<float>((tile % tiles_x) * TS);
  const float oy = static_cast<float>((tile / tiles_x) * TS);

  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT], dz[PPT];
  bool alive[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    px[i] = static_cast<float>(p % TS);
    py[i] = static_cast<float>(p / TS);
    T[i] = 1.0f;
    cr[i] = cg[i] = cb[i] = dz[i] = 0.0f;
    alive[i] = true;
  }

  for (int base = 0; base < count; base += BATCH) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    // barrier: the previous batch is fully read before it is overwritten
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
      s_r[t] = r1.z;
      s_g[t] = r1.w;
      s_bl[t] = r2.x;
      s_z[t] = r2.y;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float gx = s_x[j], gy = s_y[j];
      const float a = s_a[j], b = s_b[j], c = s_c[j], opa = s_o[j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!alive[i]) continue;
        const float dx = __fsub_rn(px[i], gx);
        const float dy = __fsub_rn(py[i], gy);
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                  __fmul_rn(__fmul_rn(c, dy), dy));
        const float power = fminf(
            __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy)),
            0.0f);
        const float alpha = fminf(ALPHA_MAX, __fmul_rn(opa, expf(power)));
        if (alpha < ALPHA_MIN) continue;
        const float U = __fmul_rn(T[i], __fsub_rn(1.0f, alpha));
        if (U < T_EPS) {  // done before this gaussian
          alive[i] = false;
          continue;
        }
        const float w = __fmul_rn(alpha, T[i]);
        cr[i] = __fadd_rn(cr[i], __fmul_rn(w, s_r[j]));
        cg[i] = __fadd_rn(cg[i], __fmul_rn(w, s_g[j]));
        cb[i] = __fadd_rn(cb[i], __fmul_rn(w, s_bl[j]));
        dz[i] = __fadd_rn(dz[i], __fmul_rn(w, s_z[j]));
        T[i] = U;
      }
    }
  }

  float* o = out + static_cast<size_t>(tile) * 5 * NPIX;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    o[p] = cr[i];
    o[NPIX + p] = cg[i];
    o[2 * NPIX + p] = cb[i];
    o[3 * NPIX + p] = dz[i];
    o[4 * NPIX + p] = __fsub_rn(1.0f, T[i]);
  }
}

}  // namespace

// table (N, 12) f32 row-major, 16-byte aligned; sorted_ids (P,) i32;
// tile_starts / tile_counts (num_tiles,) i32 with counts already clamped;
// out (num_tiles, 5, ts*ts) f32 rows r, g, b, depth, alpha.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gd_composite_fwd(const float* table, const int* sorted_ids,
                                const int* tile_starts, const int* tile_counts,
                                float* out, int num_tiles, int tiles_x,
                                int tile_size, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16) {
    composite_fwd_kernel<16><<<num_tiles, THREADS, 0, s>>>(
        table, sorted_ids, tile_starts, tile_counts, out, tiles_x);
  } else if (tile_size == 32) {
    composite_fwd_kernel<32><<<num_tiles, THREADS, 0, s>>>(
        table, sorted_ids, tile_starts, tile_counts, out, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
