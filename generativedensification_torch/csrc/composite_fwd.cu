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

// The kernel body is composite_fwd.cuh, shared with the stage probes of
// composite_fwd_probe.cu; this file instantiates only the production kernel.

#include "composite_fwd.cuh"

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
