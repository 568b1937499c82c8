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
// Design (the body is composite_subtile.cuh).  One CTA of 256 threads per
// 16 x 16 sub-tile, one pixel per thread: a 32 px tile is four CTAs, so a
// 512^2 view launches 1,024 CTAs on 132 SMs and the straggler tile's work is
// spread over four of them.  Every sub-tile CTA walks its tile's whole
// segment in batches of 256 slots: each thread gathers one slot's 48-byte row
// of the (N, 12) table (the table of 262,144 gaussians is 12.6 MB and stays
// in the 50 MB L2 cache), drops the slot if it provably cannot reach alpha
// >= 1/255 anywhere in the sub-tile (the binning's bound on the sub-tile
// rectangle, with margins above the kernel's own rounding), and the kept
// slots are compacted into shared memory in segment order.  A pixel skips
// expf where its power alone puts alpha below 1/255 (the slot's power
// floor, staged with it).  A pixel's transmittance test is one predicate;
// the CTA leaves the segment once its 256 pixels are done
// (__syncthreads_count).
//
// Bound on an H100.  The bytes are small (the table read once, the live ids,
// the 5-row output: ~19 MB at 262,144 gaussians, ~6 us at 3.35 TB/s).  The
// work is one ~17-operation evaluation per kept (slot, live pixel) plus ~12
// more where the gaussian contributes, so the kernel is bound by f32
// operations (chip_smoke.py computes the bound from each run's own counts,
// after the skip).  No tensor cores: the power term stays strict f32, and
// every operation on the path from power to the accumulators is an
// explicitly rounded intrinsic (no FMA contraction) in the same order as the
// plain PyTorch version in splat/kernels.py, so the two agree to the last
// bit wherever expf agrees; the skip drops only slots whose rounded alpha is
// below 1/255 at every pixel of the sub-tile, so it changes no bit.  Build
// without --use_fast_math: approximate exp, flushed denormals or approximate
// division would move the alpha >= 1/255 and T < 1e-4 edges.

#include "composite_subtile.cuh"

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
    subtile::composite_fwd_kernel<16><<<num_tiles, subtile::THREADS, 0, s>>>(
        table, sorted_ids, tile_starts, tile_counts, out, tiles_x);
  } else if (tile_size == 32) {
    subtile::composite_fwd_kernel<32><<<num_tiles * 4, subtile::THREADS, 0, s>>>(
        table, sorted_ids, tile_starts, tile_counts, out, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
