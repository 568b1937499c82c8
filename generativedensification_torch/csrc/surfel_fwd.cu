// 2DGS surfel forward compositor for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel `pallas_surfel_fwd` / `_fwd_kernel` of
// generativedensification_tpu/splat/pallas_surfel.py, with the semantics of
// the JAX package's `_xla_scan_fwd` (splat/surfel.py): per tile, walk the
// tile's depth-sorted segment front to back and, per pixel (X, Y) in global
// coordinates,
//   cr    = acr + X bcr + Y ccr            (the ray-plane cross product)
//   rz    = 1 / cr_z  (cr_z replaced by 1e-8 where |cr_z| < 1e-8)
//   power = max(-1/2 ((cr_x rz)^2 + (cr_y rz)^2), -1/4 |(X, Y) - center|^2)
//   z     = det rz
//   alpha = min(0.99, opacity exp(power)), skipped below 1/255, at z <= 0.2
//           and outside the circle |(X, Y) - center| <= rad
//   a pixel stops before the slot whose U = T (1 - alpha) < 1e-4
// and accumulate color, view normal, expected depth, the median depth (z at
// the slot where T crosses 0.5), and the moments sum w, sum w m, sum w m^2 of
// the mapped depth m = zfar/(zfar - znear) (1 - znear/z), from which the
// distortion is the closed form dist = sum w * sum w m^2 - (sum w m)^2.
//
// Design.  The sub-tile front of surfel_subtile.cuh: one CTA of 256 threads
// per 16 x 16 sub-tile, one pixel per thread (a 32 px tile is four CTAs,
// 1,024 for a 512^2 view, against 256 one-CTA-per-tile blocks on 132 SMs).
// Each CTA stages its tile's segment 256 slots at a time (each staging
// thread gathers one surfel's 96-byte row; the table of 262,144 surfels is
// 25 MB and stays in the 50 MB L2 cache) and keeps a slot only where its
// screen circle can reach one of the sub-tile's pixel centres, compacted in
// segment order; pixels then walk the kept slots.  The circle test is the
// first test of every pair and a pair that fails it changes nothing, so
// the skip is exact: the output is bitwise that of the unskipped walk and
// of the plain version.  The CTA leaves the segment once all its 256 pixels
// are done (__syncthreads_count, once per batch).  The stage probes of
// surfel_fwd_probe.cu are instantiations of the same body.
//
// Bound on an H100.  The bytes are small (the table read once, the live ids,
// the 13-row output: ~45 MB at 262,144 surfels in a 512^2 view, ~0.014 ms at
// 3.35 TB/s).  The work is a 6-operation circle test per (kept slot, live
// pixel), ~30 more operations inside the circle and ~30 per contribution, so
// the kernel is bound by f32 operations (chip_smoke.py computes the bound
// from each run's own counts, with the circle tests the skip leaves).  No
// tensor cores: every operation on the path from the coefficients to the
// accumulators is an explicitly rounded intrinsic (no FMA contraction) in
// the same order as the plain PyTorch version in splat/surfel_kernels.py, so
// the two agree to the last bit wherever expf agrees.  Build without
// --use_fast_math: approximate exp, flushed denormals or approximate
// division would move the alpha >= 1/255, z > 0.2, circle and T < 1e-4
// edges.

#include "surfel_subtile.cuh"

using namespace surfel_subtile;

// table (N, 24) f32 row-major, 16-byte aligned; sorted_ids (P,) i32;
// tile_starts / tile_counts (num_tiles,) i32 with counts already clamped;
// planes (2,) f32 [znear, zfar]; out (num_tiles, 13, ts*ts) f32 rows r, g, b,
// nx, ny, nz, expected depth, median depth, dist, sum w, M1, M2, T_final.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gd_surfel_fwd(const float* table, const int* sorted_ids,
                             const int* tile_starts, const int* tile_counts,
                             const float* planes, float* out, int num_tiles,
                             int tiles_x, int tile_size, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_size == 16) {
    surfel_fwd_kernel<16><<<num_tiles * Pixel<16>::CTAS, THREADS, 0, st>>>(
        table, sorted_ids, tile_starts, tile_counts, planes, out, tiles_x);
  } else if (tile_size == 32) {
    surfel_fwd_kernel<32><<<num_tiles * Pixel<32>::CTAS, THREADS, 0, st>>>(
        table, sorted_ids, tile_starts, tile_counts, planes, out, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
