// Stage probes of the 2DGS surfel forward compositor for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the TPU probe kernel `make_fwd` of the JAX package's
// scripts/dev_surfel_break.py (the stage ladder of pallas_surfel_fwd).  Each
// variant is an instantiation of the one-CTA-per-tile body (surfel_fwd.cuh)
// that was the production kernel before the sub-tile design of
// surfel_subtile.cuh, so a probe times exactly that code minus the stages it
// leaves out; `full` is bitwise the production kernel.  What each stage
// writes is in the header; the plain PyTorch versions are
// splat/probe_kernels.py.
//
// Variants, by the index the wrapper passes (probe_kernels.SURFEL_VARIANTS):
//   0 noop  1 load  2 alpha  3 geomd  4 trans  5 acc  6 full
//
// Bound on an H100: as the production kernel, by f32 operations for every
// stage past load (the stage's own counts, tools/surfel_break.py).

#include "surfel_fwd.cuh"

namespace {

template <int TS, int STAGE>
int launch(const float* table, const int* ids, const int* starts,
           const int* counts, const float* planes, float* out, int num_tiles,
           int tiles_x, cudaStream_t s) {
  surfel_fwd_kernel<TS, STAGE><<<num_tiles, THREADS, 0, s>>>(
      table, ids, starts, counts, planes, out, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int TS>
int dispatch(int variant, const float* table, const int* ids,
             const int* starts, const int* counts, const float* planes,
             float* out, int num_tiles, int tiles_x, cudaStream_t s) {
#define GD_ARGS table, ids, starts, counts, planes, out, num_tiles, tiles_x, s
  switch (variant) {
    case 0: return launch<TS, NOOP>(GD_ARGS);
    case 1: return launch<TS, LOAD>(GD_ARGS);
    case 2: return launch<TS, ALPHA>(GD_ARGS);
    case 3: return launch<TS, GEOMD>(GD_ARGS);
    case 4: return launch<TS, TRANS>(GD_ARGS);
    case 5: return launch<TS, ACC>(GD_ARGS);
    case 6: return launch<TS, FULL>(GD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GD_ARGS
}

}  // namespace

// As gd_surfel_fwd, with the variant's index first; out (num_tiles, 13,
// ts*ts) f32 holds what the variant writes.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int gd_surfel_fwd_probe(int variant, const float* table,
                                   const int* sorted_ids,
                                   const int* tile_starts,
                                   const int* tile_counts, const float* planes,
                                   float* out, int num_tiles, int tiles_x,
                                   int tile_size, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16)
    return dispatch<16>(variant, table, sorted_ids, tile_starts, tile_counts,
                        planes, out, num_tiles, tiles_x, s);
  if (tile_size == 32)
    return dispatch<32>(variant, table, sorted_ids, tile_starts, tile_counts,
                        planes, out, num_tiles, tiles_x, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
