// Stage probes of the 3DGS forward compositor for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replace the TPU probe kernels of the JAX package's
// scripts/dev_kernel_break.py: `make_fwd` (the stage ladder of
// pallas_composite_fwd), `make_fwd_hbm` (its output written by a manual
// double-buffered DMA) and `make_fwd_tpb` (tiles per grid program).  Those
// are copies of the Pallas kernel with stages switched off; here variants
// 0-14 are instantiations of the one-CTA-per-tile body that was the
// production kernel until the sub-tile redesign (composite_fwd.cuh, kept as
// it was), so a probe times exactly that code minus the stages it leaves
// out, and `full` is that design whole.  What each stage writes is in the
// header; the plain PyTorch versions are splat/probe_kernels.py.
//
// Variants, by the index the wrapper passes (probe_kernels.COMPOSITE_VARIANTS):
//    0 noop         1 load         2 power        3 alpha        4 trans
//    5 full         6 full_noexit (no per-tile exit)
//    7 full_b128 (128 slots staged per batch)     8 trips
//    9 noop_bulk   10 full_bulk (output by one bulk asynchronous copy)
//   11 tpb2        12 tpb4 (2 or 4 tiles per CTA, in turn)
//   13 tpb2_bulk   14 tpb4_bulk
//   15 sub_noexit  16 sub_noskip (the production kernel of
//      composite_subtile.cuh without its per-sub-tile exit, or without its
//      footprint skip: what each of the two costs or saves)
// The TPU variants pvpu / fullvpu / _high / _dflt have no counterpart: the
// power form is computed elementwise in f32 on CUDA cores here (power and
// full are that form), and no matrix unit precision is involved.
//
// Bound on an H100: as the production kernel, by f32 operations for every
// stage past load (the stage's own counts, tools/kernel_break.py).

#include "composite_fwd.cuh"
#include "composite_subtile.cuh"

namespace {

template <int TS, int STAGE, int NB = BATCH, int TPB = 1, bool EXIT = true,
          bool BULK = false>
int launch(const float* table, const int* sorted_ids, const int* tile_starts,
           const int* tile_counts, float* out, int num_tiles, int tiles_x,
           cudaStream_t s) {
  if (num_tiles % TPB) return static_cast<int>(cudaErrorInvalidValue);
  composite_fwd_kernel<TS, STAGE, NB, TPB, EXIT, BULK>
      <<<num_tiles / TPB, THREADS, 0, s>>>(table, sorted_ids, tile_starts,
                                           tile_counts, out, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int TS, bool EXIT, bool SKIP>
int launch_subtile(const float* table, const int* sorted_ids,
                   const int* tile_starts, const int* tile_counts, float* out,
                   int num_tiles, int tiles_x, cudaStream_t s) {
  subtile::composite_fwd_kernel<TS, EXIT, SKIP>
      <<<num_tiles * subtile::SubTile<TS>::CTAS, subtile::THREADS, 0, s>>>(
          table, sorted_ids, tile_starts, tile_counts, out, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int TS>
int dispatch(int variant, const float* table, const int* ids,
             const int* starts, const int* counts, float* out, int num_tiles,
             int tiles_x, cudaStream_t s) {
#define GD_ARGS table, ids, starts, counts, out, num_tiles, tiles_x, s
  switch (variant) {
    case 0: return launch<TS, NOOP>(GD_ARGS);
    case 1: return launch<TS, LOAD>(GD_ARGS);
    case 2: return launch<TS, POWER>(GD_ARGS);
    case 3: return launch<TS, ALPHA>(GD_ARGS);
    case 4: return launch<TS, TRANS>(GD_ARGS);
    case 5: return launch<TS, FULL>(GD_ARGS);
    case 6: return launch<TS, FULL, BATCH, 1, false>(GD_ARGS);
    case 7: return launch<TS, FULL, 128>(GD_ARGS);
    case 8: return launch<TS, TRIPS>(GD_ARGS);
    case 9: return launch<TS, NOOP, BATCH, 1, true, true>(GD_ARGS);
    case 10: return launch<TS, FULL, BATCH, 1, true, true>(GD_ARGS);
    case 11: return launch<TS, FULL, BATCH, 2>(GD_ARGS);
    case 12: return launch<TS, FULL, BATCH, 4>(GD_ARGS);
    case 13: return launch<TS, FULL, BATCH, 2, true, true>(GD_ARGS);
    case 14: return launch<TS, FULL, BATCH, 4, true, true>(GD_ARGS);
    case 15: return launch_subtile<TS, false, true>(GD_ARGS);
    case 16: return launch_subtile<TS, true, false>(GD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GD_ARGS
}

}  // namespace

// As gd_composite_fwd, with the variant's index first; out (num_tiles, 5,
// ts*ts) f32 holds what the variant writes.  tpb variants need num_tiles a
// multiple of their tiles per CTA.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int gd_composite_fwd_probe(int variant, const float* table,
                                      const int* sorted_ids,
                                      const int* tile_starts,
                                      const int* tile_counts, float* out,
                                      int num_tiles, int tiles_x,
                                      int tile_size, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16)
    return dispatch<16>(variant, table, sorted_ids, tile_starts, tile_counts,
                        out, num_tiles, tiles_x, s);
  if (tile_size == 32)
    return dispatch<32>(variant, table, sorted_ids, tile_starts, tile_counts,
                        out, num_tiles, tiles_x, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
